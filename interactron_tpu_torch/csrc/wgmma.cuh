// Hopper building blocks for the bf16 attention kernels, in inline PTX:
// TMA tile loads and reduce-adds described by tensor maps, mbarriers, and
// warpgroup MMA (wgmma) on swizzled shared-memory tiles.
//
// Layout conventions (all tiles are 64 rows of 64 or 32 bf16, one row per
// TMA box row, the tile base 1024-byte aligned):
//   * a row of 128 bytes (D = 64, or any 64-key row) uses the 128-byte
//     swizzle, a row of 64 bytes (D = 32) the 64-byte swizzle: the 16-byte
//     chunk c of row r sits at chunk c ^ (r % 8) (128 B) or c ^ ((r / 2) % 4)
//     (64 B). The TMA map and the wgmma descriptor name the same swizzle.
//   * K-major operand (the product's reduction dimension contiguous, e.g. Q
//     and K for S = Q K^T): stride between 8-row groups (SBO) = 8 rows; the
//     k-th 16-element slice starts 32 bytes further along the row.
//   * MN-major operand (the output dimension contiguous, e.g. V for P V, or
//     P^T for dV = P^T dO): rows are the reduction dimension; SBO = 8 rows,
//     and the k-th 16-row slice starts 16 rows further. Every tile here is
//     one swizzle atom wide, so the leading byte offset is never used.
// Accumulator layout of m64nNk16 (f32): thread t of the warpgroup, warp
// w = t / 32, lane l: register 4j + 2h + e holds row 16w + l/4 + 8h, column
// 8j + 2(l % 4) + e. The register A operand of k-slice kk is the same layout
// over columns [16kk, 16kk + 16), packed two bf16 to a register.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ipt {

// ------------------------------------------------------------ shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (r, c) of a 2-byte tile with `row_bytes` (64 or
// 128) per row, in that row width's swizzle
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const uint32_t cb = c * 2;
  const uint32_t chunk = (cb >> 4) ^ (ROW_BYTES == 128 ? (r & 7) : ((r >> 1) & 3));
  return r * ROW_BYTES + (chunk << 4) + (cb & 15);
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase `parity` has completed; a copy that never
// lands (a bad tensor map) traps after ~2^34 cycles (~10 s) instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > (1ll << 34)) asm volatile("trap;");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ----------------------------------------------------------------------- TMA

// load box (c0, c1, c2) of `map` into shared memory at `dst`, completing
// the box's bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// add the shared-memory tile at `src` into box (c0, c1, c2) of `map`
// (elementwise, fp32); boxes past the tensor's edge are clipped
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every committed bulk group has finished reading its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// every committed bulk group has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operand reads, TMA stores)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier over the 128 threads of warpgroup 0 (id 1; id 0 is __syncthreads)
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// --------------------------------------------------------------------- wgmma

constexpr uint64_t kSw128 = 1;
constexpr uint64_t kSw64 = 2;

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle; base offset 0 (1024-aligned tiles)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// descriptor of a tile with ROW_BYTES (64 or 128) per row, either major
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return make_desc(addr, 64 * ROW_BYTES, 8 * ROW_BYTES, ROW_BYTES == 128 ? kSw128 : kSw64);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// ties registers to the point of this call, so the compiler neither reads
// an accumulator before wgmma_wait_all nor moves its writes past a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define IPT_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : IPT_R8(0), IPT_R8(8), IPT_R8(16), IPT_R8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : IPT_R8(0), IPT_R8(8)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : IPT_R8(0), IPT_R8(8), IPT_R8(16), IPT_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : IPT_R8(0), IPT_R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

#undef IPT_R8

// D (64 x N, fp32) (+)= A (64 x 16, shared) B (16 x N, shared), bf16 operands;
// TA / TB: 0 = K-major, 1 = MN-major; scale_d = 0 overwrites D
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma width 32 or 64");
  if constexpr (N == 64) wgmma_ss64<TA, TB>(d, da, db, scale_d);
  else wgmma_ss32<TA, TB>(d, da, db, scale_d);
}

// the same with A (64 x 16) from registers, in the accumulator's layout
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma width 32 or 64");
  if constexpr (N == 64) wgmma_rs64<TB>(d, a, db, scale_d);
  else wgmma_rs32<TB>(d, a, db, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// Let `kernel` take `bytes` of dynamic shared memory (above the default
// 48 KB); `*set_for` remembers the device it was last set for.
inline cudaError_t allow_smem(const void* kernel, int bytes, int* set_for) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || *set_for == dev) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *set_for = dev;
  return err;
}

// Map of a packed (B, rows, H*D) tensor as (H*D, rows, B), box (D, 64, 1):
// one head's 64-row tile of one batch element, rows past `rows` zero-filled
// on load and clipped on store, never read from the next batch element.
// bf16 tiles take the swizzle of their row width; fp32 tiles are unswizzled.
inline cudaError_t packed_map(CUtensorMap* map, const void* ptr, bool fp32, int B, int rows,
                              int H, int D) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const int elt = fp32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * D * elt, (cuuint64_t)rows * H * D * elt};
  const cuuint32_t box[3] = {(cuuint32_t)D, 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = fp32 ? CU_TENSOR_MAP_SWIZZLE_NONE
                                 : D * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                : CU_TENSOR_MAP_SWIZZLE_64B;
  CUresult r = fn(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace ipt

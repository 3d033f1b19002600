// The K/V-resident warpgroup of the bf16 attention backward on Hopper
// (wgmma, TMA), shared by two kernels:
//   * flash_bwd.cu's `bwd_wgmma_kernel` (WithDq = true): the merged backward,
//     replacing `_bwd_merged_kernel` (interactron_tpu/ops/flash_attention.py:299);
//   * flash_dkv.cu's `dkv_wgmma_kernel` (WithDq = false): the split
//     backward's dK/dV half, replacing `_dkv_kernel_fullt` (`:242`) and
//     `_dkv_kernel` (`:175`).
//
// Bound on the H100 at the fusion shape (B=1, H=8, T=S=2060, D=64): five
// (T x S x D) products with dQ, about 21.7 GFLOP (~22 us at 989 TFLOP/s
// bf16), four without it, about 17.4 GFLOP (~18 us): bound by operations.
// With dropout the keep-bit hash (11 integer ops an element at 33.4 T ops/s)
// is ~11 us of its own, below both.
//
// Design. One CTA is one warpgroup (128 threads) that owns (b, h, 64 keys):
// its K and V tiles are loaded once by TMA and dK/dV stay in fp32 wgmma
// accumulators for its whole life. Q and dO tiles of 64 query rows stream
// through a 2-stage TMA ring (one mbarrier a stage). L and delta, 256 bytes
// a tile, go straight from global memory into the registers of the threads
// that own their rows (four values a thread). A 1-D tensor map over the flat
// (B*H*T) fp32 arrays could bring them by TMA, but it would add two map
// encodes to the host cost of every launch, on paths that are host-bound,
// and a round trip through shared memory, to save four loads a thread a
// tile. For each query tile: S = Q K^T and dP = dO V^T by wgmma (both
// operands K-major); P = exp2(S scale log2e - L log2e) and dS = P (dP -
// delta) on the accumulator registers, with the keep bits of each
// register's (row, col); P (dropped) and dS stored as bf16 (the TPU kernels'
// rounding points) to 128-byte swizzled shared tiles; dV += P^T dO and
// dK += dS^T Q by wgmma with the transposed (MN-major) A from those tiles and
// dO, Q as MN-major B (dK from the raw q, scaled at the end). Keys >= S and
// rows >= T get P = dS = 0; TMA zero-fills their tiles per batch element.
//
// dQ. With WithDq, the tile's dQ share dS K is formed by wgmma with dS from
// registers as A and goes through an fp32 shared tile into one TMA
// reduce-add (add.f32 in L2) per tile: S/64 adds per dQ element, in no fixed
// order, so the merged dQ is not bitwise reproducible. Without it, the
// kernel has no dQ map, no fp32 tile, no dQ product and no reduce-add: every
// output element (dK, dV) is written once, by the CTA that owns its key, so
// the split formulation (this kernel with flash_dq.cu) has no atomics and two
// runs give bitwise-equal results. Shared memory a CTA at D=64: K, V 16 KB,
// Q/dO ring 32 KB, P and dS 16 KB (65 KB), plus the 16 KB dQ tile with
// WithDq (81 KB); at D=32, 41 KB and 49 KB.
//
// fp32 stays on each file's scalar-FMA kernel: TF32 tensor cores would round
// the operands to 10 mantissa bits and break the fp32 card-vs-CPU checks.
#pragma once

#include "common.cuh"
#include "dropout.cuh"
#include "wgmma.cuh"

namespace ipt {

constexpr int kBwdKeys = 64;    // keys per CTA: one warpgroup's dK/dV rows
constexpr int kBwdRows = 64;    // query rows per Q/dO tile
constexpr int kBwdStages = 2;   // Q/dO ring depth
constexpr int kBwdThreads = 128;

// byte offsets from the CTA's 1024-aligned shared-memory base
template <int D, bool WithDq>
struct BwdSmem {
  static constexpr int kTile = 64 * D * 2;  // one 64-row bf16 tile of width D
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;                   // kBwdStages tiles
  static constexpr int kDO = kQ + kBwdStages * kTile;     // kBwdStages tiles
  static constexpr int kP = kDO + kBwdStages * kTile;     // 64 x 64 bf16
  static constexpr int kDS = kP + 64 * 64 * 2;            // 64 x 64 bf16
  static constexpr int kDQ = kDS + 64 * 64 * 2;           // 64 x D fp32, with WithDq
  static constexpr int kBar = kDQ + (WithDq ? 64 * D * 4 : 0);  // K/V barrier, then one a stage
  static constexpr int kBytes = kBar + 8 * (1 + kBwdStages) + 1024;  // + alignment slack
};

// The body of both kernels; the maps are the kernels' __grid_constant__
// parameters (dqmap is null without WithDq).
template <int D, bool WithDq>
__device__ __forceinline__ void kv_resident_bwd(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    const CUtensorMap* domap, const CUtensorMap* dqmap, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int t_len, int s_len, int heads, float scale, Dropout drop) {
  using L = BwdSmem<D, WithDq>;
  constexpr int RB = D * 2;  // bytes of one q/k/v/dO tile row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));  // generic pointer
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_q = bar_kv + 8;  // + 8 * stage

  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.x * kBwdKeys;
  const int nq = (t_len + kBwdRows - 1) / kBwdRows;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kBwdStages; ++s) mbar_init(bar_q + 8 * s, 1);
    mbar_fence_init();
    mbar_expect_tx(bar_kv, 2 * L::kTile);
    tma_load_3d(sk, kmap, bar_kv, h * D, k0, b);
    tma_load_3d(sv, vmap, bar_kv, h * D, k0, b);
    for (int s = 0; s < kBwdStages && s < nq; ++s) {
      mbar_expect_tx(bar_q + 8 * s, 2 * L::kTile);
      tma_load_3d(base + L::kQ + s * L::kTile, qmap, bar_q + 8 * s, h * D, s * kBwdRows, b);
      tma_load_3d(base + L::kDO + s * L::kTile, domap, bar_q + 8 * s, h * D, s * kBwdRows, b);
    }
  }
  __syncthreads();

  // this thread's accumulator rows are r0 and r0 + 8 (h = 0, 1), and in
  // each 8-column block its columns are c0 and c0 + 1
  const int r0 = 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float s2 = scale * kLog2e;
  const float* lb = lse + (size_t)bh * t_len;
  const float* db = delta + (size_t)bh * t_len;
  float dv_acc[D / 2], dk_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  const uint64_t dk_desc = tile_desc<RB>(sk);
  const uint64_t dv_desc = tile_desc<RB>(sv);
  const uint64_t dp_desc = tile_desc<128>(base + L::kP);
  const uint64_t ds_desc = tile_desc<128>(base + L::kDS);
  mbar_wait(bar_kv, 0);
  for (int i = 0; i < nq; ++i) {
    const int st = i % kBwdStages;
    const int q0 = i * kBwdRows;
    const uint32_t sq = base + L::kQ + st * L::kTile;
    const uint32_t sdo = base + L::kDO + st * L::kTile;
    const uint64_t q_desc = tile_desc<RB>(sq);
    const uint64_t do_desc = tile_desc<RB>(sdo);
    bool rok[2];
    float lrow[2], drow[2];
    uint32_t rkey[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      rok[hh] = row < t_len;
      lrow[hh] = rok[hh] ? lb[row] * kLog2e : 0.f;
      drow[hh] = rok[hh] ? db[row] : 0.f;
      rkey[hh] = row_key(drop.seed, bh, row);
    }
    mbar_wait(bar_q + 8 * st, (i / kBwdStages) & 1);

    // S = Q K^T and dP = dO V^T, k-slices of 16 along D
    float sacc[32], pacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(sacc, q_desc + 2 * kk, dk_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(pacc, do_desc + 2 * kk, dv_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);

    // P (dropped) into sacc, dS into pacc
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e / 2) % 2;
      const int col = k0 + 8 * (e / 4) + c0 + (e % 2);
      const bool ok = rok[hh] && col < s_len;
      const float p = ok ? exp2f(sacc[e] * s2 - lrow[hh]) : 0.f;
      const float dp = drop.apply(pacc[e], rkey[hh], col);
      sacc[e] = drop.apply(p, rkey[hh], col);
      pacc[e] = p * (dp - drow[hh]);
    }
    // both as bf16 to the swizzled shared tiles; with WithDq dS also as the
    // A operand of dQ's k-slices (16 keys each)
    uint32_t dsa[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = r0 + 8 * ((e / 2) % 2);
      const int c = 8 * (e / 4) + c0;
      const uint32_t at = swz<128>(r, c);
      *reinterpret_cast<uint32_t*>(gbase + L::kP + at) = pack_bf16(sacc[e], sacc[e + 1]);
      const uint32_t ds2 = pack_bf16(pacc[e], pacc[e + 1]);
      *reinterpret_cast<uint32_t*>(gbase + L::kDS + at) = ds2;
      dsa[e / 8][(e % 8) / 2] = ds2;
    }
    fence_async_smem();
    wg_sync();

    // dV += P^T dO, dK += dS^T Q (k-slices of 16 query rows); with WithDq
    // the dQ share dS K (k-slices of 16 keys)
    float dq_acc[WithDq ? D / 2 : 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<D, 1, 1>(dv_acc, dp_desc + (16 * kk * 128 >> 4), do_desc + (16 * kk * RB >> 4), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<D, 1, 1>(dk_acc, ds_desc + (16 * kk * 128 >> 4), q_desc + (16 * kk * RB >> 4), 1);
    if constexpr (WithDq) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D, 1>(dq_acc, dsa[kk], dk_desc + (16 * kk * RB >> 4), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if constexpr (WithDq) {
      fence_regs(dq_acc);
      if (tid == 0) bulk_wait_read();  // the last reduce-add has read the dQ tile
    }
    wg_sync();  // every warp is done with this stage, P, dS (and the dQ tile)
    if (tid == 0 && i + kBwdStages < nq) {
      mbar_expect_tx(bar_q + 8 * st, 2 * L::kTile);
      tma_load_3d(sq, qmap, bar_q + 8 * st, h * D, (i + kBwdStages) * kBwdRows, b);
      tma_load_3d(sdo, domap, bar_q + 8 * st, h * D, (i + kBwdStages) * kBwdRows, b);
    }
    if constexpr (WithDq) {
      float* dqs = reinterpret_cast<float*>(gbase + L::kDQ);
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(dqs + (r0 + 8 * hh) * D + 8 * jb + c0) =
              make_float2(dq_acc[4 * jb + 2 * hh] * scale, dq_acc[4 * jb + 2 * hh + 1] * scale);
      }
      fence_async_smem();
      wg_sync();
      if (tid == 0) {
        tma_reduce_add_3d(dqmap, base + L::kDQ, h * D, q0, b);
        bulk_commit();
      }
    }
  }
  if constexpr (WithDq) {
    if (tid == 0) bulk_wait_all();
  }

  // dK (scaled) and dV: accumulator rows are keys, columns are D
  const int ld = heads * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + r0 + 8 * hh;
    if (key < s_len) {
      const size_t at = ((size_t)b * s_len + key) * ld + h * D + c0;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * jb) =
            pack_bf16(dk_acc[4 * jb + 2 * hh] * scale, dk_acc[4 * jb + 2 * hh + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * jb) =
            pack_bf16(dv_acc[4 * jb + 2 * hh], dv_acc[4 * jb + 2 * hh + 1]);
      }
    }
  }
}

// the merged backward: dK, dV, and dQ added into an fp32 buffer
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap dqmap, const float* __restrict__ lse,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int t_len, int s_len, int heads, float scale,
                 Dropout drop) {
  kv_resident_bwd<D, true>(&qmap, &kmap, &vmap, &domap, &dqmap, lse, delta, dk, dv, t_len, s_len,
                           heads, scale, drop);
}

// the split backward's dK/dV half
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t_len,
                 int s_len, int heads, float scale, Dropout drop) {
  kv_resident_bwd<D, false>(&qmap, &kmap, &vmap, &domap, nullptr, lse, delta, dk, dv, t_len,
                            s_len, heads, scale, drop);
}

// Launch one of the two on bf16 q/dout (B, T, H*D), k/v (B, S, H*D), lse and
// delta (B, H, T) fp32, dk/dv like k, and with WithDq dq (B, T, H*D) fp32
// zero-filled by the caller (ignored without it).
template <int D, bool WithDq>
cudaError_t launch_kv_resident(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, void* dk, void* dv,
                               int B, int T_len, int S_len, int H, Dropout drop,
                               cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom, dqm;
  cudaError_t err;
  if ((err = packed_map(&qm, q, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&km, k, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&vm, v, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&dom, dout, false, B, T_len, H, D)) != cudaSuccess) return err;
  if constexpr (WithDq) {
    if ((err = packed_map(&dqm, dq, true, B, T_len, H, D)) != cudaSuccess) return err;
  }
  constexpr int smem = BwdSmem<D, WithDq>::kBytes;
  const void* kernel;  // only the chosen kernel is instantiated
  if constexpr (WithDq) kernel = reinterpret_cast<const void*>(bwd_wgmma_kernel<D>);
  else kernel = reinterpret_cast<const void*>(dkv_wgmma_kernel<D>);
  static int smem_set_for = -1;
  if ((err = allow_smem(kernel, smem, &smem_set_for)) != cudaSuccess) return err;
  const dim3 grid((S_len + kBwdKeys - 1) / kBwdKeys, B * H);
  const float scale = 1.f / sqrtf((float)D);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  __nv_bfloat16* gk = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* gv = static_cast<__nv_bfloat16*>(dv);
  if constexpr (WithDq)
    bwd_wgmma_kernel<D><<<grid, kBwdThreads, smem, stream>>>(qm, km, vm, dom, dqm, l, d, gk, gv,
                                                             T_len, S_len, H, scale, drop);
  else
    dkv_wgmma_kernel<D><<<grid, kBwdThreads, smem, stream>>>(qm, km, vm, dom, l, d, gk, gv, T_len,
                                                             S_len, H, scale, drop);
  return cudaGetLastError();
}

}  // namespace ipt

// Fused attention forward on the packed (B, T, H*D) layout.
//
// Replaces the Pallas kernel `_fwd_kernel` (interactron_tpu/ops/flash_attention.py:92,
// launched by `_fwd_impl`). It computes the same function: fp32 logits
// q.k^T / sqrt(D), an fp32 softmax, P cast to v's dtype before P.V, the
// 1/denominator folded into O, and the natural-log normaliser
// L = m + log(sum exp) per (b, h, row) for the backward. With dropout, each
// P entry is multiplied by keep / (1 - rate) after the denominator has
// taken it (`_fwd_kernel:123-131`); the keep bits are those of
// csrc/dropout.cuh, hashed from (seed, b*H + h, row, col).
//
// Bound on the H100: at the fusion shape (B=1, H=8, T=S=2060, D=64) the work
// is 4*B*H*T*S*D = 8.7 GFLOP over 8.4 MB of q/k/v/O, so it is bound by
// operations (about 8.8 us at the 989 TFLOP/s bf16 tensor-core peak); the
// DETR encoder (B=5, T=S=361, D=32) is small on both counts (~1 us).
//
// bf16 (the configuration's dtype): tensor cores. One CTA is one warpgroup
// (128 threads) that owns (b, h, 64 query rows). Its Q tile is loaded once
// by TMA; K and V stream through a 2-stage ring of 64-key tiles, each stage
// loaded by TMA on its own mbarrier and refilled as soon as the warpgroup
// is done with it. S = Q K^T is one wgmma chain m64n64k16 with both
// operands K-major in shared memory; the online softmax runs in fp32 on the
// accumulator registers in base 2; P (dropped, rounded to bf16) is packed
// in registers as the A operand of O += P V, with V the MN-major B operand.
// Tiles use the 128-byte swizzle at D=64 and the 64-byte one at D=32, set
// alike in the TMA map and the wgmma descriptor (csrc/wgmma.cuh). A 3-D map
// (H*D, T, B) with a (D, 64, 1) box zero-fills rows past T or S within one
// batch element; keys >= S get -inf before the row max, rows >= T are not
// written. Shared memory a CTA: 8 KB of Q + 2 x 16 KB of K/V at D=64 (half
// at D=32), about 41 KB.
//
// fp32: the scalar-FMA kernel below (`fwd_kernel`), unchanged from the
// first port. TF32 tensor cores would round the operands to 10 mantissa
// bits and break the fp32 card-vs-CPU checks (1e-4 x max|ref|); the
// configuration runs bf16, so fp32 exists for those checks. It streams K/V
// through shared memory 32 keys at a time; four threads share a query row.
#include "common.cuh"
#include "dropout.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 32;       // keys per shared-memory tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;  // threads per query row
constexpr int KPT = BK / TPR;      // logits per thread per tile

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int t_len, int s_len, int heads,
           float qscale, ipt::Dropout drop) {
  constexpr int CPT = D / TPR;  // output columns per thread
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D];
  __shared__ float Ps[BQ][BK + 1];

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int row = blockIdx.x * BQ + r;
  const int ld = heads * D;
  const T* qb = q + (size_t)b * t_len * ld + h * D;
  const T* kb = k + (size_t)b * s_len * ld + h * D;
  const T* vb = v + (size_t)b * s_len * ld + h * D;
  const uint32_t rkey = ipt::row_key(drop.seed, bh, row);

  // q row pre-scaled by scale*log2(e): the softmax runs in base 2
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qr[d] = row < t_len ? ipt::to_f<T>(qb[(size_t)row * ld + d]) * qscale : 0.f;

  float m = -INFINITY;
  float l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) acc[cc] = 0.f;

  for (int k0 = 0; k0 < s_len; k0 += BK) {
    __syncthreads();  // every reader of the previous tile is done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D;
      const int d = i % D;
      const int s = k0 + j;
      const bool ok = s < s_len;
      Ks[j][d] = ok ? ipt::to_f<T>(kb[(size_t)s * ld + d]) : 0.f;
      Vs[j][d] = ok ? ipt::to_f<T>(vb[(size_t)s * ld + d]) : 0.f;
    }
    __syncthreads();

    float sc[KPT];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + TPR * jj;
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], Ks[j][d], a);
      sc[jj] = (k0 + j < s_len) ? a : -INFINITY;
      tmax = fmaxf(tmax, sc[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    // every tile holds at least one valid key, so m_new is finite
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = exp2f(sc[jj] - m_new);
      psum += p;  // the denominator is taken before dropout
      // P (dropped and rescaled) in v's dtype for P.V
      Ps[r][sub + TPR * jj] = ipt::round_to<T>(drop.apply(p, rkey, k0 + sub + TPR * jj));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's P entries come from the 4 lanes of this row

#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int c = sub + TPR * cc;
      float a = acc[cc] * alpha;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(Ps[r][j], Vs[j][c], a);
      acc[cc] = a;
    }
  }

  if (row < t_len) {
    const float inv = 1.f / l;
    T* ob = o + (size_t)b * t_len * ld + h * D + (size_t)row * ld;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) ob[sub + TPR * cc] = ipt::from_f<T>(acc[cc] * inv);
    if (sub == 0) lse[(size_t)bh * t_len + row] = m * ipt::kLn2 + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int T_len, int S_len, int H,
                   ipt::Dropout drop, cudaStream_t stream) {
  const float qscale = ipt::kLog2e / sqrtf((float)D);
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      T_len, S_len, H, qscale, drop);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16: wgmma + TMA

constexpr int kRows = 64;    // query rows per CTA: one warpgroup
constexpr int kKeys = 64;    // keys per K/V tile
constexpr int kStages = 2;   // K/V ring depth
constexpr int kWgThreads = 128;

// byte offsets from the CTA's 1024-aligned shared-memory base
template <int D>
struct FwdSmem {
  static constexpr int kTile = 64 * D * 2;  // one 64-row bf16 tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // Q barrier, then one per stage
  static constexpr int kBytes = kBar + 8 * (1 + kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kWgThreads)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int t_len, int s_len, int heads, float qscale,
                 ipt::Dropout drop) {
  using L = FwdSmem<D>;
  constexpr int RB = D * 2;  // bytes of one q/k/v tile row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (ipt::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_kv = bar_q + 8;  // + 8 * stage

  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kRows;
  const int nk = (s_len + kKeys - 1) / kKeys;

  if (tid == 0) {
    ipt::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) ipt::mbar_init(bar_kv + 8 * s, 1);
    ipt::mbar_fence_init();
    ipt::mbar_expect_tx(bar_q, L::kTile);
    ipt::tma_load_3d(sq, &qmap, bar_q, h * D, q0, b);
    for (int s = 0; s < kStages && s < nk; ++s) {
      ipt::mbar_expect_tx(bar_kv + 8 * s, 2 * L::kTile);
      ipt::tma_load_3d(base + L::kK + s * L::kTile, &kmap, bar_kv + 8 * s, h * D, s * kKeys, b);
      ipt::tma_load_3d(base + L::kV + s * L::kTile, &vmap, bar_kv + 8 * s, h * D, s * kKeys, b);
    }
  }
  __syncthreads();

  // this thread's accumulator rows are r0 and r0 + 8 (h = 0, 1), and in
  // each 8-column block its columns are c0 and c0 + 1
  const int r0 = 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);
  uint32_t rkey[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rkey[hh] = ipt::row_key(drop.seed, bh, q0 + r0 + 8 * hh);
    m[hh] = -INFINITY;
    l[hh] = 0.f;  // this thread's part of the row sum
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint64_t dq = ipt::tile_desc<RB>(sq);
  ipt::mbar_wait(bar_q, 0);
  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    const uint32_t sk = base + L::kK + st * L::kTile;
    const uint32_t sv = base + L::kV + st * L::kTile;
    const uint64_t dk = ipt::tile_desc<RB>(sk);
    const uint64_t dv = ipt::tile_desc<RB>(sv);
    ipt::mbar_wait(bar_kv + 8 * st, (j / kStages) & 1);

    // S = Q K^T: k-slices of 16 along D, 32 bytes apart in a row
    float s[32];
    ipt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ipt::wgmma_ss<64, 0, 0>(s, dq + 2 * kk, dk + 2 * kk, kk);
    ipt::wgmma_commit();
    ipt::wgmma_wait_all();
    ipt::fence_regs(s);

    // online softmax in base 2
    const int k0 = j * kKeys;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + c0 + (i % 2);
      s[i] = (k0 + col < s_len) ? s[i] * qscale : -INFINITY;
      tmax[(i / 2) % 2] = fmaxf(tmax[(i / 2) % 2], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
      // every tile holds at least one valid key, so the new max is finite
      const float m_new = fmaxf(m[hh], tmax[hh]);
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i / 2) % 2;
      const float p = exp2f(s[i] - m[hh]);
      l[hh] += p;  // the denominator is taken before dropout
      s[i] = drop.apply(p, rkey[hh], k0 + 8 * (i / 4) + c0 + (i % 2));
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // O += P V, P in bf16 registers as the A operand of each 16-key slice
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = ipt::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    }
    ipt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ipt::wgmma_rs<D, 1>(acc, pa[kk], dv + (16 * kk * RB >> 4), 1);
    ipt::wgmma_commit();
    ipt::wgmma_wait_all();
    ipt::fence_regs(acc);

    ipt::wg_sync();  // every warp is done with this stage
    if (tid == 0 && j + kStages < nk) {
      ipt::mbar_expect_tx(bar_kv + 8 * st, 2 * L::kTile);
      ipt::tma_load_3d(sk, &kmap, bar_kv + 8 * st, h * D, (j + kStages) * kKeys, b);
      ipt::tma_load_3d(sv, &vmap, bar_kv + 8 * st, h * D, (j + kStages) * kKeys, b);
    }
  }

  const int ld = heads * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = q0 + r0 + 8 * hh;
    if (row < t_len) {
      const float inv = 1.f / l[hh];
      __nv_bfloat16* ob = o + ((size_t)b * t_len + row) * ld + h * D + c0;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb)
        *reinterpret_cast<uint32_t*>(ob + 8 * jb) =
            ipt::pack_bf16(acc[4 * jb + 2 * hh] * inv, acc[4 * jb + 2 * hh + 1] * inv);
      if (lane % 4 == 0) lse[(size_t)bh * t_len + row] = m[hh] * ipt::kLn2 + logf(l[hh]);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int T_len, int S_len, int H, ipt::Dropout drop, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err;
  if ((err = ipt::packed_map(&qm, q, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = ipt::packed_map(&km, k, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = ipt::packed_map(&vm, v, false, B, S_len, H, D)) != cudaSuccess) return err;
  constexpr int smem = FwdSmem<D>::kBytes;
  const auto kernel = fwd_wgmma_kernel<D>;
  static int smem_set_for = -1;
  err = ipt::allow_smem(reinterpret_cast<const void*>(kernel), smem, &smem_set_for);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + kRows - 1) / kRows, B * H);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), T_len, S_len, H,
      ipt::kLog2e / sqrtf((float)D), drop);
  return cudaGetLastError();
}

}  // namespace

// q (B, T, H*D), k/v (B, S, H*D), o like q, lse (B, H, T) fp32; all
// contiguous, bf16 tensors 16-byte aligned (TMA). Dropout: seed, keep
// threshold, 1 / (1 - rate), and whether it is on. Returns the CUDA error
// of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int T, int S, int H, int D,
                         int dtype, unsigned seed, unsigned threshold, float inv,
                         int drop_on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ipt::Dropout drop{seed, threshold, inv, drop_on};
  if (T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == ipt::kFloat32 && D == 32)
    return (int)launch<float, 32>(q, k, v, o, lse, B, T, S, H, drop, st);
  if (dtype == ipt::kFloat32 && D == 64)
    return (int)launch<float, 64>(q, k, v, o, lse, B, T, S, H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 32)
    return (int)launch_bf16<32>(q, k, v, o, lse, B, T, S, H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 64)
    return (int)launch_bf16<64>(q, k, v, o, lse, B, T, S, H, drop, st);
  return (int)cudaErrorInvalidValue;
}

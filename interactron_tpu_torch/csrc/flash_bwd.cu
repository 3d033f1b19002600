// Merged first-order attention backward on the packed (B, T, H*D) layout.
//
// Replaces the Pallas kernel `_bwd_merged_kernel`
// (interactron_tpu/ops/flash_attention.py:299, selected in `_bwd_kernels`).
// From the forward's residuals (q, k, v, O, L) and the cotangent dO, with
// delta = rowsum(dO * O) per head computed by the caller, it recomputes
// P = exp(q.k^T * scale - L), forms dS = P * (dP - delta) with dP = dO.v^T,
// and writes dV = P^T dO, dK = scale * dS^T q, dQ = scale * dS k. P is cast
// to dO's dtype before dV and dS to q's dtype before dK and dQ, as the TPU
// kernel does. With dropout (keep bits of csrc/dropout.cuh), dP becomes
// keep / (1 - rate) * (dO.v^T) and dV = (P * keep / (1 - rate))^T dO, while
// dS = P * (dP - delta) keeps the undropped P and delta = rowsum(dO * O).
//
// Bound on the H100: five (T x S x D) products against the forward's two,
// so at the fusion shape (B=1, H=8, T=S=2060, D=64) about 21.7 GFLOP,
// bound by operations (~22 us at 989 TFLOP/s bf16); the DETR encoder shape
// is small on both counts.
//
// dQ and reproducibility: on the TPU the grid runs in order and dQ sums in
// a VMEM-resident output revisited across k-blocks. CTAs on the card run in
// no order, so each CTA adds its dQ share atomically into an fp32 buffer
// that the caller zeroes and casts to q's dtype (bf16: a TMA reduce-add,
// whose adds are atomic in L2; fp32: atomicAdd). The order of those adds
// varies between runs, so dQ is not bitwise reproducible in its last bits;
// the split formulation (flash_dq + flash_dkv) is the reproducible one.
//
// bf16 (the configuration's dtype): tensor cores. One CTA is one warpgroup
// (128 threads) that owns (b, h, 64 keys): its K and V tiles are loaded
// once by TMA and dK/dV stay in fp32 wgmma accumulators for its whole life.
// Q and dO tiles of 64 query rows stream through a 2-stage TMA ring (one
// mbarrier a stage). L and delta, 256 bytes a tile, go straight from
// global memory into the registers of the threads that own their rows
// (four values a thread). A 1-D tensor map over the flat (B*H*T) fp32
// arrays could bring them by TMA, but it would add two map encodes to the
// host cost of every launch, on paths that are host-bound, and a round
// trip through shared memory, to save four loads a thread a tile. For each
// query tile: S = Q K^T and dP = dO V^T by wgmma (both
// operands K-major); P = exp2(S scale log2e - L log2e) and dS = P (dP -
// delta) on the accumulator registers, with the keep bits of each
// register's (row, col); P (dropped) and dS stored as bf16 to 128-byte
// swizzled shared tiles; dV += P^T dO and dK += dS^T Q by wgmma with the
// transposed (MN-major) A from those tiles and dO, Q as MN-major B; the
// tile's dQ share dS K by wgmma with dS from registers as A. The share goes
// through an fp32 shared tile into one TMA reduce-add (add.f32 in L2) per
// tile: S/64 adds per dQ element. Keys >= S and rows >= T get P = dS = 0;
// TMA zero-fills their tiles per batch element and clips the reduce at T.
// Shared memory a CTA at D=64: K, V 16 KB, Q/dO ring 32 KB, P and dS 16 KB,
// the dQ tile 16 KB: about 81 KB (49 KB at D=32).
//
// fp32: the scalar-FMA kernel below (`bwd_kernel`), unchanged from the
// first port: one CTA per 32 keys, dQ by fp32 atomicAdd. TF32 tensor cores
// would round the operands to 10 mantissa bits and break the fp32
// card-vs-CPU checks (1e-4 x max|ref|); the configuration runs bf16, so
// fp32 exists for those checks.
#include "common.cuh"
#include "dropout.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BK = 32;  // keys per CTA
constexpr int BQ = 32;  // query rows per loop step
constexpr int THREADS = 256;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
           int t_len, int s_len, int heads, float scale, ipt::Dropout drop) {
  constexpr int CPR = THREADS / D;      // rows covered per pass of (row, col) maps
  constexpr int KV_E = BK * D / THREADS;  // dK/dV entries per thread
  constexpr int Q_E = BQ * D / THREADS;   // dQ entries per thread
  constexpr int P_E = BQ * BK / THREADS;  // P/dS entries per thread
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D + 1];
  __shared__ float Qs[BQ][D];
  __shared__ float dOs[BQ][D];
  __shared__ float Ps[BQ][BK + 1];
  __shared__ float dSs[BQ][BK + 1];
  __shared__ float Ls[BQ];
  __shared__ float Dl[BQ];
  __shared__ uint32_t Rk[BQ];  // dropout row keys of the q-tile

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.x * BK;
  const int ld = heads * D;
  const size_t qoff = (size_t)b * t_len * ld + h * D;
  const size_t koff = (size_t)b * s_len * ld + h * D;
  const float* lb = lse + (size_t)bh * t_len;
  const float* db = delta + (size_t)bh * t_len;
  const float s2 = scale * ipt::kLog2e;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int j = i / D;
    const int d = i % D;
    const bool ok = k0 + j < s_len;
    Ks[j][d] = ok ? ipt::to_f<T>(k[koff + (size_t)(k0 + j) * ld + d]) : 0.f;
    Vs[j][d] = ok ? ipt::to_f<T>(v[koff + (size_t)(k0 + j) * ld + d]) : 0.f;
  }

  float dk_acc[KV_E];
  float dv_acc[KV_E];
#pragma unroll
  for (int e = 0; e < KV_E; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  const int col = tid % D;   // column owned in the (row, col) maps below
  const int rsub = tid / D;
  const int pj = tid % BK;   // key owned in the P/dS map
  const int pi = tid / BK;

  for (int q0 = 0; q0 < t_len; q0 += BQ) {
    __syncthreads();  // readers of the previous step are done
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D;
      const int d = i % D;
      const bool ok = q0 + r < t_len;
      const size_t at = qoff + (size_t)(q0 + r) * ld + d;
      Qs[r][d] = ok ? ipt::to_f<T>(q[at]) : 0.f;
      dOs[r][d] = ok ? ipt::to_f<T>(dout[at]) : 0.f;
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < t_len;
      Ls[tid] = ok ? lb[q0 + tid] : 0.f;
      Dl[tid] = ok ? db[q0 + tid] : 0.f;
      Rk[tid] = ipt::row_key(drop.seed, bh, q0 + tid);
    }
    __syncthreads();

    // P and dS for this (q-tile, k-tile) pair
#pragma unroll
    for (int e = 0; e < P_E; ++e) {
      const int i = pi + (THREADS / BK) * e;
      float sdot = 0.f;
      float pdot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sdot = fmaf(Qs[i][d], Ks[pj][d], sdot);
        pdot = fmaf(dOs[i][d], Vs[pj][d], pdot);
      }
      const bool ok = (q0 + i < t_len) && (k0 + pj < s_len);
      const float p = ok ? exp2f(sdot * s2 - Ls[i] * ipt::kLog2e) : 0.f;
      const float dp = drop.apply(pdot, Rk[i], k0 + pj);
      Ps[i][pj] = ipt::round_to<T>(drop.apply(p, Rk[i], k0 + pj));
      dSs[i][pj] = ipt::round_to<T>(p * (dp - Dl[i]));
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T q for the CTA's keys
#pragma unroll
    for (int e = 0; e < KV_E; ++e) {
      const int j = rsub + CPR * e;
      float av = dv_acc[e];
      float ak = dk_acc[e];
#pragma unroll 8
      for (int i = 0; i < BQ; ++i) {
        av = fmaf(Ps[i][j], dOs[i][col], av);
        ak = fmaf(dSs[i][j], Qs[i][col], ak);
      }
      dv_acc[e] = av;
      dk_acc[e] = ak;
    }

    // this k-tile's share of dQ = scale * dS k
#pragma unroll
    for (int e = 0; e < Q_E; ++e) {
      const int i = rsub + CPR * e;
      if (q0 + i < t_len) {
        float a = 0.f;
#pragma unroll 8
        for (int j = 0; j < BK; ++j) a = fmaf(dSs[i][j], Ks[j][col], a);
        atomicAdd(dq + qoff + (size_t)(q0 + i) * ld + col, a * scale);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < KV_E; ++e) {
    const int j = rsub + CPR * e;
    if (k0 + j < s_len) {
      const size_t at = koff + (size_t)(k0 + j) * ld + col;
      dk[at] = ipt::from_f<T>(dk_acc[e] * scale);
      dv[at] = ipt::from_f<T>(dv_acc[e]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int B, int T_len, int S_len,
                   int H, ipt::Dropout drop, cudaStream_t stream) {
  dim3 grid((S_len + BK - 1) / BK, B * H);
  bwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      T_len, S_len, H, 1.f / sqrtf((float)D), drop);
  return cudaGetLastError();
}


// ------------------------------------------------------------ bf16: wgmma + TMA

constexpr int kKeys = 64;    // keys per CTA: one warpgroup's dK/dV rows
constexpr int kRows = 64;    // query rows per Q/dO tile
constexpr int kStages = 2;   // Q/dO ring depth
constexpr int kWgThreads = 128;

// byte offsets from the CTA's 1024-aligned shared-memory base
template <int D>
struct BwdSmem {
  static constexpr int kTile = 64 * D * 2;  // one 64-row bf16 tile of width D
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;                // kStages tiles
  static constexpr int kDO = kQ + kStages * kTile;     // kStages tiles
  static constexpr int kP = kDO + kStages * kTile;     // 64 x 64 bf16
  static constexpr int kDS = kP + 64 * 64 * 2;         // 64 x 64 bf16
  static constexpr int kDQ = kDS + 64 * 64 * 2;        // 64 x D fp32
  static constexpr int kBar = kDQ + 64 * D * 4;        // K/V barrier, then one per stage
  static constexpr int kBytes = kBar + 8 * (1 + kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kWgThreads)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap dqmap, const float* __restrict__ lse,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int t_len, int s_len, int heads, float scale,
                 ipt::Dropout drop) {
  using L = BwdSmem<D>;
  constexpr int RB = D * 2;  // bytes of one q/k/v/dO tile row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (ipt::smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - ipt::smem_addr(smem_raw));  // generic pointer
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
  const int k0 = blockIdx.x * kKeys;
  const int nq = (t_len + kRows - 1) / kRows;

  if (tid == 0) {
    ipt::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) ipt::mbar_init(bar_q + 8 * s, 1);
    ipt::mbar_fence_init();
    ipt::mbar_expect_tx(bar_kv, 2 * L::kTile);
    ipt::tma_load_3d(sk, &kmap, bar_kv, h * D, k0, b);
    ipt::tma_load_3d(sv, &vmap, bar_kv, h * D, k0, b);
    for (int s = 0; s < kStages && s < nq; ++s) {
      ipt::mbar_expect_tx(bar_q + 8 * s, 2 * L::kTile);
      ipt::tma_load_3d(base + L::kQ + s * L::kTile, &qmap, bar_q + 8 * s, h * D, s * kRows, b);
      ipt::tma_load_3d(base + L::kDO + s * L::kTile, &domap, bar_q + 8 * s, h * D, s * kRows, b);
    }
  }
  __syncthreads();

  // this thread's accumulator rows are r0 and r0 + 8 (h = 0, 1), and in
  // each 8-column block its columns are c0 and c0 + 1
  const int r0 = 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float s2 = scale * ipt::kLog2e;
  const float* lb = lse + (size_t)bh * t_len;
  const float* db = delta + (size_t)bh * t_len;
  float dv_acc[D / 2], dk_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  const uint64_t dk_desc = ipt::tile_desc<RB>(sk);
  const uint64_t dv_desc = ipt::tile_desc<RB>(sv);
  const uint64_t dp_desc = ipt::tile_desc<128>(base + L::kP);
  const uint64_t ds_desc = ipt::tile_desc<128>(base + L::kDS);
  ipt::mbar_wait(bar_kv, 0);
  for (int i = 0; i < nq; ++i) {
    const int st = i % kStages;
    const int q0 = i * kRows;
    const uint32_t sq = base + L::kQ + st * L::kTile;
    const uint32_t sdo = base + L::kDO + st * L::kTile;
    const uint64_t q_desc = ipt::tile_desc<RB>(sq);
    const uint64_t do_desc = ipt::tile_desc<RB>(sdo);
    bool rok[2];
    float lrow[2], drow[2];
    uint32_t rkey[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      rok[hh] = row < t_len;
      lrow[hh] = rok[hh] ? lb[row] * ipt::kLog2e : 0.f;
      drow[hh] = rok[hh] ? db[row] : 0.f;
      rkey[hh] = ipt::row_key(drop.seed, bh, row);
    }
    ipt::mbar_wait(bar_q + 8 * st, (i / kStages) & 1);

    // S = Q K^T and dP = dO V^T, k-slices of 16 along D
    float sacc[32], pacc[32];
    ipt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ipt::wgmma_ss<64, 0, 0>(sacc, q_desc + 2 * kk, dk_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ipt::wgmma_ss<64, 0, 0>(pacc, do_desc + 2 * kk, dv_desc + 2 * kk, kk);
    ipt::wgmma_commit();
    ipt::wgmma_wait_all();
    ipt::fence_regs(sacc);
    ipt::fence_regs(pacc);

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
    // both as bf16 to the swizzled shared tiles; dS also as the A operand
    // of dQ's k-slices (16 keys each)
    uint32_t dsa[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = r0 + 8 * ((e / 2) % 2);
      const int c = 8 * (e / 4) + c0;
      const uint32_t at = ipt::swz<128>(r, c);
      *reinterpret_cast<uint32_t*>(gbase + L::kP + at) = ipt::pack_bf16(sacc[e], sacc[e + 1]);
      const uint32_t ds2 = ipt::pack_bf16(pacc[e], pacc[e + 1]);
      *reinterpret_cast<uint32_t*>(gbase + L::kDS + at) = ds2;
      dsa[e / 8][(e % 8) / 2] = ds2;
    }
    ipt::fence_async_smem();
    ipt::wg_sync();

    // dV += P^T dO, dK += dS^T Q (k-slices of 16 query rows), dQ share = dS K
    // (k-slices of 16 keys)
    float dq_acc[D / 2];
    ipt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ipt::wgmma_ss<D, 1, 1>(dv_acc, dp_desc + (16 * kk * 128 >> 4), do_desc + (16 * kk * RB >> 4), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ipt::wgmma_ss<D, 1, 1>(dk_acc, ds_desc + (16 * kk * 128 >> 4), q_desc + (16 * kk * RB >> 4), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ipt::wgmma_rs<D, 1>(dq_acc, dsa[kk], dk_desc + (16 * kk * RB >> 4), kk);
    ipt::wgmma_commit();
    ipt::wgmma_wait_all();
    ipt::fence_regs(dv_acc);
    ipt::fence_regs(dk_acc);
    ipt::fence_regs(dq_acc);

    if (tid == 0) ipt::bulk_wait_read();  // the last reduce-add has read the dQ tile
    ipt::wg_sync();  // every warp is done with this stage, P, dS and the dQ tile
    if (tid == 0 && i + kStages < nq) {
      ipt::mbar_expect_tx(bar_q + 8 * st, 2 * L::kTile);
      ipt::tma_load_3d(sq, &qmap, bar_q + 8 * st, h * D, (i + kStages) * kRows, b);
      ipt::tma_load_3d(sdo, &domap, bar_q + 8 * st, h * D, (i + kStages) * kRows, b);
    }
    float* dqs = reinterpret_cast<float*>(gbase + L::kDQ);
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(dqs + (r0 + 8 * hh) * D + 8 * jb + c0) =
            make_float2(dq_acc[4 * jb + 2 * hh] * scale, dq_acc[4 * jb + 2 * hh + 1] * scale);
    }
    ipt::fence_async_smem();
    ipt::wg_sync();
    if (tid == 0) {
      ipt::tma_reduce_add_3d(&dqmap, base + L::kDQ, h * D, q0, b);
      ipt::bulk_commit();
    }
  }
  if (tid == 0) ipt::bulk_wait_all();

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
            ipt::pack_bf16(dk_acc[4 * jb + 2 * hh] * scale, dk_acc[4 * jb + 2 * hh + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * jb) =
            ipt::pack_bf16(dv_acc[4 * jb + 2 * hh], dv_acc[4 * jb + 2 * hh + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
                        int T_len, int S_len, int H, ipt::Dropout drop, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom, dqm;
  cudaError_t err;
  if ((err = ipt::packed_map(&qm, q, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = ipt::packed_map(&km, k, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = ipt::packed_map(&vm, v, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = ipt::packed_map(&dom, dout, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = ipt::packed_map(&dqm, dq, true, B, T_len, H, D)) != cudaSuccess) return err;
  constexpr int smem = BwdSmem<D>::kBytes;
  const auto kernel = bwd_wgmma_kernel<D>;
  static int smem_set_for = -1;
  err = ipt::allow_smem(reinterpret_cast<const void*>(kernel), smem, &smem_set_for);
  if (err != cudaSuccess) return err;
  dim3 grid((S_len + kKeys - 1) / kKeys, B * H);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, dom, dqm, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T_len, S_len, H,
      1.f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

}  // namespace

// q/dout (B, T, H*D), k/v (B, S, H*D), lse/delta (B, H, T) fp32, dq
// (B, T, H*D) fp32 zero-filled by the caller, dk/dv like k; all contiguous,
// q/k/v/dout/dq 16-byte aligned (TMA). Dropout arguments as flash_fwd's.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, void* dk, void* dv, int B, int T, int S,
                         int H, int D, int dtype, unsigned seed, unsigned threshold,
                         float inv, int drop_on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ipt::Dropout drop{seed, threshold, inv, drop_on};
  if (T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == ipt::kFloat32 && D == 32)
    return (int)launch<float, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, T, S, H, drop, st);
  if (dtype == ipt::kFloat32 && D == 64)
    return (int)launch<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, T, S, H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 32)
    return (int)launch_bf16<32>(q, k, v, dout, lse, delta, dq, dk, dv, B, T, S, H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 64)
    return (int)launch_bf16<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, T, S, H, drop, st);
  return (int)cudaErrorInvalidValue;
}

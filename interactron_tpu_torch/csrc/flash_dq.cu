// Split attention backward, first half: dQ on the packed (B, T, H*D) layout.
//
// Replaces the Pallas kernel `_dq_kernel`
// (interactron_tpu/ops/flash_attention.py:138, launched by `_bwd_kernels:472`
// when FLASH_BWD is not "merged"). From the forward's residuals (q, k, v, L),
// the cotangent dO and delta = rowsum(dO * O) per head (computed by the
// caller), it recomputes P = exp(q.k^T * scale - L), dP = dO.v^T (times
// keep / (1 - rate) with dropout; keep bits of csrc/dropout.cuh) and
// dS = P * (dP - delta), rounds dS to q's dtype as `:166` does, and writes
// dQ = scale * dS k in q's dtype.
//
// Bound on the H100: three (T x S x D) products a head, 6*B*H*T*S*D FLOPs,
// so at the fusion shape (B=1, H=8, T=S=2060, D=64) about 13 GFLOP, bound by
// operations (0.0132 ms at 989 TFLOP/s bf16; with dropout the keep-bit hash,
// 11 integer ops an element at 33.4 T ops/s, is ~0.011 ms of its own); the
// DETR encoder shape is small on both counts.
//
// The TPU kernel holds all of K/V in VMEM for one q-block. Here one CTA owns
// (b, h, 64 query rows) and streams K/V through shared memory, so dQ
// accumulates on chip and is written once by the CTA that owns it: no
// atomics and no reduce-add, and two runs give bitwise-equal dQ
// (flash_bwd.cu's merged pass adds dQ atomically instead).
//
// bf16 (the configuration's dtype): tensor cores, `dq_wgmma_kernel`, built
// on flash_fwd.cu's Q-resident warpgroup. One warpgroup (128 threads) owns
// the 64 rows: their Q and dO tiles arrive once by TMA and their L and
// delta go into registers once, by per-thread loads (four floats a thread;
// csrc/bwd_wgmma.cuh says why not TMA). K/V 64-key tiles stream through a
// 2-stage TMA ring, one mbarrier a stage. For each tile: S = Q K^T and
// dP = dO V^T by wgmma (both operands K-major); P = exp2(S scale log2e -
// L log2e) and dS = P (keep dP / (1 - rate) - delta) on the accumulator
// registers, with the keep bits of each register's (row, col)
// (csrc/wgmma.cuh's fragment rule) applied to dP in a pass of its own that
// runs only with dropout; dS packed to bf16 registers as the A
// operand of dQ += dS K, with the ring's K tile as the MN-major B; the stage
// is refilled only after that product has completed. The epilogue stores
// dQ scale in bf16 from the accumulators. Keys >= S get P = 0 and rows >= T
// are not written; TMA zero-fills their tiles within one batch element.
// Shared memory a CTA at D=64: Q and dO 16 KB, the K/V ring 32 KB: about
// 49 KB (25 KB at D=32).
//
// fp32: the scalar-FMA kernel below (`dq_kernel`), unchanged from the first
// port: four threads share a query row, K/V stream through ~57 KB of shared
// memory 32 keys at a time, dQ accumulates in fp32 registers. TF32 tensor
// cores would round the operands to 10 mantissa bits and break the fp32
// card-vs-CPU checks (1e-4 x max|ref|); the configuration runs bf16, so
// fp32 exists for those checks.
#include "common.cuh"
#include "dropout.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 32;  // keys per tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;  // threads per query row
constexpr int KPT = BK / TPR;      // tile entries per thread

template <int D>
struct Smem {
  float Q[BQ][D + 1], dO[BQ][D + 1];
  float K[BK][D + 1], V[BK][D + 1];
  float DS[BQ][BK + 1];  // dS of the tile, rounded to q's dtype
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int t_len, int s_len,
          int heads, float scale, ipt::Dropout drop) {
  constexpr int CPT = D / TPR;  // dQ columns per thread
  extern __shared__ float smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + r;
  const bool row_ok = row < t_len;
  const int ld = heads * D;
  const size_t qoff = (size_t)b * t_len * ld + h * D;
  const size_t koff = (size_t)b * s_len * ld + h * D;
  const float s2 = scale * ipt::kLog2e;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D;
    const int d = i % D;
    const bool ok = q0 + rr < t_len;
    const size_t at = qoff + (size_t)(q0 + rr) * ld + d;
    sm.Q[rr][d] = ok ? ipt::to_f<T>(q[at]) : 0.f;
    sm.dO[rr][d] = ok ? ipt::to_f<T>(dout[at]) : 0.f;
  }
  const float l2 = row_ok ? lse[(size_t)bh * t_len + row] * ipt::kLog2e : 0.f;
  const float drow = row_ok ? delta[(size_t)bh * t_len + row] : 0.f;
  const uint32_t rkey = ipt::row_key(drop.seed, bh, row);

  float acc[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) acc[cc] = 0.f;

  for (int k0 = 0; k0 < s_len; k0 += BK) {
    __syncthreads();  // readers of the previous tile are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D;
      const int d = i % D;
      const bool ok = k0 + j < s_len;
      const size_t at = koff + (size_t)(k0 + j) * ld + d;
      sm.K[j][d] = ok ? ipt::to_f<T>(k[at]) : 0.f;
      sm.V[j][d] = ok ? ipt::to_f<T>(v[at]) : 0.f;
    }
    __syncthreads();

    // q.k and dO.v of the thread's KPT tile entries
    float qk[KPT], dov[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) qk[jj] = dov[jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sm.Q[r][d], od = sm.dO[r][d];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const int j = sub + TPR * jj;
        qk[jj] = fmaf(qd, sm.K[j][d], qk[jj]);
        dov[jj] = fmaf(od, sm.V[j][d], dov[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + TPR * jj;
      const int col = k0 + j;
      const float p = (row_ok && col < s_len) ? exp2f(qk[jj] * s2 - l2) : 0.f;
      const float dp = drop.apply(dov[jj], rkey, col);
      sm.DS[r][j] = ipt::round_to<T>(p * (dp - drow));
    }
    __syncwarp();  // a row's four threads share one warp

    // dQ += dS k for the thread's columns of its row
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float ds = sm.DS[r][j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[cc] = fmaf(ds, sm.K[j][sub + TPR * cc], acc[cc]);
    }
  }

  if (row_ok) {
    const size_t at = qoff + (size_t)row * ld;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) dq[at + sub + TPR * cc] = ipt::from_f<T>(acc[cc] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int T_len, int S_len,
                   int H, ipt::Dropout drop, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), T_len, S_len, H,
      1.f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16: wgmma + TMA

constexpr int kRows = 64;    // query rows per CTA: one warpgroup
constexpr int kKeys = 64;    // keys per K/V tile
constexpr int kStages = 2;   // K/V ring depth
constexpr int kWgThreads = 128;

// byte offsets from the CTA's 1024-aligned shared-memory base
template <int D>
struct DqSmem {
  static constexpr int kTile = 64 * D * 2;  // one 64-row bf16 tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTile;
  static constexpr int kK = kDO + kTile;             // kStages tiles
  static constexpr int kV = kK + kStages * kTile;    // kStages tiles
  static constexpr int kBar = kV + kStages * kTile;  // Q/dO barrier, then one per stage
  static constexpr int kBytes = kBar + 8 * (1 + kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kWgThreads)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int t_len, int s_len, int heads, float scale,
                ipt::Dropout drop) {
  using L = DqSmem<D>;
  constexpr int RB = D * 2;  // bytes of one q/k/v/dO tile row
  extern __shared__ uint8_t dq_smem[];
  const uint32_t base = (ipt::smem_addr(dq_smem) + 1023) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t sdo = base + L::kDO;
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
    ipt::mbar_expect_tx(bar_q, 2 * L::kTile);
    ipt::tma_load_3d(sq, &qmap, bar_q, h * D, q0, b);
    ipt::tma_load_3d(sdo, &domap, bar_q, h * D, q0, b);
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
  const float s2 = scale * ipt::kLog2e;
  bool rok[2];
  float lrow[2], drow[2];
  uint32_t rkey[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    rok[hh] = row < t_len;
    lrow[hh] = rok[hh] ? lse[(size_t)bh * t_len + row] * ipt::kLog2e : 0.f;
    drow[hh] = rok[hh] ? delta[(size_t)bh * t_len + row] : 0.f;
    rkey[hh] = ipt::row_key(drop.seed, bh, row);
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint64_t q_desc = ipt::tile_desc<RB>(sq);
  const uint64_t do_desc = ipt::tile_desc<RB>(sdo);
  ipt::mbar_wait(bar_q, 0);
  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    const int k0 = j * kKeys;
    const uint32_t sk = base + L::kK + st * L::kTile;
    const uint32_t sv = base + L::kV + st * L::kTile;
    const uint64_t k_desc = ipt::tile_desc<RB>(sk);
    const uint64_t v_desc = ipt::tile_desc<RB>(sv);
    ipt::mbar_wait(bar_kv + 8 * st, (j / kStages) & 1);

    // S = Q K^T and dP = dO V^T, k-slices of 16 along D
    float sacc[32], pacc[32];
    ipt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ipt::wgmma_ss<64, 0, 0>(sacc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ipt::wgmma_ss<64, 0, 0>(pacc, do_desc + 2 * kk, v_desc + 2 * kk, kk);
    ipt::wgmma_commit();
    ipt::wgmma_wait_all();
    ipt::fence_regs(sacc);
    ipt::fence_regs(pacc);

    // dropout on dP in a pass of its own, so that the pass below has no
    // branch an element (it ran 25% slower with one at the fusion shape)
    if (drop.on) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        pacc[e] = drop.apply(pacc[e], rkey[(e / 2) % 2], k0 + 8 * (e / 4) + c0 + (e % 2));
    }
    // dS = P (dP - delta), rounded to bf16 and packed as the A operand of
    // each 16-key slice
    uint32_t dsa[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      float ds[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int hh = (e / 2) % 2;
        const int col = k0 + 8 * (e / 4) + c0 + x;
        const bool ok = rok[hh] && col < s_len;
        const float p = ok ? exp2f(sacc[e + x] * s2 - lrow[hh]) : 0.f;
        ds[x] = p * (pacc[e + x] - drow[hh]);
      }
      dsa[e / 8][(e % 8) / 2] = ipt::pack_bf16(ds[0], ds[1]);
    }

    // dQ += dS K, K as the MN-major B operand (k-slices of 16 keys)
    ipt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ipt::wgmma_rs<D, 1>(acc, dsa[kk], k_desc + (16 * kk * RB >> 4), 1);
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

  // dQ (scaled): accumulator rows are query rows, columns are D
  const int ld = heads * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    if (rok[hh]) {
      __nv_bfloat16* out = dq + ((size_t)b * t_len + row) * ld + h * D + c0;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb)
        *reinterpret_cast<uint32_t*>(out + 8 * jb) =
            ipt::pack_bf16(acc[4 * jb + 2 * hh] * scale, acc[4 * jb + 2 * hh + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int T_len, int S_len,
                        int H, ipt::Dropout drop, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  cudaError_t err;
  if ((err = ipt::packed_map(&qm, q, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = ipt::packed_map(&km, k, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = ipt::packed_map(&vm, v, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = ipt::packed_map(&dom, dout, false, B, T_len, H, D)) != cudaSuccess) return err;
  constexpr int smem = DqSmem<D>::kBytes;
  const auto kernel = dq_wgmma_kernel<D>;
  static int smem_set_for = -1;
  err = ipt::allow_smem(reinterpret_cast<const void*>(kernel), smem, &smem_set_for);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + kRows - 1) / kRows, B * H);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, dom, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), T_len, S_len, H, 1.f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

}  // namespace

// q/dout/dq (B, T, H*D), k/v (B, S, H*D), lse/delta (B, H, T) fp32; all
// contiguous, bf16 q/k/v/dout 16-byte aligned (TMA). Dropout arguments as
// flash_fwd's. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int T, int S,
                        int H, int D, int dtype, unsigned seed, unsigned threshold, float inv,
                        int drop_on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ipt::Dropout drop{seed, threshold, inv, drop_on};
  if (T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == ipt::kFloat32 && D == 32)
    return (int)launch<float, 32>(q, k, v, dout, lse, delta, dq, B, T, S, H, drop, st);
  if (dtype == ipt::kFloat32 && D == 64)
    return (int)launch<float, 64>(q, k, v, dout, lse, delta, dq, B, T, S, H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 32)
    return (int)launch_bf16<32>(q, k, v, dout, lse, delta, dq, B, T, S, H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 64)
    return (int)launch_bf16<64>(q, k, v, dout, lse, delta, dq, B, T, S, H, drop, st);
  return (int)cudaErrorInvalidValue;
}

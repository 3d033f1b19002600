// Split second-order attention backward, column half: c_k and c_v on the
// packed (B, T, H*D) layout.
//
// Replaces the Pallas kernel `_sov_col_kernel`
// (interactron_tpu/ops/flash_attention.py:867, launched by
// `_so_vjp_impl:1191` when SO_MERGED=0). With the notation of
// flash_so_row.cu, and the row statistics g_D = -rowsum(P*g_dS) and
// s_gp = rowsum(P*g_P) that the row half wrote (one key tile cannot form a
// full row's sums), it recomputes per (query, key) pair
//   dS = P*e,  g_P = g_P1 + g_dS*e + g_D*dp,  g_dp = M*inv*P*(g_dS + g_D),
//   g_S = P*(g_P - s_gp)
// as `:947-955` does, rounds g_S, dS and g_dp to the operand dtype
// (`:956-958`), and accumulates c_k = scale*(g_S^T q + dS^T A) and
// c_v = g_dp^T dO in fp32, written once in q's dtype (`:1214`).
//
// Bound on the H100: eight (T x S x D) products a head (16*B*H*T*S*D FLOPs),
// so at the fusion shape (B=1, H=8, T=S=2060, D=64) about 35 GFLOP, bound by
// operations (~35 us at 989 TFLOP/s bf16); with dropout the keep-bit hash
// (11 integer ops an element at 33.4 T ops/s) is ~11 us beside it.
//
// The TPU kernel splits the q sweep between the grid and an in-kernel loop
// and accumulates in a VMEM-resident output revisited across grid steps.
// Here one CTA owns (b, h, a tile of keys) and sweeps every query row once,
// with c_k/c_v in fp32 registers for its whole life. Every output element is
// written once by the CTA that owns its key: no atomics, and two runs give
// bitwise-equal results (flash_so.cu's merged pass adds c_k/c_v across CTAs
// instead). The dropout bits come from the per-element hash of
// csrc/dropout.cuh, so the row and column halves regenerate the same mask at
// any tiling (the TPU kernel keys its tiles by the global q-block, `:938`).
//
// bf16 (the configuration's dtype): tensor cores, `so_col_wgmma_kernel`.
//   * One CTA is one warpgroup (128 threads) that owns (b, h, 64 keys): its
//     K, V, Bc and C tiles arrive once by TMA and stay resident, and c_k, c_v
//     stay in fp32 wgmma accumulators (M = the 64 keys), as in
//     csrc/bwd_wgmma.cuh's K/V-resident warpgroup. Q, dO and A tiles of 64
//     query rows stream through a 2-stage TMA/mbarrier ring. Grid
//     ceil(S/64) x B*H: 264 CTAs at F and at L, 240 at E.
//   * Keys as M. Each ring tile runs as two 32-query halves (N = 32). The
//     four score tiles are formed transposed, the resident tile as the
//     shared-memory A and the streamed tile as B, every operand K-major
//     (`col_scores`): S^T = K Q^T, dP^T = V dO^T, g_dS^T / scale =
//     K A^T + Bc Q^T, g_P1^T = C dO^T. Their accumulator fragments, after
//     the per-element pass, rounded to bf16 and packed, are directly the
//     register A of c_k += g_S^T Q + dS^T A and c_v += g_dp^T dO, with the
//     ring's Q, A and dO tiles as the MN-major B (as so_wgmma.cuh feeds c_q
//     and c_dO). So no P or dS tile goes through shared memory: the one
//     structural difference from bwd_wgmma.cuh, which needs the transposed
//     A from shared tiles because its scores come out with queries as M.
//   * Per-query statistics live on the accumulator's columns: a register's
//     query is 8j + 2(l%4) + e of its half (csrc/wgmma.cuh's fragment rule),
//     eight queries a thread a half. L log2(e), D, g_D and s_gp of the ring
//     tile's 64 queries (and the dropout row keys row_key(seed, bh, query))
//     are staged in shared memory, one copy a ring stage: the threads load
//     the next tile's values into registers at the start of a tile and
//     store them at its end, so the loads' latency hides behind the tile's
//     products. Per-thread loads rather than a 1-D TMA for the reason
//     bwd_wgmma.cuh gives (two more tensor-map encodes on the host per
//     launch, on paths that are host-bound, to save two loads a thread a
//     tile). Queries >= T get L = +inf, so P = exp2(-inf) = 0; keys >= S get
//     P = 0 by index; TMA zero-fills both tiles' tails within one batch
//     element.
//   * Dropout bits of a half are hashed once (16 a thread) into one
//     register of bits and applied to dp and g_P1, then to g_dp, by passes
//     that run only with dropout on (a per-element branch cost flash_dq
//     22-27%).
//   * Registers: c_k and c_v (D a thread), the four 32-query score
//     accumulators (4 x 16) and their three packed fragments (24). Shared
//     memory at D=64: K, V, Bc, C 32 KB, the ring 48 KB, the statistics
//     2.5 KB (83 KB, two CTAs an SM); at D=32, 43 KB.
//   * At L (T = 255) each CTA sees only four query tiles: the kernel is
//     latency-bound there (one warpgroup runs its products, per-element
//     passes and waits in series); that is tuning, not this design.
//
// fp32: the scalar-FMA kernel below (`sov_col_kernel`), unchanged from the
// first port: 32 keys a CTA, 256 threads, 32 query rows a step through ~70
// KB of dynamic shared memory. TF32 tensor cores would round the operands to
// 10 mantissa bits and break the fp32 card-vs-CPU checks.
#include "common.cuh"
#include "dropout.cuh"
#include "so_wgmma.cuh"

namespace {

constexpr int BK = 32;  // keys per CTA
constexpr int BQ = 32;  // query rows per loop step
constexpr int THREADS = 256;

template <int D>
struct Smem {
  float K[BK][D + 1], V[BK][D + 1], Bc[BK][D + 1], C[BK][D + 1];
  float Q[BQ][D + 1], dO[BQ][D + 1], A[BQ][D + 1];
  // rounded tile products: g_S, dS, g_dp
  float GS[BQ][BK + 1], DS[BQ][BK + 1], GDP[BQ][BK + 1];
  float L[BQ], Dl[BQ], GD[BQ], SGP[BQ];  // per query row: L, D, g_D, s_gp
  uint32_t Rk[BQ];                       // dropout row keys
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
sov_col_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const T* __restrict__ a, const T* __restrict__ bc,
               const T* __restrict__ c, const float* __restrict__ lse,
               const float* __restrict__ delta, const float* __restrict__ gd,
               const float* __restrict__ sgp, T* __restrict__ ck, T* __restrict__ cv,
               int t_len, int s_len, int heads, float scale, ipt::Dropout drop) {
  constexpr int CPR = THREADS / D;        // key rows per pass of the c_k/c_v map
  constexpr int KV_E = BK * D / THREADS;  // c_k / c_v entries per thread
  constexpr int P_E = BQ * BK / THREADS;  // tile entries per thread
  extern __shared__ float smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.x * BK;
  const int ld = heads * D;
  const size_t qoff = (size_t)b * t_len * ld + h * D;
  const size_t koff = (size_t)b * s_len * ld + h * D;
  const size_t roff = (size_t)bh * t_len;
  const float s2 = scale * ipt::kLog2e;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int j = i / D;
    const int d = i % D;
    const bool ok = k0 + j < s_len;
    const size_t at = koff + (size_t)(k0 + j) * ld + d;
    sm.K[j][d] = ok ? ipt::to_f<T>(k[at]) : 0.f;
    sm.V[j][d] = ok ? ipt::to_f<T>(v[at]) : 0.f;
    sm.Bc[j][d] = ok ? ipt::to_f<T>(bc[at]) : 0.f;
    sm.C[j][d] = ok ? ipt::to_f<T>(c[at]) : 0.f;
  }

  float ck_acc[KV_E], cv_acc[KV_E];
#pragma unroll
  for (int e = 0; e < KV_E; ++e) ck_acc[e] = cv_acc[e] = 0.f;

  const int col = tid % D;  // column owned in the c_k/c_v map
  const int rsub = tid / D;
  const int pj = tid % BK;  // key owned in the tile map
  const int pi = tid / BK;

  for (int q0 = 0; q0 < t_len; q0 += BQ) {
    __syncthreads();  // readers of the previous step are done
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D;
      const int d = i % D;
      const bool ok = q0 + r < t_len;
      const size_t at = qoff + (size_t)(q0 + r) * ld + d;
      sm.Q[r][d] = ok ? ipt::to_f<T>(q[at]) : 0.f;
      sm.dO[r][d] = ok ? ipt::to_f<T>(dout[at]) : 0.f;
      sm.A[r][d] = ok ? ipt::to_f<T>(a[at]) : 0.f;
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < t_len;
      sm.L[tid] = ok ? lse[roff + q0 + tid] * ipt::kLog2e : 0.f;
      sm.Dl[tid] = ok ? delta[roff + q0 + tid] : 0.f;
      sm.GD[tid] = ok ? gd[roff + q0 + tid] : 0.f;
      sm.SGP[tid] = ok ? sgp[roff + q0 + tid] : 0.f;
      sm.Rk[tid] = ipt::row_key(drop.seed, bh, q0 + tid);
    }
    __syncthreads();

    // g_S, dS and g_dp of this (q-tile, k-tile) pair
#pragma unroll
    for (int e = 0; e < P_E; ++e) {
      const int i = pi + (THREADS / BK) * e;
      float qk = 0.f, dov = 0.f, ak = 0.f, qb = 0.f, doc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qd = sm.Q[i][d], od = sm.dO[i][d], kd = sm.K[pj][d];
        qk = fmaf(qd, kd, qk);
        ak = fmaf(sm.A[i][d], kd, ak);
        dov = fmaf(od, sm.V[pj][d], dov);
        qb = fmaf(qd, sm.Bc[pj][d], qb);
        doc = fmaf(od, sm.C[pj][d], doc);
      }
      const int kcol = k0 + pj;
      const bool ok = (q0 + i < t_len) && (kcol < s_len);
      const float p = ok ? exp2f(qk * s2 - sm.L[i]) : 0.f;
      const float g_ds = (ak + qb) * scale;
      const float dp = drop.apply(dov, sm.Rk[i], kcol);
      const float g_p1 = drop.apply(doc, sm.Rk[i], kcol);
      const float e_ = dp - sm.Dl[i];
      const float g_d = sm.GD[i];
      const float g_p = g_p1 + g_ds * e_ + g_d * dp;
      sm.GS[i][pj] = ipt::round_to<T>(p * (g_p - sm.SGP[i]));
      sm.DS[i][pj] = ipt::round_to<T>(p * e_);
      sm.GDP[i][pj] = ipt::round_to<T>(drop.apply(p * (g_ds + g_d), sm.Rk[i], kcol));
    }
    __syncthreads();

    // c_k += g_S^T q + dS^T A and c_v += g_dp^T dO for the CTA's keys
#pragma unroll
    for (int e = 0; e < KV_E; ++e) {
      const int j = rsub + CPR * e;
      float sk = ck_acc[e];
      float sv = cv_acc[e];
#pragma unroll 8
      for (int i = 0; i < BQ; ++i) {
        sk = fmaf(sm.GS[i][j], sm.Q[i][col], fmaf(sm.DS[i][j], sm.A[i][col], sk));
        sv = fmaf(sm.GDP[i][j], sm.dO[i][col], sv);
      }
      ck_acc[e] = sk;
      cv_acc[e] = sv;
    }
  }

#pragma unroll
  for (int e = 0; e < KV_E; ++e) {
    const int j = rsub + CPR * e;
    if (k0 + j < s_len) {
      const size_t at = koff + (size_t)(k0 + j) * ld + col;
      ck[at] = ipt::from_f<T>(ck_acc[e] * scale);
      cv[at] = ipt::from_f<T>(cv_acc[e]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* a, const void* bc, const void* c, const void* lse,
                   const void* delta, const void* gd, const void* sgp, void* ck, void* cv,
                   int B, int T_len, int S_len, int H, ipt::Dropout drop,
                   cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(sov_col_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S_len + BK - 1) / BK, B * H);
  sov_col_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const T*>(a), static_cast<const T*>(bc),
      static_cast<const T*>(c), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(gd),
      static_cast<const float*>(sgp), static_cast<T*>(ck), static_cast<T*>(cv), T_len, S_len,
      H, 1.f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

}  // namespace

namespace ipt {

constexpr int kColKeys = 64;    // keys per CTA: one warpgroup's c_k/c_v rows
constexpr int kColRows = 64;    // query rows per ring tile
constexpr int kColStages = 2;   // Q/dO/A ring depth
constexpr int kColThreads = 128;

// a ring tile's per-query values: (L log2(e), D, g_D, s_gp) and the dropout
// row key of each of its query rows
struct ColStats {
  float4 v[kColRows];
  uint32_t key[kColRows];
};

// byte offsets from the CTA's 1024-aligned shared-memory base
template <int D>
struct ColSmem {
  static constexpr int kTile = 64 * D * 2;  // one 64-row bf16 tile of width D
  static constexpr int kK = 0;              // K, then V, Bc, C one tile further each
  static constexpr int kRing = 4 * kTile;   // a stage: Q, dO, A
  static constexpr int kStage = 3 * kTile;
  static constexpr int kStats = kRing + kColStages * kStage;  // one ColStats a stage
  static constexpr int kBar = kStats + kColStages * (int)sizeof(ColStats);  // K/V/Bc/C, then one a stage
  static constexpr int kBytes = kBar + 8 * (1 + kColStages) + 1024;  // + alignment slack
};

// The four score tiles of N query rows for the CTA's 64 keys, transposed
// (keys as M), every operand K-major (descriptors of the tiles' first rows):
// S^T = K Q^T, dP^T = V dO^T, g_dS^T / scale = K A^T + Bc Q^T and
// g_P1^T = C dO^T. so_wgmma.cuh's so_scores with the roles of rows and keys
// swapped; Q is the B of two products, so it is a function of its own.
template <int N, int D>
__device__ __forceinline__ void col_scores(float (&s)[N / 2], float (&dp)[N / 2],
                                           float (&gds)[N / 2], float (&gp1)[N / 2], uint64_t k,
                                           uint64_t v, uint64_t bc, uint64_t c, uint64_t q,
                                           uint64_t o, uint64_t a) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(s, k + 2 * kk, q + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(dp, v + 2 * kk, o + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(gds, k + 2 * kk, a + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(gds, bc + 2 * kk, q + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(gp1, c + 2 * kk, o + 2 * kk, kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
  fence_regs(gds);
  fence_regs(gp1);
}

template <int D>
__global__ void __launch_bounds__(kColThreads)
so_col_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bcmap,
                    const __grid_constant__ CUtensorMap cmap, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ gd,
                    const float* __restrict__ sgp, __nv_bfloat16* __restrict__ ck,
                    __nv_bfloat16* __restrict__ cv, int t_len, int s_len, int heads, float scale,
                    Dropout drop) {
  using L = ColSmem<D>;
  constexpr int RB = D * 2;                      // bytes of one tile row
  constexpr uint32_t kTileDesc = L::kTile >> 4;  // one tile further, in descriptor units
  extern __shared__ uint8_t col_smem[];  // named apart from the scalar kernel's float array
  const uint32_t base = (smem_addr(col_smem) + 1023) & ~1023u;
  ColStats* const stats =
      reinterpret_cast<ColStats*>(col_smem + (base - smem_addr(col_smem)) + L::kStats);
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_ring = bar_kv + 8;  // + 8 * stage
  const CUtensorMap *qm = &qmap, *dom = &domap, *am = &amap;

  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.x * kColKeys;
  const int nq = (t_len + kColRows - 1) / kColRows;

  // tid 0: load query tile `it` into its stage
  auto load_stage = [&](int it) {
    const int st = it % kColStages;
    const uint32_t dst = base + L::kRing + st * L::kStage;
    const uint32_t bar = bar_ring + 8 * st;
    mbar_expect_tx(bar, 3 * L::kTile);
    tma_load_3d(dst, qm, bar, h * D, it * kColRows, b);
    tma_load_3d(dst + L::kTile, dom, bar, h * D, it * kColRows, b);
    tma_load_3d(dst + 2 * L::kTile, am, bar, h * D, it * kColRows, b);
  };

  // The statistics of query tile `it`: thread tid reads row tid % 64's
  // (L log2(e), D) or, in the second half of the warpgroup, its (g_D, s_gp)
  // and row key. Rows >= T read L = +inf (so P = 0) and zeros.
  const int sr = tid % kColRows;
  const int sh = tid / kColRows;
  const float* const src0 = (sh ? gd : lse) + (size_t)bh * t_len;
  const float* const src1 = (sh ? sgp : delta) + (size_t)bh * t_len;
  const float mul0 = sh ? 1.f : kLog2e;
  const float pad0 = sh ? 0.f : __int_as_float(0x7f800000);
  auto stat_load = [&](int it, float2& x, uint32_t& key) {
    const int row = it * kColRows + sr;
    const bool ok = row < t_len;
    x.x = ok ? src0[row] * mul0 : pad0;
    x.y = ok ? src1[row] : 0.f;
    key = row_key(drop.seed, bh, row);
  };
  auto stat_store = [&](int st, float2 x, uint32_t key) {
    reinterpret_cast<float2*>(&stats[st].v[sr])[sh] = x;
    if (sh) stats[st].key[sr] = key;
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kColStages; ++s) mbar_init(bar_ring + 8 * s, 1);
    mbar_fence_init();
    mbar_expect_tx(bar_kv, 4 * L::kTile);
    tma_load_3d(base + L::kK, &kmap, bar_kv, h * D, k0, b);
    tma_load_3d(base + L::kK + L::kTile, &vmap, bar_kv, h * D, k0, b);
    tma_load_3d(base + L::kK + 2 * L::kTile, &bcmap, bar_kv, h * D, k0, b);
    tma_load_3d(base + L::kK + 3 * L::kTile, &cmap, bar_kv, h * D, k0, b);
    for (int it = 0; it < kColStages && it < nq; ++it) load_stage(it);
  }
  {
    float2 x;
    uint32_t key;
    stat_load(0, x, key);
    stat_store(0, x, key);
  }
  __syncthreads();

  // this thread's accumulator rows are keys r0 and r0 + 8 (hh = 0, 1), and
  // in each 8-column block its query columns are c0 and c0 + 1
  const int r0 = 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float s2 = scale * kLog2e;
  bool key_ok[2];
  int key_of[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key_of[hh] = k0 + r0 + 8 * hh;
    key_ok[hh] = key_of[hh] < s_len;
  }
  float ck_acc[D / 2], cv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ck_acc[i] = cv_acc[i] = 0.f;

  const uint64_t k_desc = tile_desc<RB>(base + L::kK);
  const uint64_t v_desc = k_desc + kTileDesc;
  const uint64_t bc_desc = k_desc + 2 * kTileDesc;
  const uint64_t c_desc = k_desc + 3 * kTileDesc;
  mbar_wait(bar_kv, 0);
  for (int i = 0; i < nq; ++i) {
    const int st = i % kColStages;
    float2 next;
    uint32_t next_key;
    stat_load(i + 1, next, next_key);  // in flight while this tile runs
    const uint64_t q_desc = tile_desc<RB>(base + L::kRing + st * L::kStage);
    const uint64_t do_desc = q_desc + kTileDesc;
    const uint64_t a_desc = q_desc + 2 * kTileDesc;
    const ColStats& cs = stats[st];
    mbar_wait(bar_ring + 8 * st, (i / kColStages) & 1);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t half = (32 * hf * RB) >> 4;  // the half's first query row
      const int qc = 32 * hf + c0;  // the thread's first query column, in the tile
      float s[16], dp[16], gds[16], gp1[16];
      col_scores<32, D>(s, dp, gds, gp1, k_desc, v_desc, bc_desc, c_desc, q_desc + half,
                        do_desc + half, a_desc + half);
      // register e: key r0 + 8 ((e / 2) % 2), query qc + 8 (e / 4) + e % 2
      uint32_t bits = 0;
      if (drop.on) {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          bits |= (uint32_t)drop.keep(cs.key[qc + 8 * (e / 4) + e % 2], key_of[(e / 2) % 2])
                  << e;
        so_drop<32>(dp, bits, drop.inv);
        so_drop<32>(gp1, bits, drop.inv);
      }
      // in place: dp <- dS, gds <- g_dp before dropout, gp1 <- g_S
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float4 qv = cs.v[qc + 8 * (e / 4) + e % 2];  // L log2(e), D, g_D, s_gp
        const float p = key_ok[(e / 2) % 2] ? exp2f(s[e] * s2 - qv.x) : 0.f;
        const float g_ds = gds[e] * scale;
        const float ee = dp[e] - qv.y;
        const float g_p = gp1[e] + g_ds * ee + qv.z * dp[e];
        dp[e] = p * ee;
        gds[e] = p * (g_ds + qv.z);
        gp1[e] = p * (g_p - qv.w);
      }
      if (drop.on) so_drop<32>(gds, bits, drop.inv);
      // rounded to bf16 and packed as the A operand of each 16-query slice
      uint32_t gsa[2][4], dsa[2][4], gpa[2][4];
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        gsa[e / 8][(e % 8) / 2] = pack_bf16(gp1[e], gp1[e + 1]);
        dsa[e / 8][(e % 8) / 2] = pack_bf16(dp[e], dp[e + 1]);
        gpa[e / 8][(e % 8) / 2] = pack_bf16(gds[e], gds[e + 1]);
      }
      // c_k += g_S^T Q + dS^T A, c_v += g_dp^T dO: the ring tiles as the
      // MN-major B (k-slices of 16 query rows)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t rows = ((32 * hf + 16 * kk) * RB) >> 4;
        wgmma_rs<D, 1>(ck_acc, gsa[kk], q_desc + rows, 1);
        wgmma_rs<D, 1>(ck_acc, dsa[kk], a_desc + rows, 1);
        wgmma_rs<D, 1>(cv_acc, gpa[kk], do_desc + rows, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ck_acc);
      fence_regs(cv_acc);
    }
    // the other stage's statistics were last read in the previous tile,
    // before the previous wg_sync
    stat_store((i + 1) % kColStages, next, next_key);
    wg_sync();  // every warp is done with the stage (and the next statistics are stored)
    if (tid == 0 && i + kColStages < nq) load_stage(i + kColStages);
  }

  // c_k (scaled) and c_v: accumulator rows are keys, columns are D
  const int ld = heads * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (key_ok[hh]) {
      const size_t at = ((size_t)b * s_len + key_of[hh]) * ld + h * D + c0;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        *reinterpret_cast<uint32_t*>(ck + at + 8 * jb) =
            pack_bf16(ck_acc[4 * jb + 2 * hh] * scale, ck_acc[4 * jb + 2 * hh + 1] * scale);
        *reinterpret_cast<uint32_t*>(cv + at + 8 * jb) =
            pack_bf16(cv_acc[4 * jb + 2 * hh], cv_acc[4 * jb + 2 * hh + 1]);
      }
    }
  }
}

// Launch it on bf16 q/dout/a (B, T, H*D), k/v/bc/c and ck/cv (B, S, H*D),
// lse, delta, gd and sgp (B, H, T) fp32.
template <int D>
cudaError_t launch_col(const void* q, const void* k, const void* v, const void* dout,
                       const void* a, const void* bc, const void* c, const void* lse,
                       const void* delta, const void* gd, const void* sgp, void* ck, void* cv,
                       int B, int T_len, int S_len, int H, Dropout drop, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom, am, bcm, cm;
  cudaError_t err;
  if ((err = packed_map(&qm, q, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&km, k, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&vm, v, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&dom, dout, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&am, a, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&bcm, bc, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&cm, c, false, B, S_len, H, D)) != cudaSuccess) return err;
  constexpr int smem = ColSmem<D>::kBytes;
  static int smem_set_for = -1;
  err = allow_smem(reinterpret_cast<const void*>(so_col_wgmma_kernel<D>), smem, &smem_set_for);
  if (err != cudaSuccess) return err;
  const dim3 grid((S_len + kColKeys - 1) / kColKeys, B * H);
  so_col_wgmma_kernel<D><<<grid, kColThreads, smem, stream>>>(
      qm, km, vm, dom, am, bcm, cm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(gd),
      static_cast<const float*>(sgp), static_cast<__nv_bfloat16*>(ck),
      static_cast<__nv_bfloat16*>(cv), T_len, S_len, H, 1.f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

}  // namespace ipt

// q/dout/a (B, T, H*D), k/v/bc/c and the outputs ck/cv (B, S, H*D),
// lse/delta and the row half's gd/sgp (B, H, T) fp32; all contiguous, bf16
// q/k/v/dout/a/bc/c 16-byte aligned (TMA).
// Dropout arguments as flash_fwd's. Returns the CUDA error of the launch (0
// on success).
extern "C" int flash_so_col(const void* q, const void* k, const void* v, const void* dout,
                            const void* a, const void* bc, const void* c, const void* lse,
                            const void* delta, const void* gd, const void* sgp, void* ck,
                            void* cv, int B, int T, int S, int H, int D, int dtype,
                            unsigned seed, unsigned threshold, float inv, int drop_on,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ipt::Dropout drop{seed, threshold, inv, drop_on};
  if (T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
#define IPT_SO_COL_LAUNCH(TT, DD)                                                          \
  return (int)launch<TT, DD>(q, k, v, dout, a, bc, c, lse, delta, gd, sgp, ck, cv, B, T, \
                             S, H, drop, st)
  if (dtype == ipt::kFloat32 && D == 32) IPT_SO_COL_LAUNCH(float, 32);
  if (dtype == ipt::kFloat32 && D == 64) IPT_SO_COL_LAUNCH(float, 64);
#undef IPT_SO_COL_LAUNCH
  if (dtype == ipt::kBFloat16 && D == 32)
    return (int)ipt::launch_col<32>(q, k, v, dout, a, bc, c, lse, delta, gd, sgp, ck, cv, B, T, S,
                                    H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 64)
    return (int)ipt::launch_col<64>(q, k, v, dout, a, bc, c, lse, delta, gd, sgp, ck, cv, B, T, S,
                                    H, drop, st);
  return (int)cudaErrorInvalidValue;
}

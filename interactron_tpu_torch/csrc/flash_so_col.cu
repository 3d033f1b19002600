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
// operations (~35 us at 989 TFLOP/s bf16).
//
// Design: the TPU kernel splits the q sweep between the grid and an
// in-kernel loop and accumulates in a VMEM-resident output revisited across
// grid steps. Here one CTA owns (b, h, 32 keys): it keeps that tile's K, V,
// Bc and C rows in shared memory and its c_k/c_v accumulators in fp32
// registers for its whole life, and loops over the query rows 32 at a time,
// loading their q, dO and A with L, D, g_D and s_gp. Every output element is
// written once by the CTA that owns it: no atomics, and two runs give
// bitwise-equal results (flash_so.cu's merged pass adds c_k/c_v with
// atomics instead). The dropout bits come from the per-element hash of
// csrc/dropout.cuh, so the row and column halves regenerate the same mask at
// any tiling (the TPU kernel keys its tiles by the global q-block, `:938`).
// The ragged edge is masked by index (P = 0 outside T x S; keys >= S are not
// written). Scalar fp32 FMA through ~70 KB of dynamic shared memory; tensor
// cores come later.
#include "common.cuh"
#include "dropout.cuh"

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

// q/dout/a (B, T, H*D), k/v/bc/c and the outputs ck/cv (B, S, H*D),
// lse/delta and the row half's gd/sgp (B, H, T) fp32; all contiguous.
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
  if (dtype == ipt::kBFloat16 && D == 32) IPT_SO_COL_LAUNCH(__nv_bfloat16, 32);
  if (dtype == ipt::kBFloat16 && D == 64) IPT_SO_COL_LAUNCH(__nv_bfloat16, 64);
#undef IPT_SO_COL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

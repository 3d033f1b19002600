// Second-order attention backward on the packed (B, T, H*D) layout: the VJP
// of (q, k, v, dO) -> (dq, dk, dv).
//
// Replaces the Pallas kernel `_sov_merged_kernel`
// (interactron_tpu/ops/flash_attention.py:969, launched by `_so_vjp_impl`),
// which the twice-differentiated meta inner loss runs for every attention
// in the kernels' gates. Per head, with P the softmax recomputed from L,
// M the keep mask (csrc/dropout.cuh), inv = 1 / (1 - rate),
// dp = M*inv*(dO V^T), e = dp - D, dS = P*e and the cotangents (A, Bc, C)
// of (dq, dk, dv) (the derivation is at flash_attention.py:777-786):
//   g_dS = scale*(A K^T + Q Bc^T)        g_P1 = M*inv*(dO C^T)
//   g_D  = -rowsum(P*g_dS)               g_P  = g_P1 + g_dS*e + g_D*dp
//   g_dp = M*inv*P*(g_dS + g_D)          g_S  = P*(g_P - rowsum(P*g_P))
//   c_q  = scale*(g_S K + dS Bc)         c_k  = scale*(g_S^T Q + dS^T A)
//   c_dO = (M*inv*P) C + g_dp V          c_v  = g_dp^T dO
// g_S, dS, M*inv*P and g_dp are rounded to the operand dtype before each
// product, where the Pallas kernel rounds (`:1043-1050`).
//
// Bound on the H100: twelve (T x S x D) products a head (24*B*H*T*S*D
// FLOPs), so at the fusion shape (B=1, H=8, T=S=2060, D=64) about 52 GFLOP,
// bound by operations (~53 us at 989 TFLOP/s bf16).
//
// Design: the TPU kernel holds the whole K/V/Bc/C sequence in VMEM and takes
// both row sums of a q-block in one pass over a (bq, S) tile. Here one CTA
// owns (b, h, 64 query rows), keeps its q, dO and A rows in shared memory,
// and sweeps the K/V/Bc/C tiles (32 keys each) twice:
//   sweep 1 forms a1 = rowsum(P*g_dS), a2 = rowsum(P*(g_P1 + g_dS*e)) and
//     a3 = rowsum(P*dp); then g_D = -a1 and rowsum(P*g_P) = a2 + g_D*a3,
//     since g_P = g_P1 + g_dS*e + g_D*dp, so no third sweep is needed;
//   sweep 2 recomputes the tile, keeps c_q and c_dO in registers, and adds
//     the tile's c_k/c_v shares into zeroed fp32 buffers with atomicAdd (the
//     CTAs that share a key tile run in no order), as flash_bwd.cu does for
//     dQ; the caller casts them to q's dtype.
// Four threads share a query row (8 of the tile's 32 keys each; row sums
// by two warp shuffles). The ragged edge is masked by index (P = 0 outside
// T x S). Arithmetic is scalar fp32 FMA through ~114 KB of dynamic shared
// memory, one CTA per SM; tensor cores come later.
#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 32;  // keys per tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;  // threads per query row
constexpr int KPT = BK / TPR;      // tile entries per thread

template <int D>
struct Smem {
  float Q[BQ][D + 1], dO[BQ][D + 1], A[BQ][D + 1];
  float K[BK][D + 1], V[BK][D + 1], Bc[BK][D + 1], C[BK][D + 1];
  // rounded tile products of sweep 2
  float GS[BQ][BK + 1], DS[BQ][BK + 1], PD[BQ][BK + 1], GDP[BQ][BK + 1];
};

// The five row-by-key dot products of the thread's KPT tile entries:
// q.k, dO.v, A.k, q.Bc and dO.C.
template <int D>
__device__ __forceinline__ void tile_dots(const Smem<D>& sm, int r, int sub, float (&qk)[KPT],
                                          float (&dov)[KPT], float (&ak)[KPT],
                                          float (&qb)[KPT], float (&doc)[KPT]) {
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) qk[jj] = dov[jj] = ak[jj] = qb[jj] = doc[jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float qd = sm.Q[r][d], od = sm.dO[r][d], ad = sm.A[r][d];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + TPR * jj;
      const float kd = sm.K[j][d];
      qk[jj] = fmaf(qd, kd, qk[jj]);
      ak[jj] = fmaf(ad, kd, ak[jj]);
      dov[jj] = fmaf(od, sm.V[j][d], dov[jj]);
      qb[jj] = fmaf(qd, sm.Bc[j][d], qb[jj]);
      doc[jj] = fmaf(od, sm.C[j][d], doc[jj]);
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(Smem<D>& sm, const T* k, const T* v, const T* bc,
                                          const T* c, size_t koff, int k0, int s_len, int ld) {
  for (int i = threadIdx.x; i < BK * D; i += THREADS) {
    const int j = i / D;
    const int d = i % D;
    const bool ok = k0 + j < s_len;
    const size_t at = koff + (size_t)(k0 + j) * ld + d;
    sm.K[j][d] = ok ? ipt::to_f<T>(k[at]) : 0.f;
    sm.V[j][d] = ok ? ipt::to_f<T>(v[at]) : 0.f;
    sm.Bc[j][d] = ok ? ipt::to_f<T>(bc[at]) : 0.f;
    sm.C[j][d] = ok ? ipt::to_f<T>(c[at]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
so_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const T* __restrict__ a, const T* __restrict__ bc,
          const T* __restrict__ c, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ cq, T* __restrict__ cdo,
          float* __restrict__ ck, float* __restrict__ cv, int t_len, int s_len, int heads,
          float scale, ipt::Dropout drop) {
  constexpr int CPT = D / TPR;            // c_q / c_dO columns per thread
  constexpr int CPR = THREADS / D;        // key rows per pass of the c_k/c_v map
  constexpr int KV_E = BK * D / THREADS;  // c_k / c_v entries per thread per tile
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
    sm.A[rr][d] = ok ? ipt::to_f<T>(a[at]) : 0.f;
  }
  const float l2 = row_ok ? lse[(size_t)bh * t_len + row] * ipt::kLog2e : 0.f;
  const float drow = row_ok ? delta[(size_t)bh * t_len + row] : 0.f;
  const uint32_t rkey = ipt::row_key(drop.seed, bh, row);

  float qk[KPT], dov[KPT], ak[KPT], qb[KPT], doc[KPT];

  // ---- sweep 1: the row sums a1, a2, a3
  float a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int k0 = 0; k0 < s_len; k0 += BK) {
    __syncthreads();  // readers of the previous tile are done
    load_tile<T, D>(sm, k, v, bc, c, koff, k0, s_len, ld);
    __syncthreads();
    tile_dots<D>(sm, r, sub, qk, dov, ak, qb, doc);
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int col = k0 + sub + TPR * jj;
      const float p = (row_ok && col < s_len) ? exp2f(qk[jj] * s2 - l2) : 0.f;
      const float g_ds = (ak[jj] + qb[jj]) * scale;
      const float dp = drop.apply(dov[jj], rkey, col);
      const float g_p1 = drop.apply(doc[jj], rkey, col);
      const float e = dp - drow;
      a1 = fmaf(p, g_ds, a1);
      a2 = fmaf(p, g_p1 + g_ds * e, a2);
      a3 = fmaf(p, dp, a3);
    }
  }
#pragma unroll
  for (int m = 1; m < TPR; m <<= 1) {
    a1 += __shfl_xor_sync(0xffffffffu, a1, m);
    a2 += __shfl_xor_sync(0xffffffffu, a2, m);
    a3 += __shfl_xor_sync(0xffffffffu, a3, m);
  }
  const float g_d = -a1;
  const float s_gp = a2 + g_d * a3;

  // ---- sweep 2: c_q, c_dO in registers; c_k, c_v by atomics
  float acc_q[CPT], acc_do[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) acc_q[cc] = acc_do[cc] = 0.f;
  const int kcol = tid % D;  // column owned in the c_k/c_v map
  const int krow = tid / D;
  for (int k0 = 0; k0 < s_len; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(sm, k, v, bc, c, koff, k0, s_len, ld);
    __syncthreads();
    tile_dots<D>(sm, r, sub, qk, dov, ak, qb, doc);
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + TPR * jj;
      const int col = k0 + j;
      const float p = (row_ok && col < s_len) ? exp2f(qk[jj] * s2 - l2) : 0.f;
      const float g_ds = (ak[jj] + qb[jj]) * scale;
      const float dp = drop.apply(dov[jj], rkey, col);
      const float g_p1 = drop.apply(doc[jj], rkey, col);
      const float e = dp - drow;
      const float g_p = g_p1 + g_ds * e + g_d * dp;
      sm.GS[r][j] = ipt::round_to<T>(p * (g_p - s_gp));
      sm.DS[r][j] = ipt::round_to<T>(p * e);
      sm.PD[r][j] = ipt::round_to<T>(drop.apply(p, rkey, col));
      sm.GDP[r][j] = ipt::round_to<T>(drop.apply(p * (g_ds + g_d), rkey, col));
    }
    __syncthreads();

    // c_q += g_S K + dS Bc and c_dO += Pd C + g_dp V for the thread's row
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float gs = sm.GS[r][j], ds = sm.DS[r][j], pd = sm.PD[r][j], gdp = sm.GDP[r][j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int cidx = sub + TPR * cc;
        acc_q[cc] = fmaf(gs, sm.K[j][cidx], fmaf(ds, sm.Bc[j][cidx], acc_q[cc]));
        acc_do[cc] = fmaf(pd, sm.C[j][cidx], fmaf(gdp, sm.V[j][cidx], acc_do[cc]));
      }
    }

    // this q-block's shares of c_k = scale*(g_S^T q + dS^T A), c_v = g_dp^T dO
#pragma unroll
    for (int e = 0; e < KV_E; ++e) {
      const int j = krow + CPR * e;
      float sk = 0.f, sv = 0.f;
#pragma unroll 8
      for (int i = 0; i < BQ; ++i) {
        sk = fmaf(sm.GS[i][j], sm.Q[i][kcol], fmaf(sm.DS[i][j], sm.A[i][kcol], sk));
        sv = fmaf(sm.GDP[i][j], sm.dO[i][kcol], sv);
      }
      if (k0 + j < s_len) {
        const size_t at = koff + (size_t)(k0 + j) * ld + kcol;
        atomicAdd(ck + at, sk * scale);
        atomicAdd(cv + at, sv);
      }
    }
  }

  if (row_ok) {
    const size_t at = qoff + (size_t)row * ld;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      cq[at + sub + TPR * cc] = ipt::from_f<T>(acc_q[cc] * scale);
      cdo[at + sub + TPR * cc] = ipt::from_f<T>(acc_do[cc]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* a, const void* bc, const void* c, const void* lse,
                   const void* delta, void* cq, void* cdo, void* ck, void* cv, int B,
                   int T_len, int S_len, int H, ipt::Dropout drop, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(so_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  so_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const T*>(a), static_cast<const T*>(bc),
      static_cast<const T*>(c), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(cq), static_cast<T*>(cdo),
      static_cast<float*>(ck), static_cast<float*>(cv), T_len, S_len, H,
      1.f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

}  // namespace

// q/dout/a and cq/cdo (B, T, H*D), k/v/bc/c (B, S, H*D), lse/delta (B, H, T)
// fp32, ck/cv (B, S, H*D) fp32 zero-filled by the caller; all contiguous.
// Dropout arguments as flash_fwd's. Returns the CUDA error of the launch (0
// on success).
extern "C" int flash_so(const void* q, const void* k, const void* v, const void* dout,
                        const void* a, const void* bc, const void* c, const void* lse,
                        const void* delta, void* cq, void* cdo, void* ck, void* cv, int B,
                        int T, int S, int H, int D, int dtype, unsigned seed,
                        unsigned threshold, float inv, int drop_on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ipt::Dropout drop{seed, threshold, inv, drop_on};
  if (T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
#define IPT_SO_LAUNCH(TT, DD)                                                           \
  return (int)launch<TT, DD>(q, k, v, dout, a, bc, c, lse, delta, cq, cdo, ck, cv, B, T, \
                             S, H, drop, st)
  if (dtype == ipt::kFloat32 && D == 32) IPT_SO_LAUNCH(float, 32);
  if (dtype == ipt::kFloat32 && D == 64) IPT_SO_LAUNCH(float, 64);
  if (dtype == ipt::kBFloat16 && D == 32) IPT_SO_LAUNCH(__nv_bfloat16, 32);
  if (dtype == ipt::kBFloat16 && D == 64) IPT_SO_LAUNCH(__nv_bfloat16, 64);
#undef IPT_SO_LAUNCH
  return (int)cudaErrorInvalidValue;
}

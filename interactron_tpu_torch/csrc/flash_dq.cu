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
// operations (~13 us at 989 TFLOP/s bf16); the DETR encoder shape is small
// on both counts.
//
// Design: the TPU kernel holds all of K/V in VMEM for one q-block. Here one
// CTA owns (b, h, 64 query rows): it keeps the rows' q and dO in shared
// memory and their L and delta in registers, and streams K/V through shared
// memory 32 keys at a time. Four threads share a query row (8 of the tile's
// 32 keys each for P and dS, D/4 columns each of dQ), so dQ accumulates in
// fp32 registers and is written once by the CTA that owns it: no atomics,
// and two runs give bitwise-equal dQ (flash_bwd.cu's merged pass adds dQ
// with atomics instead). The ragged edge is masked by index (keys >= S get
// P = 0; rows >= T are not written). Arithmetic is scalar fp32 FMA through
// ~57 KB of dynamic shared memory; tensor cores come later.
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

}  // namespace

// q/dout/dq (B, T, H*D), k/v (B, S, H*D), lse/delta (B, H, T) fp32; all
// contiguous. Dropout arguments as flash_fwd's. Returns the CUDA error of
// the launch (0 on success).
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int T, int S,
                        int H, int D, int dtype, unsigned seed, unsigned threshold, float inv,
                        int drop_on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ipt::Dropout drop{seed, threshold, inv, drop_on};
  if (T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
#define IPT_DQ_LAUNCH(TT, DD) \
  return (int)launch<TT, DD>(q, k, v, dout, lse, delta, dq, B, T, S, H, drop, st)
  if (dtype == ipt::kFloat32 && D == 32) IPT_DQ_LAUNCH(float, 32);
  if (dtype == ipt::kFloat32 && D == 64) IPT_DQ_LAUNCH(float, 64);
  if (dtype == ipt::kBFloat16 && D == 32) IPT_DQ_LAUNCH(__nv_bfloat16, 32);
  if (dtype == ipt::kBFloat16 && D == 64) IPT_DQ_LAUNCH(__nv_bfloat16, 64);
#undef IPT_DQ_LAUNCH
  return (int)cudaErrorInvalidValue;
}

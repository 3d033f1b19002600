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
// bf16 (the configuration's dtype): tensor cores, `bwd_wgmma_kernel` of
// csrc/bwd_wgmma.cuh, whose note has the design. One warpgroup owns
// (b, h, 64 keys) with K/V resident and dK/dV in wgmma accumulators; Q/dO
// stream through a 2-stage TMA ring; the tile's dQ share dS K goes through
// an fp32 shared tile into one TMA reduce-add (add.f32 in L2) per tile:
// S/64 adds per dQ element, clipped at T. flash_dkv.cu runs the same
// warpgroup without the dQ share. Shared memory a CTA at D=64: about 81 KB
// (49 KB at D=32).
//
// fp32: the scalar-FMA kernel below (`bwd_kernel`), unchanged from the
// first port: one CTA per 32 keys, dQ by fp32 atomicAdd. TF32 tensor cores
// would round the operands to 10 mantissa bits and break the fp32
// card-vs-CPU checks (1e-4 x max|ref|); the configuration runs bf16, so
// fp32 exists for those checks.
#include "bwd_wgmma.cuh"
#include "common.cuh"
#include "dropout.cuh"

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
    return (int)ipt::launch_kv_resident<32, true>(q, k, v, dout, lse, delta, dq, dk, dv, B, T,
                                                  S, H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 64)
    return (int)ipt::launch_kv_resident<64, true>(q, k, v, dout, lse, delta, dq, dk, dv, B, T,
                                                  S, H, drop, st);
  return (int)cudaErrorInvalidValue;
}

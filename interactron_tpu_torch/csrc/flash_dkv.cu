// Split attention backward, second half: dK and dV on the packed (B, T, H*D)
// layout.
//
// Replaces both Pallas dK/dV kernels, selected in `_bwd_kernels:553` by
// FLASH_DKV when FLASH_BWD is not "merged": `_dkv_kernel_fullt`
// (interactron_tpu/ops/flash_attention.py:242) and `_dkv_kernel` (`:175`).
// The two compute the same function and differ only in how they use the
// TPU's VMEM (one M=T_pad product per k-block against a loop of bq-row
// products) and in which tile-keyed PRNG stream they regenerate; the
// per-element hash of csrc/dropout.cuh removes the second difference, and a
// CUDA block streams query tiles through shared memory either way, since a
// (T_pad x bk) fp32 tile at the fusion shape (~0.5 MB) fits no block. From
// (q, k, v, L), dO and delta = rowsum(dO * O) it recomputes
// P = exp(q.k^T * scale - L), dP = keep / (1 - rate) * (dO.v^T) and
// dS = P * (dP - delta), and writes dV = (P * keep / (1 - rate))^T dO and
// dK = scale * dS^T q (raw q times the scale, `_dkv_kernel`'s form; the
// fullt kernel's pre-scaled q agrees to rounding). P is rounded to dO's
// dtype before dV and dS to q's dtype before dK, as the TPU kernels do.
//
// Bound on the H100: four (T x S x D) products a head, 8*B*H*T*S*D FLOPs,
// so at the fusion shape (B=1, H=8, T=S=2060, D=64) about 17.4 GFLOP, bound
// by operations (0.0176 ms at 989 TFLOP/s bf16; with dropout the keep-bit
// hash, 11 integer ops an element at 33.4 T ops/s, adds ~0.011 ms of its
// own that can run beside the products).
//
// bf16 (the configuration's dtype): tensor cores, `dkv_wgmma_kernel` of
// csrc/bwd_wgmma.cuh: flash_bwd.cu's K/V-resident warpgroup without the dQ
// share. One warpgroup (128 threads) owns (b, h, 64 keys): K and V are
// loaded once by TMA, dK/dV stay in fp32 wgmma accumulators for the CTA's
// life, Q/dO 64-row tiles stream through a 2-stage TMA/mbarrier ring, S and
// dP are formed by wgmma from shared memory, and P (dropped) and dS are
// written as bf16 to swizzled shared tiles for the transposed products
// dV += P^T dO and dK += dS^T q. Each dK/dV element is written once, by the
// CTA that owns its key: no atomics and no TMA reduce-add, so two runs give
// bitwise-equal results. Shared memory a CTA: about 65 KB at D=64 (41 KB at
// D=32).
//
// fp32: the scalar-FMA kernel below (`dkv_kernel`), unchanged from the
// first port: one CTA owns (b, h, 32 keys), keeps that K/V tile and its
// dK/dV accumulators in fp32 registers and loops over the query rows 32 at a
// time, writing each output element once. TF32 tensor cores would round the
// operands to 10 mantissa bits and break the fp32 card-vs-CPU checks
// (1e-4 x max|ref|); the configuration runs bf16, so fp32 exists for those
// checks. The ragged edge is masked by index: query rows >= T and keys >= S
// get P = dS = 0, and keys >= S are never written.
#include "bwd_wgmma.cuh"
#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int BK = 32;  // keys per CTA
constexpr int BQ = 32;  // query rows per loop step
constexpr int THREADS = 256;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
           int t_len, int s_len, int heads, float scale, ipt::Dropout drop) {
  constexpr int CPR = THREADS / D;        // rows covered per pass of (row, col) maps
  constexpr int KV_E = BK * D / THREADS;  // dK/dV entries per thread
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

  const int col = tid % D;  // column owned in the (row, col) map below
  const int rsub = tid / D;
  const int pj = tid % BK;  // key owned in the P/dS map
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

    // the dropped P and dS for this (q-tile, k-tile) pair
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
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, int T_len,
                   int S_len, int H, ipt::Dropout drop, cudaStream_t stream) {
  dim3 grid((S_len + BK - 1) / BK, B * H);
  dkv_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), T_len,
      S_len, H, 1.f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

}  // namespace

// q/dout (B, T, H*D), k/v and dk/dv (B, S, H*D), lse/delta (B, H, T) fp32;
// all contiguous, bf16 q/k/v/dout 16-byte aligned (TMA). Dropout arguments
// as flash_fwd's. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B, int T,
                         int S, int H, int D, int dtype, unsigned seed, unsigned threshold,
                         float inv, int drop_on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ipt::Dropout drop{seed, threshold, inv, drop_on};
  if (T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == ipt::kFloat32 && D == 32)
    return (int)launch<float, 32>(q, k, v, dout, lse, delta, dk, dv, B, T, S, H, drop, st);
  if (dtype == ipt::kFloat32 && D == 64)
    return (int)launch<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, T, S, H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 32)
    return (int)ipt::launch_kv_resident<32, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, B,
                                                   T, S, H, drop, st);
  if (dtype == ipt::kBFloat16 && D == 64)
    return (int)ipt::launch_kv_resident<64, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, B,
                                                   T, S, H, drop, st);
  return (int)cudaErrorInvalidValue;
}

// Fused attention forward on the packed (B, T, H*D) layout.
//
// Replaces the Pallas kernel `_fwd_kernel` (interactron_tpu/ops/flash_attention.py:92,
// launched by `_fwd_impl`). It computes the same function: fp32 logits
// q.k^T / sqrt(D), an fp32 softmax, P cast to v's dtype before P.V, the
// 1/denominator folded into O, and the natural-log normaliser
// L = m + log(sum exp) per (b, h, row) for the backward.
//
// Bound on the H100: at the fusion shape (B=1, H=8, T=S=2060, D=64) the work
// is 4*B*H*T*S*D = 8.7 GFLOP over 8.4 MB of q/k/v/O, so it is bound by
// operations (about 8.8 us at the 989 TFLOP/s bf16 tensor-core peak); the
// DETR encoder (B=5, T=S=361, D=32) is small on both counts (~1 us).
//
// Design: the TPU kernel holds all of K/V in VMEM, takes the softmax of a
// whole row at once and subtracts the analytic mass of zero-padded columns.
// Here one CTA owns (b, h, 64 query rows) and streams K/V through shared
// memory 32 keys at a time with an online (running max / running sum)
// softmax in fp32 registers, so shared memory stays at ~25 KB whatever S is.
// The ragged edge is masked by index (keys >= S get p = 0; rows >= T are not
// written). Four threads share a query row: each computes 8 of the tile's
// 32 logits against the row's q held in registers, the row max and sum are
// combined with two warp shuffles, and each thread accumulates D/4 output
// columns. Arithmetic is scalar fp32 FMA, which keeps the kernel simple and
// lets fp32 inputs stay exact; tensor cores (mma/wgmma) and TMA are the
// next step for speed.
#include "common.cuh"

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
           float qscale) {
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
      psum += p;
      Ps[r][sub + TPR * jj] = ipt::round_to<T>(p);  // P in v's dtype for P.V
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
                   cudaStream_t stream) {
  const float qscale = ipt::kLog2e / sqrtf((float)D);
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      T_len, S_len, H, qscale);
  return cudaGetLastError();
}

}  // namespace

// q (B, T, H*D), k/v (B, S, H*D), o like q, lse (B, H, T) fp32; all
// contiguous. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int T, int S, int H, int D,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == ipt::kFloat32 && D == 32)
    return (int)launch<float, 32>(q, k, v, o, lse, B, T, S, H, st);
  if (dtype == ipt::kFloat32 && D == 64)
    return (int)launch<float, 64>(q, k, v, o, lse, B, T, S, H, st);
  if (dtype == ipt::kBFloat16 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(q, k, v, o, lse, B, T, S, H, st);
  if (dtype == ipt::kBFloat16 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, T, S, H, st);
  return (int)cudaErrorInvalidValue;
}

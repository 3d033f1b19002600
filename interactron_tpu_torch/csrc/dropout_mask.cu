// Dropout keep mask of a (n_bh, n_rows, n_cols) region of attention
// probabilities, as uint8 (1 = kept).
//
// Replaces the Pallas kernel `_mask_row_kernel`
// (interactron_tpu/ops/flash_attention.py:640, launched by
// `_dropout_mask_row`), which writes the keep mask of one q-block so that
// code outside the kernels can apply the same mask. Here the bits are those
// of csrc/dropout.cuh, so the region can start anywhere: a sub-block gives
// the bits of the full request. The port also uses it for every dropout
// outside the fused kernels (module dropout and the dense attention path).
//
// Bound on the H100: it reads nothing and writes one byte per element, so it
// is bound by bytes (a fusion-sized 8 x 2060 x 2060 region is 34 MB, about
// 10 us at 3.35 TB/s). Design: a grid-stride loop, one element per thread
// per step, 4 consecutive elements of a row per thread written as one
// 32-bit store where the row allows it, so neighbouring threads write
// neighbouring words.
#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;  // mask bytes per thread per step

__global__ void __launch_bounds__(THREADS)
mask_kernel(uint8_t* __restrict__ out, uint32_t seed, uint32_t threshold, int n_bh,
            int n_rows, int n_cols, int bh0, int row0, int col0) {
  const int vec_per_row = (n_cols + VEC - 1) / VEC;
  const long long total = (long long)n_bh * n_rows * vec_per_row;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int cv = (int)(i % vec_per_row);
    const long long br = i / vec_per_row;
    const int r = (int)(br % n_rows);
    const int b = (int)(br / n_rows);
    const uint32_t rkey = ipt::row_key(seed, (uint32_t)(bh0 + b), (uint32_t)(row0 + r));
    uint8_t* row_out = out + br * n_cols;
    const int c0 = cv * VEC;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const uint32_t kept = ipt::keep_bits(rkey, (uint32_t)(col0 + c0 + e)) >= threshold;
      word |= kept << (8 * e);
    }
    const bool aligned = ((reinterpret_cast<uintptr_t>(row_out + c0) & 3) == 0);
    if (c0 + VEC <= n_cols && aligned) {
      *reinterpret_cast<uint32_t*>(row_out + c0) = word;
    } else {
      for (int e = 0; e < VEC && c0 + e < n_cols; ++e) row_out[c0 + e] = (word >> (8 * e)) & 0xFF;
    }
  }
}

}  // namespace

// out (n_bh, n_rows, n_cols) uint8, contiguous. Returns the CUDA error of the
// launch (0 on success).
extern "C" int dropout_mask(void* out, unsigned seed, unsigned threshold, int n_bh,
                            int n_rows, int n_cols, int bh0, int row0, int col0,
                            void* stream) {
  if (n_bh <= 0 || n_rows <= 0 || n_cols <= 0) return (int)cudaErrorInvalidValue;
  const long long work = (long long)n_bh * n_rows * ((n_cols + VEC - 1) / VEC);
  const long long blocks = (work + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 132 * 64 ? blocks : 132 * 64);
  mask_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), seed, threshold, n_bh, n_rows, n_cols, bh0, row0, col0);
  return (int)cudaGetLastError();
}

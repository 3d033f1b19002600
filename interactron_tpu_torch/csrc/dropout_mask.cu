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
// Bound on the H100: it reads nothing and writes one byte an element, and
// hashes every element: 11 integer ops (the column's multiple, one add with
// the row part held; fmix32's two multiplies and three xor-shifts, the
// first xor three-way with the row part; the compare; the byte's place in
// its word). An SM issues 128 lanes of instructions a clock, which the
// INT32 pipe (xor, shift, compare) and the FMA pipe (multiplies, and adds
// and left shifts as IMAD) take together: 132 SMs x 128 x 1.98 GHz, 33.4 T
// ops/s, 11 / 33.4e12 s an element against 1 / 3.35e12 s for its byte of
// HBM. So it is bound by operations, barely: the fusion-sized 8 x 2060 x
// 2060 region (34 MB) is ~11 us of hashing and ~10 us of writes. ptxas
// leaves the xor-shifts, the compare and its select on the INT32 pipe (64
// lanes an SM), so the kernel cannot reach that bound; forcing the add, the
// compare or the shifts onto the FMA pipe (IMAD, IMAD.WIDE's carry,
// IMAD.HI) made it slower.
//
// Design. The region is one flat byte buffer cut into 16-byte chunks, each
// hashed and written by one thread as one 16-byte store (neighbouring
// threads write neighbouring chunks: a warp 512 contiguous bytes).
//   * Indices. A thread finds its first chunk's (bh, row, col) by two 32-bit
//     divisions, once; then it walks its chunks by the grid stride, whose
//     own (bh, row, col) the host divides out, with mixed-radix increments
//     (one carry each at most). No division or modulo in the loop.
//   * Hash. The row part is hashed once a chunk, with fmix32's first
//     xor-shift folded into it (dropout.cuh's keep_bits_mixed), and a
//     byte's column multiple is the chunk's plus a constant: ~11 ops a byte.
//   * Rows that do not start on a 16-byte boundary (rows of 2060 or 77
//     bytes start at any residue mod 16): a chunk that crosses a row end
//     switches row keys inside it, by selects. A warp takes that path only
//     when one of its chunks crosses (a vote), so aligned rows (module
//     dropout: 256, 512 or 2048 bytes) never do. The next row's key is the
//     one the right-hand lane hashed for its own chunk, which starts in that
//     row: one shuffle, not a second row hash (rows of 361 bytes put a row
//     end in every warp's 512 bytes, so at E every warp takes this path).
//     The whole warp takes every step of the loop (lanes past the region's
//     end walk along without storing), so the vote and the shuffle read
//     every lane. Rows shorter than 16 bytes are walked byte by byte; the
//     region's last, partial chunk is stored byte by byte.
//   * Latency. The grid is one wave (8 CTAs of 256 threads on each of 132
//     SMs) with the chunks spread evenly over it: at the F region ~8 chunks
//     a thread, each 16 independent hashes, so the integer pipes stay fed.
//     A region of a few MB (the E and L attention regions, every module
//     dropout) has a bound of 1-2 us, about what a launch of its own costs
//     the card: only drawing it inside its consumer would approach it.
#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16;            // bytes a thread writes a step: one 16-byte store
constexpr int MAX_BLOCKS = 132 * 8;  // one wave: 8 CTAs on each of 132 SMs

// the row part of an element's hash, fmix32's first xor-shift applied
__device__ __forceinline__ uint32_t row_mix(uint32_t seed, int bh, int row) {
  const uint32_t r = ipt::row_key(seed, (uint32_t)bh, (uint32_t)row);
  return r ^ (r >> 16);
}

// A chunk's 16 keep bytes as four little-endian words: byte x hashes row
// part ma and column multiple ca + x kMixCol when x < m, else mb and
// cb + x kMixCol (the next row, its columns shifted back by m in cb).
__device__ __forceinline__ uint4 chunk_bits(uint32_t ma, uint32_t ca, uint32_t mb, uint32_t cb,
                                            int m, uint32_t threshold) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * i + e;
      const uint32_t h =
          ipt::keep_bits_mixed(x < m ? ma : mb, (x < m ? ca : cb) + (uint32_t)x * ipt::kMixCol);
      w[i] |= (uint32_t)(h >= threshold) << (8 * e);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(THREADS)
mask_vec16_kernel(uint8_t* __restrict__ out, uint32_t seed, uint32_t threshold, int n_rows,
                  int n_cols, int bh0, int row0, int col0, uint32_t n_bytes, int step_bh,
                  int step_row, int step_col) {
  const uint32_t n_chunks = (n_bytes + CHUNK - 1) / CHUNK;
  const uint32_t stride = gridDim.x * THREADS;
  const int lane = threadIdx.x % 32;
  uint32_t k = blockIdx.x * THREADS + threadIdx.x;
  // the first chunk's first byte as (bh, row, col)
  const uint32_t flat_row = k * CHUNK / (uint32_t)n_cols;
  int col = (int)(k * CHUNK - flat_row * (uint32_t)n_cols);
  int bh = (int)(flat_row / (uint32_t)n_rows);
  int row = (int)(flat_row - (uint32_t)bh * (uint32_t)n_rows);
  for (;; k += stride) {
    const bool live = k < n_chunks;
    if (!__any_sync(0xffffffffu, live)) break;
    const uint32_t ma = row_mix(seed, bh0 + bh, row0 + row);
    const uint32_t ca = (uint32_t)(col0 + col) * ipt::kMixCol;
    uint4 bits;
    if (n_cols < CHUNK) {
      // several row ends a chunk: byte by byte
      uint32_t w[4] = {0, 0, 0, 0};
      int b = bh, r = row, c = col;
      uint32_t m = ma;
#pragma unroll
      for (int x = 0; x < CHUNK; ++x) {
        const uint32_t h = ipt::keep_bits_mixed(m, (uint32_t)(col0 + c) * ipt::kMixCol);
        w[x / 4] |= (uint32_t)(h >= threshold) << (8 * (x % 4));
        if (++c == n_cols) {
          c = 0;
          if (++r == n_rows) {
            r = 0;
            ++b;
          }
          m = row_mix(seed, bh0 + b, row0 + r);
        }
      }
      bits = make_uint4(w[0], w[1], w[2], w[3]);
    } else if (__any_sync(0xffffffffu, col + CHUNK > n_cols)) {
      // a chunk of the warp crosses a row end: bytes from m = n_cols - col
      // on are the next row's (m >= 16 for a chunk that does not cross),
      // where the next lane's chunk starts (it is chunk k + 1)
      const int m = n_cols - col;
      uint32_t mb = __shfl_down_sync(0xffffffffu, ma, 1);
      if (lane == 31 && m < CHUNK) {
        int b = bh, r = row + 1;
        if (r == n_rows) {
          r = 0;
          ++b;
        }
        mb = row_mix(seed, bh0 + b, row0 + r);
      }
      bits = chunk_bits(ma, ca, mb, (uint32_t)(col0 - m) * ipt::kMixCol, m, threshold);
    } else {
      bits = chunk_bits(ma, ca, ma, ca, CHUNK, threshold);
    }
    uint8_t* const dst = out + (size_t)k * CHUNK;
    if (live && k * CHUNK + CHUNK <= n_bytes) {
      *reinterpret_cast<uint4*>(dst) = bits;
    } else if (live) {  // the region's last, partial chunk
      const uint32_t w[4] = {bits.x, bits.y, bits.z, bits.w};
      const uint32_t rest = n_bytes - k * CHUNK;
#pragma unroll
      for (uint32_t x = 0; x < CHUNK; ++x)
        if (x < rest) dst[x] = (uint8_t)(w[x / 4] >> (8 * (x % 4)));
    }
    // the next chunk: (bh, row, col) += the stride's
    col += step_col;
    if (col >= n_cols) {
      col -= n_cols;
      ++row;
    }
    row += step_row;
    if (row >= n_rows) {
      row -= n_rows;
      ++bh;
    }
    bh += step_bh;
  }
}

}  // namespace

// out (n_bh, n_rows, n_cols) uint8, contiguous, 16-byte aligned, at most
// 2^32 - 16 bytes (32-bit offsets in the kernel). Returns the CUDA error of
// the launch (0 on success).
extern "C" int dropout_mask(void* out, unsigned seed, unsigned threshold, int n_bh,
                            int n_rows, int n_cols, int bh0, int row0, int col0,
                            void* stream) {
  if (n_bh <= 0 || n_rows <= 0 || n_cols <= 0) return (int)cudaErrorInvalidValue;
  const unsigned long long n_bytes = (unsigned long long)n_bh * n_rows * n_cols;
  if (n_bytes > 0xFFFFFFF0ull || (reinterpret_cast<uintptr_t>(out) & (CHUNK - 1)))
    return (int)cudaErrorInvalidValue;
  // the chunks spread evenly over at most one wave of CTAs
  const unsigned long long n_chunks = (n_bytes + CHUNK - 1) / CHUNK;
  const unsigned long long wave = (unsigned long long)THREADS * MAX_BLOCKS;
  const unsigned long long per_thread = (n_chunks + wave - 1) / wave;
  const unsigned long long grid = (n_chunks + THREADS * per_thread - 1) / (THREADS * per_thread);
  // the grid stride as (bh, row, col) steps
  const unsigned long long stride = grid * THREADS * CHUNK;
  const unsigned long long stride_rows = stride / n_cols;
  mask_vec16_kernel<<<(unsigned)grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), seed, threshold, n_rows, n_cols, bh0, row0, col0,
      (uint32_t)n_bytes, (int)(stride_rows / n_rows), (int)(stride_rows % n_rows),
      (int)(stride % n_cols));
  return (int)cudaGetLastError();
}

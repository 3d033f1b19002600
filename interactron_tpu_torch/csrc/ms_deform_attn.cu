// Multi-scale deformable attention (Deformable DETR's MSDeformAttn core):
// the forward and the first-order backward. The JAX package has no such
// kernel; these serve `MODEL.BACKBONE: resnet50_deformable`
// (models/deformable_detr.py). Plain versions and the operands' layout:
// ops/ms_deform_attn.py.
//
// What bounds it on the H100: memory latency. Each (frame, query, head)
// reads 4 taps of D values at data-dependent places of one level's map for
// each of L*P points, and the arithmetic per byte is a few FLOPs, far below
// what the tensor cores need. The design keeps every read coalesced where
// it can be: one warp per (frame, query, head), one lane per channel, so a
// tap is one 32 x 2-byte row of the value map (one or two sectors in bf16),
// and the point's location and weight are one broadcast load for the warp.
// The maps of a frame (1930 tokens x 256 channels in bf16, ~1 MB) stay in
// L2 across its queries. Sums are in fp32.
//
// The backward runs the same loop: dWeights and dLocations are sums over
// the channels (a warp reduction, written once by lane 0), and dValue
// scatters each tap's share into an fp32 buffer with atomicAdd (the caller
// zeroes it and casts it to the value's dtype), so dValue's last bits vary
// run to run; the forward is deterministic.

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];  // first token of each level in value's S axis
};

struct Shape {
  int n, lq, s, heads, dim, levels, points;
};

// pixel coordinates of a location on an h x w map (align_corners=False)
struct Tap {
  int x0, y0;
  float fx, fy;
  bool any;  // some corner lies inside the map
};

// x = loc * W - 0.5 rounded after the product and after the difference, as
// two tensor ops round it (no FMA): the gradient with respect to a location
// jumps where the pixel coordinate crosses an integer, so the plain version
// and the kernel must floor the same number
__device__ __forceinline__ Tap tap_of(float lx, float ly, int h, int w) {
  Tap t;
  const float x = __fadd_rn(__fmul_rn(lx, static_cast<float>(w)), -0.5f);
  const float y = __fadd_rn(__fmul_rn(ly, static_cast<float>(h)), -0.5f);
  // a corner column floor(x) or floor(x) + 1 lies in [0, w) iff -1 <= x < w
  // (at x = -1 the inside column's weight is 0 but its slope is not, as in
  // grid_sample's gradient)
  t.any = x >= -1.f && y >= -1.f && x < w && y < h;
  const float xf = floorf(x), yf = floorf(y);
  t.x0 = static_cast<int>(xf);
  t.y0 = static_cast<int>(yf);
  t.fx = x - xf;
  t.fy = y - yf;
  return t;
}

// the value of channel d at (y, x), zero outside the map
template <typename T>
__device__ __forceinline__ float corner(const T* map, int y, int x, int h, int w, long row,
                                        bool& inside) {
  inside = y >= 0 && y < h && x >= 0 && x < w;
  return inside ? ipt::to_f<T>(map[(static_cast<long>(y) * w + x) * row]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) msda_fwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc, const float* __restrict__ attw,
    T* __restrict__ out, Shape sh, Levels lv) {
  const long warp = (static_cast<long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long>(sh.n) * sh.lq * sh.heads) return;
  const int head = warp % sh.heads;
  const long frame = warp / (static_cast<long>(sh.heads) * sh.lq);
  const long row = static_cast<long>(sh.heads) * sh.dim;  // one token's values
  const int lp = sh.levels * sh.points;
  const float* l_ptr = loc + warp * lp * 2;
  const float* a_ptr = attw + warp * lp;
  const T* v_frame = value + frame * sh.s * row + head * sh.dim;
  T* o_ptr = out + (warp / sh.heads) * row + head * sh.dim;
  for (int d = lane; d < sh.dim; d += 32) {
    float acc = 0.f;
    for (int l = 0; l < sh.levels; ++l) {
      const int h = lv.h[l], w = lv.w[l];
      const T* map = v_frame + static_cast<long>(lv.start[l]) * row + d;
      for (int p = 0; p < sh.points; ++p) {
        const int i = l * sh.points + p;
        const Tap t = tap_of(l_ptr[2 * i], l_ptr[2 * i + 1], h, w);
        if (!t.any) continue;
        bool m;
        const float v00 = corner(map, t.y0, t.x0, h, w, row, m);
        const float v01 = corner(map, t.y0, t.x0 + 1, h, w, row, m);
        const float v10 = corner(map, t.y0 + 1, t.x0, h, w, row, m);
        const float v11 = corner(map, t.y0 + 1, t.x0 + 1, h, w, row, m);
        const float s = (1.f - t.fy) * ((1.f - t.fx) * v00 + t.fx * v01) +
                        t.fy * ((1.f - t.fx) * v10 + t.fx * v11);
        acc += a_ptr[i] * s;
      }
    }
    o_ptr[d] = ipt::from_f<T>(acc);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) msda_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc, const float* __restrict__ attw,
    const T* __restrict__ grad_out, float* __restrict__ grad_value, float* __restrict__ grad_loc,
    float* __restrict__ grad_attw, Shape sh, Levels lv) {
  const long warp = (static_cast<long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long>(sh.n) * sh.lq * sh.heads) return;
  const int head = warp % sh.heads;
  const long frame = warp / (static_cast<long>(sh.heads) * sh.lq);
  const long row = static_cast<long>(sh.heads) * sh.dim;
  const int lp = sh.levels * sh.points;
  const float* l_ptr = loc + warp * lp * 2;
  const float* a_ptr = attw + warp * lp;
  const long v_off = frame * sh.s * row + head * sh.dim;
  const T* go_ptr = grad_out + (warp / sh.heads) * row + head * sh.dim;
  for (int l = 0; l < sh.levels; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const long map_off = v_off + static_cast<long>(lv.start[l]) * row;
    for (int p = 0; p < sh.points; ++p) {
      const int i = l * sh.points + p;
      const Tap t = tap_of(l_ptr[2 * i], l_ptr[2 * i + 1], h, w);
      const float a = a_ptr[i];
      float g_a = 0.f, g_x = 0.f, g_y = 0.f;
      if (t.any) {  // the same for every lane of the warp
        const float w00 = (1.f - t.fy) * (1.f - t.fx), w01 = (1.f - t.fy) * t.fx;
        const float w10 = t.fy * (1.f - t.fx), w11 = t.fy * t.fx;
        for (int d = lane; d < sh.dim; d += 32) {
          const T* map = value + map_off + d;
          bool m00, m01, m10, m11;
          const float v00 = corner(map, t.y0, t.x0, h, w, row, m00);
          const float v01 = corner(map, t.y0, t.x0 + 1, h, w, row, m01);
          const float v10 = corner(map, t.y0 + 1, t.x0, h, w, row, m10);
          const float v11 = corner(map, t.y0 + 1, t.x0 + 1, h, w, row, m11);
          const float go = ipt::to_f<T>(go_ptr[d]);
          g_a += go * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
          const float ga = go * a;
          g_x += ga * ((1.f - t.fy) * (v01 - v00) + t.fy * (v11 - v10));
          g_y += ga * ((1.f - t.fx) * (v10 - v00) + t.fx * (v11 - v01));
          float* gv = grad_value + map_off + d;
          if (m00) atomicAdd(gv + (static_cast<long>(t.y0) * w + t.x0) * row, ga * w00);
          if (m01) atomicAdd(gv + (static_cast<long>(t.y0) * w + t.x0 + 1) * row, ga * w01);
          if (m10) atomicAdd(gv + (static_cast<long>(t.y0 + 1) * w + t.x0) * row, ga * w10);
          if (m11) atomicAdd(gv + (static_cast<long>(t.y0 + 1) * w + t.x0 + 1) * row, ga * w11);
        }
        g_a = warp_sum(g_a);
        g_x = warp_sum(g_x);
        g_y = warp_sum(g_y);
      }
      if (lane == 0) {
        grad_attw[warp * lp + i] = g_a;
        grad_loc[(warp * lp + i) * 2] = g_x * w;
        grad_loc[(warp * lp + i) * 2 + 1] = g_y * h;
      }
    }
  }
}

bool make_levels(int levels, const int* hs, const int* ws, Levels& lv) {
  if (levels < 1 || levels > kMaxLevels) return false;
  int start = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.h[l] = l < levels ? hs[l] : 0;
    lv.w[l] = l < levels ? ws[l] : 0;
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  return true;
}

unsigned blocks_for(const Shape& sh) {
  const long warps = static_cast<long>(sh.n) * sh.lq * sh.heads;
  return static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int msda_fwd(const void* value, const void* loc, const void* attw, void* out, int n,
                        int lq, int s, int heads, int dim, int levels, int points, int dtype,
                        int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
                        cudaStream_t stream) {
  const int hs[kMaxLevels] = {h0, h1, h2, h3}, ws[kMaxLevels] = {w0, w1, w2, w3};
  Levels lv;
  if (!make_levels(levels, hs, ws, lv) || lv.start[kMaxLevels - 1] + lv.h[3] * lv.w[3] != s)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{n, lq, s, heads, dim, levels, points};
  if (static_cast<long>(n) * lq * heads == 0) return 0;
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  if (dtype == ipt::kBFloat16) {
    msda_fwd_kernel<__nv_bfloat16><<<blocks_for(sh), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(value), l, a, static_cast<__nv_bfloat16*>(out), sh, lv);
  } else if (dtype == ipt::kFloat32) {
    msda_fwd_kernel<float><<<blocks_for(sh), kThreads, 0, stream>>>(
        static_cast<const float*>(value), l, a, static_cast<float*>(out), sh, lv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msda_bwd(const void* value, const void* loc, const void* attw,
                        const void* grad_out, void* grad_value, void* grad_loc, void* grad_attw,
                        int n, int lq, int s, int heads, int dim, int levels, int points,
                        int dtype, int h0, int h1, int h2, int h3, int w0, int w1, int w2,
                        int w3, cudaStream_t stream) {
  const int hs[kMaxLevels] = {h0, h1, h2, h3}, ws[kMaxLevels] = {w0, w1, w2, w3};
  Levels lv;
  if (!make_levels(levels, hs, ws, lv) || lv.start[kMaxLevels - 1] + lv.h[3] * lv.w[3] != s)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{n, lq, s, heads, dim, levels, points};
  if (static_cast<long>(n) * lq * heads == 0) return 0;
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  float* gv = static_cast<float*>(grad_value);
  float* gl = static_cast<float*>(grad_loc);
  float* ga = static_cast<float*>(grad_attw);
  if (dtype == ipt::kBFloat16) {
    msda_bwd_kernel<__nv_bfloat16><<<blocks_for(sh), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(value), l, a,
        static_cast<const __nv_bfloat16*>(grad_out), gv, gl, ga, sh, lv);
  } else if (dtype == ipt::kFloat32) {
    msda_bwd_kernel<float><<<blocks_for(sh), kThreads, 0, stream>>>(
        static_cast<const float*>(value), l, a, static_cast<const float*>(grad_out), gv, gl, ga,
        sh, lv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

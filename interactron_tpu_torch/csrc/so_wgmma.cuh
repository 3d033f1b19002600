// The Q-resident warpgroup of the bf16 second-order attention backward on
// Hopper (wgmma, TMA), shared by two kernels:
//   * flash_so.cu's `so_wgmma_kernel` (WithKV = true): the merged VJP,
//     replacing `_sov_merged_kernel` (interactron_tpu/ops/flash_attention.py:969);
//   * flash_so_row.cu's `so_row_wgmma_kernel` (WithKV = false): the split
//     VJP's row half, replacing `_sov_row_kernel` (`:791`).
// The math is flash_so.cu's header: per head, P recomputed from L, dp, g_dS,
// g_P1 from four score products, the row sums g_D and s_gp, then
// c_q = scale (g_S K + dS Bc) and c_dO = Pd C + g_dp V, and with WithKV
// c_k = scale (g_S^T Q + dS^T A) and c_v = g_dp^T dO.
//
// Design. One CTA is one warpgroup (128 threads) that owns (b, h, 64 query
// rows): its Q, dO and A tiles arrive once by TMA; L and D of its rows go
// into the registers of the threads that own them by per-thread loads (as
// in flash_dq.cu; csrc/bwd_wgmma.cuh says why not TMA). The K, V, Bc and C
// tiles of 64 keys stream through a 2-stage TMA ring (one mbarrier a stage,
// four tiles a stage), twice: once a sweep, as one stream of 2 x S/64 tiles.
//   * Sweep 1, the row sums. Per tile four fp32 accumulators of 64 keys:
//     S = Q K^T, dP = dO V^T, g_dS = A K^T + Q Bc^T (two products into one
//     accumulator) and g_P1 = dO C^T, every operand K-major. Each thread
//     sums a1 = rowsum(P g_dS), a2 = rowsum(P (g_P1 + g_dS e)) and
//     a3 = rowsum(P dp) for its two rows; the quad that shares a row adds
//     them by shuffles once, after the sweep; then g_D = -a1 and
//     s_gp = a2 + g_D a3 (since g_P = g_P1 + g_dS e + g_D dp), so no third
//     sweep is needed.
//   * Sweep 2 recomputes the four accumulators for each 32-key half of a
//     tile, forms g_S, dS, Pd = M inv P and g_dp in fp32 and rounds each to
//     bf16 where the Pallas kernels round (`:1043-1050`), packed as register
//     A fragments of c_q += g_S K + dS Bc and c_dO += Pd C + g_dp V, with the
//     ring's K, Bc, C, V tiles as the MN-major B (as flash_dq.cu's dQ).
//   * WithKV: both halves also store their bf16 g_S, dS and g_dp to 128-byte
//     swizzled shared tiles; once the tile's 64 keys are there, c_k and c_v
//     shares (M = 64 keys, the score accumulators dead by then) are formed
//     with the transposed (MN-major) A from those tiles and Q, A, dO as
//     MN-major B, as bwd_wgmma.cuh forms dK. Each share goes through an fp32
//     shared tile into one TMA reduce-add (add.f32 in L2) per tile into the
//     caller's zeroed (B, S, H*D) buffers: the merged formulation's
//     accumulation across query tiles, in no fixed order, as the JAX
//     kernel's and the scalar kernel's. No atomicAdd.
//   * Without WithKV the kernel writes g_D and s_gp as (B, H, T) fp32 once,
//     by the threads that own the row; every output element is written once
//     (no atomics), so the split formulation stays bitwise reproducible.
// Registers: sweep 1 holds four 64-key accumulators (4 x 32 a thread);
// sweep 2 holds c_q and c_dO (D a thread) beside four 32-key accumulators
// (4 x 16) and their bf16 fragments; WithKV's c_k, c_v (D a thread) are
// live only after both halves. Dropout: each element's keep bit is hashed
// once a sweep (csrc/dropout.cuh) into one register of bits, applied by
// selects to dp and g_P1, then to Pd and g_dp, in passes that run only with
// dropout (a per-element branch in the main pass cost flash_dq 22-27%).
// Ragged edges: keys >= S and rows >= T get P = 0 (every product of theirs
// is then 0); TMA zero-fills a tile's tail within one batch element and
// clips a reduce-add box at S; rows >= T are not written.
// Shared memory a CTA at D=64: Q, dO, A 24 KB, ring 64 KB (89 KB, two CTAs
// an SM); WithKV adds 24 KB of g_S, dS, g_dp and two 16 KB fp32 staging
// tiles (145 KB, one CTA an SM). At D=32: 45 KB and 85 KB.
#pragma once

#include "common.cuh"
#include "dropout.cuh"
#include "wgmma.cuh"

namespace ipt {

constexpr int kSoRows = 64;     // query rows per CTA: one warpgroup
constexpr int kSoKeys = 64;     // keys per ring tile
constexpr int kSoStages = 2;    // K/V/Bc/C ring depth
constexpr int kSoThreads = 128;

// byte offsets from the CTA's 1024-aligned shared-memory base
template <int D, bool WithKV>
struct SoSmem {
  static constexpr int kTile = 64 * D * 2;  // one 64-row bf16 tile of width D
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTile;
  static constexpr int kA = kDO + kTile;
  static constexpr int kRing = kA + kTile;  // a stage: K, V, Bc, C
  static constexpr int kStage = 4 * kTile;
  static constexpr int kGS = kRing + kSoStages * kStage;  // 64 x 64 bf16, WithKV
  static constexpr int kDS = kGS + 64 * 64 * 2;
  static constexpr int kGDP = kDS + 64 * 64 * 2;
  static constexpr int kCK = kGDP + 64 * 64 * 2;  // 64 x D fp32, WithKV
  static constexpr int kCV = kCK + 64 * D * 4;
  static constexpr int kBar = WithKV ? kCV + 64 * D * 4 : kGS;  // Q/dO/A, then one a stage
  static constexpr int kBytes = kBar + 8 * (1 + kSoStages) + 1024;  // + alignment slack
};

// what a thread keeps of its two accumulator rows, r0 and r0 + 8
struct SoRows {
  bool ok[2];        // row < T
  float l2[2];       // L log2(e)
  float delta[2];    // D = rowsum(dO O)
  uint32_t key[2];   // the dropout hash's row part
};

// The four score tiles of N keys for the CTA's 64 rows, every operand
// K-major (descriptors of the keys' first row): S = Q K^T, dP = dO V^T,
// g_dS / scale = A K^T + Q Bc^T and g_P1 = dO C^T.
template <int N, int D>
__device__ __forceinline__ void so_scores(float (&s)[N / 2], float (&dp)[N / 2],
                                          float (&gds)[N / 2], float (&gp1)[N / 2], uint64_t q,
                                          uint64_t o, uint64_t a, uint64_t k, uint64_t v,
                                          uint64_t bc, uint64_t c) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(s, q + 2 * kk, k + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(dp, o + 2 * kk, v + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(gds, a + 2 * kk, k + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(gds, q + 2 * kk, bc + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<N, 0, 0>(gp1, o + 2 * kk, c + 2 * kk, kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
  fence_regs(gds);
  fence_regs(gp1);
}

// keep bits of an N-wide accumulator: bit e for register e, whose column is
// col0 + 8 (e / 4) + e % 2 (col0: the first key plus the thread's offset)
template <int N>
__device__ __forceinline__ uint32_t so_keep_bits(const Dropout& drop, const SoRows& rs, int col0) {
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < N / 2; ++e)
    bits |= (uint32_t)drop.keep(rs.key[(e / 2) % 2], col0 + 8 * (e / 4) + (e % 2)) << e;
  return bits;
}

template <int N>
__device__ __forceinline__ void so_drop(float (&x)[N / 2], uint32_t bits, float inv) {
#pragma unroll
  for (int e = 0; e < N / 2; ++e) x[e] = (bits >> e) & 1u ? x[e] * inv : 0.f;
}

// The body of both kernels; the maps are the kernels' __grid_constant__
// parameters (ckmap and cvmap are null without WithKV, gd_out and sgp_out
// with it).
template <int D, bool WithKV>
__device__ __forceinline__ void q_resident_so(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    const CUtensorMap* domap, const CUtensorMap* amap, const CUtensorMap* bcmap,
    const CUtensorMap* cmap, const CUtensorMap* ckmap, const CUtensorMap* cvmap,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ cq, __nv_bfloat16* __restrict__ cdo, float* __restrict__ gd_out,
    float* __restrict__ sgp_out, int t_len, int s_len, int heads, float scale, Dropout drop) {
  using L = SoSmem<D, WithKV>;
  constexpr int RB = D * 2;  // bytes of one q/k/v/dO/A/Bc/C tile row
  extern __shared__ uint8_t so_smem[];  // named apart from the scalar kernels' float array
  const uint32_t base = (smem_addr(so_smem) + 1023) & ~1023u;
  uint8_t* const gbase = so_smem + (base - smem_addr(so_smem));  // generic pointer
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_ring = bar_q + 8;  // + 8 * stage

  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kSoRows;
  const int nk = (s_len + kSoKeys - 1) / kSoKeys;
  const int n_it = 2 * nk;  // ring tiles over both sweeps; tile `it` holds keys of tile it % nk

  // tid 0: load ring tile `it` into its stage
  auto load_stage = [&](int it) {
    const int st = it % kSoStages;
    const uint32_t dst = base + L::kRing + st * L::kStage;
    const uint32_t bar = bar_ring + 8 * st;
    const int key = (it % nk) * kSoKeys;
    mbar_expect_tx(bar, 4 * L::kTile);
    tma_load_3d(dst, kmap, bar, h * D, key, b);
    tma_load_3d(dst + L::kTile, vmap, bar, h * D, key, b);
    tma_load_3d(dst + 2 * L::kTile, bcmap, bar, h * D, key, b);
    tma_load_3d(dst + 3 * L::kTile, cmap, bar, h * D, key, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kSoStages; ++s) mbar_init(bar_ring + 8 * s, 1);
    mbar_fence_init();
    mbar_expect_tx(bar_q, 3 * L::kTile);
    tma_load_3d(base + L::kQ, qmap, bar_q, h * D, q0, b);
    tma_load_3d(base + L::kDO, domap, bar_q, h * D, q0, b);
    tma_load_3d(base + L::kA, amap, bar_q, h * D, q0, b);
    for (int it = 0; it < kSoStages && it < n_it; ++it) load_stage(it);
  }
  __syncthreads();

  // this thread's accumulator rows are r0 and r0 + 8 (hh = 0, 1), and in
  // each 8-column block its columns are c0 and c0 + 1
  const int r0 = 16 * w + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float s2 = scale * kLog2e;
  SoRows rs;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    rs.ok[hh] = row < t_len;
    rs.l2[hh] = rs.ok[hh] ? lse[(size_t)bh * t_len + row] * kLog2e : 0.f;
    rs.delta[hh] = rs.ok[hh] ? delta[(size_t)bh * t_len + row] : 0.f;
    rs.key[hh] = row_key(drop.seed, bh, row);
  }

  const uint64_t q_desc = tile_desc<RB>(base + L::kQ);
  const uint64_t do_desc = tile_desc<RB>(base + L::kDO);
  const uint64_t a_desc = tile_desc<RB>(base + L::kA);
  constexpr uint32_t kTileDesc = L::kTile >> 4;  // one tile further, in descriptor units
  mbar_wait(bar_q, 0);

  // ---- sweep 1: the row sums a1, a2, a3 over 64-key tiles
  float a1[2] = {0.f, 0.f}, a2[2] = {0.f, 0.f}, a3[2] = {0.f, 0.f};
  for (int j = 0; j < nk; ++j) {
    const int it = j;
    const int st = it % kSoStages;
    const int k0 = j * kSoKeys;
    const uint64_t k_desc = tile_desc<RB>(base + L::kRing + st * L::kStage);
    mbar_wait(bar_ring + 8 * st, (it / kSoStages) & 1);
    float s[32], dp[32], gds[32], gp1[32];
    so_scores<64, D>(s, dp, gds, gp1, q_desc, do_desc, a_desc, k_desc, k_desc + kTileDesc,
                     k_desc + 2 * kTileDesc, k_desc + 3 * kTileDesc);
    wg_sync();  // every warp's products have read the stage
    if (tid == 0 && it + kSoStages < n_it) load_stage(it + kSoStages);
    if (drop.on) {
      const uint32_t bits = so_keep_bits<64>(drop, rs, k0 + c0);
      so_drop<64>(dp, bits, drop.inv);
      so_drop<64>(gp1, bits, drop.inv);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e / 2) % 2;
      const int col = k0 + 8 * (e / 4) + c0 + (e % 2);
      const float p = (rs.ok[hh] && col < s_len) ? exp2f(s[e] * s2 - rs.l2[hh]) : 0.f;
      const float g_ds = gds[e] * scale;
      const float ee = dp[e] - rs.delta[hh];
      a1[hh] = fmaf(p, g_ds, a1[hh]);
      a2[hh] = fmaf(p, fmaf(g_ds, ee, gp1[e]), a2[hh]);
      a3[hh] = fmaf(p, dp[e], a3[hh]);
    }
  }
  float g_d[2], s_gp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {  // the quad of lanes that shares the row
      a1[hh] += __shfl_xor_sync(0xffffffffu, a1[hh], m);
      a2[hh] += __shfl_xor_sync(0xffffffffu, a2[hh], m);
      a3[hh] += __shfl_xor_sync(0xffffffffu, a3[hh], m);
    }
    g_d[hh] = -a1[hh];
    s_gp[hh] = a2[hh] + g_d[hh] * a3[hh];
  }
  if constexpr (!WithKV) {
    if (lane % 4 == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (rs.ok[hh]) {
          const size_t at = (size_t)bh * t_len + q0 + r0 + 8 * hh;
          gd_out[at] = g_d[hh];
          sgp_out[at] = s_gp[hh];
        }
      }
    }
  }

  // ---- sweep 2: c_q, c_dO in registers; with WithKV the c_k/c_v shares
  float cq_acc[D / 2], cdo_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) cq_acc[i] = cdo_acc[i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int it = nk + j;
    const int st = it % kSoStages;
    const int k0 = j * kSoKeys;
    const uint64_t k_desc = tile_desc<RB>(base + L::kRing + st * L::kStage);
    const uint64_t v_desc = k_desc + kTileDesc;
    const uint64_t bc_desc = k_desc + 2 * kTileDesc;
    const uint64_t c_desc = k_desc + 3 * kTileDesc;
    mbar_wait(bar_ring + 8 * st, (it / kSoStages) & 1);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      const int kb = k0 + 32 * hf;
      const uint32_t half = (32 * hf * RB) >> 4;  // the half's first key row
      float s[16], dp[16], gds[16], gp1[16];
      so_scores<32, D>(s, dp, gds, gp1, q_desc, do_desc, a_desc, k_desc + half, v_desc + half,
                       bc_desc + half, c_desc + half);
      uint32_t bits = 0;
      if (drop.on) {
        bits = so_keep_bits<32>(drop, rs, kb + c0);
        so_drop<32>(dp, bits, drop.inv);
        so_drop<32>(gp1, bits, drop.inv);
      }
      // in place: s <- P (Pd before dropout), dp <- dS, gds <- g_dp before
      // dropout, gp1 <- g_S
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int hh = (e / 2) % 2;
        const int col = kb + 8 * (e / 4) + c0 + (e % 2);
        const float p = (rs.ok[hh] && col < s_len) ? exp2f(s[e] * s2 - rs.l2[hh]) : 0.f;
        const float g_ds = gds[e] * scale;
        const float ee = dp[e] - rs.delta[hh];
        const float g_p = gp1[e] + g_ds * ee + g_d[hh] * dp[e];
        s[e] = p;
        dp[e] = p * ee;
        gds[e] = p * (g_ds + g_d[hh]);
        gp1[e] = p * (g_p - s_gp[hh]);
      }
      if (drop.on) {
        so_drop<32>(s, bits, drop.inv);
        so_drop<32>(gds, bits, drop.inv);
      }
      // rounded to bf16 and packed as the A operand of each 16-key slice;
      // with WithKV also stored to the g_S, dS, g_dp tiles
      uint32_t gsa[2][4], dsa[2][4], pda[2][4], gpa[2][4];
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        gsa[e / 8][(e % 8) / 2] = pack_bf16(gp1[e], gp1[e + 1]);
        dsa[e / 8][(e % 8) / 2] = pack_bf16(dp[e], dp[e + 1]);
        pda[e / 8][(e % 8) / 2] = pack_bf16(s[e], s[e + 1]);
        gpa[e / 8][(e % 8) / 2] = pack_bf16(gds[e], gds[e + 1]);
        if constexpr (WithKV) {
          const uint32_t at = swz<128>(r0 + 8 * ((e / 2) % 2), 32 * hf + 8 * (e / 4) + c0);
          *reinterpret_cast<uint32_t*>(gbase + L::kGS + at) = gsa[e / 8][(e % 8) / 2];
          *reinterpret_cast<uint32_t*>(gbase + L::kDS + at) = dsa[e / 8][(e % 8) / 2];
          *reinterpret_cast<uint32_t*>(gbase + L::kGDP + at) = gpa[e / 8][(e % 8) / 2];
        }
      }
      // c_q += g_S K + dS Bc, c_dO += Pd C + g_dp V: the ring tiles as the
      // MN-major B (k-slices of 16 keys)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t rows = ((32 * hf + 16 * kk) * RB) >> 4;
        wgmma_rs<D, 1>(cq_acc, gsa[kk], k_desc + rows, 1);
        wgmma_rs<D, 1>(cq_acc, dsa[kk], bc_desc + rows, 1);
        wgmma_rs<D, 1>(cdo_acc, pda[kk], c_desc + rows, 1);
        wgmma_rs<D, 1>(cdo_acc, gpa[kk], v_desc + rows, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(cq_acc);
      fence_regs(cdo_acc);
    }
    if constexpr (WithKV) fence_async_smem();  // the g_S, dS, g_dp stores, for wgmma
    wg_sync();  // every warp is done with the stage (and has stored its g_S, dS, g_dp)
    if (tid == 0 && it + kSoStages < n_it) load_stage(it + kSoStages);

    if constexpr (WithKV) {
      // the tile's shares c_k / scale = g_S^T Q + dS^T A and c_v = g_dp^T dO
      // (rows: the 64 keys; k-slices of 16 query rows)
      const uint64_t gs_desc = tile_desc<128>(base + L::kGS);
      const uint64_t ds_desc = tile_desc<128>(base + L::kDS);
      const uint64_t gdp_desc = tile_desc<128>(base + L::kGDP);
      float ck_acc[D / 2], cv_acc[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t sa = (16 * kk * 128) >> 4, sb = (16 * kk * RB) >> 4;
        wgmma_ss<D, 1, 1>(ck_acc, gs_desc + sa, q_desc + sb, kk);
        wgmma_ss<D, 1, 1>(ck_acc, ds_desc + sa, a_desc + sb, 1);
        wgmma_ss<D, 1, 1>(cv_acc, gdp_desc + sa, do_desc + sb, kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ck_acc);
      fence_regs(cv_acc);
      if (tid == 0) bulk_wait_read();  // the last reduce-adds have read the staging tiles
      wg_sync();  // ... and every warp's products have read g_S, dS, g_dp
      float* cks = reinterpret_cast<float*>(gbase + L::kCK);
      float* cvs = reinterpret_cast<float*>(gbase + L::kCV);
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = (r0 + 8 * hh) * D + 8 * jb + c0;
          *reinterpret_cast<float2*>(cks + at) =
              make_float2(ck_acc[4 * jb + 2 * hh] * scale, ck_acc[4 * jb + 2 * hh + 1] * scale);
          *reinterpret_cast<float2*>(cvs + at) =
              make_float2(cv_acc[4 * jb + 2 * hh], cv_acc[4 * jb + 2 * hh + 1]);
        }
      }
      fence_async_smem();
      wg_sync();
      if (tid == 0) {
        tma_reduce_add_3d(ckmap, base + L::kCK, h * D, k0, b);
        tma_reduce_add_3d(cvmap, base + L::kCV, h * D, k0, b);
        bulk_commit();
      }
    }
  }
  if constexpr (WithKV) {
    if (tid == 0) bulk_wait_all();
  }

  // c_q (scaled) and c_dO: accumulator rows are query rows, columns are D
  const int ld = heads * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rs.ok[hh]) {
      const size_t at = ((size_t)b * t_len + q0 + r0 + 8 * hh) * ld + h * D + c0;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        *reinterpret_cast<uint32_t*>(cq + at + 8 * jb) =
            pack_bf16(cq_acc[4 * jb + 2 * hh] * scale, cq_acc[4 * jb + 2 * hh + 1] * scale);
        *reinterpret_cast<uint32_t*>(cdo + at + 8 * jb) =
            pack_bf16(cdo_acc[4 * jb + 2 * hh], cdo_acc[4 * jb + 2 * hh + 1]);
      }
    }
  }
}

// the merged VJP: c_q, c_dO, and the c_k/c_v shares added into fp32 buffers
template <int D>
__global__ void __launch_bounds__(kSoThreads)
so_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bcmap,
                const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap ckmap,
                const __grid_constant__ CUtensorMap cvmap, const float* __restrict__ lse,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ cq,
                __nv_bfloat16* __restrict__ cdo, int t_len, int s_len, int heads, float scale,
                Dropout drop) {
  q_resident_so<D, true>(&qmap, &kmap, &vmap, &domap, &amap, &bcmap, &cmap, &ckmap, &cvmap, lse,
                         delta, cq, cdo, nullptr, nullptr, t_len, s_len, heads, scale, drop);
}

// the split VJP's row half: c_q, c_dO and the row statistics g_D, s_gp
template <int D>
__global__ void __launch_bounds__(kSoThreads)
so_row_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bcmap,
                    const __grid_constant__ CUtensorMap cmap, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ cq,
                    __nv_bfloat16* __restrict__ cdo, float* __restrict__ gd_out,
                    float* __restrict__ sgp_out, int t_len, int s_len, int heads, float scale,
                    Dropout drop) {
  q_resident_so<D, false>(&qmap, &kmap, &vmap, &domap, &amap, &bcmap, &cmap, nullptr, nullptr,
                          lse, delta, cq, cdo, gd_out, sgp_out, t_len, s_len, heads, scale, drop);
}

// Launch one of the two on bf16 q/dout/a (B, T, H*D), k/v/bc/c (B, S, H*D),
// lse and delta (B, H, T) fp32, cq/cdo like q; with WithKV out0/out1 are the
// c_k/c_v (B, S, H*D) fp32 buffers zero-filled by the caller, without it
// the g_D/s_gp (B, H, T) fp32 outputs.
template <int D, bool WithKV>
cudaError_t launch_q_resident(const void* q, const void* k, const void* v, const void* dout,
                              const void* a, const void* bc, const void* c, const void* lse,
                              const void* delta, void* cq, void* cdo, void* out0, void* out1,
                              int B, int T_len, int S_len, int H, Dropout drop,
                              cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom, am, bcm, cm, ckm, cvm;
  cudaError_t err;
  if ((err = packed_map(&qm, q, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&km, k, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&vm, v, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&dom, dout, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&am, a, false, B, T_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&bcm, bc, false, B, S_len, H, D)) != cudaSuccess) return err;
  if ((err = packed_map(&cm, c, false, B, S_len, H, D)) != cudaSuccess) return err;
  if constexpr (WithKV) {
    if ((err = packed_map(&ckm, out0, true, B, S_len, H, D)) != cudaSuccess) return err;
    if ((err = packed_map(&cvm, out1, true, B, S_len, H, D)) != cudaSuccess) return err;
  }
  constexpr int smem = SoSmem<D, WithKV>::kBytes;
  const void* kernel;  // only the chosen kernel is instantiated
  if constexpr (WithKV) kernel = reinterpret_cast<const void*>(so_wgmma_kernel<D>);
  else kernel = reinterpret_cast<const void*>(so_row_wgmma_kernel<D>);
  static int smem_set_for = -1;
  if ((err = allow_smem(kernel, smem, &smem_set_for)) != cudaSuccess) return err;
  const dim3 grid((T_len + kSoRows - 1) / kSoRows, B * H);
  const float scale = 1.f / sqrtf((float)D);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  __nv_bfloat16* gq = static_cast<__nv_bfloat16*>(cq);
  __nv_bfloat16* go = static_cast<__nv_bfloat16*>(cdo);
  if constexpr (WithKV)
    so_wgmma_kernel<D><<<grid, kSoThreads, smem, stream>>>(qm, km, vm, dom, am, bcm, cm, ckm, cvm,
                                                           l, d, gq, go, T_len, S_len, H, scale,
                                                           drop);
  else
    so_row_wgmma_kernel<D><<<grid, kSoThreads, smem, stream>>>(
        qm, km, vm, dom, am, bcm, cm, l, d, gq, go, static_cast<float*>(out0),
        static_cast<float*>(out1), T_len, S_len, H, scale, drop);
  return cudaGetLastError();
}

}  // namespace ipt

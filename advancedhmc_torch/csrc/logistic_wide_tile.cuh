// The column-tiled logistic likelihood for p > 128: the stages of a row
// panel, as device code for K2's wide target (fused_nuts.cu), the one
// kernel that evaluates the Bernoulli-logit likelihood at any width this
// way (K1's wide path is two wgmma GEMMs of its own, fused_logistic.cu).
// Built on the warp tile's 3xTF32 mma and cp.async helpers
// (logistic_tile.cuh).
//
// At p = 999 a block's beta and two x tiles at full width would need ~514
// KB of shared memory, and a chain's gradient would not fit in registers.
// So the columns are cut into chunks of kChunk = 128, the width of the
// narrow warp tile's largest instance, and the rows into panels of
// kPanelTiles tiles of 32. For each panel of its rows a kernel runs
//
//   stage A  for each column chunk (beta's chunk staged once), for each row
//            tile (x[tile, chunk] staged, double-buffered): product 1 of the
//            chunk, `chunk_logits`, added in float32 into the panel's logits
//            in shared memory (64 chains x kPanelRows rows, row stride
//            kResStride), `add_logits`; then `panel_epilogue` turns them
//            into lp and residuals, in place;
//   stage B  for each column chunk, for each row tile: product 2 from the
//            residuals in shared memory into 16 x 8 NNT accumulators a warp,
//            `chunk_grad`; the kernel then adds the chunk's sum into the
//            gradient, the first panel writing it.
//
// The (C, n) logits and residuals never leave the chip: a panel's live in
// shared memory between the stages, as the TPU kernel keeps them in VMEM.
// A warp owns 16 chains (the M rows of the mma); where several warps share
// 16 chains, each takes NJ of a tile's 4 n-tiles (rows) in stage A and NNT
// of a chunk's 16 n-tiles (columns) in stage B, so that their outputs are
// disjoint. Both products run short mma chains from zero, added in float32,
// since the tensor cores truncate where they accumulate (logistic_tile.cuh).

#pragma once

#include <cstdint>

#include "logistic_tile.cuh"

namespace logistic_wide_tile {

using logistic_tile::kTileRows;

constexpr int kWideKSteps = 16;                    // k-steps of 8 a chunk
constexpr int kChunk = 8 * kWideKSteps;            // columns per chunk
constexpr int kWideS = logistic_tile::x_stride(kWideKSteps);   // 132
constexpr int kPanelTiles = 4;                     // row tiles per panel
constexpr int kPanelRows = kPanelTiles * kTileRows;
// Row stride of the panel's logits and residuals: 8 mod 32, so that the
// float2 accesses of a C fragment (rows 2t, 2t+1 of chain g) and of product
// 2's A fragment (the same elements) hit 32 different banks per half-warp.
constexpr int kResStride = kPanelRows + 8;

// Product 1 of one x tile over one column chunk for the warp's 16 chains
// and NJ of the tile's n-tiles: out[j] is the C fragment of the rows 8j..
// 8j+7 after `xs`. Short chains as in warp_tile: each k-step's three mma
// from zero, added in float32.
template <int NJ>
__device__ __forceinline__ void chunk_logits(const float* __restrict__ bs,
                                             const float* __restrict__ xs,
                                             int n_ks, float (&out)[NJ][4]) {
  constexpr int S = kWideS;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[j][i] = 0.f;
  }
#pragma unroll
  for (int ks0 = 0; ks0 < kWideKSteps; ks0 += 2) {
    if (ks0 < n_ks) {
      // two k-steps' chains side by side: 2 NJ independent mma in flight
      float d[2][NJ][4] = {};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (ks0 + q < n_ks) {
          const float* br = bs + g * S + 8 * (ks0 + q) + t;
          uint32_t a_hi[4], a_lo[4];
          logistic_tile::split_tf32(br[0], a_hi[0], a_lo[0]);
          logistic_tile::split_tf32(br[8 * S], a_hi[1], a_lo[1]);
          logistic_tile::split_tf32(br[4], a_hi[2], a_lo[2]);
          logistic_tile::split_tf32(br[8 * S + 4], a_hi[3], a_lo[3]);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float* xr = xs + (8 * j + g) * S + 8 * (ks0 + q) + t;
            uint32_t b_hi[2], b_lo[2];
            logistic_tile::split_tf32(xr[0], b_hi[0], b_lo[0]);
            logistic_tile::split_tf32(xr[4], b_hi[1], b_lo[1]);
            logistic_tile::mma_3xtf32(d[q][j], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) out[j][i] += d[0][j][i] + d[1][j][i];
      }
    }
  }
}

// The C fragments of `chunk_logits` into the panel's logits: the lane's
// chains cw, cw + 8 at rows r0 + 8j, r0 + 8j + 1 (r0 = the tile's first
// row in the panel + 8 j0 + 2t); the first chunk writes, later ones add.
template <int NJ>
__device__ __forceinline__ void add_logits(float* res, int cw, int r0,
                                           const float (&d)[NJ][4],
                                           bool first) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float2* l0 = reinterpret_cast<float2*>(res + cw * kResStride + r0 + 8 * j);
    float2* l8 =
        reinterpret_cast<float2*>(res + (cw + 8) * kResStride + r0 + 8 * j);
    if (first) {
      *l0 = make_float2(d[j][0], d[j][1]);
      *l8 = make_float2(d[j][2], d[j][3]);
    } else {
      const float2 a = *l0, b = *l8;
      *l0 = make_float2(a.x + d[j][0], a.y + d[j][1]);
      *l8 = make_float2(b.x + d[j][2], b.y + d[j][3]);
    }
  }
}

// The epilogue of a panel of `nt_p` tiles: each lane turns its own logits
// (those `add_logits` wrote) into residuals, in place, and adds their lp
// terms to lp_g (chain cw) and lp_g8 (chain cw + 8). `yp` holds the panel's
// y; rows from `rows` on lie past n (weight 0).
template <int NJ>
__device__ __forceinline__ void panel_epilogue(float* res,
                                               const float* __restrict__ yp,
                                               int cw, int j0, int nt_p,
                                               int rows, float& lp_g,
                                               float& lp_g8) {
  const int t = threadIdx.x & 3;
  for (int i = 0; i < nt_p; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r0 = kTileRows * i + 8 * (j0 + j) + 2 * t;
      const float w0 = r0 < rows ? 1.f : 0.f;
      const float w1 = r0 + 1 < rows ? 1.f : 0.f;
      float2* l0 = reinterpret_cast<float2*>(res + cw * kResStride + r0);
      float2* l8 = reinterpret_cast<float2*>(res + (cw + 8) * kResStride + r0);
      const float2 a = *l0, b = *l8;
      float2 ra, rb;
      ra.x = logistic_tile::logit_term(a.x, yp[r0], w0, lp_g);
      ra.y = logistic_tile::logit_term(a.y, yp[r0 + 1], w1, lp_g);
      rb.x = logistic_tile::logit_term(b.x, yp[r0], w0, lp_g8);
      rb.y = logistic_tile::logit_term(b.y, yp[r0 + 1], w1, lp_g8);
      *l0 = ra;
      *l8 = rb;
    }
  }
}

// Product 2 of one x tile over one column chunk: acc[nt] (the chunk's
// columns 8(nt0+nt)..+7) += the tile's residuals times x, one chain of four
// k-steps (the tile's 32 rows) from zero, added in float32. `rs` holds the
// warp's 16 chains' residuals of this tile's rows (row stride kResStride);
// n-tiles from `n_nt` on lie past p.
template <int NNT>
__device__ __forceinline__ void chunk_grad(const float* __restrict__ rs,
                                           const float* __restrict__ xs,
                                           int nt0, int n_nt,
                                           float (&acc)[NNT][4]) {
  constexpr int S = kWideS;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float d[NNT][4] = {};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // A order (chain g, row r0), (g+8, r0), (g, r0+1), (g+8, r0+1), r0 =
    // 8j + 2t: the C fragment of product 1, as in warp_tile
    const float2 v0 =
        *reinterpret_cast<const float2*>(rs + g * kResStride + 8 * j + 2 * t);
    const float2 v1 = *reinterpret_cast<const float2*>(
        rs + (g + 8) * kResStride + 8 * j + 2 * t);
    uint32_t a_hi[4], a_lo[4];
    logistic_tile::split_tf32(v0.x, a_hi[0], a_lo[0]);
    logistic_tile::split_tf32(v1.x, a_hi[1], a_lo[1]);
    logistic_tile::split_tf32(v0.y, a_hi[2], a_lo[2]);
    logistic_tile::split_tf32(v1.y, a_hi[3], a_lo[3]);
#pragma unroll
    for (int nt = 0; nt < NNT; ++nt) {
      if (nt0 + nt < n_nt) {
        const float* xc = xs + (8 * j + 2 * t) * S + 8 * (nt0 + nt) + g;
        uint32_t b_hi[2], b_lo[2];
        logistic_tile::split_tf32(xc[0], b_hi[0], b_lo[0]);
        logistic_tile::split_tf32(xc[S], b_hi[1], b_lo[1]);
        logistic_tile::mma_3xtf32(d[nt], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NNT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += d[nt][i];
  }
}

}  // namespace logistic_wide_tile

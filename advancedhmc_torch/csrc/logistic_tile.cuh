// The logistic likelihood tile on Hopper's tensor cores: one warp, 16
// chains, one staged tile of kTileRows observations, and the cp.async
// helpers that stage those tiles (device code shared by the kernels that
// evaluate the Bernoulli-logit likelihood: K1 fused_logistic.cu, K2
// fused_nuts.cu).
//
// For the warp's chains c and the tile's rows j, with beta_c = theta[c, 1:]:
//
//   product 1   logit[c, j]  = beta_c . x[j]             (16 x kTileRows)
//   epilogue    lp[c]       += y[j] * logit - softplus(logit)
//               r[c, j]      = y[j] - sigmoid(logit)
//   product 2   grad[c, :]  += sum_j r[c, j] * x[j]      (16 x 8*KSteps)
//
// Both products are mma.sync.m16n8k8 in TF32 with the 3xTF32 split: every
// float32 operand a becomes a_hi = tf32(a), a_lo = tf32(a - a_hi) (round to
// nearest, ties away, as `cvt.rna`), and a.b ~ a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, the small terms first, into a float32 accumulator. The dropped
// a_lo.b_lo and the rounding of a_lo leave about 2^-21 of |a.b|, which is
// float32's accuracy for sums of this length; one TF32 product (2^-11)
// misses the 1e-4 gate on the gradient (tests/test_torch_tf32_split.py).
// Operands are split in registers as they are loaded.
//
// Modes (the JAX model's reduced-precision switches, `Mode` below): kF32
// is the above. kBf16 (`x_dtype` bfloat16) rounds beta, x and the residual
// to bfloat16 as they are loaded: a bfloat16 value is exact in TF32 and
// the product of two is exact in float32, so one TF32 product per k-step
// computes what the JAX model computes (bf16 operands, float32 sums), with
// no lo passes. kResidBf16 (`resid_dtype` bfloat16 on a float32 design)
// rounds the residual alone, before product 2's 3xTF32 split. kF16 and
// kResidF16 are the same with float16 (`x_dtype`, `resid_dtype`
// "float16"): a float16 value, subnormals included, has at most 11
// significant bits, so TF32 holds it exactly too and a product of two is
// exact in float32.
//
// Fragment layouts (PTX ISA, m16n8k8 .tf32; lane = 4 g + t): A holds
// (row g | g+8, k t | t+4), B holds (k t | t+4, col g), C holds (row g | g+8,
// col 2t | 2t+1). The reduction index of a product may be permuted freely,
// so product 2 reads its k-step's rows in the order (2t, 2t+1) instead of
// (t, t+4): then the accumulator of product 1's n-tile j (chain g | g+8,
// rows 8j+2t, 8j+2t+1) is, element for element, the A operand of product
// 2's k-step j. The residuals go from product 1 to product 2 in registers.
//
// Shared-memory layout: x of a staged tile at xs[j * x_stride + k] (row j,
// column k; columns p .. x_stride-1 zero), y at ys[j], and the warp's beta
// rows at the same stride. The stride is 4 mod 8, so that the reads of
// product 1 (8 rows g at column k0 + t, for beta and x: banks 4g + t
// mod 32 in some order) and of product 2 (rows 2t, 2t+1 at column k0 + g:
// banks 8t + g and 8t + 4 + g, in some order) fall in 32 different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

namespace logistic_tile {

constexpr int kTileRows = 32;  // 4 n-tiles of product 1, 4 k-steps of 2

// Which operands are rounded, and to what; the numbers of the C interface.
enum Mode : int {
  kF32 = 0, kBf16 = 1, kResidBf16 = 2, kF16 = 3, kResidF16 = 4
};

// The modes that round every operand (one TF32 product, no lo passes),
// and those that round the residual alone.
__host__ __device__ constexpr bool rounds_operands(int mode) {
  return mode == kBf16 || mode == kF16;
}
__host__ __device__ constexpr bool rounds_resid_only(int mode) {
  return mode == kResidBf16 || mode == kResidF16;
}

// The row stride of a staged x tile: 8 * ksteps floats and 4 more, so 4
// mod 8.
__host__ __device__ constexpr int x_stride(int ksteps) {
  return 8 * ksteps + 4;
}

// tf32(v): round to nearest, ties away from zero, at 10 mantissa bits; the
// same value as `cvt.rna.tf32.f32`, in two integer operations instead of a
// conversion (a quarter-rate pipe).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// cp.async of one float from device to shared memory; `valid` false reads
// no bytes and zero-fills the destination
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// v rounded to bfloat16 (to nearest, ties to even, as torch's and JAX's
// casts), as a float32 value
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v rounded to the mode's reduced dtype (bfloat16 or float16, to nearest,
// ties to even), as a float32 value
template <int Mode>
__device__ __forceinline__ float round_mode(float v) {
  if constexpr (Mode == kF16 || Mode == kResidF16) {
    return __half2float(__float2half_rn(v));
  } else {
    return round_bf16(v);
  }
}

// An operand as the mode takes it: split into its TF32 parts, or rounded
// to bfloat16 or float16, which TF32 holds exactly (lo is then not used).
template <int Mode>
__device__ __forceinline__ void operand(float v, uint32_t& hi,
                                        uint32_t& lo) {
  if constexpr (rounds_operands(Mode)) {
    hi = __float_as_uint(round_mode<Mode>(v));
    lo = 0u;
  } else {
    split_tf32(v, hi, lo);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b at float32 accuracy: the two small terms, then the large one.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// One logit's share: adds y*l - w*softplus(l) to `lp` and returns the
// residual y - w*sigmoid(l); w is 0 on a padded row. One exp(-|l|) serves
// both softplus and sigmoid.
__device__ __forceinline__ float logit_term(float l, float y, float w,
                                            float& lp) {
  const float e = expf(-fabsf(l));
  const float softplus = fmaxf(l, 0.f) + log1pf(e);
  const float inv = 1.f / (1.f + e);
  const float sig = l >= 0.f ? inv : e * inv;
  lp += y * l - w * softplus;
  return y - w * sig;
}

// One staged tile through the warp's 16 chains. `bs` holds their beta,
// chain i at bs[i * x_stride + k] (columns p.. zero); `grad[nt]` accumulates
// product 2's C fragment at columns 8nt..8nt+7; `lp_g`, `lp_g8` this lane's
// share of lp of chains g and g+8. `rows` (<= kTileRows) rows are real.
//
// The tensor cores truncate where they add into the accumulator, so a long
// chain of mma on one accumulator drifts (on the 100-D model, 1.7e-3 on
// gradients of ~270 with one chain through all of n). Each product
// therefore runs short chains from zero and adds them in float32: product 1
// two k-steps at a time, product 2 one tile (32 rows) at a time.
template <int KSteps, int Mode = kF32>
__device__ __forceinline__ void warp_tile(const float* __restrict__ bs,
                                          const float* __restrict__ xs,
                                          const float* __restrict__ ys,
                                          int rows, float (&grad)[KSteps][4],
                                          float& lp_g, float& lp_g8) {
  constexpr int S = x_stride(KSteps);
  constexpr int kNT = kTileRows / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // product 1: logits of the tile's rows 8j + (0..7), n-tile j
  float logit[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) logit[j][i] = 0.f;
  }
#pragma unroll
  for (int ks0 = 0; ks0 < KSteps; ks0 += 2) {
    constexpr int kPair = 2;
    const int n_ks = ks0 + 1 < KSteps ? kPair : 1;
    // A fragments: beta of chain (g, g+8, g, g+8) at column (8ks+t, 8ks+t,
    // 8ks+t+4, 8ks+t+4)
    uint32_t a_hi[kPair][4], a_lo[kPair][4];
#pragma unroll
    for (int q = 0; q < kPair; ++q) {
      if (q < n_ks) {
        const float* br = bs + g * S + 8 * (ks0 + q) + t;
        operand<Mode>(br[0], a_hi[q][0], a_lo[q][0]);
        operand<Mode>(br[8 * S], a_hi[q][1], a_lo[q][1]);
        operand<Mode>(br[4], a_hi[q][2], a_lo[q][2]);
        operand<Mode>(br[8 * S + 4], a_hi[q][3], a_lo[q][3]);
      }
    }
    // the four n-tiles' chains side by side, so that the warp has four
    // independent mma in flight
    float d[kNT][4] = {};
#pragma unroll
    for (int q = 0; q < kPair; ++q) {
      if (q < n_ks) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* xr = xs + (8 * j + g) * S + 8 * (ks0 + q) + t;
          uint32_t b_hi[2], b_lo[2];
          operand<Mode>(xr[0], b_hi[0], b_lo[0]);
          operand<Mode>(xr[4], b_hi[1], b_lo[1]);
          if constexpr (rounds_operands(Mode)) {
            mma_tf32(d[j], a_hi[q], b_hi);
          } else {
            mma_3xtf32(d[j], a_hi[q], a_lo[q], b_hi, b_lo);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) logit[j][i] += d[j][i];
    }
  }

  // epilogue: n-tile j's residuals become product 2's A fragment at k-step
  // j, in the A order (g, k t = row r0), (g+8, r0), (g, k t+4 = row r0+1),
  // (g+8, r0+1), where r0 = 8j + 2t holds C elements 0, 2 and r0+1 holds 1, 3
  uint32_t r_hi[kNT][4], r_lo[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int r0 = 8 * j + 2 * t;
    const float y0 = ys[r0], y1 = ys[r0 + 1];
    const float w0 = r0 < rows ? 1.f : 0.f;
    const float w1 = r0 + 1 < rows ? 1.f : 0.f;
    float r[4];
    r[0] = logit_term(logit[j][0], y0, w0, lp_g);
    r[1] = logit_term(logit[j][2], y0, w0, lp_g8);
    r[2] = logit_term(logit[j][1], y1, w1, lp_g);
    r[3] = logit_term(logit[j][3], y1, w1, lp_g8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (rounds_resid_only(Mode)) r[i] = round_mode<Mode>(r[i]);
      operand<Mode>(r[i], r_hi[j][i], r_lo[j][i]);
    }
  }

  // product 2: the tile's share of every gradient column block nt, all
  // blocks' chains side by side
  float d[KSteps][4] = {};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int nt = 0; nt < KSteps; ++nt) {
      const float* xc = xs + (8 * j + 2 * t) * S + 8 * nt + g;
      uint32_t b_hi[2], b_lo[2];
      operand<Mode>(xc[0], b_hi[0], b_lo[0]);
      operand<Mode>(xc[S], b_hi[1], b_lo[1]);
      if constexpr (rounds_operands(Mode)) {
        mma_tf32(d[nt], r_hi[j], b_hi);
      } else {
        mma_3xtf32(d[nt], r_hi[j], r_lo[j], b_hi, b_lo);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < KSteps; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) grad[nt][i] += d[nt][i];
  }
}

}  // namespace logistic_tile

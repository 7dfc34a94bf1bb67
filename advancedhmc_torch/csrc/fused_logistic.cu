// Bernoulli-logit likelihood value and gradient for a batch of chains in one
// pass (kernel K1 of the port).
//
// Replaces the Pallas kernel advancedhmc_tpu/ops/fused_logistic.py:36
// (`_kernel`, wrapper `fused_logistic_value_grad` :53). For chains c and
// observations j, with beta_c = theta[c, 1:] (column 0 is the hierarchical
// log sigma, which is not in the likelihood):
//
//   logit[c, j] = beta_c . x[j]
//   lp[c]       = sum_j  y[j] * logit - softplus(logit)
//   grad[c, 0]  = 0
//   grad[c, 1:] = sum_j (y[j] - sigmoid(logit)) * x[j]
//
// Bound: two products of C x p x n multiply-adds, 4*C*p*n flops, against
// C*(dim + 1) floats in and out; at the sampler's shapes (C = 4096..32768,
// p = 99, n = 1000) that is about 4000 flops per byte, so the kernel is bound
// by the float32 rate of the CUDA cores. The TPU kernel's point was to keep
// the (C, n) logits out of device memory; this kernel does the same: a block
// owns kChains chains, walks the observations in tiles of kRows rows staged
// in shared memory, forms the logits, applies softplus and sigmoid in
// registers, and folds the residuals straight into the gradient
// accumulators. Only theta is read and lp, grad are written.
//
// Inputs and accumulation are float32 (the TPU kernel's bfloat16 inputs were
// a TPU default). Ragged edges are masked here: C need not be a multiple of
// kChains, n need not be a multiple of kRows.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 32;    // chains per block
constexpr int kRows = 64;      // observations per shared-memory tile
constexpr int kThreads = 256;
constexpr int kColChunk = 128;  // gradient columns per pass of phase 2

// x tile rows are padded to an odd stride so that the phase-1 reads of 16
// different rows at one column fall in 16 different banks.
__host__ __device__ inline int x_stride(int p) { return p | 1; }

__host__ __device__ inline size_t smem_floats(int p) {
  return (size_t)kChains * p             // th: theta rows without column 0
         + (size_t)kRows * x_stride(p)   // xs: x tile
         + kRows                         // ys: y tile
         + (size_t)kChains * (kRows + 1) // rs: residuals of the tile
         + (size_t)kChains * p;          // gs: gradient accumulators
}

__global__ void __launch_bounds__(kThreads)
fused_logistic_kernel(const float* __restrict__ theta,
                      const float* __restrict__ x,
                      const float* __restrict__ y, float* __restrict__ lp,
                      float* __restrict__ grad, int n_chains, int dim, int n) {
  extern __shared__ float smem[];
  const int p = dim - 1;
  const int xs_stride = x_stride(p);
  float* th = smem;
  float* xs = th + kChains * p;
  float* ys = xs + kRows * xs_stride;
  float* rs = ys + kRows;
  float* gs = rs + kChains * (kRows + 1);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kChains;

  for (int i = tid; i < kChains * p; i += kThreads) {
    const int c = i / p, k = i % p;
    const int gc = c0 + c;
    th[i] = gc < n_chains ? theta[(size_t)gc * dim + 1 + k] : 0.f;
    gs[i] = 0.f;
  }

  // Phase 1 tile: chains 2*cg, 2*cg+1 and rows rg + 16*q (q < 4).
  const int cg = tid / 16;
  const int rg = tid % 16;
  float ll0 = 0.f, ll1 = 0.f;
  // Phase 2 tile: chains 4*wc .. 4*wc+3 and columns lane + 32*m (m < 4) of
  // each kColChunk-wide chunk; each accumulator has exactly one owner.
  const int lane = tid % 32;
  const int wc = tid / 32;

  for (int j0 = 0; j0 < n; j0 += kRows) {
    const int rows = min(kRows, n - j0);
    __syncthreads();  // the previous tile is consumed; th, gs are staged
    for (int i = tid; i < kRows * p; i += kThreads) {
      const int j = i / p, k = i % p;
      xs[j * xs_stride + k] = j < rows ? x[(size_t)(j0 + j) * p + k] : 0.f;
    }
    if (tid < kRows) ys[tid] = tid < rows ? y[j0 + tid] : 0.f;
    __syncthreads();

    // Phase 1: logits, log likelihood and residuals of the tile.
    float acc[2][4] = {};
    const float* t0 = th + (2 * cg) * p;
    const float* t1 = t0 + p;
    for (int k = 0; k < p; ++k) {
      const float a0 = t0[k], a1 = t1[k];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xv = xs[(rg + 16 * q) * xs_stride + k];
        acc[0][q] = fmaf(a0, xv, acc[0][q]);
        acc[1][q] = fmaf(a1, xv, acc[1][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = rg + 16 * q;
      const float w = j < rows ? 1.f : 0.f;  // padded rows contribute 0
      const float yv = ys[j];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float l = acc[s][q];
        const float softplus = fmaxf(l, 0.f) + log1pf(expf(-fabsf(l)));
        const float sig = 1.f / (1.f + expf(-l));
        const float ll = yv * l - w * softplus;
        if (s == 0) ll0 += ll; else ll1 += ll;
        rs[(2 * cg + s) * (kRows + 1) + j] = yv - w * sig;
      }
    }
    __syncthreads();

    // Phase 2: grad += resid . x over the tile's rows.
    for (int k0 = 0; k0 < p; k0 += kColChunk) {
      float g[4][4] = {};
      for (int j = 0; j < rows; ++j) {
        float xv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = k0 + lane + 32 * m;
          xv[m] = k < p ? xs[j * xs_stride + k] : 0.f;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float r = rs[(4 * wc + s) * (kRows + 1) + j];
#pragma unroll
          for (int m = 0; m < 4; ++m) g[s][m] = fmaf(r, xv[m], g[s][m]);
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = k0 + lane + 32 * m;
          if (k < p) gs[(4 * wc + s) * p + k] += g[s][m];
        }
      }
    }
  }
  __syncthreads();

  // The 16 threads of a phase-1 chain pair are one half of a warp.
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    ll0 += __shfl_xor_sync(0xffffffffu, ll0, off);
    ll1 += __shfl_xor_sync(0xffffffffu, ll1, off);
  }
  if (rg == 0) {
    const int gc = c0 + 2 * cg;
    if (gc < n_chains) lp[gc] = ll0;
    if (gc + 1 < n_chains) lp[gc + 1] = ll1;
  }
  for (int i = tid; i < kChains * dim; i += kThreads) {
    const int c = i / dim, k = i % dim;
    const int gc = c0 + c;
    if (gc < n_chains) {
      grad[(size_t)gc * dim + k] = k == 0 ? 0.f : gs[c * p + k - 1];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for a given dim (bytes).
size_t fused_logistic_smem_bytes(int dim) {
  return smem_floats(dim - 1) * sizeof(float);
}

// theta (n_chains, dim), x (n, dim - 1), y (n,), lp (n_chains,),
// grad (n_chains, dim): contiguous float32 device arrays. Launches on
// `stream` and returns the CUDA error code of the launch (0 on success).
int fused_logistic_value_grad_f32(const float* theta, const float* x,
                                  const float* y, float* lp, float* grad,
                                  int n_chains, int dim, int n, void* stream) {
  if (n_chains <= 0) return 0;
  const size_t smem = fused_logistic_smem_bytes(dim);
  cudaError_t err = cudaFuncSetAttribute(
      fused_logistic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported again later
    return (int)err;
  }
  const int blocks = (n_chains + kChains - 1) / kChains;
  fused_logistic_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      theta, x, y, lp, grad, n_chains, dim, n);
  return (int)cudaGetLastError();
}

const char* fused_logistic_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

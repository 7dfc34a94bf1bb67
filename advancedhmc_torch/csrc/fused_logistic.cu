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
// With `link` Poisson (the C entry's `link`, logistic_tile.cuh `Link`; 0
// is the Bernoulli-logit above) the counts y take a Poisson-log likelihood
// with the scalar offset c (`offset`) in place of the logistic's terms:
//
//   lp[c]       = sum_j  y[j] * logit - exp(c + logit)
//   grad[c, 1:] = sum_j (y[j] - exp(c + logit)) * x[j]
//
// The link changes the epilogue alone: the products, tiles and sums are
// the same. The narrow instances are compiled for each link: their
// epilogue runs inside the tile loop, once per 32 rows, in a kernel held
// at four blocks an SM with registers at the limit and a few spilled, so
// a run-time branch there would change the logistic instances' registers
// and schedule; compiled apart, the logistic instances are the code they
// were, bit for bit and in time. The wide path's stage A picks the link
// at run time, in its epilogue once per 128 x 128 tile after the main
// loop, where the branch costs nothing. The Poisson link has instances in
// kF32 and kBf16 only; another mode refuses it (cudaErrorInvalidValue).
//
// With `prior` on (the C entry's flag; the kernels take p = dim - 1 as
// `prior_p`, 0 when off) a call adds the hierarchical prior of the
// model (log sigma ~ N(0, 1), beta ~ N(0, sigma^2 I)) at ls = theta[c, 0]
// and the unrounded beta, in every mode (`prior_of` below):
//
//   inv_s2 = exp(-2 ls),  bsq = sum_k beta_k^2
//   lp[c]      += -ls^2 / 2 - bsq * inv_s2 / 2 - p * ls
//   grad[c, 0]  = -ls + bsq * inv_s2 - p
//   grad[c, k] -= beta_k * inv_s2                                (k >= 1)
//
// inside the same launches: the narrow instances sum bsq from the beta
// they hold in shared memory and add the terms where they write the
// outputs; the wide path's stage A sums bsq from the theta tiles it
// streams, stage B adds the terms in its epilogue. So the model's
// value+grad is K1 and nothing else: no (C, dim) pass outside it.
//
// Bound: two products of C x p x n multiply-adds against C*(dim + 1) floats
// in and out; at the sampler's shapes (C = 4096..32768, p = 99, n = 1000)
// some 4000 flops per byte, so the kernel is bound by its arithmetic. At
// float32 accuracy on the tensor cores (3xTF32, logistic_tile.cuh) that is
// 3 * 4*C*p*n operations at the TF32 rate (495 TFLOP/s dense); one exp and
// one log1p per logit on the CUDA cores are a second, lower floor.
//
// Design. A block of kWarps warps owns kChains = 16 * kWarps chains, a warp
// 16 of them, with their beta in shared memory and their gradient in
// registers as product 2's accumulators. The block walks its
// rows in tiles of 32, staged in shared memory by cp.async into two buffers:
// the next tile loads while the warps multiply the current one. Like the
// TPU kernel it keeps the (C, n) logits out of device memory: they live in
// registers from product 1 to the residuals that feed product 2. Both
// products run short mma chains added in float32, since the tensor cores
// truncate where they accumulate (logistic_tile.cuh). A block
// reads the design matrix once for its 64 chains (C/64 * n*p*4 bytes of L2
// reads per call: 203 MB at C = 32768, 25 MB at 4096).
//
// Filling the card. The rows are split across the blocks of a thread-block
// cluster (up to 8), enough that a small C still fills every block slot of
// the card (at C = 4096, 64 chain tiles x 8 = 512 blocks for 4 x 132
// slots). Each block leaves its
// partial lp and gradient in its shared memory; after a cluster barrier the
// cluster's blocks sum the partials of every rank in rank order through
// distributed shared memory and write the result. No atomics: identical
// inputs give identical bits.
//
// Inputs and sums are float32 (the TPU kernel's bfloat16 inputs were a TPU
// default). Ragged C and n are masked here.
//
// Modes (logistic_tile.cuh `Mode`), the JAX model's reduced-precision
// switches: kF32 as above; kBf16 (`x_dtype="bfloat16"`) rounds theta, x
// and the residual to bfloat16 where they are loaded into registers and
// runs one TF32 product where kF32 runs three, which is exact for such
// operands: what the JAX model, and the Pallas kernel, which always casts
// theta and the residual to bfloat16, compute; kResidBf16
// (`resid_dtype="bfloat16"`) rounds the residual alone; kF16 and kResidF16
// are the same with float16, which TF32 holds exactly as well. Each mode
// is its own set of instances. The narrow kernel takes p up to
// 8 * 16 = 128: the gradient's columns are compiled into register arrays
// (KSteps instances).
//
// A wider p goes to the wide path (section "wide kernel" below): both
// products as pipelined wgmma GEMMs, in two launches, their B operands fed
// by TMA from a design the wrapper lays out once per model.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>
#include <mutex>

#include "logistic_tile.cuh"

namespace cg = cooperative_groups;
using logistic_tile::cp_async4;
using logistic_tile::cp_async_commit;
using logistic_tile::cp_async_wait;
using logistic_tile::kBf16;
using logistic_tile::kF16;
using logistic_tile::kF32;
using logistic_tile::kLogistic;
using logistic_tile::kPoisson;
using logistic_tile::kResidBf16;
using logistic_tile::kResidF16;
using logistic_tile::rounds_operands;
using logistic_tile::kTileRows;
using logistic_tile::x_stride;

namespace {

// The hierarchical prior's terms of one chain at ls = log sigma, with bsq
// the sum of its p beta_k^2: inv_s2 scales the beta gradient, lp and g0 are
// the log density and its derivative in ls. Each product and sum is
// rounded as the model's PyTorch prior rounds it (no contraction into
// fma), and expf is the accurate one (no fast math), so non-finite values
// propagate as they do there.
struct Prior {
  float inv_s2, lp, g0;
};

__device__ __forceinline__ Prior prior_of(float ls, float bsq, float p) {
  Prior r;
  r.inv_s2 = expf(-2.f * ls);
  const float t = __fmul_rn(bsq, r.inv_s2);
  r.lp = __fsub_rn(__fsub_rn(-0.5f * __fmul_rn(ls, ls), 0.5f * t),
                   __fmul_rn(p, ls));
  r.g0 = __fsub_rn(__fadd_rn(-ls, t), p);
  return r;
}

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChains = 16 * kWarps;  // chains per block
constexpr int kMaxSplit = 8;          // blocks per cluster (portable limit)
constexpr int kMaxKSteps = 16;        // p <= 128

__host__ __device__ constexpr size_t smem_floats(int ksteps) {
  // beta of the block's chains, two staged tiles of x, two of y; after the
  // loop the x tiles hold the block's partial gradient (kChains x 8*ksteps)
  // and the y tiles its partial lp (kChains)
  return (size_t)(kChains + 2 * kTileRows) * x_stride(ksteps) +
         2 * kTileRows;
}

// Four blocks per SM: at most 128 registers a thread, 4 x 55.5 KB of shared
// memory at p = 99. The kernel is bound by latency more than by any one
// unit, so it gains more from the fourth block than it loses to a few
// spilled registers.
template <int KSteps, int Mode, int Link>
__global__ void __launch_bounds__(kThreads, 4)
fused_logistic_kernel(const float* __restrict__ theta,
                      const float* __restrict__ x,
                      const float* __restrict__ y, float* __restrict__ lp,
                      float* __restrict__ grad, int n_chains, int dim, int n,
                      int prior_p, float offset) {
  constexpr int S = x_stride(KSteps);
  constexpr int P8 = 8 * KSteps;
  // after the tiles the x buffers hold the partial gradient and, in the
  // columns its rows leave, the prior's terms of each chain
  static_assert(2 * kTileRows * S >= kChains * P8 + kChains * 3,
                "the prior's terms fit beside the partial gradient");
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                        // [kChains][S]
  float* xs = bs + kChains * S;            // [2][kTileRows][S]
  float* ys = xs + 2 * kTileRows * S;      // [2][kTileRows]

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c0 = (int)(blockIdx.x / n_ranks) * kChains;
  const int p = dim - 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // this rank's row tiles
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int tile_begin = rank * n_tiles / n_ranks;
  const int tile_end = (rank + 1) * n_tiles / n_ranks;

  // columns p .. S-1 of beta and of both x buffers stay zero (cp.async
  // never writes them)
  for (int i = tid; i < (kChains + 2 * kTileRows) * (S - p); i += kThreads) {
    bs[(i / (S - p)) * S + p + i % (S - p)] = 0.f;
  }

  // beta of the block's chains (zero past n_chains), as the first group of
  // copies
  for (int r = warp; r < kChains; r += kWarps) {
    const bool valid = c0 + r < n_chains;
    const float* src = theta + (size_t)(valid ? c0 + r : 0) * dim + 1;
    for (int k = lane; k < p; k += 32) cp_async4(bs + r * S + k, src + k,
                                                 valid);
  }
  cp_async_commit();

  // stage tile `tile` into buffer `buf`: warps over rows, lanes over
  // columns; rows past n are zero-filled
  auto stage = [&](int tile, int buf) {
    const int j0 = tile * kTileRows;
    float* dst = xs + buf * kTileRows * S;
    for (int r = warp; r < kTileRows; r += kWarps) {
      const bool valid = j0 + r < n;
      const float* src = x + (size_t)(valid ? j0 + r : 0) * p;
      for (int k = lane; k < p; k += 32) cp_async4(dst + r * S + k, src + k,
                                                   valid);
    }
    if (tid < kTileRows) {
      const bool valid = j0 + tid < n;
      cp_async4(ys + buf * kTileRows + tid, y + (valid ? j0 + tid : 0),
                valid);
    }
    cp_async_commit();
  };

  float acc[KSteps][4];
#pragma unroll
  for (int nt = 0; nt < KSteps; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  }
  float lp_g = 0.f, lp_g8 = 0.f;

  if (tile_begin < tile_end) stage(tile_begin, 0);
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int buf = (tile - tile_begin) & 1;
    if (tile + 1 < tile_end) {
      stage(tile + 1, buf ^ 1);
      cp_async_wait<1>();  // this tile has landed, the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    logistic_tile::warp_tile<KSteps, Mode, Link>(
        bs + 16 * warp * S, xs + buf * kTileRows * S, ys + buf * kTileRows,
        min(kTileRows, n - tile * kTileRows), acc, lp_g, lp_g8, offset);
    __syncthreads();  // the buffer is free for the tile after next
  }
  cp_async_wait<0>();  // beta's copies, where the rank had no tile

  // lp of chains g, g+8 over the 4 lanes t of the group, in a fixed order
  lp_g += __shfl_xor_sync(0xffffffffu, lp_g, 1);
  lp_g += __shfl_xor_sync(0xffffffffu, lp_g, 2);
  lp_g8 += __shfl_xor_sync(0xffffffffu, lp_g8, 1);
  lp_g8 += __shfl_xor_sync(0xffffffffu, lp_g8, 2);

  // the block's partials into its shared memory, once every warp is done
  // with the tiles (and with the zeroing above, where there were none)
  __syncthreads();
  float* part = xs;                       // [kChains][P8]
  float* part_lp = ys;                    // [kChains]
  const int cw = 16 * warp + g;
#pragma unroll
  for (int nt = 0; nt < KSteps; ++nt) {
    const int k = 8 * nt + 2 * t;
    part[cw * P8 + k] = acc[nt][0];
    part[cw * P8 + k + 1] = acc[nt][1];
    part[(cw + 8) * P8 + k] = acc[nt][2];
    part[(cw + 8) * P8 + k + 1] = acc[nt][3];
  }
  if (t == 0) {
    part_lp[cw] = lp_g;
    part_lp[cw + 8] = lp_g8;
  }
  // the prior's terms of the warp's 16 chains, from their unrounded beta in
  // bs: lanes over the columns, summed in a fixed order (every rank the
  // same bits, from its own copy of beta)
  Prior* pri = reinterpret_cast<Prior*>(part + kChains * P8);  // [kChains]
  if (prior_p != 0) {
    for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
      float s = 0.f;
      for (int k = lane; k < p; k += 32) s += bs[r * S + k] * bs[r * S + k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      if (lane == 0 && c0 + r < n_chains) {
        pri[r] = prior_of(__ldg(theta + (size_t)(c0 + r) * dim), s,
                          (float)prior_p);
      }
    }
  }
  cluster.sync();

  // every rank's partial at `at`, summed in rank order; the loads do not
  // wait for each other
  auto sum_ranks = [&](float* base, int at) {
    float part_q[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) {
      part_q[q] = q < n_ranks ? cluster.map_shared_rank(base, q)[at] : 0.f;
    }
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) v += part_q[q];
    return v;
  };
  // the cluster's ranks share the outputs, each adding the prior's terms
  // to the elements it writes
  for (int i = rank * kThreads + tid; i < kChains * dim;
       i += n_ranks * kThreads) {
    const int c = i / dim, k = i % dim;
    if (c0 + c < n_chains) {
      float v = k > 0 ? sum_ranks(part, c * P8 + k - 1) : 0.f;
      if (prior_p != 0) {
        const Prior& pr = pri[c];
        v = k > 0 ? __fsub_rn(v, __fmul_rn(bs[c * S + k - 1], pr.inv_s2))
                  : pr.g0;
      }
      grad[(size_t)(c0 + c) * dim + k] = v;
    }
  }
  for (int c = rank * kThreads + tid; c < kChains; c += n_ranks * kThreads) {
    if (c0 + c < n_chains) {
      const float v = sum_ranks(part_lp, c);
      lp[c0 + c] = prior_p != 0 ? __fadd_rn(v, pri[c].lp) : v;
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// The instances, by k-steps of 8 columns: 13 is the 100-D model's p = 99.
// Blocks per cluster: enough row splits to fill the card's block slots, at
// most kMaxSplit and at most one per row tile.
int row_split(int n_chains, int n, int slots) {
  const int chain_tiles = (n_chains + kChains - 1) / kChains;
  const int row_tiles = (n + kTileRows - 1) / kTileRows;
  return std::max(1, std::min({slots / chain_tiles, kMaxSplit, row_tiles}));
}

// Sets the instance's attributes; gives the card's SMs and the instance's
// resident blocks per SM.
template <int KSteps, int Mode, int Link>
cudaError_t prepare(int* sms, int* per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  const size_t smem = smem_floats(KSteps) * sizeof(float);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_logistic_kernel<KSteps, Mode, Link>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err == cudaSuccess) {  // room for four blocks per SM
    err = cudaFuncSetAttribute(fused_logistic_kernel<KSteps, Mode, Link>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fused_logistic_kernel<KSteps, Mode, Link>, kThreads, smem);
  }
  return err;
}

template <int KSteps, int Mode, int Link>
cudaError_t launch(const float* theta, const float* x, const float* y,
                   float* lp, float* grad, int n_chains, int dim, int n,
                   int prior_p, float offset, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = prepare<KSteps, Mode, Link>(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_floats(KSteps) * sizeof(float);
  const int split = row_split(n_chains, n, sms * std::max(per_sm, 1));
  const int chain_tiles = (n_chains + kChains - 1) / kChains;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chain_tiles * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fused_logistic_kernel<KSteps, Mode, Link>,
                            theta, x, y, lp, grad, n_chains, dim, n, prior_p,
                            offset);
}

// The compiled instances of each mode and link, by k-steps of 8 columns:
// 13 is the 100-D model's p = 99. A call takes the smallest that holds its
// p.
struct Instance {
  int ksteps;
  cudaError_t (*prepare)(int*, int*);
  cudaError_t (*launch)(const float*, const float*, const float*, float*,
                        float*, int, int, int, int, float, cudaStream_t);
};
template <int Mode, int Link>
struct Instances {
  static constexpr Instance kAll[] = {
      {4, prepare<4, Mode, Link>, launch<4, Mode, Link>},
      {8, prepare<8, Mode, Link>, launch<8, Mode, Link>},
      {13, prepare<13, Mode, Link>, launch<13, Mode, Link>},
      {kMaxKSteps, prepare<kMaxKSteps, Mode, Link>,
       launch<kMaxKSteps, Mode, Link>},
  };
};
constexpr int kModes = 5;
constexpr int kLinks = 2;
// by link, then mode; none where the link has no instances in the mode
constexpr const Instance* kInstances[kLinks][kModes] = {
    {Instances<kF32, kLogistic>::kAll, Instances<kBf16, kLogistic>::kAll,
     Instances<kResidBf16, kLogistic>::kAll, Instances<kF16, kLogistic>::kAll,
     Instances<kResidF16, kLogistic>::kAll},
    {Instances<kF32, kPoisson>::kAll, Instances<kBf16, kPoisson>::kAll,
     nullptr, nullptr, nullptr}};
constexpr int kPerMode = 4;

// Whether the link has instances in the mode (the wide path takes the
// same pairs).
bool has_link(int mode, int link) {
  return mode >= 0 && mode < kModes && link >= 0 && link < kLinks &&
         kInstances[link][mode] != nullptr;
}

const Instance* instance_for(int dim, int mode, int link = kLogistic) {
  if (!has_link(mode, link)) return nullptr;
  for (int i = 0; i < kPerMode; ++i) {
    const Instance& inst = kInstances[link][mode][i];
    if (dim - 1 <= 8 * inst.ksteps) return &inst;
  }
  return nullptr;
}

// ------------------------------------------------------------ wide kernel
// p > 128: both products as GEMMs on Hopper's warpgroup tensor-core
// instructions (wgmma), their B operands fed by the tensor memory
// accelerator (TMA). Two launches a call, in stream order:
//
//   stage A  logits = beta . x^T, M = chains, N = rows, K = k_pad; the
//            epilogue writes each chain's lp partial of the row tile and
//            the residuals R (C, n_pad);
//   stage B  grad = R . x, M = chains, N = k_pad columns of theta, K =
//            n_pad rows; the blocks of column tile 0 also sum lp over the
//            row tiles in order.
//
// With the prior (prior_p > 0), stage A's consumers also sum the squares of
// the unrounded theta they split (log sigma's column left out), and its
// blocks of row tile 0 write each chain's bsq beside the lp partials;
// stage B's epilogue reads it with theta's column 0, writes grad[c, 0],
// subtracts theta[c, k] * inv_s2 from each gradient element and, in column
// tile 0, adds the prior's lp.
//
// B operands: the design's planes, laid out once per model by the wrapper
// (ops/fused_logistic.py `wide_layout`): x as (2, n_pad, k_pad), stage A's,
// and x^T as (2, k_pad, n_pad), stage B's (wgmma takes 32-bit operands only
// K-major), each the TF32 part hi and the float32 remainder lo. Column 0 of
// x (row 0 of x^T) is zero, so theta's column 0 (log sigma) drops out of
// the logits and grad[:, 0] is 0; rows past n and columns past dim are
// zero. Their TMA maps are encoded once (`fused_logistic_wide_prepare`).
//
// A operands: theta itself in stage A and R in stage B, in float32 (half
// the bytes of hi and lo planes), into shared memory by TMA as well where
// their rows are 16-byte aligned (R's always, theta's where dim is a
// multiple of 4; a map for each call), else by the producer warpgroup's
// cp.async, counted on the stage's barrier beside B's bytes; the consumers
// read their fragments from it into registers, split them into hi and lo
// there, and pass them to wgmma as its register operand (the RS form).
//
// A block is two consumer warpgroups (a 128 x 128 output tile, 64 rows a
// warpgroup, wgmma m64n128k8) and a producer warpgroup, one thread of
// which keeps B's stages full by TMA (K = 32 a stage, the 128-byte
// swizzle's row) and A's (or all of it copies A's), in a ring of kStages
// stages with an mbarrier pair each; the producer gives most of its
// registers to the consumers. Each stage runs the 3xTF32 products (lo.hi,
// hi.lo, then hi.hi) from zero into a register accumulator and, once that
// group is done, adds it into a float32 accumulator: the tensor cores
// truncate where they accumulate, so no sum runs longer than 32 of K inside
// them (the promotion). The bytes each SM takes in, not the tensor cores,
// set the pace (scripts/k1_wide_ablation.py), hence the tall tile (each B
// byte serves 128 chains) and A in float32. Where the tiles do not fill the
// card, the K range is split across the blocks of a cluster (up to
// kMaxSplit; 2 at C = 1024), whose partial tiles are summed in rank order
// through distributed shared memory. No atomics: identical inputs give
// identical bits.
//
// Bound at C = 1024, p = 999, n = 1000: 3 * 4 * C*p*n operations at the
// TF32 rate, 24.8 us. Each 128-chain tile reads the design's hi and lo
// planes once in each stage from L2 (~8 MB a stage at p = 999).
//
// Modes: in kBf16 the wrapper lays the design out rounded to bfloat16 (hi
// holds it exactly, lo is zero), the consumers round their A fragments
// (theta; R) to bfloat16 and issue only hi.hi, one wgmma a k-step; stage A
// of kBf16 and kResidBf16 rounds the residuals to bfloat16 as it writes R.
// kF16 and kResidF16 do the same with float16.
// The planes, the ring and the tiles are those of kF32 (the lo plane is
// still loaded: keeping the design in bf16 is later work).
namespace wide {

constexpr int kBM = 128;             // chains a tile: 64 a warpgroup
constexpr int kBN = 128;             // output columns a tile: wgmma N
constexpr int kBK = 32;              // K a stage: one 128-byte swizzle row
constexpr int kKSteps = kBK / 8;     // wgmma k-steps a stage
constexpr int kStages = 4;           // stages in the ring
constexpr int kMaxSplit = 8;         // split-K ranks a cluster (portable)
constexpr int kConsumers = 2 * kBM;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;    // and a producer warpgroup
// Registers a thread: 168 at launch (384 threads in 65,536), then the
// producer gives its share to the consumers (setmaxnreg); the two sums
// match, 128 x 40 + 256 x 232 = 384 x 168.
constexpr int kLaunchRegs = 168, kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs ==
                  kThreads * kLaunchRegs,
              "the registers the producer frees are the consumers' gain");
constexpr int kAcc = kBN / 2;        // accumulator floats a thread
constexpr uint32_t kBTile = kBN * kBK * 4;    // bytes of a plane's B tile
constexpr uint32_t kBBytes = 2 * kBTile;      // B's hi and lo: TMA's bytes
// A's tile of a stage, float32: by TMA in 128-byte rows with the 128-byte
// swizzle, or by cp.async in rows of kBK + 4 floats; either way the
// fragment reads of a warp (8 rows g at column t) fall in 32 different
// banks
constexpr int kAStride = kBK + 4;
constexpr uint32_t kATmaBytes = kBM * kBK * 4;
constexpr uint32_t kABytes = kBM * kAStride * 4;
constexpr uint32_t kStageBytes = kBBytes + kABytes;
constexpr int kEpiStride = kBN + 8;  // floats a row of the epilogue tile
constexpr size_t kSmemBytes = 1024 + (size_t)kStages * kStageBytes +
                              2 * kStages * sizeof(uint64_t);
constexpr int kMaxDevices = 64;
static_assert(kBK * 4 == 128, "a stage's row is one 128-byte swizzle row");
static_assert(kStageBytes % 1024 == 0, "every stage's B on 1024 bytes");
static_assert((size_t)kBM * kEpiStride * 4 <= (size_t)kStages * kStageBytes,
              "the epilogue tile fits in the ring");

// What the kernels read and write besides the operands' tensor maps.
struct Args {
  const float* a;      // the A operand: theta (stage A), R (stage B)
  int lda, k_valid;    // its row stride; columns from k_valid on read 0
  const float* y;      // (n,)
  float* resid;        // (C, n_pad): stage A writes, stage B reads
  float* lp_part;      // (n_tiles_a, C): stage A writes, stage B sums
  float* lp;           // (C,)
  float* grad;         // (C, dim)
  int n_chains, dim, n, n_pad, k_blocks, n_tiles_a;
  const float* theta;  // (C, dim): the prior's log sigma and beta
  float* bsq;          // (C,): stage A writes the prior's sum, stage B reads
  int prior_p;         // the prior's p, 0 = no prior
  int link;            // the likelihood (logistic_tile.cuh `Link`)
  float offset;        // the Poisson link's c
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that has not
// ended after 4 s is a fault: it traps (the launch fails with an error)
// rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 4000000000ull) {
      __trap();
    }
  }
}

// One box of a 3-D tensor map at (k, row, plane) into shared memory; its
// bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row), "r"(plane)
      : "memory");
}

// The wgmma descriptor of a K-major tile in shared memory with the 128-byte
// swizzle, as TMA writes it: rows of 128 bytes, 8-row groups 1024 bytes
// apart. A k-step of 8 floats further along K is 32 bytes on: 2 in the
// address field's 16-byte units.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that own it.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int r = 0; r < kAcc; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

// d (+)= A . B for a 64 x 128 tile and one k-step of 8: A's TF32 fragment
// in registers (a0 row g, a1 row g + 8 at column t; a2, a3 the same rows
// at column t + 4; g = lane / 4, t = lane % 4, rows of the warp's 16), B
// from shared memory; scale_d 0 writes, 1 adds.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The barrier counts one arrival once this thread's copies so far landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

// The producer warpgroup's share (thread p of 128) of a stage's A tile
// where its rows are not aligned for TMA: rows m0.. of the operand at
// columns k0 .. k0 + kBK - 1 into `dst` (rows of kAStride floats), zero
// past its rows and from column k_valid on.
__device__ __forceinline__ void copy_a(uint32_t dst, const Args& a, int m0,
                                       int k0, int p) {
  const int col = p % 32;
#pragma unroll 8
  for (int i = 0; i < kBM * kBK / 128; ++i) {
    const int row = p / 32 + 4 * i, c = m0 + row;
    const bool ok = c < a.n_chains && k0 + col < a.k_valid;
    cp_async4(dst + (row * kAStride + col) * 4,
              a.a + (ok ? (size_t)c * a.lda + k0 + col : 0), ok);
  }
}

// This lane's A fragments of a stage from its tile `as` (rows `row` and
// `row` + 8 at columns 8 kk + t and + 4; TMA's tile has rows of kBK floats
// whose 16-byte chunks are swizzled by the row mod 8, the copies' rows of
// kAStride), split into their TF32 part hi and the float32 remainder lo
// (the tensor cores read lo's TF32 part). With kSumSq, the squares of the
// unrounded values are added to sq (rows row, row + 8), but for column 0
// of the operand where `col0` (the stage holds K's first block).
template <bool kTmaA, int Mode, bool kSumSq>
__device__ __forceinline__ void split_stage(const float* as, int row,
                                            uint32_t (&hi)[kKSteps][4],
                                            uint32_t (&lo)[kKSteps][4],
                                            float (&sq)[2], bool col0) {
  const int t = threadIdx.x & 3;
  constexpr int stride = kTmaA ? kBK : kAStride;
  const int swz = kTmaA ? row & 7 : 0;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int chunk = (2 * kk + (i >> 1)) ^ swz;   // row + 8: same swizzle
      const float x = as[(row + 8 * (i & 1)) * stride + 4 * chunk + t];
      if constexpr (kSumSq) {   // column 8 kk + 4 (i >> 1) + t
        const float b = kk == 0 && i < 2 && col0 && t == 0 ? 0.f : x;
        sq[i & 1] += b * b;
      }
      if constexpr (rounds_operands(Mode)) {
        hi[kk][i] = __float_as_uint(logistic_tile::round_mode<Mode>(x));
      } else {
        hi[kk][i] = logistic_tile::to_tf32(x);
        lo[kk][i] = __float_as_uint(x - __uint_as_float(hi[kk][i]));
      }
    }
  }
}

// Keeps a stage's A fragments in their registers until its wgmma, which
// read them asynchronously, are done.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[kKSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
  }
}

// One stage's products into d as one wgmma group, from zero: for each
// k-step lo.hi, hi.lo, then hi.hi (the small terms first); in kBf16 and
// kF16 hi.hi alone.
template <int Mode>
__device__ __forceinline__ void issue_stage(float (&d)[kAcc],
                                            uint32_t (&hi)[kKSteps][4],
                                            uint32_t (&lo)[kKSteps][4],
                                            uint32_t st) {
  fence_frag(hi);
  if constexpr (!rounds_operands(Mode)) fence_frag(lo);
  fence_acc(d);
  wgmma_fence();
  const uint64_t b_hi = tile_desc(st), b_lo = tile_desc(st + kBTile);
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const uint64_t o = 2 * kk;
    const int add = kk == 0 ? 0 : 1;   // the first product writes d
    if constexpr (rounds_operands(Mode)) {
      wgmma_tf32(d, hi[kk], b_hi + o, add);
      continue;
    }
    wgmma_tf32(d, lo[kk], b_hi + o, add);
    wgmma_tf32(d, hi[kk], b_lo + o, 1);
    wgmma_tf32(d, hi[kk], b_hi + o, 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void promote(float (&acc)[kAcc],
                                        float (&d)[kAcc]) {
  fence_acc(d);
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] += d[r];
}

// The epilogue of a tile: this rank's rows (kBM / split of them), each
// element the ranks' partial sums added in rank order. Threads share a row
// (2 * split of them), each takes every (2 * split)-th 4 columns. Stage A
// turns logits into residuals and lp partials under `Link`, stage B writes
// the gradient and, in column tile 0, lp.
template <int kStage, int Mode, int Link>
__device__ __forceinline__ void epilogue(cg::cluster_group& cluster,
                                         float* epi, int split, int rank,
                                         int m0, int n0, const Args& a) {
  const int tid = threadIdx.x;
  const int rows = kBM / split, tpr = kConsumers / rows;
  const int row = rank * rows + tid / tpr, q = tid % tpr;
  const int c = m0 + row;
  const bool chain_ok = c < a.n_chains;
  const bool prior = a.prior_p != 0 && chain_ok;
  Prior pr = {0.f, 0.f, 0.f};
  if constexpr (kStage == 1) {
    if (prior) {
      pr = prior_of(__ldg(a.theta + (size_t)c * a.dim), a.bsq[c],
                    (float)a.prior_p);
    }
  }
  float lp = 0.f;
  for (int col = 4 * q; col < kBN; col += 4 * tpr) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < split; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(epi, r) + row * kEpiStride +
          col);
      v[0] += u.x;
      v[1] += u.y;
      v[2] += u.z;
      v[3] += u.w;
    }
    const int j = n0 + col;
    if constexpr (kStage == 0) {
      // rows j.. j+3 of the design: residuals and lp terms (rows past n
      // weigh 0 and have y 0, so their residual is 0)
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = j + e < a.n;
        r[e] = logistic_tile::link_term<Link>(
            v[e], in ? __ldg(a.y + j + e) : 0.f, in ? 1.f : 0.f, a.offset,
            lp);
        if constexpr (Mode != kF32) {
          r[e] = logistic_tile::round_mode<Mode>(r[e]);
        }
      }
      if (chain_ok && j < a.n_pad) {
        *reinterpret_cast<float4*>(a.resid + (size_t)c * a.n_pad + j) =
            make_float4(r[0], r[1], r[2], r[3]);
      }
    } else {
      if (prior) {
        float* out = a.grad + (size_t)c * a.dim;
        const float* th = a.theta + (size_t)c * a.dim;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < a.dim) {
            out[j + e] = j + e == 0 ? pr.g0
                                    : __fsub_rn(v[e], __fmul_rn(
                                          __ldg(th + j + e), pr.inv_s2));
          }
        }
      } else if (chain_ok) {
        float* out = a.grad + (size_t)c * a.dim;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < a.dim) out[j + e] = j + e == 0 ? 0.f : v[e];
        }
      }
    }
  }
  if constexpr (kStage == 0) {
    // the row's lp over its threads, in a fixed order
    for (int o = 1; o < tpr; o <<= 1) {
      lp += __shfl_xor_sync(0xffffffffu, lp, o);
    }
    if (q == 0 && chain_ok) {
      a.lp_part[(size_t)(n0 / kBN) * a.n_chains + c] = lp;
    }
    if (n0 == 0 && q == 0 && prior) {
      // the row's sum of squares over the ranks' K ranges, in rank order,
      // from the epilogue tile's column kBN
      float s = 0.f;
      for (int r = 0; r < split; ++r) {
        s += cluster.map_shared_rank(epi, r)[row * kEpiStride + kBN];
      }
      a.bsq[c] = s;
    }
  } else {
    if (n0 == 0 && q == 0 && chain_ok) {
      float s = 0.f;
      for (int t = 0; t < a.n_tiles_a; ++t) {
        s += a.lp_part[(size_t)t * a.n_chains + c];
      }
      a.lp[c] = prior ? __fadd_rn(s, pr.lp) : s;
    }
  }
}

// Stage A (kStage 0) or B (1): the 128 x 128 output tile (blockIdx.y,
// blockIdx.x / split), whose K blocks the cluster's `split` ranks share
// (small C). b_map holds the B planes (2, N, K) in boxes of both planes'
// kBN rows; kTmaA: A comes by TMA from a_map (boxes of kBM rows), else the
// producer warpgroup copies it.
template <int kStage, bool kTmaA, int Mode>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap b_map,
            const __grid_constant__ CUtensorMap a_map, const Args args) {
  extern __shared__ unsigned char smem_raw[];
  // the ring starts on 1024 bytes, the 128-byte swizzle's period
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  float* epi = reinterpret_cast<float*>(ring);   // after the main loop

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (int)(blockIdx.x / split) * kBN;
  const int m0 = (int)blockIdx.y * kBM;
  const int kb0 = rank * args.k_blocks / split;
  const int nk = (rank + 1) * args.k_blocks / split - kb0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival and, where A is copied, the copies of the
      // 128 producer threads
      mbar_init(&full[s], kTmaA ? 1 : 1 + 128);
      // every consumer warp frees it
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the barriers are ready before any thread uses them
  cluster.sync();

  if (warp >= kConsumers / 32) {
    // producer: one thread keeps the ring full. The branches do not meet
    // again (each ends in its own cluster barriers), so that the register
    // counts hold.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    const int p = tid - kConsumers;
    constexpr bool copies = !kTmaA;   // A by the warpgroup's cp.async
    for (int it = 0; it < nk && (p == 0 || copies); ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      unsigned char* st = ring + s * kStageBytes;
      const int k = (kb0 + it) * kBK;
      if (p == 0) {
        mbar_expect_tx(&full[s], kBBytes + (copies ? 0 : kATmaBytes));
        if (!copies) tma_load(st + kBBytes, &a_map, &full[s], k, m0, 0);
        tma_load(st, &b_map, &full[s], k, n0, 0);   // both planes
      }
      if (copies) {
        copy_a(smem_u32(st + kBBytes), args, m0, k, p);
        cp_async_arrive(&full[s]);
      }
    }
    cluster.sync();   // as the consumers' two barriers below
    cluster.sync();
    return;
  }
  {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    // consumers: the lane's A rows (of warpgroup warp / 4's 64) are rows
    // 16 warp + g and + 8 of the tile; a stage's products go into d and
    // then into acc
    const int row = 16 * warp + lane / 4;
    float acc[kAcc], d[kAcc];
    uint32_t hi[kKSteps][4], lo[kKSteps][4];
    // stage A: the rows' sums of theta^2 for the prior, as the fragments
    // are split, in every block (a gate on the blocks that write them
    // spills more and costs more than the adds)
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kAcc; ++r) acc[r] = d[r] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      unsigned char* st = ring + s * kStageBytes;
      split_stage<kTmaA, Mode, kStage == 0>(
          reinterpret_cast<const float*>(st + kBBytes), row, hi, lo, sq,
          kb0 + it == 0);
      issue_stage<Mode>(d, hi, lo, smem_u32(st));
      wgmma_wait();
      fence_frag(hi);
      if constexpr (!rounds_operands(Mode)) fence_frag(lo);
      promote(acc, d);
      if (lane == 0) mbar_arrive(&empty[s]);   // stage s is free
    }
    // every wgmma of the warpgroups is done with the ring: the tile goes
    // into it, the wgmma C fragment layout (rows 16 warp + g, + 8; columns
    // 8 i + 2 (lane % 4), + 1)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    const int g = lane / 4, col0 = 2 * (lane % 4), erow = 16 * warp + g;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = 8 * i + col0;
      *reinterpret_cast<float2*>(epi + erow * kEpiStride + col) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(epi + (erow + 8) * kEpiStride + col) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
    if constexpr (kStage == 0) {
      // the rows' sums of squares over the quad's lanes, in a fixed order,
      // into the tile's spare column kBN
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
        sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
      }
      if (lane % 4 == 0) {
        epi[erow * kEpiStride + kBN] = sq[0];
        epi[(erow + 8) * kEpiStride + kBN] = sq[1];
      }
    }
  }
  // every rank's partial tile is in its shared memory
  cluster.sync();
  if (kStage == 0 && args.link == kPoisson) {
    epilogue<kStage, Mode, kPoisson>(cluster, epi, split, rank, m0, n0,
                                     args);
  } else {
    epilogue<kStage, Mode, kLogistic>(cluster, epi, split, rank, m0, n0,
                                      args);
  }
  cluster.sync();   // no block leaves while another reads its tile
}

// ---- host side
// A prepared design, kept in a buffer the caller owns (the wrapper's
// prepared layout): the TMA maps of its x and x^T planes and its shape.
struct Design {
  unsigned char x_map[sizeof(CUtensorMap)];    // (2, n_pad, k_pad)
  unsigned char xt_map[sizeof(CUtensorMap)];   // (2, k_pad, n_pad)
  int n, dim, n_pad, k_pad;
};

int round_up(int v, int to) { return (v + to - 1) / to * to; }
int n_pad_of(int n) { return round_up(std::max(n, 1), kBK); }

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (the
// library does not link libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of `planes` planes (planes, rows, inner) of floats at `base`,
// `inner` a multiple of 4: boxes of kBK x box_rows x box_planes with the
// 128-byte swizzle; what lies outside reads as zero.
cudaError_t encode_map(CUtensorMap* map, const float* base, int inner,
                       int rows, int planes, int box_rows, int box_planes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 4,
                                 (cuuint64_t)inner * rows * 4};
  const cuuint32_t box[3] = {kBK, (cuuint32_t)box_rows,
                             (cuuint32_t)box_planes};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Once per device and mode: the kernels' attributes, the SMs, blocks per SM
// and the clusters of each size the card can hold at once.
struct DeviceSetup {
  bool ready;
  cudaError_t err;
  int sms, per_sm;
  int clusters[2][kMaxSplit + 1];
};
std::mutex g_setup_mutex;
DeviceSetup g_setup[kMaxDevices][kModes];

// Stage B's instance for a mode: kResidBf16's R is already rounded, so its
// products are kF32's.
__host__ __device__ constexpr int stage_b_mode(int mode) {
  return rounds_operands(mode) ? mode : kF32;
}

template <int kStage, bool kTmaA, int Mode>
cudaError_t setup_kernel(DeviceSetup& s) {
  // setmaxnreg's totals assume the kernel was compiled at kLaunchRegs; at
  // another count the consumers' request could wait forever
  cudaFuncAttributes fa;
  cudaError_t err =
      cudaFuncGetAttributes(&fa, gemm_kernel<kStage, kTmaA, Mode>);
  if (err == cudaSuccess && fa.numRegs != kLaunchRegs) {
    return cudaErrorInvalidKernelImage;
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gemm_kernel<kStage, kTmaA, Mode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
  }
  if (err == cudaSuccess && kStage == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &s.per_sm, gemm_kernel<kStage, kTmaA, Mode>, kThreads, kSmemBytes);
  }
  for (int size = 1; err == cudaSuccess && size <= kMaxSplit; size *= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(size);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(
        &s.clusters[kStage][size], gemm_kernel<kStage, kTmaA, Mode>, &cfg);
  }
  return err;
}

// A mode's three instances: stage A's two (A by TMA or copied), stage B's
// one.
template <int Mode>
cudaError_t setup_mode(DeviceSetup& s) {
  cudaError_t err = setup_kernel<0, false, Mode>(s);
  if (err == cudaSuccess) err = setup_kernel<0, true, Mode>(s);
  if (err == cudaSuccess) err = setup_kernel<1, true, stage_b_mode(Mode)>(s);
  return err;
}

const DeviceSetup* device_setup(int mode) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 ||
      device >= kMaxDevices || mode < 0 || mode >= kModes) {
    return nullptr;
  }
  std::lock_guard<std::mutex> lock(g_setup_mutex);
  DeviceSetup& s = g_setup[device][mode];
  if (!s.ready) {
    s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (s.err == cudaSuccess) {
      s.err = mode == kBf16       ? setup_mode<kBf16>(s)
              : mode == kResidBf16 ? setup_mode<kResidBf16>(s)
              : mode == kF16       ? setup_mode<kF16>(s)
              : mode == kResidF16  ? setup_mode<kResidF16>(s)
                                   : setup_mode<kF32>(s);
    }
    s.ready = true;
  }
  return &s;
}

// Ranks a cluster splits K over: the largest power of two up to kMaxSplit
// with which the tiles still fit on the card at once, each rank keeps a K
// block, and the card can place such a cluster.
int split_for(const DeviceSetup& s, int stage, int tiles, int k_blocks) {
  int split = 1;
  while (2 * split <= kMaxSplit && tiles * 2 * split <= s.sms &&
         2 * split <= k_blocks && s.clusters[stage][2 * split] > 0) {
    split *= 2;
  }
  return split;
}

struct Shape {
  int k_pad, n_pad, m_tiles, n_tiles_a, n_tiles_b, split_a, split_b;
};

Shape shape_of(const DeviceSetup& s, int n_chains, int dim, int n) {
  Shape sh;
  sh.k_pad = round_up(dim, kBK);
  sh.n_pad = n_pad_of(n);
  sh.m_tiles = (n_chains + kBM - 1) / kBM;
  sh.n_tiles_a = (sh.n_pad + kBN - 1) / kBN;
  sh.n_tiles_b = (sh.k_pad + kBN - 1) / kBN;
  sh.split_a = split_for(s, 0, sh.m_tiles * sh.n_tiles_a, sh.k_pad / kBK);
  sh.split_b = split_for(s, 1, sh.m_tiles * sh.n_tiles_b, sh.n_pad / kBK);
  return sh;
}

// the residuals (C, n_pad), the lp partials (row tiles, C) and the
// prior's sums of squares (C)
size_t scratch_floats(int n_chains, int n) {
  const int n_pad = n_pad_of(n);
  return (size_t)n_chains * n_pad +
         (size_t)((n_pad + kBN - 1) / kBN) * n_chains + n_chains;
}

template <int kStage, bool kTmaA, int Mode>
cudaError_t launch_gemm(const CUtensorMap& b_map, const CUtensorMap& a_map,
                        const Args& args, int m_tiles, int n_tiles,
                        int split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * split, m_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemm_kernel<kStage, kTmaA, Mode>, b_map,
                            a_map, args);
}

}  // namespace wide

// The wide path of a call in mode `Mode`: stage A, stage B on `stream`,
// each launch counted in `launches`. `design` is a prepared design of this
// x (fused_logistic_wide_prepare, laid out for the mode), `scratch` holds
// wide::scratch_floats(n_chains, n) floats.
template <int Mode>
cudaError_t launch_wide_mode(const void* design, const float* theta,
                        const float* y, float* lp, float* grad,
                        float* scratch, int n_chains, int dim, int n,
                        int prior_p, int link, float offset,
                        cudaStream_t stream, int* launches) {
  using namespace wide;
  if (design == nullptr || scratch == nullptr) return cudaErrorInvalidValue;
  Design d;
  std::memcpy(&d, design, sizeof d);
  if (d.dim != dim || d.n != n) return cudaErrorInvalidValue;
  const DeviceSetup* s = device_setup(Mode);
  if (s == nullptr) return cudaErrorInvalidDevice;
  if (s->err != cudaSuccess) return s->err;
  const Shape sh = shape_of(*s, n_chains, dim, n);
  float* resid = scratch;                                 // (C, n_pad)
  float* lp_part = resid + (size_t)n_chains * sh.n_pad;   // (tiles, C)
  float* bsq = lp_part + (size_t)sh.n_tiles_a * n_chains;  // (C)
  CUtensorMap x_map, xt_map, a_map;
  std::memcpy(&x_map, d.x_map, sizeof x_map);
  std::memcpy(&xt_map, d.xt_map, sizeof xt_map);
  cudaError_t err = cudaSuccess;
  {   // stage A: A = theta, K = its columns
    // theta by TMA where its rows are 16-byte aligned, else copied
    const bool tma = dim % 4 == 0 && (uintptr_t)theta % 16 == 0;
    a_map = x_map;        // (not read where theta is copied)
    if (tma) err = encode_map(&a_map, theta, dim, n_chains, 1, kBM, 1);
    const Args args = {theta, dim,     dim, y,    resid,
                       lp_part, lp,    grad, n_chains, dim,
                       n,     sh.n_pad, sh.k_pad / kBK, sh.n_tiles_a,
                       theta, bsq,   prior_p, link, offset};
    if (err == cudaSuccess) {
      err = (tma ? launch_gemm<0, true, Mode> : launch_gemm<0, false, Mode>)(
          x_map, a_map, args, sh.m_tiles, sh.n_tiles_a, sh.split_a, stream);
    }
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  {   // stage B: A = R, K = the rows; its rows are aligned
    err = encode_map(&a_map, resid, sh.n_pad, n_chains, 1, kBM, 1);
    const Args args = {resid,   sh.n_pad, sh.n_pad, y,        resid,
                       lp_part, lp,       grad,     n_chains, dim,
                       n,       sh.n_pad, sh.n_pad / kBK, sh.n_tiles_a,
                       theta,   bsq,      prior_p, link, offset};
    if (err == cudaSuccess) {
      err = launch_gemm<1, true, stage_b_mode(Mode)>(
          xt_map, a_map, args, sh.m_tiles, sh.n_tiles_b, sh.split_b, stream);
    }
    if (err == cudaSuccess) ++*launches;
  }
  return err;
}

// The wide path of a call in `mode` (launch_wide_mode); an unknown mode,
// or a link the mode has no narrow instances of, is refused.
cudaError_t launch_wide(int mode, const void* design, const float* theta,
                        const float* y, float* lp, float* grad,
                        float* scratch, int n_chains, int dim, int n,
                        int prior_p, int link, float offset,
                        cudaStream_t stream, int* launches) {
  if (!has_link(mode, link)) return cudaErrorInvalidValue;
  switch (mode) {
    case kF32:
      return launch_wide_mode<kF32>(design, theta, y, lp, grad, scratch,
                                    n_chains, dim, n, prior_p, link, offset,
                                    stream, launches);
    case kBf16:
      return launch_wide_mode<kBf16>(design, theta, y, lp, grad, scratch,
                                     n_chains, dim, n, prior_p, link, offset,
                                     stream, launches);
    case kResidBf16:
      return launch_wide_mode<kResidBf16>(design, theta, y, lp, grad,
                                          scratch, n_chains, dim, n, prior_p,
                                          link, offset, stream, launches);
    case kF16:
      return launch_wide_mode<kF16>(design, theta, y, lp, grad, scratch,
                                    n_chains, dim, n, prior_p, link, offset,
                                    stream, launches);
    case kResidF16:
      return launch_wide_mode<kResidF16>(design, theta, y, lp, grad,
                                         scratch, n_chains, dim, n, prior_p,
                                         link, offset, stream, launches);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for a given dim (bytes): the narrow
// instance's up to dim 129, the wide kernels' (stages A and B) beyond.
size_t fused_logistic_smem_bytes(int dim) {
  const Instance* inst = instance_for(dim, kF32);
  return inst ? smem_floats(inst->ksteps) * sizeof(float) : wide::kSmemBytes;
}

// Resident blocks per SM and blocks per cluster (the narrow instances' row
// splits per chain tile; the wide path's stage A split-K ranks) for a call's
// shape and mode on the current device; 0 and 0 if that fails.
void fused_logistic_launch_shape(int n_chains, int dim, int n, int mode,
                                 int* per_sm, int* split) {
  const Instance* inst = instance_for(dim, mode);
  int sms = 0;
  *per_sm = *split = 0;
  if (inst) {
    if (inst->prepare(&sms, per_sm) == cudaSuccess) {
      *split = row_split(n_chains, n, sms * std::max(*per_sm, 1));
      return;
    }
  } else {
    const wide::DeviceSetup* s = wide::device_setup(mode);
    if (s != nullptr && s->err == cudaSuccess) {
      *per_sm = s->per_sm;
      *split = wide::shape_of(*s, n_chains, dim, n).split_a;
      return;
    }
  }
  cudaGetLastError();
  *per_sm = *split = 0;
}

// The wide path's launch shape for a call (p > 128), on the current
// device: out[0..1] stage A's blocks and split-K ranks a cluster, out[2..3]
// stage B's, out[4] resident blocks per SM, out[5] shared memory bytes a
// block, out[6] threads a block, out[7] chain tiles, out[8..9] the output
// column tiles of stages A and B, for a mode. Returns the CUDA error code.
int fused_logistic_wide_shape(int n_chains, int dim, int n, int mode,
                              int* out) {
  const wide::DeviceSetup* s = wide::device_setup(mode);
  if (s == nullptr) return (int)cudaErrorInvalidDevice;
  if (s->err != cudaSuccess) return (int)s->err;
  const wide::Shape sh = wide::shape_of(*s, n_chains, dim, n);
  out[0] = sh.m_tiles * sh.n_tiles_a * sh.split_a;
  out[1] = sh.split_a;
  out[2] = sh.m_tiles * sh.n_tiles_b * sh.split_b;
  out[3] = sh.split_b;
  out[4] = s->per_sm;
  out[5] = (int)wide::kSmemBytes;
  out[6] = wide::kThreads;
  out[7] = sh.m_tiles;
  out[8] = sh.n_tiles_a;
  out[9] = sh.n_tiles_b;
  return 0;
}

// Bytes of a prepared design (the buffer fused_logistic_wide_prepare fills).
size_t fused_logistic_wide_design_bytes() { return sizeof(wide::Design); }

// Floats of the per-call scratch of the wide path: the residuals, the lp
// partials and the prior's sums of squares.
size_t fused_logistic_wide_scratch_floats(int n_chains, int n) {
  return wide::scratch_floats(n_chains, n);
}

// Prepares the design of an (n, dim - 1) x for the wide path into `out`
// (fused_logistic_wide_design_bytes): the TMA maps of its planes, laid out
// by the wrapper as `planes` (2, n_pad, k_pad) and `t_planes` (2, k_pad,
// n_pad), contiguous float32 device arrays that must outlive every call
// with this design. Returns the CUDA error code (0 on success).
int fused_logistic_wide_prepare(void* out, const float* planes,
                                const float* t_planes, int n, int dim,
                                int n_pad, int k_pad) {
  using namespace wide;
  if (n_pad != n_pad_of(n) || k_pad != round_up(dim, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  Design d = {};
  CUtensorMap map;
  cudaError_t err = encode_map(&map, planes, k_pad, n_pad, 2, kBN, 2);
  std::memcpy(d.x_map, &map, sizeof map);
  if (err == cudaSuccess) {
    err = encode_map(&map, t_planes, n_pad, k_pad, 2, kBN, 2);
  }
  std::memcpy(d.xt_map, &map, sizeof map);
  d.n = n;
  d.dim = dim;
  d.n_pad = n_pad;
  d.k_pad = k_pad;
  std::memcpy(out, &d, sizeof d);
  return (int)err;
}

// theta (n_chains, dim), x (n, dim - 1), y (n,), lp (n_chains,),
// grad (n_chains, dim): contiguous float32 device arrays; `mode` kF32,
// kBf16, kResidBf16, kF16 or kResidF16 (logistic_tile.cuh); `prior` 0
// for the likelihood alone, or 1 to add the hierarchical prior at
// p = dim - 1 (the header's formula) in the same launches; `link`
// kLogistic or kPoisson (logistic_tile.cuh; kPoisson in kF32 and kBf16
// only), `offset` the Poisson link's c (not read by the logistic). For
// dim > 129
// also `design` (fused_logistic_wide_prepare, of this x laid out for the
// mode) and `scratch` (fused_logistic_wide_scratch_floats floats); the
// narrow instances take neither. Launches on `stream`, writes the number of
// kernels it launched to `launches` (one narrow instance, or the wide
// path's two GEMMs) and returns the CUDA error code of the launches (0 on
// success).
int fused_logistic_value_grad_f32(const float* theta, const float* x,
                                  const float* y, float* lp, float* grad,
                                  int n_chains, int dim, int n, int mode,
                                  int prior, int link, float offset,
                                  const void* design, float* scratch,
                                  void* stream, int* launches) {
  *launches = 0;
  if (n_chains <= 0) return 0;
  const int prior_p = prior ? dim - 1 : 0;
  // p <= 128 takes the narrow instance that holds it, a wider p the wide
  // kernels (which refuse a link the mode has no instances of)
  const Instance* inst = instance_for(dim, mode, link);
  const cudaError_t err =
      inst ? inst->launch(theta, x, y, lp, grad, n_chains, dim, n, prior_p,
                          offset, (cudaStream_t)stream)
           : launch_wide(mode, design, theta, y, lp, grad, scratch, n_chains,
                         dim, n, prior_p, link, offset, (cudaStream_t)stream,
                         launches);
  if (inst && err == cudaSuccess) *launches = 1;
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported again later
    return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* fused_logistic_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

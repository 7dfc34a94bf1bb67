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
// default). Ragged C and n are masked here. p is at most 8 * 16 = 128: the
// gradient's columns are compiled into register arrays (KSteps instances).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "logistic_tile.cuh"

namespace cg = cooperative_groups;
using logistic_tile::cp_async4;
using logistic_tile::cp_async_commit;
using logistic_tile::cp_async_wait;
using logistic_tile::kTileRows;
using logistic_tile::x_stride;

namespace {

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
template <int KSteps>
__global__ void __launch_bounds__(kThreads, 4)
fused_logistic_kernel(const float* __restrict__ theta,
                      const float* __restrict__ x,
                      const float* __restrict__ y, float* __restrict__ lp,
                      float* __restrict__ grad, int n_chains, int dim, int n) {
  constexpr int S = x_stride(KSteps);
  constexpr int P8 = 8 * KSteps;
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
    logistic_tile::warp_tile<KSteps>(
        bs + 16 * warp * S, xs + buf * kTileRows * S, ys + buf * kTileRows,
        min(kTileRows, n - tile * kTileRows), acc, lp_g, lp_g8);
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
  // the cluster's ranks share the outputs
  for (int i = rank * kThreads + tid; i < kChains * dim;
       i += n_ranks * kThreads) {
    const int c = i / dim, k = i % dim;
    if (c0 + c < n_chains) {
      grad[(size_t)(c0 + c) * dim + k] =
          k > 0 ? sum_ranks(part, c * P8 + k - 1) : 0.f;
    }
  }
  for (int c = rank * kThreads + tid; c < kChains; c += n_ranks * kThreads) {
    if (c0 + c < n_chains) lp[c0 + c] = sum_ranks(part_lp, c);
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
template <int KSteps>
cudaError_t prepare(int* sms, int* per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  const size_t smem = smem_floats(KSteps) * sizeof(float);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_logistic_kernel<KSteps>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err == cudaSuccess) {  // room for four blocks per SM
    err = cudaFuncSetAttribute(fused_logistic_kernel<KSteps>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fused_logistic_kernel<KSteps>, kThreads, smem);
  }
  return err;
}

template <int KSteps>
cudaError_t launch(const float* theta, const float* x, const float* y,
                   float* lp, float* grad, int n_chains, int dim, int n,
                   cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = prepare<KSteps>(&sms, &per_sm);
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
  return cudaLaunchKernelEx(&cfg, fused_logistic_kernel<KSteps>, theta, x, y,
                            lp, grad, n_chains, dim, n);
}

// The compiled instances, by k-steps of 8 columns: 13 is the 100-D model's
// p = 99. A call takes the smallest that holds its p.
struct Instance {
  int ksteps;
  cudaError_t (*prepare)(int*, int*);
  cudaError_t (*launch)(const float*, const float*, const float*, float*,
                        float*, int, int, int, cudaStream_t);
};
constexpr Instance kInstances[] = {
    {4, prepare<4>, launch<4>},
    {8, prepare<8>, launch<8>},
    {13, prepare<13>, launch<13>},
    {kMaxKSteps, prepare<kMaxKSteps>, launch<kMaxKSteps>},
};

const Instance* instance_for(int dim) {
  for (const Instance& inst : kInstances) {
    if (dim - 1 <= 8 * inst.ksteps) return &inst;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// The largest dim (p + 1) the kernel takes.
int fused_logistic_max_dim() { return 8 * kMaxKSteps + 1; }

// Dynamic shared memory of one block for a given dim (bytes), 0 if the
// kernel does not take that dim.
size_t fused_logistic_smem_bytes(int dim) {
  const Instance* inst = instance_for(dim);
  return inst ? smem_floats(inst->ksteps) * sizeof(float) : 0;
}

// Resident blocks per SM and blocks per cluster (row splits per chain tile)
// for a call's shape on the current device; 0 and 0 if that fails.
void fused_logistic_launch_shape(int n_chains, int dim, int n, int* per_sm,
                                 int* split) {
  const Instance* inst = instance_for(dim);
  int sms = 0;
  *per_sm = *split = 0;
  if (!inst || inst->prepare(&sms, per_sm) != cudaSuccess) {
    cudaGetLastError();
    *per_sm = 0;
    return;
  }
  *split = row_split(n_chains, n, sms * std::max(*per_sm, 1));
}

// theta (n_chains, dim), x (n, dim - 1), y (n,), lp (n_chains,),
// grad (n_chains, dim): contiguous float32 device arrays. Launches on
// `stream` and returns the CUDA error code of the launch (0 on success).
int fused_logistic_value_grad_f32(const float* theta, const float* x,
                                  const float* y, float* lp, float* grad,
                                  int n_chains, int dim, int n, void* stream) {
  if (n_chains <= 0) return 0;
  const Instance* inst = instance_for(dim);
  if (!inst) return (int)cudaErrorInvalidValue;
  const cudaError_t err = inst->launch(theta, x, y, lp, grad, n_chains, dim,
                                       n, (cudaStream_t)stream);
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

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
// default). Ragged C and n are masked here. The narrow kernel takes p up to
// 8 * 16 = 128: the gradient's columns are compiled into register arrays
// (KSteps instances). A wider p goes to the wide kernel below, which has no
// limit on p: it tiles the columns.
//
// The wide kernel (p > 128) runs the column-tiled stages of
// logistic_wide_tile.cuh: column chunks of 128, row panels of 128 whose
// logits and residuals stay in shared memory between the two products. A
// block still owns 64 chains (16 a warp) and a cluster rank's contiguous
// share of the row tiles, as above. After stage B of each chunk the
// cluster's ranks sum their partials of the chunk in rank order through
// distributed shared memory and add the sum to the gradient in device
// memory (the first panel writes it). The same thread owns an output
// element in every panel, so the panels add in a fixed order too.
//
// A block has 8 warps, two for each 16 chains: in stage A the two split the
// tile's rows, in stage B the chunk's columns. Shared memory is ~101 KB a
// block, so two blocks (16 warps) share an SM, and the row split across a
// cluster (up to 16 blocks, a size the H100 allows beyond the portable 8)
// fills the card as above: at C = 1024, 16 chain tiles x 16 ranks = 256
// blocks; at C = 1 (the step-size search) 16 blocks of 2 row tiles each.
// No atomics: identical inputs give identical bits. Bound at C = 1024,
// p = 999, n = 1000: 3 * 4 * C*p*n operations at the TF32 rate, 24.8 us;
// the design matrix is read from L2 twice per chain tile (stages A and B),
// 8 MB a tile. Measured on an H100 (scripts/k1_wide_ablation.py), the time
// at C <= 1024 is one block's serial path, not the card's rate: C = 1 takes
// 0.13 ms against 0.32 ms at C = 1024.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "logistic_tile.cuh"
#include "logistic_wide_tile.cuh"

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

// ------------------------------------------------------------ wide kernel
using logistic_wide_tile::kChunk;
using logistic_wide_tile::kPanelRows;
using logistic_wide_tile::kPanelTiles;
using logistic_wide_tile::kResStride;
using logistic_wide_tile::kWideKSteps;
using logistic_wide_tile::kWideS;
// Warps per block: kHalves warps share each 16 chains; in stage A they
// split the tile's n-tiles (rows), in stage B the chunk's n-tiles (columns),
// so that their outputs are disjoint. At C <= 1024 a block's serial path
// sets the time, and the halves halve it.
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kHalves = kWideWarps / 4;
constexpr int kNJ = 4 / kHalves;                   // product 1's n-tiles
constexpr int kNNT = kWideKSteps / kHalves;        // product 2's n-tiles
// Two blocks per SM (launch bounds: at most 128 registers a thread; ~101 KB
// of shared memory a block): at C = 1024 the card then takes 16 chain tiles
// x 16 ranks in one wave, 0.315 ms against 0.485 at one block per SM
// (scripts/k1_wide_ablation.py, H100).
constexpr int kWideMinBlocks = 2;
// Blocks per cluster: above 8 a non-portable size, which the H100 allows.
constexpr int kWideMaxSplit = 16;
static_assert(kWideWarps % 4 == 0 && 4 % kHalves == 0, "warps per block");

__host__ __device__ constexpr size_t wide_smem_floats() {
  // beta's chunk (after stage A the block's partial gradient chunk), two x
  // tiles of a chunk, the panel's logits/residuals, its y, the partial lp
  return (size_t)kChains * kWideS + 2 * kTileRows * kWideS +
         (size_t)kChains * kResStride + kPanelRows + kHalves * kChains;
}

__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks)
fused_logistic_wide_kernel(const float* __restrict__ theta,
                           const float* __restrict__ x,
                           const float* __restrict__ y,
                           float* __restrict__ lp, float* __restrict__ grad,
                           int n_chains, int dim, int n) {
  constexpr int S = kWideS;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                             // [kChains][S]
  float* xs = bs + kChains * S;                 // [2][kTileRows][S]
  float* res = xs + 2 * kTileRows * S;          // [kChains][kResStride]
  float* yp = res + kChains * kResStride;       // [kPanelRows]
  float* part_lp = yp + kPanelRows;             // [kHalves][kChains]
  float* part = bs;                             // [kChains][S], stage B

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c0 = (int)(blockIdx.x / n_ranks) * kChains;
  const int p = dim - 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = warp % 4, half = warp / 4;  // 16 chains, share of them
  const int g = lane / 4, t = lane % 4;
  const int cw = 16 * group + g;                // the lane's chains cw, cw+8
  const int j0 = kNJ * half;                    // stage A: rows 8 j0 + ..
  const int nt0 = kNNT * half;                  // stage B: columns 8 nt0 + ..

  const int n_chunks = (p + kChunk - 1) / kChunk;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int tile_begin = rank * n_tiles / n_ranks;
  const int tile_end = (rank + 1) * n_tiles / n_ranks;
  // every rank walks as many panels as the rank with the most tiles (the
  // cluster meets at every chunk of stage B), at least one, so that the
  // gradient is written also where n is 0
  const int max_tiles = (n_tiles + n_ranks - 1) / n_ranks;
  const int n_panels = max(1, (max_tiles + kPanelTiles - 1) / kPanelTiles);

  // x[tile, chunk] into buffer `buf`: warps over rows, lanes over columns;
  // rows past n and columns past p are zero-filled
  auto stage_x = [&](int chunk, int tile, int buf) {
    const int r0 = tile * kTileRows, k0 = chunk * kChunk;
    float* dst = xs + buf * kTileRows * S;
    for (int r = warp; r < kTileRows; r += kWideWarps) {
      const bool row_ok = r0 + r < n;
      const float* src = x + (size_t)(row_ok ? r0 + r : 0) * p;
      for (int k = lane; k < kChunk; k += 32) {
        const bool ok = row_ok && k0 + k < p;
        cp_async4(dst + r * S + k, src + (ok ? k0 + k : 0), ok);
      }
    }
    cp_async_commit();
  };
  // beta's chunk of the block's chains (zero past n_chains and past p)
  auto stage_beta = [&](int chunk) {
    const int k0 = chunk * kChunk;
    for (int r = warp; r < kChains; r += kWideWarps) {
      const bool chain_ok = c0 + r < n_chains;
      const float* src = theta + (size_t)(chain_ok ? c0 + r : 0) * dim + 1;
      for (int k = lane; k < kChunk; k += 32) {
        const bool ok = chain_ok && k0 + k < p;
        cp_async4(bs + r * S + k, src + (ok ? k0 + k : 0), ok);
      }
    }
    cp_async_commit();
  };

  float lp_g = 0.f, lp_g8 = 0.f;
  for (int panel = 0; panel < n_panels; ++panel) {
    const int t0 = tile_begin + panel * kPanelTiles;
    const int nt_p = max(0, min(tile_end, t0 + kPanelTiles) - t0);

    // ---- stage A: the panel's logits, chunk by chunk
    if (nt_p > 0) {
      for (int i = tid; i < kPanelRows; i += kWideThreads) {
        const int row = t0 * kTileRows + i;
        const bool ok = i < nt_p * kTileRows && row < n;
        cp_async4(yp + i, y + (ok ? row : 0), ok);
      }
      stage_beta(0);  // one group with the panel's y
      stage_x(0, t0, 0);
    }
    const int steps = n_chunks * nt_p;
    for (int s = 0; s < steps; ++s) {
      const int chunk = s / nt_p, i = s % nt_p, buf = s & 1;
      // beta's buffer is free: the previous step ended in a barrier
      if (i == 0 && s > 0) stage_beta(chunk);
      if (s + 1 < steps) {
        stage_x((s + 1) / nt_p, t0 + (s + 1) % nt_p, buf ^ 1);
        cp_async_wait<1>();  // this step's tile and beta have landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float d[kNJ][4];
      logistic_wide_tile::chunk_logits(
          bs + 16 * group * S, xs + (buf * kTileRows + 8 * j0) * S,
          min(kWideKSteps, (p - chunk * kChunk + 7) / 8), d);
      logistic_wide_tile::add_logits(res, cw, kTileRows * i + 8 * j0 + 2 * t,
                                     d, chunk == 0);
      __syncthreads();  // both buffers are free for the steps after next
    }
    // epilogue: each lane turns its own logits into residuals, in place
    logistic_wide_tile::panel_epilogue<kNJ>(res, yp, cw, j0, nt_p,
                                            n - t0 * kTileRows, lp_g, lp_g8);
    // product 2 reads every row of the tile: the other halves' residuals
    __syncthreads();

    // ---- stage B: the gradient, chunk by chunk
    if (nt_p > 0) stage_x(0, t0, 0);
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int k0 = chunk * kChunk;
      float acc[kNNT][4];
#pragma unroll
      for (int nt = 0; nt < kNNT; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
      }
      const int n_nt = min(kWideKSteps, (p - k0 + 7) / 8);
      for (int i = 0; i < nt_p; ++i) {
        const int buf = i & 1;
        if (i + 1 < nt_p) {
          stage_x(chunk, t0 + i + 1, buf ^ 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        logistic_wide_tile::chunk_grad(
            res + 16 * group * kResStride + kTileRows * i,
            xs + buf * kTileRows * S, nt0, n_nt, acc);
        __syncthreads();
      }
      // the next chunk's first tile loads while the cluster sums this one
      if (nt_p > 0 && chunk + 1 < n_chunks) stage_x(chunk + 1, t0, 0);
#pragma unroll
      for (int nt = 0; nt < kNNT; ++nt) {
        const int k = 8 * (nt0 + nt) + 2 * t;
        *reinterpret_cast<float2*>(part + cw * S + k) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(part + (cw + 8) * S + k) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
      cluster.sync();
      // every rank's partial, in rank order, added to the gradient; the
      // cluster's ranks share the chunk's outputs
      for (int e = rank * kWideThreads + tid; e < kChains * kChunk;
           e += n_ranks * kWideThreads) {
        const int c = e / kChunk, k = e % kChunk;
        if (c0 + c < n_chains && k0 + k < p) {
          float part_q[kWideMaxSplit];
#pragma unroll
          for (int q = 0; q < kWideMaxSplit; ++q) {
            part_q[q] =
                q < n_ranks ? cluster.map_shared_rank(part, q)[c * S + k]
                            : 0.f;
          }
          float v = 0.f;
#pragma unroll
          for (int q = 0; q < kWideMaxSplit; ++q) v += part_q[q];
          float* out = grad + (size_t)(c0 + c) * dim + 1 + k0 + k;
          *out = panel == 0 ? v : *out + v;
        }
      }
      cluster.sync();  // no rank writes its partial while another reads it
    }
  }

  // lp of chains g, g+8 over the 4 lanes t of the group, in a fixed order,
  // then over the halves and the ranks in order
  lp_g += __shfl_xor_sync(0xffffffffu, lp_g, 1);
  lp_g += __shfl_xor_sync(0xffffffffu, lp_g, 2);
  lp_g8 += __shfl_xor_sync(0xffffffffu, lp_g8, 1);
  lp_g8 += __shfl_xor_sync(0xffffffffu, lp_g8, 2);
  if (t == 0) {
    part_lp[half * kChains + cw] = lp_g;
    part_lp[half * kChains + cw + 8] = lp_g8;
  }
  cluster.sync();
  for (int c = rank * kWideThreads + tid; c < kChains;
       c += n_ranks * kWideThreads) {
    if (c0 + c < n_chains) {
      float part_q[kWideMaxSplit];
#pragma unroll
      for (int q = 0; q < kWideMaxSplit; ++q) {
        float v = 0.f;
        if (q < n_ranks) {
          const float* pq = cluster.map_shared_rank(part_lp, q);
#pragma unroll
          for (int h = 0; h < kHalves; ++h) v += pq[h * kChains + c];
        }
        part_q[q] = v;
      }
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kWideMaxSplit; ++q) v += part_q[q];
      lp[c0 + c] = v;
      grad[(size_t)(c0 + c) * dim] = 0.f;
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// Blocks per cluster of the wide kernel: as row_split, up to kWideMaxSplit.
int wide_split(int n_chains, int n, int slots) {
  const int chain_tiles = (n_chains + kChains - 1) / kChains;
  const int row_tiles = (n + kTileRows - 1) / kTileRows;
  return std::max(1,
                  std::min({slots / chain_tiles, kWideMaxSplit, row_tiles}));
}

cudaError_t prepare_wide(int* sms, int* per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  const size_t smem = wide_smem_floats() * sizeof(float);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_logistic_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_logistic_wide_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && kWideMaxSplit > kMaxSplit) {
    err = cudaFuncSetAttribute(fused_logistic_wide_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fused_logistic_wide_kernel, kWideThreads, smem);
  }
  return err;
}

// The launch configuration of the wide kernel at `split` blocks per
// cluster; `attr` holds the cluster's dimension.
cudaLaunchConfig_t wide_config(int n_chains, int split,
                               cudaLaunchAttribute* attr,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n_chains + kChains - 1) / kChains) * split);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = wide_smem_floats() * sizeof(float);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks per cluster for a call's shape: wide_split, halved until the card
// can place such a cluster at all (a cluster's blocks share one GPC).
cudaError_t wide_launch_split(int n_chains, int n, int* split) {
  int sms = 0, per_sm = 0;
  cudaError_t err = prepare_wide(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  *split = wide_split(n_chains, n, sms * std::max(per_sm, 1));
  while (*split > 1) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = wide_config(n_chains, *split, attr, 0);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters,
                                         fused_logistic_wide_kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters > 0) break;
    *split /= 2;
  }
  return cudaSuccess;
}

cudaError_t launch_wide(const float* theta, const float* x, const float* y,
                        float* lp, float* grad, int n_chains, int dim, int n,
                        cudaStream_t stream) {
  int split = 1;
  const cudaError_t err = wide_launch_split(n_chains, n, &split);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wide_config(n_chains, split, attr, stream);
  return cudaLaunchKernelEx(&cfg, fused_logistic_wide_kernel, theta, x, y,
                            lp, grad, n_chains, dim, n);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for a given dim (bytes): the narrow
// instance's up to dim 129, the wide kernel's beyond.
size_t fused_logistic_smem_bytes(int dim) {
  const Instance* inst = instance_for(dim);
  return (inst ? smem_floats(inst->ksteps) : wide_smem_floats()) *
         sizeof(float);
}

// Resident blocks per SM and blocks per cluster (row splits per chain tile)
// for a call's shape on the current device; 0 and 0 if that fails.
void fused_logistic_launch_shape(int n_chains, int dim, int n, int* per_sm,
                                 int* split) {
  const Instance* inst = instance_for(dim);
  int sms = 0;
  *per_sm = *split = 0;
  const cudaError_t err =
      inst ? inst->prepare(&sms, per_sm) : prepare_wide(&sms, per_sm);
  if (err == cudaSuccess && inst) {
    *split = row_split(n_chains, n, sms * std::max(*per_sm, 1));
    return;
  }
  if (err == cudaSuccess &&
      wide_launch_split(n_chains, n, split) == cudaSuccess) {
    return;
  }
  cudaGetLastError();
  *per_sm = *split = 0;
}

// theta (n_chains, dim), x (n, dim - 1), y (n,), lp (n_chains,),
// grad (n_chains, dim): contiguous float32 device arrays. Launches on
// `stream` and returns the CUDA error code of the launch (0 on success).
int fused_logistic_value_grad_f32(const float* theta, const float* x,
                                  const float* y, float* lp, float* grad,
                                  int n_chains, int dim, int n, void* stream) {
  if (n_chains <= 0) return 0;
  // p <= 128 takes the narrow instance that holds it, a wider p the wide
  // kernel
  const Instance* inst = instance_for(dim);
  const cudaError_t err =
      inst ? inst->launch(theta, x, y, lp, grad, n_chains, dim, n,
                          (cudaStream_t)stream)
           : launch_wide(theta, x, y, lp, grad, n_chains, dim, n,
                         (cudaStream_t)stream);
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

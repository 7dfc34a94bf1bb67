// T NUTS transitions of every chain in one launch (kernel K2 of the port).
//
// Replaces the Pallas kernel advancedhmc_tpu/ops/fused_nuts_kernel.py:105
// (`make_fused_nuts_kernel`, wrapper `fused_nuts_pallas` :417). It computes
// the same function per chain: iterative NUTS, one leaf per loop iteration,
// multinomial reservoir and biased progressive sampling, the generalised
// no-U-turn check over aligned spans with the ck_r / ck_cum stacks (slot
// tz(i) capped at S - 1), divergence at dH >= 1000, diagonal M^-1, full
// momentum refresh at a fixed step size, and the splitmix32 counter stream.
// A chain's stream depends on the seed, its block chain / block_chains, its
// row chain % block_chains, Dp = round_up(dim, 128) (momentum lane index
// row * Dp + col) and its own leaf count, so `block_chains` is an argument
// here and not the launch shape.
//
// Bound: per leaf and chain the logistic costs 4 * p * n operations (two
// products over the n x p design), which dominate. At float32 accuracy on
// the tensor cores (3xTF32, logistic_tile.cuh) that is 3 * 4 * p * n per
// leaf at the TF32 rate; the bytes (theta0 in, theta (T, C, dim) out) are
// far below. Measured against both in chip_smoke.py.
//
// Design. A block of kWarps = 4 warps owns kChains = 64 chains, a warp 16 of
// them: the M rows of K1's warp tile (logistic_tile.cuh). The block walks
// leaves in lock step, as the Pallas block does: every chain takes exactly
// one leaf per iteration, and a chain that has finished its T transitions
// keeps iterating without recording, until all chains of the block are
// done. Each iteration
//   1. evaluates the target at the frontier of all 64 chains. For the
//      logistic that is K1's loop: 32-row tiles of the design, double-
//      buffered by cp.async and shared by the block's warps, each warp's 16
//      chains through warp_tile (both products as 3xTF32 mma.sync, short
//      accumulation chains). The frontier's beta is the A operand, in
//      shared memory; after the last tile each warp writes its gradient
//      fragments over its own beta rows, and sums lp over the lanes in a
//      fixed order;
//   2. lets each warp walk its 16 chains one after another, lanes over dim:
//      the prior (per chain), the second half kick and the energy, the
//      reservoir, the checkpoints and U-turn spans, the merge, the
//      transition record and the momentum refresh, then the next leaf's
//      half kick and drift, which stages the new frontier for step 1.
// The tree state is in a device scratch buffer that the caller allocates:
// each chain's 15 + 2S vectors of dim floats lie contiguous (a vector is one
// coalesced row), so shared memory holds only the tile's operands and M^-1
// (56 KB at p = 99: four blocks, 16 warps per SM; three or two blocks were
// slower). Step 2 reads the scratch mostly from device memory, a few
// stages per chain (the kick; the reservoir with the first U-turn span or
// the checkpoint; the merge, only when a doubling completes; record and
// refresh; the drift), each one loop over the chain's elements. A chain's
// scalars are a record in the scratch too, read and written once per leaf,
// so that registers hold only the chain at hand: at four blocks an SM keeps
// ~27 KB of L1 beside the shared memory, so spills go to L2, and the pass
// was faster with fewer live registers than with more loads in flight.
// Dot products are xor-shuffle sums, which leave the same value in every
// lane. No atomics and fixed summation orders: the same inputs give the
// same bits.
//
// Wider than the warp tile (p > 128, any p). A group of 64 chains is owned
// by a thread-block cluster of R blocks (ranks), R chosen by occupancy
// (`cluster_ranks`: up to kMaxRanks, one per row tile at most; 11 at
// C = 1024 and n = 1000 on an H100, 176 blocks, all 16 groups in one
// wave), and step 1 runs the column-tiled stages of K1's wide kernel
// (logistic_wide_tile.cuh) with the rows split across the ranks as K1's
// wide kernel splits them. Rank r takes a contiguous range of
// ceil(n_tiles / R) row tiles (the last ranks fewer or none; a rank without
// rows takes part in every barrier with zero partials). Beta's chunks of
// 128 columns are staged from the frontiers' theta in the scratch (a
// group's beta at p = 999 does not fit in shared memory), x's tiles from
// x^T where it lies, and a row panel's logits, then residuals, stay in
// shared memory between the two products; a row's logits are whole within
// its rank. Stage B leaves each rank's partial of a gradient chunk in
// shared memory; after a cluster barrier the ranks add every rank's
// partial in rank order through distributed shared memory, each rank for
// the chains it walks, into the frontiers' gradient vectors in the scratch
// (the first panel writes, later panels add); lp is summed in rank order
// the same way. Step 2 is spread over the cluster: its 4R warps walk the 64
// chains in contiguous runs (`walk_begin`: one or two a warp from R = 8
// on), so that a warp reads the gradient its own rank wrote; the next
// leaf's beta, which every rank stages from every chain's frontier, is
// ordered after the drift by the cluster barrier's release and acquire at
// the head of step 1. Whether all chains are done is decided for the
// cluster: each rank publishes a flag, and after a cluster barrier every
// rank reads all of them, so all leave at the same iteration. No atomics
// and fixed orders: the same bits in every call. The tiles take ~100 KB of
// shared memory a block whatever p; M^-1 stays in device memory, so that no
// dim is too wide. Bound as above; PERF.md has the times on an H100.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <set>
#include <vector>

#include "logistic_tile.cuh"
#include "logistic_wide_tile.cuh"

namespace cg = cooperative_groups;

using logistic_tile::kTileRows;
using logistic_tile::x_stride;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChainsPerWarp = 16;              // the warp tile's M rows
constexpr int kChains = kChainsPerWarp * kWarps;
// Blocks per cluster of the wide instance, at most: above 8 a non-portable
// size, which the H100 allows; at most kChains / kWarps, so that every
// warp of a cluster walks a chain.
constexpr int kMaxRanks = 16;
static_assert(kWarps * kMaxRanks <= kChains, "a chain for every warp");
constexpr float kDeltaMax = 1000.f;
constexpr unsigned kFull = 0xffffffffu;

// tree-state vectors of a chain; the two checkpoint stacks follow kCk. The
// (theta, r, g) triples of the frontier and of the two edges are
// consecutive, so an edge's r and g sit at +1 and +2 from its theta.
enum Vec {
  kThE, kRE, kGE,       // integration frontier (leaf being taken)
  kThL, kRL, kGL,       // left edge of the tree
  kThR, kRR, kGR,       // right edge of the tree
  kThC, kGC,            // transition candidate
  kThSc, kGSc,          // candidate of the current doubling
  kRhoT, kRhoS,         // momentum sums of the tree and of the doubling
  kCk                   // ck_r[S] then ck_cum[S]
};

__host__ __device__ inline int n_vectors(int S) { return kCk + 2 * S; }

// The row in its group of the first chain that warp `gw` of a cluster's
// `warps` walks: the warps, rank by rank, share the group's chains in
// contiguous runs (one or two each from 8 ranks on), so that rank r walks,
// and sums the gradient and lp of, rows walk_begin(kWarps r) ..
// walk_begin(kWarps (r + 1)) - 1.
__host__ __device__ inline int walk_begin(int gw, int warps) {
  return kChains * gw / warps;
}

// ------------------------------------------------ counter RNG (:44-102)
__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ uint32_t bits_at(uint32_t ctr, uint32_t idx,
                                            uint32_t salt) {
  const uint32_t base = ctr * 2654435761u + salt * 40503u;
  return splitmix32(splitmix32(idx + base) ^ (idx * 0x9E3779B9u));
}

__device__ __forceinline__ float uniform_at(uint32_t ctr, uint32_t idx,
                                            uint32_t salt) {
  return ((float)(bits_at(ctr, idx, salt) >> 8) + 1.f) * (1.f / 16777216.f);
}

__device__ __forceinline__ float normal_at(uint32_t ctr, uint32_t idx,
                                           uint32_t salt) {
  const float u1 = uniform_at(ctr, idx, salt);
  const float u2 = uniform_at(ctr, idx, salt + 101u);
  return sqrtf(-2.f * logf(u1)) * cosf(6.28318530717958648f * u2);
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = a - b;
  if (isnan(d)) return a + b;      // both -inf (or a NaN)
  return fmaxf(a, b) + log1pf(expf(-fabsf(d)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ------------------------------------------------------------- targets
// A target splits its value and gradient at the frontier into
//   - `term(k, th)`, summed over the frontier's elements as the drift
//     writes them (the chain's `q`), and `put`, which stages an element
//     for `likelihood`; `clear_pad` after a chain's elements;
//   - `likelihood(sm, vecs, dim, nvec)`, called by every thread of the
//     block (of the cluster) once the frontiers of all its chains are
//     written (`vecs`: the tree-state vectors of the group's first chain,
//     chain r's vector v at vecs + (r * nvec + v) * dim): gives lane c of
//     each warp the data term of the c-th chain the warp walks;
//   - `aux(q, ls)` per chain, then `lp` per chain and `grad` per element,
//     where ls is element 0 of the frontier and `ge` the frontier's
//     gradient vector.
// kMinBlocks is the instance's launch bound (resident blocks per SM);
// kMInvShared false leaves M^-1 in device memory, for a target whose
// shared memory must not grow with dim; kCluster true launches the
// instance in clusters of ranks that share each group of kChains chains,
// and then the target also gives `all_done(sm, warp_done)`, the cluster's
// decision that every chain is done.

// Diagonal Gaussian: lp = -1/2 sum prec * theta^2, grad = -prec * theta.
struct GaussianTarget {
  static constexpr int kMinBlocks = 4;
  static constexpr bool kMInvShared = true;
  static constexpr bool kCluster = false;
  const float* prec;   // (>= dim,)

  __host__ __device__ static size_t smem_floats(int) { return 0; }
  __device__ void init(float*) const {}
  __device__ float term(int k, float th) const { return prec[k] * th * th; }
  __device__ void put(float*, int, int, float) const {}
  __device__ void clear_pad(float*, int, int) const {}
  __device__ float likelihood(float*, float*, int, int) const { return 0.f; }
  __device__ float aux(float, float) const { return 0.f; }
  __device__ float lp(float q, float, float, float) const {
    return -0.5f * q;
  }
  __device__ float grad(const float*, const float*, int, int k, float th,
                        float, float, float) const {
    return -prec[k] * th;
  }
};

// The hierarchical logistic's prior and its total, per chain: lp from the
// data term `loglik`, and the gradient's element 0 (log sigma), from q =
// sum theta^2, ls = log sigma and inv_s2 = 1 / sigma^2.
__device__ __forceinline__ float logistic_lp(int p, float q, float ls,
                                             float inv_s2, float loglik) {
  const float beta_sq = q - ls * ls;
  return -0.5f * (ls * ls) - 0.5f * beta_sq * inv_s2 - (float)p * ls
         + loglik;
}

__device__ __forceinline__ float logistic_grad0(int p, float q, float ls,
                                                float inv_s2) {
  return -ls + (q - ls * ls) * inv_s2 - (float)p;
}

// Hierarchical logistic in block form (models/logistic.py
// hierarchical_logistic_block): theta = (log sigma, beta_1..beta_p), the
// design as x^T (>= dim rows, n columns) with row 0 zero, read where it
// lies. The prior is added per chain: q = sum theta^2, aux = 1 / sigma^2.
// KSteps k-steps of 8 columns hold p.
template <int KSteps>
struct LogisticTarget {
  static constexpr int kMinBlocks = 4;
  static constexpr bool kMInvShared = true;
  static constexpr bool kCluster = false;
  static constexpr int S = x_stride(KSteps);
  static_assert(kTileRows == 32, "a tile's rows are a warp's lanes");
  const float* xt;     // (>= p + 1, n): rows 1..p are the features
  const float* y;      // (n,)
  int n, p;

  // beta of the block's chains, then two staged tiles of x, two of y (K1's
  // layout); after `likelihood` a warp's beta rows hold its chains' data
  // gradient
  __host__ __device__ static size_t smem_floats(int) {
    return (size_t)(kChains + 2 * kTileRows) * S + 2 * kTileRows;
  }

  // columns p .. S-1 of beta and of both x buffers zero (cp.async never
  // writes them, `clear_pad` keeps beta's)
  __device__ void init(float* sm) const {
    for (int i = threadIdx.x; i < (kChains + 2 * kTileRows) * (S - p);
         i += kThreads) {
      sm[(i / (S - p)) * S + p + i % (S - p)] = 0.f;
    }
  }

  __device__ float term(int, float th) const { return th * th; }

  __device__ void put(float* sm, int cb, int k, float th) const {
    if (k > 0) sm[cb * S + k - 1] = th;
  }

  // the gradient left columns p .. 8 KSteps - 1 zero, or NaN where the
  // chain's residuals were: the next tile must read zeros there
  __device__ void clear_pad(float* sm, int cb, int lane) const {
    for (int k = p + lane; k < 8 * KSteps; k += 32) sm[cb * S + k] = 0.f;
  }

  // rows j0 .. j0 + 31 of the design into a tile buffer, as one group of
  // cp.async: warps over columns, lanes over rows, so that a warp reads a
  // 128-byte run of one row of x^T with every lane busy (faster than
  // staging a row-major copy with lanes over columns, as K1 does:
  // scripts/k2_ablation.py); rows past n are zero-filled
  __device__ void stage(float* xs, float* ys, int j0) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool valid = j0 + lane < n;
    const float* src = xt + (valid ? j0 + lane : 0);
    for (int k = warp; k < p; k += kWarps) {
      logistic_tile::cp_async4(xs + lane * S + k, src + (size_t)(1 + k) * n,
                               valid);
    }
    if (warp == 0) {
      logistic_tile::cp_async4(ys + lane, y + (valid ? j0 + lane : 0), valid);
    }
    logistic_tile::cp_async_commit();
  }

  __device__ float likelihood(float* sm, float*, int, int) const {
    float* bs = sm;                          // [kChains][S]
    float* xs = bs + kChains * S;            // [2][kTileRows][S]
    float* ys = xs + 2 * kTileRows * S;      // [2][kTileRows]
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int n_tiles = (n + kTileRows - 1) / kTileRows;
    float* rows = bs + kChainsPerWarp * warp * S;

    float acc[KSteps][4];
#pragma unroll
    for (int nt = 0; nt < KSteps; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    }
    float lp_g = 0.f, lp_g8 = 0.f;
    if (n_tiles > 0) stage(xs, ys, 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int buf = tile & 1;
      if (tile + 1 < n_tiles) {
        stage(xs + (buf ^ 1) * kTileRows * S, ys + (buf ^ 1) * kTileRows,
              (tile + 1) * kTileRows);
        logistic_tile::cp_async_wait<1>();  // this tile landed, next in flight
      } else {
        logistic_tile::cp_async_wait<0>();
      }
      __syncthreads();
      logistic_tile::warp_tile<KSteps>(
          rows, xs + buf * kTileRows * S, ys + buf * kTileRows,
          min(kTileRows, n - tile * kTileRows), acc, lp_g, lp_g8);
      __syncthreads();  // the buffer is free for the tile after next
    }

    // lp of chains g, g+8 over the 4 lanes t of the group, in a fixed order
    lp_g += __shfl_xor_sync(kFull, lp_g, 1);
    lp_g += __shfl_xor_sync(kFull, lp_g, 2);
    lp_g8 += __shfl_xor_sync(kFull, lp_g8, 1);
    lp_g8 += __shfl_xor_sync(kFull, lp_g8, 2);

    // the C fragments (chains g | g+8, columns 8nt + 2t, +1) over the warp's
    // beta rows, which only this warp reads and which it has consumed
#pragma unroll
    for (int nt = 0; nt < KSteps; ++nt) {
      const int k = 8 * nt + 2 * t;
      rows[g * S + k] = acc[nt][0];
      rows[g * S + k + 1] = acc[nt][1];
      rows[(g + 8) * S + k] = acc[nt][2];
      rows[(g + 8) * S + k + 1] = acc[nt][3];
    }
    __syncwarp();
    const float a = __shfl_sync(kFull, lp_g, 4 * (lane & 7));
    const float b = __shfl_sync(kFull, lp_g8, 4 * (lane & 7));
    return lane < 8 ? a : b;
  }

  __device__ float aux(float, float ls) const { return expf(-2.f * ls); }

  __device__ float lp(float q, float ls, float inv_s2, float loglik) const {
    return logistic_lp(p, q, ls, inv_s2, loglik);
  }

  __device__ float grad(const float* sm, const float*, int cb, int k,
                        float th, float q, float ls, float inv_s2) const {
    return k == 0 ? logistic_grad0(p, q, ls, inv_s2)
                  : sm[cb * S + k - 1] + (-th * inv_s2);
  }
};

// The hierarchical logistic at any p > 128, its likelihood in the column-
// tiled stages of logistic_wide_tile.cuh with the rows split across the
// cluster's ranks (see the head of this file): beta from the frontiers'
// theta in the scratch, each rank's partials summed in rank order through
// distributed shared memory, the data gradient into the frontiers' gradient
// vectors there.
struct WideLogisticTarget {
  // ~100 KB of shared memory a block: two blocks per SM, up to 255
  // registers a thread (stage B's 16 x 128 accumulators a warp)
  static constexpr int kMinBlocks = 2;
  static constexpr bool kMInvShared = false;
  static constexpr bool kCluster = true;
  static_assert(kTileRows == 32, "a tile's rows are a warp's lanes");
  const float* xt;     // (>= p + 1, n): rows 1..p are the features
  const float* y;      // (n,)
  int n, p;

  // beta's chunk of the group's chains (in stage B the rank's partial of a
  // gradient chunk), two x tiles of a chunk, the panel's logits/residuals,
  // its y, the rank's partial lp of the group's chains, its "done" flag
  __host__ __device__ static size_t smem_floats(int) {
    using namespace logistic_wide_tile;
    return (size_t)(kChains + 2 * kTileRows) * kWideS +
           (size_t)kChains * kResStride + kPanelRows + kChains + 4;
  }

  __device__ void init(float*) const {}
  __device__ float term(int, float th) const { return th * th; }
  __device__ void put(float*, int, int, float) const {}
  __device__ void clear_pad(float*, int, int) const {}

  // The sum over the cluster's ranks, in rank order, of the float at `at`
  // in each rank's shared memory.
  __device__ static float rank_sum(cg::cluster_group& cluster, float* at,
                                   int ranks) {
    float part_q[kMaxRanks];
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q) {
      part_q[q] = q < ranks ? *cluster.map_shared_rank(at, q) : 0.f;
    }
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q) v += part_q[q];
    return v;
  }

  __device__ float likelihood(float* sm, float* vecs, int dim,
                              int nvec) const {
    using namespace logistic_wide_tile;
    constexpr int S = kWideS;
    float* bs = sm;                               // [kChains][S]
    float* xs = bs + kChains * S;                 // [2][kTileRows][S]
    float* res = xs + 2 * kTileRows * S;          // [kChains][kResStride]
    float* yp = res + kChains * kResStride;       // [kPanelRows]
    float* part_lp = yp + kPanelRows;             // [kChains]
    float* part = bs;                             // [kChains][S], stage B
    cg::cluster_group cluster = cg::this_cluster();
    const int ranks = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int cw = kChainsPerWarp * warp + g;     // the lane's chains cw, +8
    const int n_chunks = (p + kChunk - 1) / kChunk;
    const int n_tiles = (n + kTileRows - 1) / kTileRows;
    // the rank's row tiles, a contiguous range of ceil(n_tiles / ranks):
    // the last ranks may have fewer or none. Every rank walks as many
    // panels (the cluster meets in every chunk of stage B), at least one,
    // so that the gradient is written also where n is 0
    const int per_rank = (n_tiles + ranks - 1) / ranks;
    const int tile_begin = min(n_tiles, rank * per_rank);
    const int tile_end = min(n_tiles, tile_begin + per_rank);
    const int n_panels = max(1, (per_rank + kPanelTiles - 1) / kPanelTiles);
    // the chains this rank walks, whose gradient and lp it sums
    const int first = walk_begin(kWarps * rank, kWarps * ranks);
    const int span = walk_begin(kWarps * (rank + 1), kWarps * ranks) - first;
    auto vec = [&](int r, int v) {
      return vecs + ((size_t)r * nvec + v) * dim;
    };

    // x[tile, chunk] into buffer `buf` from x^T as `stage` does (warps over
    // the chunk's columns, lanes over rows); rows past n and columns past p
    // are zero-filled
    auto stage_x = [&](int chunk, int tile, int buf) {
      const int j0 = tile * kTileRows, k0 = chunk * kChunk;
      float* dst = xs + buf * kTileRows * S;
      const bool row_ok = j0 + lane < n;
      for (int k = warp; k < kChunk; k += kWarps) {
        const bool ok = row_ok && k0 + k < p;
        logistic_tile::cp_async4(
            dst + lane * S + k,
            xt + (ok ? (size_t)(1 + k0 + k) * n + j0 + lane : 0), ok);
      }
      logistic_tile::cp_async_commit();
    };
    // beta's chunk of the group's chains: columns 1 + k0 .. of each
    // frontier theta, zero past p
    auto stage_beta = [&](int chunk) {
      const int k0 = chunk * kChunk;
      for (int r = warp; r < kChains; r += kWarps) {
        const float* src = vec(r, kThE) + 1;
        for (int k = lane; k < kChunk; k += 32) {
          const bool ok = k0 + k < p;
          logistic_tile::cp_async4(bs + r * S + k, src + (ok ? k0 + k : 0),
                                   ok);
        }
      }
      logistic_tile::cp_async_commit();
    };

    float lp_g = 0.f, lp_g8 = 0.f;
    for (int panel = 0; panel < n_panels; ++panel) {
      const int t0 = tile_begin + panel * kPanelTiles;
      const int nt_p = max(0, min(tile_end, t0 + kPanelTiles) - t0);
      // the frontiers that every rank's warps wrote are visible (first
      // panel: the barrier's release and acquire order the drift's stores
      // before this rank's loads), every rank is done with the partials in
      // beta's buffer (later panels)
      cluster.sync();

      // ---- stage A: the panel's logits, chunk by chunk
      if (nt_p > 0) {
        for (int i = threadIdx.x; i < kPanelRows; i += kThreads) {
          const int row = t0 * kTileRows + i;
          const bool ok = i < nt_p * kTileRows && row < n;
          logistic_tile::cp_async4(yp + i, y + (ok ? row : 0), ok);
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
          logistic_tile::cp_async_wait<1>();  // this step's tile and beta
        } else {
          logistic_tile::cp_async_wait<0>();
        }
        __syncthreads();
        float d[4][4];
        chunk_logits(bs + kChainsPerWarp * warp * S,
                     xs + buf * kTileRows * S,
                     min(kWideKSteps, (p - chunk * kChunk + 7) / 8), d);
        add_logits(res, cw, kTileRows * i + 2 * t, d, chunk == 0);
        __syncthreads();  // both buffers are free for the steps after next
      }
      panel_epilogue<4>(res, yp, cw, 0, nt_p, n - t0 * kTileRows, lp_g,
                        lp_g8);
      __syncthreads();

      // ---- stage B: the gradient, chunk by chunk
      float* rows = part + kChainsPerWarp * warp * S;   // the warp's own
      if (nt_p > 0) stage_x(0, t0, 0);
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        const int k0 = chunk * kChunk;
        float acc[2][kWideKSteps / 2][4];
#pragma unroll
        for (int nt = 0; nt < kWideKSteps; ++nt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[nt / 8][nt % 8][q] = 0.f;
        }
        const int n_nt = min(kWideKSteps, (p - k0 + 7) / 8);
        for (int i = 0; i < nt_p; ++i) {
          const int buf = i & 1;
          if (i + 1 < nt_p) {
            stage_x(chunk, t0 + i + 1, buf ^ 1);
            logistic_tile::cp_async_wait<1>();
          } else {
            logistic_tile::cp_async_wait<0>();
          }
          __syncthreads();
          // the chunk's columns in two halves (as K1's wide kernel splits
          // them over two warps), so that only half of product 2's short
          // chains are live at once: registers for the walk's map
          const float* rs =
              res + kChainsPerWarp * warp * kResStride + kTileRows * i;
          chunk_grad(rs, xs + buf * kTileRows * S, 0, n_nt, acc[0]);
          chunk_grad(rs, xs + buf * kTileRows * S, kWideKSteps / 2, n_nt,
                     acc[1]);
          __syncthreads();
        }
        // the next chunk's first tile loads while the cluster sums this one
        if (nt_p > 0 && chunk + 1 < n_chunks) stage_x(chunk + 1, t0, 0);
        // the rank's partial: the C fragments (chains g | g+8, columns
        // 8nt + 2t, +1) over the warp's rows of beta's buffer
#pragma unroll
        for (int nt = 0; nt < kWideKSteps; ++nt) {
          const int k = 8 * nt + 2 * t;
          const float* a = acc[nt / 8][nt % 8];
          *reinterpret_cast<float2*>(rows + g * S + k) =
              make_float2(a[0], a[1]);
          *reinterpret_cast<float2*>(rows + (g + 8) * S + k) =
              make_float2(a[2], a[3]);
        }
        cluster.sync();  // every rank's partial of the chunk is written
        // every rank's partial, in rank order, into the gradient vectors of
        // the chains this rank walks, threads over columns: the first panel
        // writes, later panels add
        for (int e = tid; e < span * kChunk; e += kThreads) {
          const int c = first + e / kChunk, k = e % kChunk;
          if (k0 + k < p) {
            const float v = rank_sum(cluster, part + c * S + k, ranks);
            float* out = vec(c, kGE) + 1 + k0 + k;
            *out = panel == 0 ? v : *out + v;
          }
        }
        cluster.sync();  // no rank writes its partial while another reads it
      }
    }

    // lp of chains g, g+8 over the 4 lanes t of the group, in a fixed
    // order, then over the ranks in order: lane c of the warp takes the
    // c-th chain the warp walks
    lp_g += __shfl_xor_sync(kFull, lp_g, 1);
    lp_g += __shfl_xor_sync(kFull, lp_g, 2);
    lp_g8 += __shfl_xor_sync(kFull, lp_g8, 1);
    lp_g8 += __shfl_xor_sync(kFull, lp_g8, 2);
    if (t == 0) {
      part_lp[cw] = lp_g;
      part_lp[cw + 8] = lp_g8;
    }
    cluster.sync();
    const int gw = kWarps * rank + warp;
    const int wb = walk_begin(gw, kWarps * ranks);
    return lane < walk_begin(gw + 1, kWarps * ranks) - wb
               ? rank_sum(cluster, part_lp + wb + lane, ranks)
               : 0.f;
  }

  // Every chain of the group done: each rank publishes whether all its
  // warps' chains are, and every rank reads all the flags after a cluster
  // barrier, so that the ranks leave at the same iteration. (A flag is
  // written again only after the next likelihood's cluster barriers.)
  __device__ bool all_done(float* sm, int warp_done) const {
    using namespace logistic_wide_tile;
    int* flag = reinterpret_cast<int*>(
        sm + (size_t)(kChains + 2 * kTileRows) * kWideS +
        (size_t)kChains * kResStride + kPanelRows + kChains);
    cg::cluster_group cluster = cg::this_cluster();
    const int block_done = __syncthreads_and(warp_done);
    if (threadIdx.x == 0) *flag = block_done;
    cluster.sync();
    int done = 1;
    for (int q = 0; q < (int)cluster.num_blocks(); ++q) {
      done &= *cluster.map_shared_rank(flag, q);
    }
    return done != 0;
  }

  __device__ float aux(float, float ls) const { return expf(-2.f * ls); }

  __device__ float lp(float q, float ls, float inv_s2, float loglik) const {
    return logistic_lp(p, q, ls, inv_s2, loglik);
  }

  // element k > 0: the data gradient that `likelihood` left in `ge`
  __device__ float grad(const float*, const float* ge, int, int k, float th,
                        float q, float ls, float inv_s2) const {
    return k == 0 ? logistic_grad0(p, q, ls, inv_s2)
                  : ge[k] + (-th * inv_s2);
  }
};

// --------------------------------------------- a chain's scalar state
// One 64-byte record per chain in the scratch, after every chain's vectors:
// the warp loads chain c's record (all lanes, one address) with the first
// stage's loads, and lane 0 stores it back when the warp is done with the
// chain, so no chain's scalars stay in registers across the tile or the
// other chains.
struct alignas(16) Chain {
  float lp_c, h0, lp_sc, t_w, s_w;
  float q;              // the target's sum over the frontier
  int n_alpha, depth, leaf, v, t;
  int diverged;
  int done;             // T transitions recorded, or not a chain
  int sm;               // the SM whose warp walks it (cluster instances,
                        // written at the start; fused_nuts_sms_used)
  int pad[2];
};
constexpr int kChainWords = sizeof(Chain) / sizeof(float);

// --------------------------------------------------------------- kernel
__device__ __forceinline__ float inv_sqrt_m(float m) {
  return m > 0.f ? 1.f / fmaxf(sqrtf(m), 1e-30f) : 0.f;
}

__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// The ranks of the block's cluster and the block's rank in it; 1 and 0 for
// an instance launched without clusters.
template <bool kCluster>
__device__ __forceinline__ void cluster_shape(int& ranks, int& rank) {
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    ranks = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
  } else {
    ranks = 1;
    rank = 0;
  }
}

template <class Target>
__global__ void __launch_bounds__(kThreads, Target::kMinBlocks)
fused_nuts_kernel(Target tg, const float* __restrict__ theta0,
                  const float* __restrict__ m_inv_in, float eps,
                  uint32_t seed, int block_chains, int dp, int n_chains,
                  int dim, int T, int S, int max_iters, float* scratch,
                  float* __restrict__ out_theta,
                  int* __restrict__ out_stats) {
  extern __shared__ __align__(16) float smem[];
  float* tsm = smem;                                // the target's
  // M^-1 and 1 / sqrt(M^-1) (0 where M^-1 = 0) in shared memory after the
  // target's floats, or M^-1 where it lies and the root at each draw
  float* mi_s = smem + Target::smem_floats(dim);
  float* isq = mi_s + dim;
  const float* mi = Target::kMInvShared ? mi_s : m_inv_in;
  auto isq_at = [&](int k) {
    return Target::kMInvShared ? isq[k] : inv_sqrt_m(mi[k]);
  };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nvec = n_vectors(S);
  // a group of kChains chains to a cluster of `ranks` blocks, whose warps
  // walk them in contiguous runs (`walk_begin`); kChainsPerWarp each
  // without clusters
  int ranks, rank;
  cluster_shape<Target::kCluster>(ranks, rank);
  const int group = blockIdx.x / ranks;
  const int gw = kWarps * rank + warp;          // the warp in its cluster
  const int cb0 = Target::kCluster ? walk_begin(gw, kWarps * ranks)
                                   : kChainsPerWarp * warp;  // first's row
  const int cpw = Target::kCluster                // chains the warp walks
                      ? walk_begin(gw + 1, kWarps * ranks) - cb0
                      : kChainsPerWarp;
  const int c0 = group * kChains + cb0;         // and the first's chain
  float* const blk = scratch + (size_t)group * kChains * nvec * dim;
  Chain* records = reinterpret_cast<Chain*>(
      scratch + (size_t)(gridDim.x / ranks) * kChains * nvec * dim) + c0;

  if (Target::kMInvShared) {
    for (int k = tid; k < dim; k += kThreads) {
      const float m = m_inv_in[k];
      mi_s[k] = m;
      isq[k] = inv_sqrt_m(m);
    }
  }
  tg.init(tsm);
  __syncthreads();

  // chain c of the warp: its vectors in the scratch, its stream
  auto vecs = [&](int c) { return scratch + (size_t)(c0 + c) * nvec * dim; };
  auto row_of = [&](int c) {
    return (uint32_t)((c0 + c) % block_chains);
  };
  auto base_of = [&](int c) {
    return seed * 7919u + (uint32_t)((c0 + c) / block_chains) * 104729u;
  };

  // The leapfrog's first half at counter ctr: direction (at a doubling's
  // first leaf), half kick and drift from the leaf's start into the
  // frontier, staged for the target.
  auto drift = [&](Chain& s, int c, float* st, uint32_t ctr, uint32_t row) {
    const bool start = s.leaf == 0;
    if (start) {
      s.v = uniform_at(ctr, row, 2u) < 0.5f ? -1 : 1;
      s.s_w = -CUDART_INF_F;
    }
    const float eps_s = eps * (float)s.v;
    const float half = 0.5f * eps_s;
    const int from = start ? (s.v > 0 ? kThR : kThL) : kThE;
    const float* sth = st + from * dim;
    const float* sr = sth + dim;
    const float* sg = sr + dim;
    float* the = st + kThE * dim;
    float* re = st + kRE * dim;
    float* rhos = st + kRhoS * dim;
    float q = 0.f;
    for (int k = lane; k < dim; k += 32) {
      const float r_half = sr[k] + half * sg[k];
      const float th = sth[k] + eps_s * (r_half * mi[k]);
      the[k] = th;
      re[k] = r_half;
      if (start) rhos[k] = 0.f;
      tg.put(tsm, cb0 + c, k, th);
      q += tg.term(k, th);
    }
    tg.clear_pad(tsm, cb0 + c, lane);
    s.q = warp_sum(q);
  };

  for (int c = 0; c < cpw; ++c) {
    const int chain = c0 + c;
    const bool real = chain < n_chains;
    float* the = vecs(c) + kThE * dim;
    float q = 0.f;
    for (int k = lane; k < dim; k += 32) {
      const float th = real ? theta0[(size_t)chain * dim + k] : 0.f;
      the[k] = th;
      tg.put(tsm, cb0 + c, k, th);
      q += tg.term(k, th);
    }
    tg.clear_pad(tsm, cb0 + c, lane);
    q = warp_sum(q);
    if (lane == 0) {
      records[c].q = q;
      records[c].done = real ? 0 : 1;
      // the SM that holds the block (for the caller's count of SMs used)
      if constexpr (Target::kCluster) records[c].sm = sm_id();
    }
  }
  float lik = tg.likelihood(tsm, blk, dim, nvec);
  __syncwarp();         // the records' lane-0 stores, for every lane

  // the first transition's start (momentum at counter base + 0, salt 1),
  // then the first leaf's drift
  int warp_done = 1;    // every chain of the warp has recorded T
  for (int c = 0; c < cpw; ++c) {
    Chain s = records[c];
    const float loglik = __shfl_sync(kFull, lik, c);
    float* st = vecs(c);
    const uint32_t row = row_of(c), base = base_of(c);
    auto V = [&](int v) { return st + v * dim; };
    const float ls = V(kThE)[0];
    const float ax = tg.aux(s.q, ls);
    const float lp0 = tg.lp(s.q, ls, ax, loglik);
    float nk = 0.f;
    for (int k = lane; k < dim; k += 32) {
      const float th = V(kThE)[k];
      const float g = tg.grad(tsm, V(kGE), cb0 + c, k, th, s.q, ls, ax);
      const float r = normal_at(base, row * (uint32_t)dp + k, 1u) * isq_at(k);
      nk += r * r * mi[k];
      V(kRE)[k] = r;
      V(kThL)[k] = V(kThR)[k] = V(kThC)[k] = V(kThSc)[k] = th;
      V(kRL)[k] = V(kRR)[k] = V(kRhoT)[k] = r;
      V(kGE)[k] = V(kGL)[k] = V(kGR)[k] = V(kGC)[k] = V(kGSc)[k] = g;
      V(kRhoS)[k] = 0.f;
    }
    s.h0 = -(lp0 + -0.5f * warp_sum(nk));
    s.lp_c = s.lp_sc = lp0;
    s.t_w = 0.f;
    s.s_w = -CUDART_INF_F;
    s.n_alpha = s.depth = s.leaf = s.t = s.diverged = 0;
    s.v = 1;
    drift(s, c, st, base + 1u, row);
    warp_done &= s.done;
    if (lane == 0) records[c] = s;
  }

  for (int it = 0; it < max_iters; ++it) {
    if constexpr (Target::kCluster) {
      if (tg.all_done(tsm, warp_done)) break;
    } else {
      if (__syncthreads_and(warp_done)) break;
    }
    lik = tg.likelihood(tsm, blk, dim, nvec);
    warp_done = 1;

    for (int c = 0; c < cpw; ++c) {
      Chain s = records[c];
      const float loglik = __shfl_sync(kFull, lik, c);
      const int chain = c0 + c;
      float* st = vecs(c);
      const uint32_t row = row_of(c), base = base_of(c);
      const uint32_t ctr = base + (uint32_t)(it + 1);
      auto V = [&](int v) { return st + v * dim; };
      float* the = V(kThE); float* re = V(kRE); float* ge = V(kGE);
      float* thl = V(kThL); float* rl = V(kRL); float* gl = V(kGL);
      float* thr = V(kThR); float* rr = V(kRR); float* gr = V(kGR);
      float* thc = V(kThC); float* gc = V(kGC);
      float* thsc = V(kThSc); float* gsc = V(kGSc);
      float* rhot = V(kRhoT); float* rhos = V(kRhoS);
      float* ckr = V(kCk);                  // slot j at ckr + j * dim
      float* ckc = V(kCk + S);
      const bool fwd = s.v > 0;
      const float half = 0.5f * (eps * (float)s.v);

      // ---- the target at the frontier, and the second half kick ----
      const float ls = the[0];
      const float ax = tg.aux(s.q, ls);
      float lp_n = tg.lp(s.q, ls, ax, loglik);
      if (!isfinite(lp_n)) lp_n = -CUDART_INF_F;
      float nk = 0.f;
      for (int k = lane; k < dim; k += 32) {
        const float g = tg.grad(tsm, ge, cb0 + c, k, the[k], s.q, ls, ax);
        const float r = re[k] + half * g;
        ge[k] = g;
        re[k] = r;
        nk += r * r * mi[k];
      }
      nk = -0.5f * warp_sum(nk);
      if (!isfinite(nk)) nk = -CUDART_INF_F;
      const float h_n = -(lp_n + nk);
      const float dh = h_n - s.h0;

      // ---- multinomial leaf weight and reservoir; the first U-turn span
      // that ends at an odd leaf i (kk = 1, from leaf i - 1) or the even
      // leaf's checkpoint ----
      const float lw_leaf = -dh;
      const float new_sw = logaddexp(s.s_w, lw_leaf);
      const bool take = logf(uniform_at(ctr, row, 3u)) < lw_leaf - new_sw;
      const bool diverging = !(dh < kDeltaMax);
      s.s_w = new_sw;
      if (take) s.lp_sc = lp_n;
      s.n_alpha += 1;
      const int i = s.leaf;
      const bool odd = i & 1;
      const bool span1 = odd && S >= 2;
      const int at = odd ? i - 1 : i;           // span start, or the leaf
      const int slot0 = at == 0 ? S - 1 : min(__ffs(at) - 1, S - 1);
      const float* ra = ckr + slot0 * dim;
      const float* ca = ckc + slot0 * dim;
      float d1 = 0.f, d2 = 0.f;
      for (int k = lane; k < dim; k += 32) {
        const float rv = re[k], rh = rhos[k] + rv;
        if (take) {
          thsc[k] = the[k];
          gsc[k] = ge[k];
        }
        if (span1) {
          const float rav = ra[k];
          const float span = rh - ca[k] + rav;
          d1 += span * (rav * mi[k]);
          d2 += span * (rv * mi[k]);
        } else if (!odd) {
          ckr[slot0 * dim + k] = rv;
          ckc[slot0 * dim + k] = rh;
        }
        rhos[k] = rh;
      }
      bool s_turning = false;
      if (span1) {
        d1 = warp_sum(d1);
        d2 = warp_sum(d2);
        s_turning = d1 <= 0.f || d2 <= 0.f;
      }
      // ---- the longer aligned spans that end at leaf i ----
      if (odd) {
        const int tones = __ffs(~i) - 1;
        for (int kk = 2; kk <= S - 1 && kk <= tones && !s_turning; ++kk) {
          const int a = i - (1 << kk) + 1;
          if (a < 0) break;
          const int slot = a == 0 ? S - 1 : min(__ffs(a) - 1, S - 1);
          const float* rak = ckr + slot * dim;
          const float* cak = ckc + slot * dim;
          d1 = d2 = 0.f;
          for (int k = lane; k < dim; k += 32) {
            const float span = rhos[k] - cak[k] + rak[k];
            d1 += span * (rak[k] * mi[k]);
            d2 += span * (re[k] * mi[k]);
          }
          d1 = warp_sum(d1);
          d2 = warp_sum(d2);
          s_turning = d1 <= 0.f || d2 <= 0.f;
        }
      }

      // ---- doubling complete? then biased progressive sampling, merge ----
      const bool sub_done = s_turning || diverging;
      const bool complete = sub_done || i >= (1 << s.depth) - 1;
      const bool not_term = !sub_done;
      const float e_mh = -logf(uniform_at(ctr, row, 4u));
      const bool acc = complete && not_term && s.t_w < s.s_w + e_mh;
      if (acc) s.lp_c = s.lp_sc;
      bool full_turn = false;
      if (complete) {           // (acc implies complete)
        // the edge the doubling did not move
        const float* r_far = fwd ? rl : rr;
        float* edge = fwd ? thr : thl;          // theta, r, g of the edge
        float fl = 0.f, fr = 0.f;
        for (int k = lane; k < dim; k += 32) {
          const float rv = re[k], rf = r_far[k];
          const float tv = the[k], gv = ge[k];
          const float c_rho = rhot[k] + rhos[k];
          if (acc) {
            thc[k] = thsc[k];
            gc[k] = gsc[k];
          }
          fl += c_rho * ((fwd ? rf : rv) * mi[k]);
          fr += c_rho * ((fwd ? rv : rf) * mi[k]);
          rhot[k] = c_rho;
          edge[k] = tv;
          edge[dim + k] = rv;
          edge[2 * dim + k] = gv;
        }
        fl = warp_sum(fl);
        fr = warp_sum(fr);
        full_turn = fl <= 0.f || fr <= 0.f;
        s.t_w = logaddexp(s.t_w, s.s_w);
        s.s_w = -CUDART_INF_F;
        s.leaf = 0;
      } else {
        s.leaf = i + 1;
      }
      s.depth += complete && not_term ? 1 : 0;
      s.diverged = s.diverged || (complete && diverging);
      const bool done = (complete && (sub_done || full_turn)) ||
                        s.depth >= S;

      // ---- transition boundary: record, then refresh ----
      if (done && !s.done) {
        const bool last = s.t + 1 >= T;
        float* out = out_theta + ((size_t)s.t * n_chains + chain) * dim;
        nk = 0.f;
        for (int k = lane; k < dim; k += 32) {
          const float tv = thc[k];
          out[k] = tv;
          if (!last) {
            const float gv = gc[k];
            const float r = normal_at(ctr, row * (uint32_t)dp + k, 5u) *
                            isq_at(k);
            nk += r * r * mi[k];
            the[k] = thl[k] = thr[k] = thsc[k] = tv;
            ge[k] = gl[k] = gr[k] = gsc[k] = gv;
            re[k] = rl[k] = rr[k] = rhot[k] = r;
            rhos[k] = 0.f;
          }
        }
        if (lane == 0) {
          const size_t tc = (size_t)T * n_chains;
          const size_t at_t = (size_t)s.t * n_chains + chain;
          out_stats[at_t] = s.n_alpha;
          out_stats[tc + at_t] = s.depth;
          out_stats[2 * tc + at_t] = s.diverged ? 1 : 0;
        }
        s.t += 1;
        if (last) {
          s.done = 1;
        } else {
          s.h0 = -(s.lp_c + -0.5f * warp_sum(nk));
          s.lp_sc = s.lp_c;
          s.t_w = 0.f;
          s.s_w = -CUDART_INF_F;
          s.n_alpha = 0;
          s.depth = 0;
          s.leaf = 0;
          s.diverged = 0;
        }
      }

      // ---- the next leaf's first half (counter of iteration it + 1) ----
      drift(s, c, st, ctr + 1u, row);
      warp_done &= s.done;
      if (lane == 0) records[c] = s;
    }
  }
  if constexpr (Target::kCluster) {
    // no rank leaves while another still reads its shared memory
    cg::this_cluster().sync();
  }
}

// ---------------------------------------------------------------- launch
template <class Target>
size_t smem_bytes(int dim) {
  return (Target::smem_floats(dim) +
          (Target::kMInvShared ? 2 * (size_t)dim : 0)) * sizeof(float);
}

// Sets the instance's attributes; gives its resident blocks per SM if
// `per_sm` is not null.
template <class Target>
cudaError_t prepare(int dim, int* per_sm) {
  const size_t smem = smem_bytes<Target>(dim);
  auto kern = fused_nuts_kernel<Target>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {   // room for kMinBlocks blocks per SM
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && Target::kCluster) {   // clusters above 8
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess && per_sm) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern,
                                                        kThreads, smem);
  }
  return err;
}

struct Args {
  const float* theta0;
  const float* m_inv;
  float eps;
  uint32_t seed;
  int block_chains, dp, n_chains, dim, T, S;
  int max_iters;        // leaf iterations at most: T (2^S) + 16
  float* scratch;
  float* out_theta;
  int* out_stats;
};

// The launch of a cluster instance: a cluster of `ranks` blocks for each
// group of kChains chains; `attr` holds the cluster's dimension.
template <class Target>
cudaLaunchConfig_t cluster_config(int n_chains, int dim, int ranks,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_chains + kChains - 1) / kChains * ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<Target>(dim);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Ranks per cluster of a cluster instance for a call's shape, and how many
// clusters of that size the card holds at once. A group's leaf iteration
// lasts about as long as its rank with the most row tiles, and the groups
// that the card cannot hold at once wait for a later wave, so of the sizes
// up to kMaxRanks (and one rank per row tile) the one with the fewest
// waves times row tiles a rank, the smallest of those on a tie: the same
// time on fewer blocks, and every rank holds a row tile. At C = 1024 and
// n = 1000 an H100 holds 14 clusters of 13-16 blocks but 16 of 11-12, so
// the 16 groups take 11 ranks of 3 row tiles, one wave (PERF.md has the
// sweep).
template <class Target>
cudaError_t cluster_ranks(int n_chains, int dim, int n, int* ranks,
                          int* clusters) {
  cudaError_t err = prepare<Target>(dim, nullptr);
  if (err != cudaSuccess) return err;
  const int groups = std::max(1, (n_chains + kChains - 1) / kChains);
  const int row_tiles = (n + kTileRows - 1) / kTileRows;
  const int most = std::max(1, std::min(kMaxRanks, row_tiles));
  int best_cost = 0;
  *ranks = 1;
  *clusters = 0;
  for (int r = 1; r <= most; ++r) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cluster_config<Target>(n_chains, dim, r, attr, 0);
    int resident = 0;
    err = cudaOccupancyMaxActiveClusters(&resident, fused_nuts_kernel<Target>,
                                         &cfg);
    if (err != cudaSuccess) return err;
    if (resident == 0) continue;
    const int cost = (groups + resident - 1) / resident *
                     std::max(1, (row_tiles + r - 1) / r);
    if (best_cost == 0 || cost < best_cost) {
      best_cost = cost;
      *ranks = r;
      *clusters = resident;
    }
  }
  return cudaSuccess;
}

template <class Target>
cudaError_t launch(const Target& tg, const Args& a, cudaStream_t stream) {
  if constexpr (Target::kCluster) {
    int ranks = 1, clusters = 0;
    cudaError_t err =
        cluster_ranks<Target>(a.n_chains, a.dim, tg.n, &ranks, &clusters);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cluster_config<Target>(a.n_chains, a.dim, ranks, attr, stream);
    err = cudaLaunchKernelEx(&cfg, fused_nuts_kernel<Target>, tg, a.theta0,
                             a.m_inv, a.eps, a.seed, a.block_chains, a.dp,
                             a.n_chains, a.dim, a.T, a.S, a.max_iters,
                             a.scratch, a.out_theta, a.out_stats);
    return err != cudaSuccess ? err : cudaGetLastError();
  } else {
    const cudaError_t err = prepare<Target>(a.dim, nullptr);
    if (err != cudaSuccess) return err;
    const int blocks = (a.n_chains + kChains - 1) / kChains;
    fused_nuts_kernel<Target><<<blocks, kThreads, smem_bytes<Target>(a.dim),
                                stream>>>(
        tg, a.theta0, a.m_inv, a.eps, a.seed, a.block_chains, a.dp,
        a.n_chains, a.dim, a.T, a.S, a.max_iters, a.scratch, a.out_theta,
        a.out_stats);
    return cudaGetLastError();
  }
}

// f(target) for the kernel instance of a target kind and dim; `none` where
// the kernel does not take them. Kinds: 0 = hierarchical logistic (d0 =
// x^T, >= dim rows by n columns, row 0 zero; d1 = y (n,)), 1 = diagonal
// Gaussian (d0 = the precisions). The narrow logistic instances, by k-steps
// of 8 columns (13 is the 100-D model's p = 99), are K1's warp tile: a call
// takes the smallest that holds its p <= 128; every wider p takes the wide
// instance.
template <class F, class R>
R dispatch(int kind, int dim, const float* d0, const float* d1, int n, F f,
           R none) {
  const int p = dim - 1;
  if (kind == 1) return f(GaussianTarget{d0});
  if (kind != 0 || p < 1) return none;
  if (p <= 32) return f(LogisticTarget<4>{d0, d1, n, p});
  if (p <= 64) return f(LogisticTarget<8>{d0, d1, n, p});
  if (p <= 104) return f(LogisticTarget<13>{d0, d1, n, p});
  if (p <= 128) return f(LogisticTarget<16>{d0, d1, n, p});
  return f(WideLogisticTarget{d0, d1, n, p});
}

}  // namespace

extern "C" {

// Chains per lock-step group: a thread block, or a cluster of blocks for
// the wide instance.
int fused_nuts_chains_per_block() { return kChains; }

// Floats of device scratch a call needs: the tree state of every chain of
// every block, 15 + 2 max_depth vectors of dim floats each, then a record
// of 16 scalars per chain.
size_t fused_nuts_scratch_floats(int n_chains, int dim, int max_depth) {
  const size_t chains = (size_t)(n_chains + kChains - 1) / kChains * kChains;
  return chains * (n_vectors(max_depth) * (size_t)dim + kChainWords);
}

// Dynamic shared memory of one block (bytes); 0 if the kernel does not take
// that target kind and dim.
size_t fused_nuts_smem_bytes(int kind, int dim) {
  return dispatch(kind, dim, nullptr, nullptr, 0,
                  [&](auto tg) { return smem_bytes<decltype(tg)>(dim); },
                  (size_t)0);
}

// Resident blocks per SM of the instance for a target kind and dim on the
// current device; 0 if that fails.
int fused_nuts_blocks_per_sm(int kind, int dim) {
  int per_sm = 0;
  const cudaError_t err = dispatch(
      kind, dim, nullptr, nullptr, 0,
      [&](auto tg) { return prepare<decltype(tg)>(dim, &per_sm); },
      cudaErrorInvalidValue);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return per_sm;
}

// Ranks per cluster (blocks per group of chains) of the instance for a
// call's shape on the current device, and how many such clusters the card
// holds at once: 1 and 0 for an instance launched without clusters, 0 and
// 0 if that fails.
void fused_nuts_cluster_shape(int kind, int n_chains, int dim, int n,
                              int* ranks, int* clusters) {
  *ranks = *clusters = 0;
  const cudaError_t err = dispatch(
      kind, dim, nullptr, nullptr, n,
      [&](auto tg) {
        using Target = decltype(tg);
        if constexpr (Target::kCluster) {
          return cluster_ranks<Target>(n_chains, dim, n, ranks, clusters);
        } else {
          *ranks = 1;
          return cudaSuccess;
        }
      },
      cudaErrorInvalidValue);
  if (err != cudaSuccess) {
    cudaGetLastError();
    *ranks = *clusters = 0;
  }
}

// theta0 (n_chains, dim), m_inv (dim,): contiguous float32 device arrays;
// d0, d1, n: the target's data (see `dispatch`); scratch: at least
// fused_nuts_scratch_floats(n_chains, dim, max_depth) floats. Outputs:
// out_theta (T, n_chains, dim) float32, out_stats (3, T, n_chains) int32
// (n_steps, depth, diverged). Launches on `stream`; returns the CUDA error
// code of the launch (0 on success).
int fused_nuts_f32(int kind, const float* theta0, const float* m_inv,
                   float eps, uint32_t seed, int block_chains, int dp,
                   int n_chains, int dim, int T, int max_depth,
                   const float* d0, const float* d1, int n, float* scratch,
                   float* out_theta, int* out_stats, void* stream) {
  if (n_chains <= 0 || T <= 0) return 0;
  if (max_depth < 1 || max_depth > 10) return (int)cudaErrorInvalidValue;
  // (an argument, not computed in the kernel: the loop's bound is then
  // read where it lies instead of taking a register for the whole loop)
  const Args a{theta0, m_inv, eps, seed, block_chains, dp, n_chains, dim, T,
               max_depth, T * (1 << max_depth) + 16, scratch, out_theta,
               out_stats};
  const cudaError_t err = dispatch(
      kind, dim, d0, d1, n,
      [&](auto tg) { return launch(tg, a, (cudaStream_t)stream); },
      cudaErrorInvalidValue);
  if (err != cudaSuccess) cudaGetLastError();  // not reported again later
  return (int)err;
}

// The SMs that held a block of the call that left `scratch` (the same
// n_chains, dim and max_depth): distinct SM ids in the chains' records,
// which a cluster instance writes at its start; -1 if reading them fails.
// Waits for the device.
int fused_nuts_sms_used(int n_chains, int dim, int max_depth,
                        const float* scratch) {
  const size_t chains = (size_t)(n_chains + kChains - 1) / kChains * kChains;
  std::vector<Chain> records(chains);
  if (cudaDeviceSynchronize() != cudaSuccess ||
      cudaMemcpy(records.data(),
                 scratch + chains * n_vectors(max_depth) * (size_t)dim,
                 chains * sizeof(Chain),
                 cudaMemcpyDeviceToHost) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  std::set<int> sms;
  for (const Chain& c : records) sms.insert(c.sm);
  return (int)sms.size();
}

const char* fused_nuts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

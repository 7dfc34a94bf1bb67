// n_steps of leapfrog for a diagonal Gaussian target in one pass (kernel K3
// of the port).
//
// Replaces the Pallas kernel advancedhmc_tpu/ops/fused_leapfrog.py:33
// (`_kernel`, wrapper `fused_gaussian_leapfrog` :60). For chains c and dims
// k, with grad = -prec * theta and a diagonal M^-1:
//
//   r += eps/2 * grad;  theta += eps * (m_inv * r);  grad = -prec * theta;
//   r += eps/2 * grad                                  (n_steps times)
//   pot[c] = 1/2 sum_k prec * theta^2,   kin[c] = 1/2 sum_k m_inv * r^2
//
// Kick order. The half-kicks of consecutive steps are merged into full
// kicks, with a = eps * m_inv and b = eps * prec per element:
//
//   r -= b/2 * theta;  L times { theta += a * r;  r -= b * theta }
//                      (the last kick a half one, b/2)
//
// so an element-step is two dependent FMAs (the same function as the
// step-by-step order, rounded differently; held to it at 2e-5).
//
// Layout: rows of one dim index a lane. Dims are independent, so each
// element's L steps run in registers and theta', r' are written once. A
// warp's lanes cover 32 dims of a chain (D >= 32: the chain in chunks of
// 32 dims) or floor(32 / D) whole chains (D < 32); a lane holds that dim
// of E chains, one a row. So every element of a lane shares its a and b,
// which the step's FMAs read from one register each, and a row's 32
// elements are contiguous in memory. A task is E rows; a group of W warps
// walks the tasks (D > 256: W > 1, the warps splitting the chunks). A
// lane sums its rows' energy terms over its chunks; a warp sums its lanes
// by shuffles (segments of D lanes for D < 32), a group its warps through
// shared memory, each in a fixed order, so two calls give the same bits,
// with no atomics. No lane holds an element that does not exist, but the
// lanes past floor(32 / D) * D (D < 32) and past the last chunk's dims.
//
// E rule (host): the most rows a task, of 8, 4, 2, 1, that still gives
// every SM kWarpsPerSM warps' tasks. Many rows give each lane independent
// FMA chains (ILP; at (16384, 128) E = 8 beat E = 2 by 1.2x on an H100);
// few spread a small batch over more warps and SMs, where the dependent
// chain of 2L FMAs sets the time.
//
// Bound: (2L + 1) FMAs an element, 4 * C * D * L float32 operations at the
// CUDA cores' rate, against 16 * C * D + 8 * C + 8 * D bytes moved; at L =
// 100 the operations dominate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads a block
constexpr int kMaxE = 8;          // most rows a task
constexpr int kBlocksPerSM = 4;   // resident blocks an SM the grid aims for
constexpr int kWarpsPerSM = 12;   // warps' tasks an SM the E rule aims for

// L leapfrog steps of E independent elements with one a and b, kicks
// merged (see the head).
template <int E>
__device__ __forceinline__ void leapfrog(float (&th)[E], float (&rr)[E],
                                         float a, float nb, int n_steps) {
  if (n_steps <= 0) return;
  const float half_nb = 0.5f * nb;
#pragma unroll
  for (int e = 0; e < E; ++e) rr[e] = fmaf(half_nb, th[e], rr[e]);
#pragma unroll 16
  for (int s = 1; s < n_steps; ++s) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      th[e] = fmaf(a, rr[e], th[e]);
      rr[e] = fmaf(nb, th[e], rr[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    th[e] = fmaf(a, rr[e], th[e]);
    rr[e] = fmaf(half_nb, th[e], rr[e]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v over lanes [l, l + seg) at each lane l that starts a
// segment (l % seg == 0), in a fixed tree order.
__device__ __forceinline__ float segment_sum(float v, int lane, int seg) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane % seg + o < seg) v += u;
  }
  return v;
}

// Tasks of E rows, a task to a group of `group_warps` warps (1, or the
// block). A row is `chains_per_row` whole chains (D < 32) or one chain.
template <int E>
__global__ void __launch_bounds__(kThreads, 2)
leapfrog_rows(const float* __restrict__ theta, const float* __restrict__ r,
              const float* __restrict__ prec, const float* __restrict__ m_inv,
              float eps, int n_steps, int n_chains, int dim,
              int chains_per_row, int group_warps,
              float* __restrict__ theta_out, float* __restrict__ r_out,
              float* __restrict__ pot, float* __restrict__ kin) {
  __shared__ float part[2][kThreads / 32][E];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gw = warp % group_warps;              // warp of its group
  const int groups = blockDim.x / 32 / group_warps;
  const int cpr = chains_per_row;
  const bool packed = dim < 32;                   // whole chains a row
  const int n_chunks = packed ? 1 : (dim + 31) / 32;
  const long n_tasks = (n_chains + (long)E * cpr - 1) / ((long)E * cpr);
  // D < 32: lane l holds dim l % D of chain l / D of each row
  const int lane_chain = packed ? lane / dim : 0;
  const bool lane_used = !packed || lane < cpr * dim;
  for (long task = (long)blockIdx.x * groups + warp / group_warps;
       task < n_tasks; task += (long)gridDim.x * groups) {
    const long first = task * E * cpr + lane_chain;   // row 0's chain
    float p[E], q[E];
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = q[e] = 0.f;
    for (int c = gw; c < n_chunks; c += group_warps) {
      const int k = packed ? lane % dim : 32 * c + lane;
      const bool used = lane_used && k < dim;
      const float pr = used ? __ldg(prec + k) : 0.f;
      const float mi = used ? __ldg(m_inv + k) : 0.f;
      float th[E], rr[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const long chain = first + (long)e * cpr;
        const size_t at = (size_t)chain * dim + k;
        th[e] = used && chain < n_chains ? theta[at] : 0.f;
        rr[e] = used && chain < n_chains ? r[at] : 0.f;
      }
      leapfrog<E>(th, rr, eps * mi, -(eps * pr), n_steps);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const long chain = first + (long)e * cpr;
        if (used && chain < n_chains) {
          const size_t at = (size_t)chain * dim + k;
          theta_out[at] = th[e];
          r_out[at] = rr[e];
        }
        p[e] += pr * th[e] * th[e];
        q[e] += mi * rr[e] * rr[e];
      }
    }
    if (packed) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float pe = segment_sum(p[e], lane, dim);
        const float qe = segment_sum(q[e], lane, dim);
        const long chain = first + (long)e * cpr;
        if (lane_used && lane % dim == 0 && chain < n_chains) {
          pot[chain] = 0.5f * pe;
          kin[chain] = 0.5f * qe;
        }
      }
      continue;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      p[e] = warp_sum(p[e]);
      q[e] = warp_sum(q[e]);
    }
    if (group_warps > 1) {     // the group is the block
      if (lane == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          part[0][gw][e] = p[e];
          part[1][gw][e] = q[e];
        }
      }
      __syncthreads();
      if (gw == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          p[e] = q[e] = 0.f;
          for (int w = 0; w < group_warps; ++w) {
            p[e] += part[0][w][e];
            q[e] += part[1][w][e];
          }
        }
      }
      __syncthreads();
    }
    if (gw == 0 && lane == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const long chain = first + (long)e * cpr;
        if (chain < n_chains) {
          pot[chain] = 0.5f * p[e];
          kin[chain] = 0.5f * q[e];
        }
      }
    }
  }
}

template <int E>
cudaError_t resident(int threads, int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, leapfrog_rows<E>, threads, 0);
}

// The launch for (n_chains, dim): out = {E (rows a task), chains a row,
// warps a task, threads a block, blocks}.
constexpr int kShapeFields = 5;

cudaError_t plan(int n_chains, int dim, int* out) {
  static int sms = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int cpr = dim < 32 ? 32 / dim : 1;
  // a warp takes up to 8 chunks of a chain; longer chains split over more
  const int chunks = (dim + 31) / 32;
  const int warps = chunks > 8 * (kThreads / 32) ? kThreads / 32
                                                  : (chunks + 7) / 8;
  const int threads = warps > 1 ? 32 * warps : kThreads;
  const long rows = (n_chains + cpr - 1) / cpr;
  const long want = (long)kWarpsPerSM * sms;
  int e = kMaxE;
  while (e > 1 && rows * warps < want * e) e /= 2;
  int per_sm = 0;
  switch (e) {
    case 1: err = resident<1>(threads, &per_sm); break;
    case 2: err = resident<2>(threads, &per_sm); break;
    case 4: err = resident<4>(threads, &per_sm); break;
    default: err = resident<8>(threads, &per_sm); break;
  }
  if (err != cudaSuccess) return err;
  const long tasks = (rows + e - 1) / e;
  const int per_block = threads / 32 / warps;      // tasks a block at once
  const long blocks = (tasks + per_block - 1) / per_block;
  const long grid = (long)sms * (per_sm < kBlocksPerSM ? per_sm
                                                       : kBlocksPerSM);
  const int shape[kShapeFields] = {e, cpr, warps, threads,
                                   (int)(blocks < grid ? blocks : grid)};
  for (int i = 0; i < kShapeFields; ++i) out[i] = shape[i];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// theta, r (n_chains, dim); prec, m_inv (dim,); outputs theta_out, r_out
// (n_chains, dim), pot, kin (n_chains,): contiguous float32 device arrays.
// Launches one kernel on `stream` and returns the CUDA error code of the
// launch.
int fused_leapfrog_f32(const float* theta, const float* r, const float* prec,
                       const float* m_inv, float eps, int n_steps,
                       int n_chains, int dim, float* theta_out, float* r_out,
                       float* pot, float* kin, void* stream) {
  if (n_chains <= 0 || dim <= 0) return 0;
  int p[kShapeFields];
  cudaError_t err = plan(n_chains, dim, p);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)p[4]), block((unsigned)p[3]);
  switch (p[0]) {
#define K3_CASE(E)                                                        \
  case E:                                                                 \
    leapfrog_rows<E><<<grid, block, 0, s>>>(                              \
        theta, r, prec, m_inv, eps, n_steps, n_chains, dim, p[1], p[2],   \
        theta_out, r_out, pot, kin);                                      \
    break;
    K3_CASE(1)
    K3_CASE(2)
    K3_CASE(4)
    K3_CASE(8)
#undef K3_CASE
  }
  return (int)cudaGetLastError();
}

// The launch fused_leapfrog_f32 makes for (n_chains, dim), as plan's `out`
// (kShapeFields ints); returns a CUDA error code.
int fused_leapfrog_launch_shape(int n_chains, int dim, int* out) {
  return (int)plan(n_chains, dim, out);
}

const char* fused_leapfrog_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

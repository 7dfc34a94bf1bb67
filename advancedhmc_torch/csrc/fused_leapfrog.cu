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
// Dims are independent, so each element's L steps run in registers and
// theta', r' are written once. A chain owns a group of G lanes (G the
// smallest power of two >= dim, at most 32); a lane runs up to four of its
// chain's elements together for instruction-level parallelism, and the
// group's xor-shuffle sum forms the two energies. Bound: about 8 * C * D * L
// float32 operations against 16 * C * D + 8 * C bytes moved; at L = 100 the
// operations dominate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerLane = 4;   // elements a lane integrates together

__global__ void __launch_bounds__(kThreads)
fused_leapfrog_kernel(const float* __restrict__ theta,
                      const float* __restrict__ r,
                      const float* __restrict__ prec,
                      const float* __restrict__ m_inv, float eps, int n_steps,
                      int n_chains, int dim, int group,
                      float* __restrict__ theta_out,
                      float* __restrict__ r_out, float* __restrict__ pot,
                      float* __restrict__ kin) {
  const long gtid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long chain = gtid / group;
  const int sub = (int)(gtid % group);
  const bool real = chain < n_chains;
  const float half = 0.5f * eps;
  float pot_s = 0.f, kin_s = 0.f;
  if (real) {
    for (int k0 = sub; k0 < dim; k0 += kPerLane * group) {
      float th[kPerLane], rr[kPerLane], g[kPerLane], pr[kPerLane],
          mi[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int k = k0 + e * group;
        const bool in = k < dim;
        const size_t at = (size_t)chain * dim + k;
        th[e] = in ? theta[at] : 0.f;
        rr[e] = in ? r[at] : 0.f;
        pr[e] = in ? prec[k] : 0.f;
        mi[e] = in ? m_inv[k] : 0.f;
        g[e] = -pr[e] * th[e];
      }
      for (int s = 0; s < n_steps; ++s) {
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) {
          rr[e] = rr[e] + half * g[e];
          th[e] = th[e] + eps * (mi[e] * rr[e]);
          g[e] = -pr[e] * th[e];
          rr[e] = rr[e] + half * g[e];
        }
      }
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int k = k0 + e * group;
        if (k < dim) {
          const size_t at = (size_t)chain * dim + k;
          theta_out[at] = th[e];
          r_out[at] = rr[e];
          pot_s += pr[e] * th[e] * th[e];
          kin_s += mi[e] * rr[e] * rr[e];
        }
      }
    }
  }
  // sum over the chain's lane group (groups are aligned within the warp)
  for (int o = group / 2; o > 0; o >>= 1) {
    pot_s += __shfl_xor_sync(0xffffffffu, pot_s, o);
    kin_s += __shfl_xor_sync(0xffffffffu, kin_s, o);
  }
  if (real && sub == 0) {
    pot[chain] = 0.5f * pot_s;
    kin[chain] = 0.5f * kin_s;
  }
}

}  // namespace

extern "C" {

// theta, r (n_chains, dim); prec, m_inv (dim,); outputs theta_out, r_out
// (n_chains, dim), pot, kin (n_chains,): contiguous float32 device arrays.
// Launches on `stream` and returns the CUDA error code of the launch.
int fused_leapfrog_f32(const float* theta, const float* r, const float* prec,
                       const float* m_inv, float eps, int n_steps,
                       int n_chains, int dim, float* theta_out, float* r_out,
                       float* pot, float* kin, void* stream) {
  if (n_chains <= 0 || dim <= 0) return 0;
  int group = 1;
  while (group < dim && group < 32) group *= 2;
  const long threads = (long)n_chains * group;
  const long blocks = (threads + kThreads - 1) / kThreads;
  fused_leapfrog_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      theta, r, prec, m_inv, eps, n_steps, n_chains, dim, group, theta_out,
      r_out, pot, kin);
  return (int)cudaGetLastError();
}

const char* fused_leapfrog_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

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
// Design: a thread block owns kChains = 8 chains, one warp each. A warp
// keeps its chain's tree state (15 + 2S vectors of dim floats) in shared
// memory, with element k of every vector owned by lane k % 32, so the
// bookkeeping of a leaf needs no barrier; dot products are xor-shuffle sums,
// which leave the same value in every lane. The block walks leaves in lock
// step, as the Pallas block does: every chain takes exactly one leaf per
// iteration, and a chain that has finished its T transitions keeps
// iterating without recording, until all chains of the block are done.
// The target's value and gradient is computed for the whole tile at once
// (template parameter `Target`): for the hierarchical logistic the tile's
// 8 chains share each shared-memory tile of the design matrix.
//
// Bound: per leaf and chain the logistic costs 4 * p * n float32 operations
// (two products over the n x p design), which dominate; the bytes are the
// outputs theta (T, C, dim). Measured against both in chip_smoke.py.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;               // chains per block, one warp each
constexpr int kThreads = 32 * kChains;
constexpr int kRows = 128;               // design rows per shared tile
constexpr float kDeltaMax = 1000.f;

// tree-state vectors of a chain; the two checkpoint stacks follow kCk
enum Vec {
  kThE, kRE, kGE,       // integration frontier (leaf being taken)
  kThL, kRL, kGL,       // left edge of the tree
  kThR, kRR, kGR,       // right edge of the tree
  kThC, kGC,            // transition candidate
  kThSc, kGSc,          // candidate of the current doubling
  kRhoT, kRhoS,         // momentum sums of the tree and of the doubling
  kCk                   // ck_r[S] then ck_cum[S]
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
// rows of the design tile at a stride of 4 mod 32 floats: the float4 reads
// of 8 consecutive rows fall in 8 different groups of 4 banks
__host__ __device__ inline int xs_stride(int p) {
  const int s = round4(p);
  return s + (36 - s % 32) % 32;
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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float* vec_of(float* st, int nvec, int dim, int c,
                                         int v) {
  return st + ((size_t)c * nvec + v) * dim;
}

// ------------------------------------------------------------- targets
// Each target is called by every thread of the block. It reads theta from
// the kThE vector of each of the tile's chains and writes the gradient to
// its kGE vector and the log density to lp[c].

// Diagonal Gaussian: lp = -1/2 sum prec * theta^2, grad = -prec * theta.
struct GaussianTarget {
  const float* prec;   // (>= dim,)

  __host__ __device__ static size_t smem_floats(int) { return 0; }

  __device__ void operator()(float* st, int nvec, int dim, float* lp,
                             float*) const {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float* th = vec_of(st, nvec, dim, w, kThE);
    float* g = vec_of(st, nvec, dim, w, kGE);
    float s = 0.f;
    for (int k = lane; k < dim; k += 32) {
      const float t = th[k], pr = prec[k];
      s += pr * t * t;
      g[k] = -pr * t;
    }
    s = warp_sum(s);
    if (lane == 0) lp[w] = -0.5f * s;
  }
};

// Hierarchical logistic in block form (models/logistic.py:207-249):
// theta = (log sigma, beta_1..beta_p), x^T (d_pad, n) with row 0 zero.
struct LogisticTarget {
  const float* xt;     // (d_pad, n): rows 1..p are the features
  const float* y;      // (n,)
  int n, p;

  __host__ __device__ static size_t smem_floats(int dim) {
    const int p = dim - 1;
    return (size_t)kRows * xs_stride(p)      // xs: design tile, row-major
           + (size_t)kChains * round4(p)     // bt: the tile's beta rows
           + (size_t)kRows * kChains         // rs: residuals [row][chain]
           + kRows                           // ys
           + (size_t)kChains * round4(p)     // gacc: data gradient
           + 2 * kChains;                    // per-warp log-lik partials
  }

  __device__ void operator()(float* st, int nvec, int dim, float* lp,
                             float* sm) const {
    const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
    const int xstr = xs_stride(p), bstr = round4(p);
    float* xs = sm;
    float* bt = xs + kRows * xstr;
    float* rs = bt + kChains * bstr;
    float* ys = rs + kRows * kChains;
    float* gacc = ys + kRows;
    float* part = gacc + kChains * bstr;

    // warp w stages its chain's beta and the prior's sums
    const float* th = vec_of(st, nvec, dim, w, kThE);
    float ssq = 0.f;
    for (int k = lane; k < dim; k += 32) ssq += th[k] * th[k];
    ssq = warp_sum(ssq);
    const float ls = th[0];
    for (int k = lane; k < bstr; k += 32) {
      bt[w * bstr + k] = k < p ? th[1 + k] : 0.f;
      gacc[w * bstr + k] = 0.f;
    }

    // phase 1: chains 2cp, 2cp+1 x rows rp, rp+64; phase 2: chains
    // 4cq..4cq+3 x column col of each 128-wide chunk. Every accumulator
    // has one owner, so no atomics and a fixed summation order.
    const int cp = tid / 64, rp = tid % 64;
    const int cq = tid / 128, col = tid % 128;
    float ll0 = 0.f, ll1 = 0.f;
    for (int j0 = 0; j0 < n; j0 += kRows) {
      const int rows = min(kRows, n - j0);
      __syncthreads();   // the previous tile is consumed; bt, gacc staged
      for (int i = tid; i < kRows * bstr; i += kThreads) {
        const int j = i % kRows, k = i / kRows;
        xs[j * xstr + k] =
            (j < rows && k < p) ? xt[(size_t)(1 + k) * n + j0 + j] : 0.f;
      }
      if (tid < kRows) ys[tid] = tid < rows ? y[j0 + tid] : 0.f;
      __syncthreads();

      float acc[2][2] = {};
      const float4* b0 = reinterpret_cast<const float4*>(bt + 2 * cp * bstr);
      const float4* b1 = b0 + bstr / 4;
      const float4* x0 = reinterpret_cast<const float4*>(xs + rp * xstr);
      const float4* x1 = reinterpret_cast<const float4*>(xs + (rp + 64) * xstr);
      for (int k4 = 0; k4 < bstr / 4; ++k4) {
        const float4 a0 = b0[k4], a1 = b1[k4], u0 = x0[k4], u1 = x1[k4];
        acc[0][0] = fmaf(a0.x, u0.x, acc[0][0]);
        acc[0][0] = fmaf(a0.y, u0.y, acc[0][0]);
        acc[0][0] = fmaf(a0.z, u0.z, acc[0][0]);
        acc[0][0] = fmaf(a0.w, u0.w, acc[0][0]);
        acc[0][1] = fmaf(a0.x, u1.x, acc[0][1]);
        acc[0][1] = fmaf(a0.y, u1.y, acc[0][1]);
        acc[0][1] = fmaf(a0.z, u1.z, acc[0][1]);
        acc[0][1] = fmaf(a0.w, u1.w, acc[0][1]);
        acc[1][0] = fmaf(a1.x, u0.x, acc[1][0]);
        acc[1][0] = fmaf(a1.y, u0.y, acc[1][0]);
        acc[1][0] = fmaf(a1.z, u0.z, acc[1][0]);
        acc[1][0] = fmaf(a1.w, u0.w, acc[1][0]);
        acc[1][1] = fmaf(a1.x, u1.x, acc[1][1]);
        acc[1][1] = fmaf(a1.y, u1.y, acc[1][1]);
        acc[1][1] = fmaf(a1.z, u1.z, acc[1][1]);
        acc[1][1] = fmaf(a1.w, u1.w, acc[1][1]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = rp + 64 * q;
        const bool valid = j < rows;
        const float yv = ys[j];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float l = acc[s][q];
          const float softplus = fmaxf(l, 0.f) + log1pf(expf(-fabsf(l)));
          const float sig = 1.f / (1.f + expf(-l));
          const float ll = valid ? yv * l - softplus : 0.f;
          if (s == 0) ll0 += ll; else ll1 += ll;
          rs[j * kChains + 2 * cp + s] = valid ? yv - sig : 0.f;
        }
      }
      __syncthreads();

      for (int k = col; k < p; k += 128) {
        float g[4] = {};
        const float4* r4 = reinterpret_cast<const float4*>(rs) + cq;
        for (int j = 0; j < rows; ++j) {
          const float xv = xs[j * xstr + k];
          const float4 r = r4[2 * j];
          g[0] = fmaf(r.x, xv, g[0]);
          g[1] = fmaf(r.y, xv, g[1]);
          g[2] = fmaf(r.z, xv, g[2]);
          g[3] = fmaf(r.w, xv, g[3]);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) gacc[(4 * cq + s) * bstr + k] += g[s];
      }
    }
    ll0 = warp_sum(ll0);
    ll1 = warp_sum(ll1);
    if (lane == 0) {
      part[2 * w] = ll0;
      part[2 * w + 1] = ll1;
    }
    __syncthreads();

    // chain w sits in pair w / 2, slot w % 2, summed by warps 2(w/2), +1
    const int pw = 2 * (w / 2), s = w % 2;
    const float loglik = part[2 * pw + s] + part[2 * (pw + 1) + s];
    const float inv_s2 = expf(-2.f * ls);
    const float beta_sq = ssq - ls * ls;
    if (lane == 0) {
      lp[w] = -0.5f * (ls * ls) - 0.5f * beta_sq * inv_s2 - (float)p * ls
              + loglik;
    }
    float* g = vec_of(st, nvec, dim, w, kGE);
    for (int k = lane; k < dim; k += 32) {
      g[k] = k == 0 ? -ls + beta_sq * inv_s2 - (float)p
                    : gacc[w * bstr + k - 1] + (-th[k] * inv_s2);
    }
  }
};

template <class Target>
__host__ __device__ inline size_t smem_floats(int dim, int S) {
  return Target::smem_floats(dim) + kChains + 2 * (size_t)dim
         + (size_t)kChains * (kCk + 2 * S) * dim;
}

// --------------------------------------------------------------- kernel
template <class Target, int S>
__global__ void __launch_bounds__(kThreads, 1)
fused_nuts_kernel(Target target, const float* __restrict__ theta0,
                  const float* __restrict__ m_inv_in, float eps,
                  uint32_t seed, int block_chains, int dp, int n_chains,
                  int dim, int T, float* __restrict__ out_theta,
                  int* __restrict__ out_stats) {
  extern __shared__ float4 smem4[];
  float* scratch = reinterpret_cast<float*>(smem4);
  float* lpbuf = scratch + Target::smem_floats(dim);
  float* mi = lpbuf + kChains;          // M^-1
  float* isq = mi + dim;                // 1 / sqrt(M^-1), 0 where M^-1 = 0
  float* st = isq + dim;
  constexpr int nvec = kCk + 2 * S;

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int chain = blockIdx.x * kChains + w;
  const bool real = chain < n_chains;
  const uint32_t row = (uint32_t)(chain % block_chains);
  const uint32_t base =
      seed * 7919u + (uint32_t)(chain / block_chains) * 104729u;
  auto V = [&](int v) { return vec_of(st, nvec, dim, w, v); };
  float* the = V(kThE); float* re = V(kRE); float* ge = V(kGE);
  float* thl = V(kThL); float* rl = V(kRL); float* gl = V(kGL);
  float* thr = V(kThR); float* rr = V(kRR); float* gr = V(kGR);
  float* thc = V(kThC); float* gc = V(kGC);
  float* thsc = V(kThSc); float* gsc = V(kGSc);
  float* rhot = V(kRhoT); float* rhos = V(kRhoS);
  float* ckr = V(kCk);                  // slot s at ckr + s * dim
  float* ckc = V(kCk + S);

  for (int k = tid; k < dim; k += kThreads) {
    const float m = m_inv_in[k];
    mi[k] = m;
    isq[k] = m > 0.f ? 1.f / fmaxf(sqrtf(m), 1e-30f) : 0.f;
  }
  for (int k = lane; k < dim; k += 32) {
    the[k] = real ? theta0[(size_t)chain * dim + k] : 0.f;
  }
  __syncthreads();
  target(st, nvec, dim, lpbuf, scratch);
  __syncthreads();

  // initial transition: momentum at counter base + 0, salt 1
  float lp_c = lpbuf[w];
  float nk = 0.f;
  for (int k = lane; k < dim; k += 32) {
    const float r = normal_at(base, row * (uint32_t)dp + k, 1u) * isq[k];
    nk += r * r * mi[k];
    const float t = the[k], g = ge[k];
    re[k] = r;
    thl[k] = thr[k] = thc[k] = thsc[k] = t;
    rl[k] = rr[k] = rhot[k] = r;
    gl[k] = gr[k] = gc[k] = gsc[k] = g;
    rhos[k] = 0.f;
  }
  float h0 = -(lp_c + -0.5f * warp_sum(nk));
  float lp_sc = lp_c, t_w = 0.f, s_w = -CUDART_INF_F;
  int n_alpha = 0, depth = 0, leaf = 0, v = 1, t = 0;
  bool diverged = false, all_done = !real;

  const int max_iters = T * (1 << S) + 16;
  for (int it = 0; it < max_iters; ++it) {
    if (__syncthreads_and(all_done)) break;
    const uint32_t ctr = base + (uint32_t)(it + 1);
    const bool start = leaf == 0;
    if (start) v = uniform_at(ctr, row, 2u) < 0.5f ? -1 : 1;
    const bool fwd = v > 0;
    const float eps_s = eps * (float)v;
    const float half = 0.5f * eps_s;

    // ---- one leapfrog step: half kick and drift into the frontier ----
    const float* sth = start ? (fwd ? thr : thl) : the;
    const float* sr = start ? (fwd ? rr : rl) : re;
    const float* sg = start ? (fwd ? gr : gl) : ge;
    for (int k = lane; k < dim; k += 32) {
      const float r_half = sr[k] + half * sg[k];
      the[k] = sth[k] + eps_s * (r_half * mi[k]);
      re[k] = r_half;
      if (start) rhos[k] = 0.f;
    }
    if (start) s_w = -CUDART_INF_F;
    __syncthreads();
    target(st, nvec, dim, lpbuf, scratch);
    __syncthreads();

    float lp_n = lpbuf[w];
    if (!isfinite(lp_n)) lp_n = -CUDART_INF_F;
    nk = 0.f;
    for (int k = lane; k < dim; k += 32) {
      const float r = re[k] + half * ge[k];
      re[k] = r;
      nk += r * r * mi[k];
    }
    nk = -0.5f * warp_sum(nk);
    if (!isfinite(nk)) nk = -CUDART_INF_F;
    const float h_n = -(lp_n + nk);
    const float dh = h_n - h0;

    // ---- multinomial leaf weight and reservoir ----
    const float lw_leaf = -dh;
    const float new_sw = logaddexp(s_w, lw_leaf);
    const bool take = logf(uniform_at(ctr, row, 3u)) < lw_leaf - new_sw;
    const bool diverging = !(dh < kDeltaMax);
    s_w = new_sw;
    if (take) lp_sc = lp_n;
    for (int k = lane; k < dim; k += 32) {
      if (take) {
        thsc[k] = the[k];
        gsc[k] = ge[k];
      }
      rhos[k] += re[k];
    }
    n_alpha += 1;

    // ---- U-turn checks over the aligned spans that end at leaf i ----
    const int i = leaf;
    bool s_turning = false;
    if (i & 1) {
      const int tones = __ffs(~i) - 1;
      for (int kk = 1; kk <= S - 1 && kk <= tones && !s_turning; ++kk) {
        const int a = i - (1 << kk) + 1;
        if (a < 0) break;
        const int slot = a == 0 ? S - 1 : min(__ffs(a) - 1, S - 1);
        const float* ra = ckr + slot * dim;
        const float* ca = ckc + slot * dim;
        float d1 = 0.f, d2 = 0.f;
        for (int k = lane; k < dim; k += 32) {
          const float span = rhos[k] - ca[k] + ra[k];
          d1 += span * (ra[k] * mi[k]);
          d2 += span * (re[k] * mi[k]);
        }
        d1 = warp_sum(d1);
        d2 = warp_sum(d2);
        s_turning = d1 <= 0.f || d2 <= 0.f;
      }
    } else {
      // ---- store the even leaf's checkpoint ----
      const int slot = i == 0 ? S - 1 : min(__ffs(i) - 1, S - 1);
      for (int k = lane; k < dim; k += 32) {
        ckr[slot * dim + k] = re[k];
        ckc[slot * dim + k] = rhos[k];
      }
    }

    // ---- doubling complete? then biased progressive sampling, merge ----
    const bool sub_done = s_turning || diverging;
    const bool complete = sub_done || i >= (1 << depth) - 1;
    const bool not_term = !sub_done;
    const float e_mh = -logf(uniform_at(ctr, row, 4u));
    const bool acc = complete && not_term && t_w < s_w + e_mh;
    if (acc) lp_c = lp_sc;
    bool full_turn = false;
    float fl = 0.f, fr = 0.f;
    for (int k = lane; k < dim; k += 32) {
      if (acc) {
        thc[k] = thsc[k];
        gc[k] = gsc[k];
      }
      if (complete) {
        const float c_rho = rhot[k] + rhos[k];
        const float r_l = fwd ? rl[k] : re[k];
        const float r_r = fwd ? re[k] : rr[k];
        fl += c_rho * (r_l * mi[k]);
        fr += c_rho * (r_r * mi[k]);
        rhot[k] = c_rho;
        if (fwd) {
          thr[k] = the[k]; rr[k] = re[k]; gr[k] = ge[k];
        } else {
          thl[k] = the[k]; rl[k] = re[k]; gl[k] = ge[k];
        }
      }
    }
    if (complete) {
      fl = warp_sum(fl);
      fr = warp_sum(fr);
      full_turn = fl <= 0.f || fr <= 0.f;
      t_w = logaddexp(t_w, s_w);
      s_w = -CUDART_INF_F;
      leaf = 0;
    } else {
      leaf = i + 1;
    }
    depth += complete && not_term ? 1 : 0;
    diverged = diverged || (complete && diverging);
    const bool done = (complete && (sub_done || full_turn)) || depth >= S;

    // ---- transition boundary: record, then refresh ----
    if (done && !all_done) {
      for (int k = lane; k < dim; k += 32) {
        out_theta[((size_t)t * n_chains + chain) * dim + k] = thc[k];
      }
      if (lane == 0) {
        const size_t tc = (size_t)T * n_chains;
        const size_t at = (size_t)t * n_chains + chain;
        out_stats[at] = n_alpha;
        out_stats[tc + at] = depth;
        out_stats[2 * tc + at] = diverged ? 1 : 0;
      }
      t += 1;
      if (t >= T) {
        all_done = true;
      } else {
        nk = 0.f;
        for (int k = lane; k < dim; k += 32) {
          const float r = normal_at(ctr, row * (uint32_t)dp + k, 5u) * isq[k];
          nk += r * r * mi[k];
          const float tc = thc[k], g = gc[k];
          the[k] = thl[k] = thr[k] = thsc[k] = tc;
          ge[k] = gl[k] = gr[k] = gsc[k] = g;
          re[k] = rl[k] = rr[k] = rhot[k] = r;
          rhos[k] = 0.f;
        }
        h0 = -(lp_c + -0.5f * warp_sum(nk));
        lp_sc = lp_c;
        t_w = 0.f;
        s_w = -CUDART_INF_F;
        n_alpha = 0;
        depth = 0;
        leaf = 0;
        diverged = false;
      }
    }
  }
}

template <class Target, int S>
int launch(const Target& target, const float* theta0, const float* m_inv,
           float eps, uint32_t seed, int block_chains, int dp, int n_chains,
           int dim, int T, float* out_theta, int* out_stats,
           cudaStream_t stream) {
  const size_t smem = smem_floats<Target>(dim, S) * sizeof(float);
  auto kern = fused_nuts_kernel<Target, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported again later
    return (int)err;
  }
  const int blocks = (n_chains + kChains - 1) / kChains;
  kern<<<blocks, kThreads, smem, stream>>>(target, theta0, m_inv, eps, seed,
                                           block_chains, dp, n_chains, dim, T,
                                           out_theta, out_stats);
  return (int)cudaGetLastError();
}

template <class Target>
int launch_depth(int S, const Target& target, const float* theta0,
                 const float* m_inv, float eps, uint32_t seed,
                 int block_chains, int dp, int n_chains, int dim, int T,
                 float* out_theta, int* out_stats, cudaStream_t stream) {
#define K2_CASE(s)                                                        \
  case s:                                                                 \
    return launch<Target, s>(target, theta0, m_inv, eps, seed,            \
                             block_chains, dp, n_chains, dim, T,          \
                             out_theta, out_stats, stream);
  switch (S) {
    K2_CASE(1) K2_CASE(2) K2_CASE(3) K2_CASE(4) K2_CASE(5)
    K2_CASE(6) K2_CASE(7) K2_CASE(8) K2_CASE(9) K2_CASE(10)
  }
#undef K2_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Target kinds: 0 = hierarchical logistic block, 1 = diagonal Gaussian.
// Dynamic shared memory one block needs (bytes).
size_t fused_nuts_smem_bytes(int kind, int dim, int max_depth) {
  const size_t floats = kind == 0 ? smem_floats<LogisticTarget>(dim, max_depth)
                                  : smem_floats<GaussianTarget>(dim, max_depth);
  return floats * sizeof(float);
}

// theta0 (n_chains, dim), m_inv (dim,): contiguous float32 device arrays.
// Logistic: d0 = x^T (>= dim rows, n columns), d1 = y (n,). Gaussian: d0 =
// the precisions (>= dim,). Outputs: out_theta (T, n_chains, dim) float32,
// out_stats (3, T, n_chains) int32 (n_steps, depth, diverged). Launches on
// `stream`; returns the CUDA error code of the launch (0 on success).
int fused_nuts_f32(int kind, const float* theta0, const float* m_inv,
                   float eps, uint32_t seed, int block_chains, int dp,
                   int n_chains, int dim, int T, int max_depth,
                   const float* d0, const float* d1, int n, float* out_theta,
                   int* out_stats, void* stream) {
  if (n_chains <= 0 || T <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) {
    const LogisticTarget tg{d0, d1, n, dim - 1};
    return launch_depth(max_depth, tg, theta0, m_inv, eps, seed,
                        block_chains, dp, n_chains, dim, T, out_theta,
                        out_stats, s);
  }
  if (kind == 1) {
    const GaussianTarget tg{d0};
    return launch_depth(max_depth, tg, theta0, m_inv, eps, seed,
                        block_chains, dp, n_chains, dim, T, out_theta,
                        out_stats, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fused_nuts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

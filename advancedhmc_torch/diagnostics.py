"""Diagnostics: pooled bulk ESS, the ragged per-chain ESS, rank-normalised
bulk ESS, tail ESS and split-R̂, the storage-free online summary and the
end-of-run report.

PyTorch counterpart of `advancedhmc_tpu/diagnostics.py:16,38,83,162,170,
185,245,311`. Draws are (n_samples, n_chains, dim) (the ragged ESS takes
(n_chains, T, dim) and the chains' counts); the ESS and R̂ are computed in
float64 on the draws' device, with FFT autocovariances (`torch.fft`). The
online summary (`collect="online"`) keeps per-chain running moments and a
window of lagged products in the draws' dtype, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _as_draws(x):
    x = torch.as_tensor(x).to(torch.float64)
    return x[:, None, :] if x.dim() == 2 else x


def _autocovariance_fft(x):
    """Autocovariance along axis 0 via FFT. x: (n, ...)."""
    n = x.shape[0]
    xc = x - x.mean(0, keepdim=True)
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    return torch.fft.irfft(f * f.conj(), n=nfft, dim=0)[:n] / n


def effective_sample_size(x):
    """Bulk ESS with Geyer's initial monotone sequence, pooling chains.

    x: (n_samples, n_chains, dim) → (dim,).
    """
    x = _as_draws(x)
    n, m, _ = x.shape
    acov = _autocovariance_fft(x)                       # (n, m, dim)
    mean_var = torch.mean(acov[0] * n / (n - 1.0), 0)   # within-chain W
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + torch.var(x.mean(0), 0, correction=1)
    rho = 1.0 - (mean_var[None] - acov.mean(1)) / var_plus[None]

    tau = torch.clamp(_geyer_tau(rho, 0), min=1.0 / math.log10(n * m))
    return n * m / tau


def _geyer_tau(rho, axis):
    """τ = −1 + 2 Σ P_k by Geyer's initial monotone sequence along `axis`
    of the autocorrelations `rho`: P_k = ρ_2k + ρ_2k+1, made monotone by a
    running minimum, summed while positive (a NaN pair ends the sum, as in
    the JAX scan)."""
    n_pairs = rho.shape[axis] // 2
    pair = (rho.narrow(axis, 0, 2 * n_pairs)
            .unflatten(axis, (n_pairs, 2)).sum(axis + 1))
    mono = torch.cummin(pair, axis).values
    alive = torch.cumprod(((pair > 0) & (mono > 0)).to(torch.int32),
                          axis) > 0
    return -1.0 + 2.0 * torch.sum(torch.where(alive, mono, 0.0), axis)


def effective_sample_size_ragged(x, counts):
    """Per-chain bulk ESS summed over chains, for ragged draws.

    `x` (n_chains, T, dim): chain c's draws are rows [0, counts[c]);
    `counts` (n_chains,) ints. Returns (dim,): the sum over chains of each
    chain's Geyer ESS on its own rows (no pooling of the correlograms and
    no between-chain term). A chain with one draw or none, or with no
    variance, adds 0.
    """
    x = torch.as_tensor(x).to(torch.float64)
    c, t_max, _ = x.shape
    counts = torch.as_tensor(counts, device=x.device)
    cntf = counts.to(torch.float64)
    mask = (torch.arange(t_max, device=x.device)[None]
            < counts[:, None])[..., None]                      # (C, T, 1)
    denom = torch.clamp(cntf, min=1.0)[:, None, None]
    xc = torch.where(mask, x - torch.sum(torch.where(mask, x, 0.0), 1,
                                         keepdim=True) / denom, 0.0)
    nfft = 1
    while nfft < 2 * t_max:
        nfft *= 2
    f = torch.fft.rfft(xc, n=nfft, dim=1)
    acov = torch.fft.irfft(f * f.conj(), n=nfft, dim=1)[:, :t_max] / denom
    var_c = acov[:, 0]                                         # (C, dim)
    rho = acov / torch.clamp(var_c[:, None],
                             min=torch.finfo(torch.float64).tiny)
    # lags at or past a chain's count are exact zeros (zero-padded xc), so
    # its monotone sum stops there at the latest
    tau = torch.maximum(_geyer_tau(rho, 1), 1.0 / torch.log10(
        torch.clamp(cntf, min=10.0))[:, None])
    ess_c = torch.where((var_c > 0) & (counts[:, None] > 1),
                        cntf[:, None] / tau, 0.0)
    return torch.sum(ess_c, 0)


def _rank_normalize(x):
    """z = Φ⁻¹((rank − 3/8)/(S + 1/4)) over the pooled (sample, chain) axes."""
    n, m = x.shape[0], x.shape[1]
    flat = x.reshape(n * m, -1)
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True).to(torch.float64) + 1.0
    u = (ranks - 0.375) / (n * m + 0.25)
    return torch.special.ndtri(u).reshape(x.shape)


def ess_bulk(x):
    """Rank-normalized bulk ESS. x: (n, m, dim) → (dim,)."""
    return effective_sample_size(_rank_normalize(_as_draws(x)))


def quantile0(x, q):
    """The `q`-quantile along axis 0 with linear interpolation (numpy's
    and `jnp.quantile`'s default method; NaN where a column holds one),
    from two order statistics a column: torch.quantile refuses inputs of
    more than 2^24 elements, which a long run's pooled draws exceed."""
    n = x.shape[0]
    pos = q * (n - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    w_hi = pos - lo
    low = torch.kthvalue(x, lo + 1, 0).values
    high = low if hi == lo else torch.kthvalue(x, hi + 1, 0).values
    out = low * (1.0 - w_hi) + high * w_hi
    return torch.where(torch.isnan(x).any(0), float("nan"), out)


def ess_tail(x, prob: float = 0.05):
    """Tail ESS: the smaller ESS of the two tail indicators I(x ≤ q_prob)
    and I(x ≥ q_{1−prob}) (the indicators' ESS directly, not
    rank-normalised). x: (n, m, dim) → (dim,)."""
    x = _as_draws(x)
    flat = x.reshape(-1, x.shape[-1])
    q_lo, q_hi = quantile0(flat, prob), quantile0(flat, 1.0 - prob)
    return torch.minimum(
        effective_sample_size((x <= q_lo).to(x.dtype)),
        effective_sample_size((x >= q_hi).to(x.dtype)))


def _median0(x):
    s = torch.sort(x, 0).values
    k = s.shape[0]
    return s[k // 2] if k % 2 else 0.5 * (s[k // 2 - 1] + s[k // 2])


def split_rhat(x):
    """Split-R̂ per parameter. x: (n_samples, n_chains, dim) → (dim,)."""
    x = _as_draws(x)
    half = x.shape[0] // 2
    halves = torch.cat([x[:half], x[half:2 * half]], 1)
    nn = halves.shape[0]
    w = torch.mean(torch.var(halves, 0, correction=1), 0)
    b = nn * torch.var(halves.mean(0), 0, correction=1)
    return torch.sqrt(((nn - 1.0) / nn * w + b / nn) / w)


def rhat(x):
    """Rank-normalized split-R̂: max of the bulk and folded statistics."""
    x = _as_draws(x)
    bulk = split_rhat(_rank_normalize(x))
    folded = torch.abs(x - _median0(x.reshape(-1, x.shape[-1])))
    return torch.maximum(bulk, split_rhat(_rank_normalize(folded)))


def ebfmi(energies):
    """E-BFMI = mean(diff(E)²) / var(E) along the draws, per chain."""
    e = torch.as_tensor(energies).to(torch.float64)
    return torch.mean(torch.diff(e, dim=0) ** 2, 0) / torch.var(
        e, 0, correction=0)


@dataclasses.dataclass(frozen=True)
class OnlineMoments:
    """Running per-chain moments and a window of lagged products, folded
    one draw batch at a time (no draw is stored)."""

    n: torch.Tensor          # () int32, draws folded in
    mean: torch.Tensor       # (C, D)
    m2: torch.Tensor         # (C, D), Σ of squared deviations
    lag_buf: torch.Tensor    # (K, C, D), the last K draws, newest first
    lag_acc: torch.Tensor    # (K, C, D), running Σ_t x_t·x_{t-k-1}


def online_init(n_chains: int, dim: int, n_lags: int = 16,
                dtype=torch.float32, device=None) -> OnlineMoments:
    """An empty summary on `device` (None means CUDA)."""
    from .utils import resolve_device

    device = resolve_device(device)
    z = torch.zeros(n_chains, dim, dtype=dtype, device=device)
    zk = torch.zeros(n_lags, n_chains, dim, dtype=dtype, device=device)
    return OnlineMoments(torch.zeros((), dtype=torch.int32, device=device),
                         z, z.clone(), zk, zk.clone())


def online_update(om: OnlineMoments, x) -> OnlineMoments:
    """Fold one draw batch `x (n_chains, dim)` into the running summary."""
    k = om.lag_buf.shape[0]
    valid = (om.n > torch.arange(k, device=x.device))[:, None, None]
    lag_acc = om.lag_acc + torch.where(valid, x[None] * om.lag_buf, 0.0)
    lag_buf = torch.cat([x[None], om.lag_buf[:-1]], 0)
    n1 = om.n + 1
    delta = x - om.mean
    mean = om.mean + delta / n1.to(x.dtype)
    m2 = om.m2 + delta * (x - mean)
    return OnlineMoments(n1, mean, m2, lag_buf, lag_acc)


def online_summary(om: OnlineMoments):
    """Per-chain mean and variance, and the pooled bulk ESS from the K-lag
    window (the Geyer sum truncated at K lags: exact when the chain mixes
    within K lags, an upper bound otherwise)."""
    dtype = om.mean.dtype
    n = om.n.to(dtype)
    k, n_chains, dim = om.lag_buf.shape
    var = om.m2 / torch.clamp(n - 1.0, min=1.0)           # (C, D)
    # autocovariance at lag k+1: S_k/(n-k-1) - mean² (final-mean approx)
    lags = torch.arange(1, k + 1, dtype=dtype, device=om.mean.device)
    acov = om.lag_acc / torch.clamp(n - lags, min=1.0)[:, None, None] \
        - (om.mean ** 2)[None]
    w = torch.mean(var, 0)                                # (D,)
    var_plus = w * (n - 1.0) / n
    if n_chains > 1:
        var_plus = var_plus + torch.var(om.mean, 0, correction=1)
    rho = 1.0 - (w[None] - torch.mean(acov, 1)) / var_plus[None]   # (K, D)
    rho = torch.cat([torch.ones_like(rho[:1]), rho], 0)
    n_pairs = (k + 1) // 2
    even = rho[0:2 * n_pairs:2]
    odd = rho[1:1 + 2 * n_pairs:2]
    pair = even + odd[:even.shape[0]]
    # the JAX scan: a running minimum, summed while positive
    prev = torch.full_like(pair[0], float("inf"))
    alive = torch.ones_like(pair[0], dtype=torch.bool)
    total_pairs = torch.zeros_like(pair[0])
    for p in pair:
        p = torch.minimum(p, prev)
        alive = alive & (p > 0)
        prev = torch.where(alive, p, prev)
        total_pairs = total_pairs + torch.where(alive, p, 0.0)
    tau = torch.clamp(-1.0 + 2.0 * total_pairs, min=1.0)
    return {"n": om.n, "mean": om.mean, "var": var,
            "ess": n * n_chains / tau}


def summarize(result, verbose: bool = True):
    """End-of-run report: E-BFMI, mean acceptance and divergence rate per
    chain, and the bulk and tail ESS and R̂ of the draws (or the online
    summary's ESS)."""
    stats = result.stats
    report = {
        "ebfmi": ebfmi(stats["hamiltonian_energy"]),
        "mean_acceptance_rate": torch.mean(
            stats["acceptance_rate"].to(torch.float64), 0),
        "divergence_rate": torch.mean(
            stats["numerical_error"].to(torch.float64), 0),
    }
    if result.thetas is not None:
        report["ess"] = ess_bulk(result.thetas)
        report["ess_tail"] = ess_tail(result.thetas)
        report["rhat"] = rhat(result.thetas)
    elif result.online is not None:
        report["ess"] = result.online["ess"]
    if verbose:
        msg = {k: float(torch.mean(v.to(torch.float64)))
               for k, v in report.items()}
        print(f"[advancedhmc_torch] sampling finished: {msg}")
        if msg["divergence_rate"] > 0.25:
            print("[advancedhmc_torch] WARNING: the level of numerical "
                  "errors is high (>25% divergent transitions). Please "
                  "check the model carefully.")
    return report

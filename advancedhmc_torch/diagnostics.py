"""Diagnostics: pooled bulk ESS, rank-normalised bulk ESS and split-R̂.

PyTorch counterpart of `advancedhmc_tpu/diagnostics.py:38,162,185`. Draws are
(n_samples, n_chains, dim); everything is computed in float64 on the draws'
device, with FFT autocovariances (`torch.fft`).
"""

from __future__ import annotations

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

    # Geyer: P_k = rho_2k + rho_2k+1, made monotone by a running minimum,
    # summed while positive (a NaN pair ends the sum, as in the JAX scan).
    n_pairs = n // 2
    pair = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    mono = torch.cummin(pair, 0).values
    alive = torch.cumprod(((pair > 0) & (mono > 0)).to(torch.int32), 0) > 0
    tau = -1.0 + 2.0 * torch.sum(torch.where(alive, mono, 0.0), 0)
    tau = torch.clamp(tau, min=1.0 / math.log10(n * m))
    return n * m / tau


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

"""The benchmark's frozen copy of the pooled bulk ESS.

The estimator is the program's `diagnostics.effective_sample_size` as it
stood when the benchmark was defined (Geyer's initial monotone sequence
over FFT autocovariances pooled across chains, with the between-chain
variance in var⁺), copied so that a change to the program cannot move the
yardstick. It is taken over blocks of parameters, in float64, so that a
long window's draws fit on the card; the result is the same as over all
parameters at once.
"""

from __future__ import annotations

import math

import torch


def _autocovariance_fft(x):
    n = x.shape[0]
    xc = x - x.mean(0, keepdim=True)
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    return torch.fft.irfft(f * f.conj(), n=nfft, dim=0)[:n] / n


def _geyer_tau(rho):
    n_pairs = rho.shape[0] // 2
    pair = rho[:2 * n_pairs].unflatten(0, (n_pairs, 2)).sum(1)
    mono = torch.cummin(pair, 0).values
    alive = torch.cumprod(((pair > 0) & (mono > 0)).to(torch.int32), 0) > 0
    return -1.0 + 2.0 * torch.sum(torch.where(alive, mono, 0.0), 0)


def _ess_block(x):
    n, m, _ = x.shape
    acov = _autocovariance_fft(x)
    mean_var = torch.mean(acov[0] * n / (n - 1.0), 0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + torch.var(x.mean(0), 0, correction=1)
    rho = 1.0 - (mean_var[None] - acov.mean(1)) / var_plus[None]
    tau = torch.clamp(_geyer_tau(rho), min=1.0 / math.log10(n * m))
    return n * m / tau


def effective_sample_size(x, max_bytes: float = 4e9):
    """Pooled bulk ESS of draws `x` (n_samples, n_chains, dim) → (dim,)
    float64, over blocks of parameters of at most about `max_bytes` of
    float64 work each (the FFT's buffers are about six times the block)."""
    n, m, d = x.shape
    per_param = 6 * 8 * 2 * n * m
    step = max(1, min(d, int(max_bytes // per_param)))
    return torch.cat([_ess_block(x[:, :, lo:lo + step].to(torch.float64))
                      for lo in range(0, d, step)])

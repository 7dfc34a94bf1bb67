"""Gaussian-mixture targets (counterpart of `advancedhmc_tpu/models/
mixtures.py`), batched with their analytic gradients."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..target import LogDensityTarget
from ..utils import resolve_device


def gaussian_mixture(means, sigmas=1.0, weights=None, dtype=torch.float32,
                     device=None) -> LogDensityTarget:
    """Isotropic Gaussian mixture in D dimensions, its parameters in
    `dtype` on `device` (None means CUDA).

    `means`: (K, D) component means. `sigmas`: scalar or (K,) component
    standard deviations. `weights`: (K,) mixture weights (default
    uniform)."""
    device = resolve_device(device)
    mu = torch.as_tensor(np.asarray(means, np.float64), dtype=dtype,
                         device=device)
    k, d = mu.shape
    sig = torch.broadcast_to(torch.as_tensor(sigmas, dtype=dtype,
                                             device=device), (k,))
    if weights is None:
        log_w = torch.zeros(k, dtype=dtype, device=device) - math.log(k)
    else:
        w = torch.as_tensor(np.asarray(weights, np.float64), dtype=dtype,
                            device=device)
        log_w = torch.log(w / torch.sum(w))
    log_norm = -0.5 * d * math.log(2.0 * math.pi) - d * torch.log(sig)
    inv_var = 1.0 / (sig * sig)

    def logdensity_and_grad(theta):
        diff = (theta[:, None, :] - mu) / sig[:, None]            # (C, K, D)
        comp = log_w + log_norm - 0.5 * torch.sum(diff * diff, -1)  # (C, K)
        lp = torch.logsumexp(comp, -1)
        resp = torch.softmax(comp, -1)
        grad = -torch.sum(resp[:, :, None] * (theta[:, None, :] - mu)
                          * inv_var[:, None], 1)
        return lp, grad

    return LogDensityTarget(lambda theta: logdensity_and_grad(theta)[0],
                            int(d), logdensity_and_grad)


def two_gaussian_mixtures_2d(sep: float = 3.0, sigma: float = 0.5,
                             dtype=torch.float32,
                             device=None) -> LogDensityTarget:
    """The bimodal 2-D benchmark: equal-weight modes at (±sep/2, 0)."""
    half = 0.5 * sep
    return gaussian_mixture([[-half, 0.0], [half, 0.0]], sigma, dtype=dtype,
                            device=device)

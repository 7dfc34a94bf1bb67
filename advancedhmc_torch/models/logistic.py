"""Hierarchical Bayesian logistic regression, the sampler's main-path target.

PyTorch counterpart of `advancedhmc_tpu/models/logistic.py` (the same
fixed-seed synthetic design and the same model):

    log σ ~ N(0, 1),   β_j ~ N(0, σ²),   y_i ~ Bernoulli(logit⁻¹(x_iᵀ β))

θ = (log σ, β₁..β_p), dim = p + 1. The batched value+grad is the prior in
torch plus the likelihood from `ops.fused_logistic`, which is the CUDA
kernel K1 for CUDA tensors and its plain PyTorch version for CPU tensors —
the JAX package's `fused=True` route, taken on every batched call.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.fused_logistic import fused_logistic_value_grad
from ..target import LogDensityTarget
from ..utils import resolve_device


@lru_cache(maxsize=None)
def _synthetic_data(n: int, p: int, seed: int = 0):
    """Copy of the JAX package's generator; tests hold the two bit-equal."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    x = (x - x.mean(0)) / x.std(0)
    beta_true = rng.normal(size=(p,)) * 0.5
    logits = x @ beta_true
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    return x, y


def _prior(theta, p):
    """Log prior of (log σ, β) and its gradient, batched."""
    ls = theta[:, 0]
    beta = theta[:, 1:]
    inv_s2 = torch.exp(-2.0 * ls)
    bsq = torch.sum(beta * beta, -1)
    lp = -0.5 * ls * ls - 0.5 * bsq * inv_s2 - p * ls
    g0 = -ls + bsq * inv_s2 - p
    return lp, torch.cat([g0[:, None], -beta * inv_s2[:, None]], 1)


def hierarchical_logistic(n: int = 1000, p: int = 24, seed: int = 0,
                          dtype=torch.float32, resid_dtype=None, x_dtype=None,
                          device=None) -> LogDensityTarget:
    """The hierarchical logistic target on `device` (None means CUDA)."""
    if resid_dtype is not None or x_dtype is not None:
        raise NotImplementedError(
            "reduced-precision residuals / design matrix are not ported yet "
            "(ROADMAP.md section 1, item 2)")
    device = resolve_device(device)
    x_np, y_np = _synthetic_data(n, p, seed)
    x = torch.as_tensor(x_np, dtype=dtype, device=device).contiguous()
    y = torch.as_tensor(y_np, dtype=dtype, device=device)
    likelihood = fused_logistic_value_grad(x, y)

    def logdensity(theta):
        logits = theta[:, 1:] @ x.T
        ll = torch.sum(
            y * logits - torch.logaddexp(logits, torch.zeros_like(logits)), -1)
        return _prior(theta, p)[0] + ll

    def logdensity_and_grad(theta):
        lp_lik, g_lik = likelihood(theta)
        lp_pri, g_pri = _prior(theta, p)
        return lp_pri + lp_lik, g_pri + g_lik

    return LogDensityTarget(logdensity, p + 1, logdensity_and_grad)

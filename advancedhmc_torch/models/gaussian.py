"""Gaussian targets.

Counterparts of `advancedhmc_tpu/models/gaussian.py`: `std_gaussian` (:11),
`mvn_diag` (:23) and `correlated_gaussian` (:37) as batched targets with
their analytic gradients, and the first two in the block form of the NUTS
megakernel K2: a diagonal Gaussian with precisions `prec`, log density
−½ Σ prec·θ² and gradient −prec ⊙ θ (the target of the leapfrog kernel
K3), its data the (1, Dp) precision row, zero on padded dims; its
"gaussian" kind is compiled into K2's CUDA kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.counter_rng import _round_up
from ..target import BlockTarget, LogDensityTarget
from ..utils import resolve_device


def std_gaussian(dim: int, device=None) -> LogDensityTarget:
    """Standard normal on R^dim; its tensors are θ's, and `device` (None
    means CUDA) is checked as the other constructors check it."""
    resolve_device(device)

    def logdensity(x):
        return -0.5 * torch.sum(x * x, -1)

    def logdensity_and_grad(x):
        return logdensity(x), -x

    return LogDensityTarget(logdensity, dim, logdensity_and_grad)


def mvn_diag(variances, dtype=torch.float32, device=None) -> LogDensityTarget:
    """Independent Gaussian with the given variances, held in `dtype` on
    `device` (None means CUDA)."""
    var = torch.as_tensor(np.asarray(variances), dtype=dtype,
                          device=resolve_device(device))

    def logdensity(x):
        return -0.5 * torch.sum(x * x / var, -1)

    def logdensity_and_grad(x):
        return logdensity(x), -x / var

    return LogDensityTarget(logdensity, var.shape[0], logdensity_and_grad)


def correlated_gaussian(dim: int, rho: float = 0.8, dtype=torch.float32,
                        device=None) -> LogDensityTarget:
    """Equicorrelated Gaussian (pairwise correlation ρ), its covariance in
    the target's `cov` (float64, numpy) and its precision in `dtype` on
    `device` (None means CUDA)."""
    cov = (1 - rho) * np.eye(dim) + rho * np.ones((dim, dim))
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=dtype,
                           device=resolve_device(device))

    def logdensity_and_grad(x):
        g = x @ prec.T         # row c is prec·x_c
        return -0.5 * torch.sum(x * g, -1), -g

    def logdensity(x):
        return logdensity_and_grad(x)[0]

    t = LogDensityTarget(logdensity, dim, logdensity_and_grad)
    object.__setattr__(t, "cov", cov)
    return t


def _diag_gaussian_block(th, prec):
    return -0.5 * torch.sum(prec * th * th, 1, keepdim=True), -prec * th


def mvn_diag_block(variances, device=None):
    """Independent Gaussian with the given variances, on `device` (None
    means CUDA). Returns `(target, (prec (1, Dp),))`, Dp = round_up(dim,
    128). The precision is stored, so log density and gradient round as
    θ²·(1/var) where the JAX function divides by the variance."""
    device = resolve_device(device)
    var = np.asarray(variances, np.float64)
    prec = np.zeros((1, _round_up(var.shape[0], 128)), np.float32)
    prec[0, :var.shape[0]] = 1.0 / var
    return BlockTarget("gaussian", _diag_gaussian_block), (
        torch.as_tensor(prec, device=device),)


def std_gaussian_block(dim: int, device=None):
    """Standard normal on R^dim in block form (unit precisions)."""
    return mvn_diag_block(np.ones(dim), device=device)

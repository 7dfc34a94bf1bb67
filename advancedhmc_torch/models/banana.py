"""Banana-shaped posterior (counterpart of `advancedhmc_tpu/models/
banana.py`), batched with its analytic gradient."""

from __future__ import annotations

import torch

from ..target import LogDensityTarget
from ..utils import resolve_device


def banana(b: float = 0.03, sigma: float = 10.0,
           device=None) -> LogDensityTarget:
    """2-D twisted Gaussian: θ₁ ~ N(0, σ²), θ₂ | θ₁ ~ N(b(θ₁² − σ²), 1).
    Its tensors are θ's; `device` (None means CUDA) is checked as the other
    constructors check it."""
    resolve_device(device)

    def logdensity_and_grad(theta):
        t1, t2 = theta[:, 0], theta[:, 1]
        u = t2 - b * (t1 * t1 - sigma ** 2)
        lp = -0.5 * t1 * t1 / sigma ** 2 - 0.5 * u * u
        grad = torch.stack([-t1 / sigma ** 2 + 2.0 * b * t1 * u, -u], -1)
        return lp, grad

    return LogDensityTarget(lambda theta: logdensity_and_grad(theta)[0], 2,
                            logdensity_and_grad)

"""Spiral-shaped 2-D target (counterpart of `advancedhmc_tpu/models/
spiral.py`), batched with its analytic gradient.

Mass along an Archimedean spiral r = a·φ with a Gaussian cross-section σ;
the winding ambiguity (φ vs φ + 2πk) is a logsumexp over winding numbers.
"""

from __future__ import annotations

import math

import torch

from ..target import LogDensityTarget
from ..utils import resolve_device


def spiral(a: float = 0.5, sigma: float = 0.1, n_turns: int = 8,
           decay: float = 0.05, device=None) -> LogDensityTarget:
    """p(x) ∝ Σ_k exp(−(r − a(φ + 2πk))²/2σ² − decay·(φ + 2πk)) over
    k = 0..n_turns−1, r = ‖x‖, φ = atan2 ∈ [0, 2π). Its tensors are θ's;
    `device` (None means CUDA) is checked as the other constructors check
    it."""
    resolve_device(device)
    two_pi = 2.0 * math.pi

    def logdensity_and_grad(theta):
        x, y = theta[:, :1], theta[:, 1:2]
        rsq = x * x + y * y
        r = torch.sqrt(rsq + 1e-12)
        phi = torch.remainder(torch.atan2(y, x), two_pi)
        arm = phi + two_pi * torch.arange(n_turns, dtype=theta.dtype,
                                          device=theta.device)   # (C, K)
        res = (r - a * arm) / sigma
        lp_k = -0.5 * res * res - decay * arm
        lp = torch.logsumexp(lp_k, -1)
        w = torch.softmax(lp_k, -1)
        # ∂lp_k/∂r and ∂lp_k/∂φ, weighted by the winding's share
        d_r = torch.sum(w * -res / sigma, -1, keepdim=True)
        d_phi = torch.sum(w * (res * a / sigma - decay), -1, keepdim=True)
        grad = torch.cat([d_r * x / r - d_phi * y / rsq,
                          d_r * y / r + d_phi * x / rsq], 1)
        return lp, grad

    return LogDensityTarget(lambda theta: logdensity_and_grad(theta)[0], 2,
                            logdensity_and_grad)

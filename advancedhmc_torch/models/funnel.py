"""Neal's funnel, centered and non-centered (counterpart of
`advancedhmc_tpu/models/funnel.py`), as batched targets with autograd
gradients."""

from __future__ import annotations

import torch

from ..target import LogDensityTarget
from ..utils import resolve_device


def neal_funnel(dim: int = 10, sigma_v: float = 3.0,
                device=None) -> LogDensityTarget:
    """θ = (v, x₁..x_{d-1}): v ~ N(0, σ_v²), x_i | v ~ N(0, exp(v)).
    Its tensors are θ's; `device` (None means CUDA) is checked as the other
    constructors check it."""
    resolve_device(device)

    def logdensity(theta):
        v, x = theta[:, 0], theta[:, 1:]
        lp_v = -0.5 * v * v / sigma_v ** 2
        lp_x = -0.5 * torch.sum(x * x, -1) * torch.exp(-v) \
            - 0.5 * (dim - 1) * v
        return lp_v + lp_x

    return LogDensityTarget(logdensity, dim)


def neal_funnel_nc(dim: int = 10, sigma_v: float = 3.0,
                   device=None) -> LogDensityTarget:
    """Non-centered funnel θ̃ = (v, z₁..z_{d-1}), x_i = z_i·exp(v/2): v/σ_v
    and z are iid standard normals; `funnel_nc_to_centered` maps draws
    back."""
    resolve_device(device)

    def logdensity(theta):
        v, z = theta[:, 0], theta[:, 1:]
        return -0.5 * v * v / sigma_v ** 2 - 0.5 * torch.sum(z * z, -1)

    return LogDensityTarget(logdensity, dim)


def funnel_nc_to_centered(thetas):
    """(…, dim) non-centered draws → centered (v, x = z·exp(v/2))."""
    v = thetas[..., :1]
    return torch.cat([v, thetas[..., 1:] * torch.exp(0.5 * v)], -1)

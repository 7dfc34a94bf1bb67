"""Eight-schools hierarchical model, non-centred (counterpart of
`advancedhmc_tpu/models/eight_schools.py`), batched with its analytic
gradient. θ = (μ, log τ, z₁..z₈), dim = 10."""

from __future__ import annotations

import torch

from ..target import LogDensityTarget
from ..utils import resolve_device

_Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
_SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)


def eight_schools(dtype=torch.float32, device=None) -> LogDensityTarget:
    """μ ~ N(0, 5²), log τ ~ N(0, 1.5²), z ~ N(0, I), y_j ~ N(μ + τ z_j,
    σ_j²), the data in `dtype` on `device` (None means CUDA)."""
    device = resolve_device(device)
    y = torch.tensor(_Y, dtype=dtype, device=device)
    sigma = torch.tensor(_SIGMA, dtype=dtype, device=device)

    def logdensity_and_grad(theta):
        mu, log_tau, z = theta[:, :1], theta[:, 1:2], theta[:, 2:]
        tau = torch.exp(log_tau)
        res = (y - (mu + tau * z)) / sigma                      # (C, 8)
        lp = (-0.5 * (mu[:, 0] / 5.0) ** 2 - 0.5 * (log_tau[:, 0] / 1.5) ** 2
              - 0.5 * torch.sum(z * z, -1) - 0.5 * torch.sum(res * res, -1))
        e = res / sigma
        grad = torch.cat([
            -mu / 25.0 + torch.sum(e, -1, keepdim=True),
            -log_tau / 2.25 + torch.sum(e * tau * z, -1, keepdim=True),
            -z + tau * e], 1)
        return lp, grad

    return LogDensityTarget(lambda theta: logdensity_and_grad(theta)[0], 10,
                            logdensity_and_grad)

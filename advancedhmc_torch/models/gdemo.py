"""The gdemo conjugate model (counterpart of `advancedhmc_tpu/models/
gdemo.py`), batched with its analytic gradient.

s ~ InverseGamma(2, 3); m | s ~ N(0, s); observations 1.5, 2.0 ~ N(m, s).
Unconstrained θ = (log s, m) with the log-Jacobian; the posterior mean of
(s, m) is (49/24, 7/6).
"""

from __future__ import annotations

import math

import torch

from ..target import LogDensityTarget
from ..utils import resolve_device

GDEMO_MEAN = (49.0 / 24.0, 7.0 / 6.0)  # posterior mean of (s, m)

_OBS = (1.5, 2.0)
_ALPHA, _BETA = 2.0, 3.0


def gdemo(device=None) -> LogDensityTarget:
    """Its tensors are θ's; `device` (None means CUDA) is checked as the
    other constructors check it."""
    resolve_device(device)
    const = _ALPHA * math.log(_BETA) - math.lgamma(_ALPHA)
    log_2pi = math.log(2 * math.pi)

    def logdensity_and_grad(theta):
        z, m = theta[:, 0], theta[:, 1]
        s = torch.exp(z)
        inv_s = torch.exp(-z)
        log_s = torch.log(s)
        # InverseGamma(α, β) log pdf + log|ds/dz| = z; m | s ~ N(0, s)
        lp = (const - (_ALPHA + 1) * log_s - _BETA / s + z
              - 0.5 * (log_2pi + log_s + m * m / s))
        g_z = -(_ALPHA + 1) + _BETA * inv_s + 1.0 - 0.5 * (1.0 - m * m * inv_s)
        g_m = -m * inv_s
        for x in _OBS:
            lp = lp - 0.5 * (log_2pi + log_s + (x - m) ** 2 / s)
            g_z = g_z - 0.5 * (1.0 - (x - m) ** 2 * inv_s)
            g_m = g_m + (x - m) * inv_s
        return lp, torch.stack([g_z, g_m], -1)

    return LogDensityTarget(lambda theta: logdensity_and_grad(theta)[0], 2,
                            logdensity_and_grad)


def constrain(theta):
    """Map unconstrained draws (…, (log s, m)) to (…, (s, m))."""
    return torch.stack([torch.exp(theta[..., 0]), theta[..., 1]], -1)

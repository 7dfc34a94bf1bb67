"""ChEES: gradient-based trajectory-length adaptation (Hoffman, Radul &
Sountsov, AISTATS 2021).

Counterpart of `advancedhmc_tpu/adaptation/chees.py`. The mean trajectory
length T of jittered fixed-length HMC follows stochastic gradient ascent
(Adam on log T) on the Change-in-Estimator-of-Expected-Squared criterion

    ChEES(T) = ¼ E[ (‖θ′ − μ′‖² − ‖θ − μ‖²)² ],

whose per-chain pathwise gradient in the trajectory time τ is
(‖θ′ − μ′‖² − ‖θ − μ‖²) · (θ′ − μ′)ᵀ v′ (v′ = M⁻¹r′), weighted across
chains by the acceptance probabilities. The centering means μ, μ′ are
means over the chain batch, so the scheme is cross-chain. Trajectory times
are jittered by a Halton sequence, τ_m = u_m · T, shared by the chains at
iteration m. The state is a dataclass of 0-d tensors on the chains' device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..utils import resolve_device


def halton_sequence(n: int, base: int = 2) -> np.ndarray:
    """First n points of the van der Corput (Halton) sequence in (0, 1)."""
    out = np.zeros(n)
    for i in range(n):
        f, r, idx = 1.0, 0.0, i + 1
        while idx > 0:
            f /= base
            r += f * (idx % base)
            idx //= base
        out[i] = r
    return out


@dataclasses.dataclass(frozen=True)
class CheesConfig:
    """Adam-on-log-T hyperparameters. `avg_start`: the SGA steps after
    which iterates enter the finalize average (None: `sample_chees` takes
    n_adapts // 2)."""

    learning_rate: float = 0.025
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8
    max_trajectory_length: float = 100.0
    min_trajectory_length: float = 1e-3
    avg_start: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class CheesState:
    """Running trajectory-length adaptation state (0-d tensors)."""

    log_t: torch.Tensor      # log mean trajectory length T
    log_t_avg: torch.Tensor  # iterate average (used after finalize)
    m: torch.Tensor          # Adam first moment
    v: torch.Tensor          # Adam second moment
    count: torch.Tensor      # Adam step counter (int32)

    @classmethod
    def init(cls, t0, dtype=torch.float32, device=None):
        """T = t0 on `device` (None means CUDA)."""
        device = resolve_device(device)
        z = torch.zeros((), dtype=dtype, device=device)
        log_t = torch.log(torch.as_tensor(t0, dtype=dtype, device=device))
        return cls(log_t=log_t, log_t_avg=log_t, m=z, v=z,
                   count=torch.zeros((), dtype=torch.int32, device=device))

    @property
    def trajectory_length(self):
        return torch.exp(self.log_t)

    def finalize(self):
        """Freeze T at the iterate average."""
        return dataclasses.replace(self, log_t=self.log_t_avg)


def chees_update(cfg: CheesConfig, st: CheesState, theta_prev, theta_prop,
                 v_prop, alpha, tau) -> CheesState:
    """One stochastic-gradient-ascent step on log T, from the positions
    `theta_prev (C, D)`, the PROPOSED end points `theta_prop (C, D)` (even
    where rejected), their velocities `v_prop (C, D)`, the acceptance
    probabilities `alpha (C,)` and this iteration's time `tau` (0-d).
    Chains whose gradient term is not finite weigh nothing; a non-finite
    step keeps the old state (the count still moves)."""
    dtype = st.log_t.dtype
    c_prev = theta_prev - theta_prev.mean(0)
    c_prop = theta_prop - theta_prop.mean(0)
    dsq = torch.sum(c_prop * c_prop, -1) - torch.sum(c_prev * c_prev, -1)
    per_chain = dsq * torch.sum(c_prop * v_prop, -1)
    finite = torch.isfinite(per_chain)
    w = torch.where(finite, torch.clamp(alpha, 0.0, 1.0), 0.0)
    per_chain = torch.where(finite, per_chain, 0.0)
    grad_tau = torch.sum(w * per_chain) / torch.clamp(torch.sum(w), min=1e-6)
    # τ = u·exp(log T) ⇒ dτ/dlog T = τ; normalised by the criterion's scale
    grad = grad_tau * tau
    grad = grad / (torch.sqrt(torch.mean(dsq * dsq)) + 1e-6)

    count = st.count + 1
    cf = count.to(dtype)
    m = cfg.beta1 * st.m + (1.0 - cfg.beta1) * grad
    v = cfg.beta2 * st.v + (1.0 - cfg.beta2) * (grad * grad)
    m_hat = m / (1.0 - cfg.beta1 ** cf)
    v_hat = v / (1.0 - cfg.beta2 ** cf)
    log_t = st.log_t + cfg.learning_rate * m_hat / (
        torch.sqrt(v_hat) + cfg.adam_eps)
    log_t = torch.clamp(log_t, math.log(cfg.min_trajectory_length),
                        math.log(cfg.max_trajectory_length))
    # the iterate average restarts after `avg_start` SGA steps
    start = float(cfg.avg_start or 0)
    eta = 1.0 / torch.clamp(cf - start, min=1.0)
    log_t_avg = torch.where(cf <= start, log_t,
                            (1.0 - eta) * st.log_t_avg + eta * log_t)
    ok = torch.isfinite(log_t)
    return CheesState(
        log_t=torch.where(ok, log_t, st.log_t),
        log_t_avg=torch.where(ok, log_t_avg, st.log_t_avg),
        m=torch.where(ok, m, st.m),
        v=torch.where(ok, v, st.v),
        count=count,
    )

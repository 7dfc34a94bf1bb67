"""Nesterov dual-averaging step-size adaptation.

PyTorch counterpart of `advancedhmc_tpu/adaptation/stepsize.py:19,28,103`,
with the Stan defaults γ=0.05, t₀=10, κ=0.75. The state is a dataclass of
0-d tensors on the sampler's device, so an update never waits on the host.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DualAveragingConfig:
    delta: float = 0.8
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75


@dataclasses.dataclass(frozen=True)
class DualAveragingState:
    """State {m, ϵ, μ, x̄, H̄}."""

    m: torch.Tensor       # iteration counter (int32)
    eps: torch.Tensor     # current step size
    mu: torch.Tensor      # log(10·ϵ0) shrinkage target
    x_bar: torch.Tensor   # running average of log ϵ
    h_bar: torch.Tensor   # running average statistic

    @classmethod
    def init(cls, eps):
        return cls(m=torch.zeros_like(eps, dtype=torch.int32), eps=eps,
                   mu=torch.log(10.0 * eps), x_bar=torch.zeros_like(eps),
                   h_bar=torch.zeros_like(eps))

    def reset(self):
        """Recompute μ from the current ϵ."""
        return DualAveragingState.init(self.eps)

    def finalize(self):
        """ϵ ← exp(x̄)."""
        return dataclasses.replace(self, eps=torch.exp(self.x_bar))


def da_update(cfg: DualAveragingConfig, st: DualAveragingState, alpha):
    """One dual-averaging step on the acceptance statistic `alpha`.

    A non-finite ϵ reverts the whole update.
    """
    alpha = torch.as_tensor(alpha, dtype=st.eps.dtype, device=st.eps.device)
    m = st.m + 1
    mf = m.to(st.eps.dtype)
    eta_h = 1.0 / (mf + cfg.t0)
    h_bar = (1.0 - eta_h) * st.h_bar + eta_h * (
        cfg.delta - torch.clamp(alpha, max=1.0))
    x = st.mu - h_bar * torch.sqrt(mf) / cfg.gamma
    eta_x = mf ** (-cfg.kappa)
    x_bar = (1.0 - eta_x) * st.x_bar + eta_x * x
    eps = torch.exp(x)
    ok = torch.isfinite(eps)
    return DualAveragingState(
        m=torch.where(ok, m, st.m),
        eps=torch.where(ok, eps, st.eps),
        mu=st.mu,
        x_bar=torch.where(ok, x_bar, st.x_bar),
        h_bar=torch.where(ok, h_bar, st.h_bar),
    )

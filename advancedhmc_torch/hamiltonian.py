"""Hamiltonian layer: energies, phase points, momentum refreshment.

PyTorch counterpart of `advancedhmc_tpu/hamiltonian.py`. A `PhasePoint`
holds a batch of chains — θ, r and ∇ℓπ are (C, dim), ℓπ and -K are (C,) —
and caches the target density and gradient so that each leapfrog step
evaluates the target once. Non-finite log densities and kinetic energies
are clamped to -Inf at construction, so Metropolis-Hastings steps
auto-reject them. The momentum refreshments are full (a fresh draw) and
partial (r' = α·r + sqrt(1 − α²)·G).
"""

from __future__ import annotations

import dataclasses

import torch

from .kinetic import GaussianKinetic
from .metrics import Metric
from .target import LogDensityTarget
from .utils import clamp_nonfinite, roadmap


@dataclasses.dataclass(frozen=True)
class PhasePoint:
    """Positions + momenta with cached energies and target gradient."""

    theta: torch.Tensor       # (C, dim)
    r: torch.Tensor           # (C, dim)
    logdensity: torch.Tensor  # (C,), -inf where non-finite
    grad: torch.Tensor        # (C, dim) gradient of logdensity at theta
    neg_k: torch.Tensor       # (C,), -K(r), -inf where non-finite

    def energy(self):
        return -(self.logdensity + self.neg_k)

    def is_finite(self):
        return torch.isfinite(self.logdensity) & torch.isfinite(self.neg_k)


def select_phasepoint(pred, a: PhasePoint, b: PhasePoint) -> PhasePoint:
    """Per chain, `a` where `pred (C,)` holds, else `b`."""
    p2 = pred[:, None]
    return PhasePoint(
        theta=torch.where(p2, a.theta, b.theta),
        r=torch.where(p2, a.r, b.r),
        logdensity=torch.where(pred, a.logdensity, b.logdensity),
        grad=torch.where(p2, a.grad, b.grad),
        neg_k=torch.where(pred, a.neg_k, b.neg_k),
    )


@dataclasses.dataclass(frozen=True)
class Hamiltonian:
    """Bundles metric, kinetic energy, and the target density."""

    metric: Metric
    target: LogDensityTarget
    kinetic: GaussianKinetic = GaussianKinetic()

    def __post_init__(self):
        if not isinstance(self.kinetic, GaussianKinetic):
            raise NotImplementedError(
                "only the Gaussian kinetic energy is ported "
                + roadmap("surface"))

    @property
    def dim(self):
        return self.target.dim

    def neg_kinetic_energy(self, r):
        return self.metric.neg_kinetic_energy(r)

    def velocity(self, r):
        """∂H∂r = M⁻¹ r."""
        return self.metric.velocity(r)

    def phasepoint(self, theta, r, logdensity=None, grad=None):
        """Build a phase point, evaluating ℓπ/∇ℓπ unless provided."""
        if logdensity is None or grad is None:
            logdensity, grad = self.target.logdensity_and_grad(theta)
        return PhasePoint(
            theta=theta,
            r=r,
            logdensity=clamp_nonfinite(logdensity),
            grad=grad,
            neg_k=clamp_nonfinite(self.neg_kinetic_energy(r)),
        )

    def rand_momentum(self, generator, n_chains):
        return self.metric.rand_momentum(generator, n_chains)

    def init_phasepoint(self, generator, theta):
        """Fresh-momentum phase points at `theta (C, dim)`."""
        return self.phasepoint(theta,
                               self.rand_momentum(generator, theta.shape[0]))


@dataclasses.dataclass(frozen=True)
class FullMomentumRefreshment:
    """Completely resample momentum."""

    def refresh(self, generator, h: Hamiltonian, z: PhasePoint) -> PhasePoint:
        r = h.rand_momentum(generator, z.theta.shape[0])
        return h.phasepoint(z.theta, r, logdensity=z.logdensity, grad=z.grad)


@dataclasses.dataclass(frozen=True)
class PartialMomentumRefreshment:
    """r' = α·r + sqrt(1 − α²)·G, G a fresh momentum draw."""

    alpha: float

    def mix(self, h: Hamiltonian, z: PhasePoint, g) -> PhasePoint:
        """The refreshed phase points given the draws `g (C, dim)`."""
        a = torch.as_tensor(self.alpha, dtype=z.r.dtype, device=z.r.device)
        r = a * z.r + torch.sqrt(1 - a ** 2) * g
        return h.phasepoint(z.theta, r, logdensity=z.logdensity, grad=z.grad)

    def refresh(self, generator, h: Hamiltonian, z: PhasePoint) -> PhasePoint:
        return self.mix(h, z, h.rand_momentum(generator, z.theta.shape[0]))

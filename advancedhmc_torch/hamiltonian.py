"""Hamiltonian layer: energies, phase points, momentum refreshment.

PyTorch counterpart of `advancedhmc_tpu/hamiltonian.py`. A `PhasePoint`
holds a batch of chains — θ, r and ∇ℓπ are (C, dim), ℓπ and -K are (C,) —
and caches the target density and gradient so that each leapfrog step
evaluates the target once. Non-finite log densities and kinetic energies
are clamped to -Inf at construction, so Metropolis-Hastings steps
auto-reject them. The momentum refreshments are full (a fresh draw) and
partial (r' = α·r + sqrt(1 − α²)·G).

The kinetic energy is the Gaussian one, or the relativistic one
(`RelativisticKinetic`) on a unit or diagonal metric, shared or per chain:
K(r) = m c² sqrt(rᵀM⁻¹r/(m²c²) + 1), its velocity M⁻¹r/(m·sqrt(…)), its
momenta drawn by `riemannian.relativistic`.
"""

from __future__ import annotations

import dataclasses

import torch

from .kinetic import GaussianKinetic, RelativisticKinetic
from .metrics import DenseEuclideanMetric, DiagEuclideanMetric, Metric, \
    RankUpdateEuclideanMetric, UnitEuclideanMetric
from .target import LogDensityTarget
from .utils import clamp_nonfinite


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


def select_phasepoint(pred, a, b):
    """Per chain, `a` where `pred (C,)` holds, else `b`: two phase points
    of one class (a `PhasePoint`, or any frozen dataclass of (C,) and
    (C, dim) tensors, such as the Riemannian phase point)."""
    p2 = pred[:, None]
    return type(a)(**{
        f.name: torch.where(pred if getattr(a, f.name).dim() == 1 else p2,
                            getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)})


@dataclasses.dataclass(frozen=True)
class Hamiltonian:
    """Bundles metric, kinetic energy, and the target density."""

    metric: Metric
    target: LogDensityTarget
    kinetic: object = GaussianKinetic()

    # ∂H∂r depends on r alone (the Riemannian Hamiltonian's on θ too)
    theta_dependent_velocity = False

    def __post_init__(self):
        if not isinstance(self.kinetic, (GaussianKinetic,
                                         RelativisticKinetic)):
            raise TypeError(f"unknown kinetic energy "
                            f"{type(self.kinetic).__name__}")

    @property
    def dim(self):
        return self.target.dim

    @property
    def gaussian(self):
        """Whether the kinetic energy is the Gaussian one (its velocity
        linear in r)."""
        return isinstance(self.kinetic, GaussianKinetic)

    def neg_kinetic_energy(self, r):
        if self.gaussian:
            return self.metric.neg_kinetic_energy(r)
        return relativistic_neg_kinetic(self.kinetic, mass_inv_diag(
            self.metric), r)

    def velocity(self, r):
        """∂H∂r: M⁻¹ r for the Gaussian kinetic energy."""
        if self.gaussian:
            return self.metric.velocity(r)
        return relativistic_velocity(self.kinetic, mass_inv_diag(self.metric),
                                     r)

    def velocity_rows(self, rows):
        """The velocity of each row of `rows` (C, K, dim), each chain's M⁻¹
        applied to its own rows: M⁻¹r, or the relativistic velocity."""
        m = self.metric
        if isinstance(m, DiagEuclideanMetric) and m.m_inv.dim() == 2:
            if not self.gaussian:
                return relativistic_velocity(self.kinetic, m.m_inv[:, None],
                                             rows)
            return rows * m.m_inv[:, None]
        if isinstance(m, DenseEuclideanMetric) and m.m_inv.dim() == 3:
            return torch.bmm(rows, m.m_inv.mT)
        if isinstance(m, RankUpdateEuclideanMetric) and m.a_diag.dim() == 2:
            out = rows * m.a_diag[:, None]
            if m.rank > 0:
                out = out + torch.bmm(torch.bmm(torch.bmm(rows, m.b),
                                                m.d.mT), m.b.mT)
            return out
        c, k, d = rows.shape
        return self.velocity(rows.reshape(c * k, d)).reshape(c, k, d)

    def velocity_z(self, z):
        """∂H∂r at the phase points `z`: position-independent here; the
        Riemannian Hamiltonian's reads θ too (the hook the NUTS tree
        uses)."""
        return self.velocity(z.r)

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
        if self.gaussian:
            return self.metric.rand_momentum(generator, n_chains)
        from .riemannian.relativistic import rand_momentum_relativistic

        return rand_momentum_relativistic(self.kinetic, self.metric,
                                          generator, n_chains)

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


# -- the relativistic kinetic energy -------------------------------------------


def mass_inv_diag(metric: Metric):
    """The relativistic kinetic energy's M⁻¹ diagonal: None for the unit
    metric (M⁻¹ = I), (dim,) or per chain (C, dim) for a diagonal one; any
    other metric raises, as in the JAX package."""
    if isinstance(metric, UnitEuclideanMetric):
        return None
    if isinstance(metric, DiagEuclideanMetric):
        return metric.m_inv
    raise NotImplementedError(
        "RelativisticKinetic supports unit/diagonal metrics only")


def _mass_term(kinetic: RelativisticKinetic, m_inv, r):
    """sqrt(rᵀM⁻¹r/(m²c²) + 1) over the last axis of `r`."""
    m, c = kinetic.m, kinetic.c
    q = r * r if m_inv is None else r * r * m_inv
    return torch.sqrt(torch.sum(q, -1) / (m ** 2 * c ** 2) + 1.0)


def relativistic_neg_kinetic(kinetic: RelativisticKinetic, m_inv, r):
    """-K(r) = -m c² sqrt(rᵀM⁻¹r/(m²c²) + 1) over the last axis; `m_inv`
    None (unit metric) or broadcasting against `r`."""
    m, c = kinetic.m, kinetic.c
    return -m * c ** 2 * _mass_term(kinetic, m_inv, r)


def relativistic_velocity(kinetic: RelativisticKinetic, m_inv, r):
    """∂K/∂r = M⁻¹ r / (m · sqrt(…)) over the last axis of `r`."""
    denom = kinetic.m * _mass_term(kinetic, m_inv, r)
    return (r if m_inv is None else m_inv * r) / denom[..., None]

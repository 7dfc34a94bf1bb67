"""Riemannian Hamiltonian: position-dependent kinetic energy and gradients
(counterpart of `advancedhmc_tpu/riemannian/hamiltonian.py`; Girolami &
Calderhead 2011 Eqs 13-15, Betancourt 2012's SoftAbs gradients).

Batched over chains: θ and r are (C, D), G(θ) is (C, D, D) and ∂G
(C, D, D, D); the factorisations (`slogdet`, `solve`, `inv`, `eigh`,
Cholesky) run batched and give NaN, as in JAX, where a matrix is not
finite or not invertible, without a read back to the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..metrics import cholesky_upper
from ..target import LogDensityTarget
from ..utils import clamp_nonfinite, rand_normal
from .metric import DenseRiemannianMetric, IdentityMap, SoftAbsMap, \
    apply_map, softabs


@dataclasses.dataclass(frozen=True)
class RiemannianPhasePoint:
    """Phase points caching ℓπ, the full ∂H∂θ (which depends on θ AND r),
    and the position-dependent negative kinetic energy."""

    theta: torch.Tensor       # (C, D)
    r: torch.Tensor           # (C, D)
    logdensity: torch.Tensor  # (C,), -inf where non-finite
    dHdtheta: torch.Tensor    # (C, D) ∂H∂θ(θ, r), not just -∇ℓπ
    neg_k: torch.Tensor       # (C,), -inf where non-finite

    def energy(self):
        return -(self.logdensity + self.neg_k)

    def is_finite(self):
        return torch.isfinite(self.logdensity) & torch.isfinite(self.neg_k)


def _dsoftabs_dlam(alpha, lam):
    """d/dλ [λ coth(αλ)], Taylor-safe (the JAX function's form)."""
    al = alpha * lam
    coth = 1.0 / torch.tanh(al)
    csch2 = 1.0 / torch.square(torch.sinh(al))
    val = coth - al * csch2
    return torch.where(torch.abs(al) < 1e-4, 2.0 * al / (3.0 * alpha) * alpha,
                       val)


def _make_j(lam, alpha):
    """Betancourt's J matrix of eigenvalues `lam (…, D)`:
    J_ij = (sλ_i − sλ_j)/(λ_i − λ_j), on the diagonal and between
    degenerate eigenvalues the mean of dsoftabs/dλ at the two."""
    sl = lam / torch.tanh(alpha * lam)
    sl = torch.where(torch.abs(alpha * lam) < 1e-4, 1.0 / alpha, sl)
    num = sl[..., :, None] - sl[..., None, :]
    den = lam[..., :, None] - lam[..., None, :]
    diag = _dsoftabs_dlam(alpha, lam)
    safe = torch.abs(den) > 1e-10
    return torch.where(safe, num / torch.where(safe, den, 1.0),
                       0.5 * (diag[..., :, None] + diag[..., None, :]))


def _solve(a, b):
    """a⁻¹ b for batched `a (C, D, D)` and rows `b (C, D)`."""
    return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]


def _rows(a, b):
    """a @ b for batched `a (C, D, D)` and rows `b (C, D)`."""
    return (a @ b[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class RiemannianHamiltonian:
    """Hamiltonian with a `DenseRiemannianMetric` (Gaussian kinetic energy
    in G(θ))."""

    metric: DenseRiemannianMetric
    target: LogDensityTarget

    # ∂H∂r = G(θ)⁻¹r reads θ: the NUTS tree carries velocities
    theta_dependent_velocity = True

    @property
    def dim(self):
        return self.target.dim

    def _g(self, theta):
        return apply_map(self.metric.map, self.metric.g_fn(theta))

    def neg_kinetic_energy(self, theta, r):
        """−K = −½(D·log2π + logdet G) − ½ rᵀG⁻¹r (Eq 13)."""
        g = self._g(theta)
        d = g.shape[-1]
        _, logdet = torch.linalg.slogdet(g)
        logz = 0.5 * (d * math.log(2 * math.pi) + logdet)
        quad = torch.sum(r * _solve(g, r), -1)
        return -logz - 0.5 * quad

    def velocity(self, theta, r):
        """∂H∂r = G(θ)⁻¹ r (Eq 14)."""
        return _solve(self._g(theta), r)

    def velocity_z(self, z):
        """∂H∂r at the phase points `z`: the hook the NUTS tree uses, so
        that dynamic trajectories run on this geometry too."""
        return self.velocity(z.theta, z.r)

    def dH_dtheta(self, theta, r, cache=None, return_cache=False):
        """(ℓπ, ∂H∂θ(θ, r)) (Eq 15 / Betancourt 2012). ℓπ and ∇ℓπ come from
        the target's value+grad. `cache` carries the θ-only terms across
        the generalised leapfrog's fixed-point loop."""
        if isinstance(self.metric.map, IdentityMap):
            if cache is None:
                lp, glp = self.target.logdensity_and_grad(theta)
                g = self.metric.g_fn(theta)
                inv_g = torch.linalg.inv_ex(g)[0]
                dg = self.metric.dg_fn(theta)           # (C, D, D, i)
                cache = (lp, glp, inv_g, dg)
            else:
                lp, glp, inv_g, dg = cache
            # gᵢ = ∂ℓπᵢ − ½tr(G⁻¹∂Gᵢ) + ½ rᵀG⁻¹ ∂Gᵢ G⁻¹r
            tr_term = torch.einsum("cab,cbai->ci", inv_g, dg)
            gr = _rows(inv_g, r)
            quad_term = torch.einsum("ca,cabi,cb->ci", gr, dg, gr)
            grad_h = -(glp - 0.5 * tr_term + 0.5 * quad_term)
            out = (lp, grad_h)
            return (out, cache) if return_cache else out

        assert isinstance(self.metric.map, SoftAbsMap)
        alpha = self.metric.map.alpha
        if cache is None:
            lp, glp = self.target.logdensity_and_grad(theta)
            h_raw = self.metric.g_fn(theta)
            dh = self.metric.dg_fn(theta)               # (C, D, D, i)
            _, q, lam, soft_lam = softabs(h_raw, alpha)
            j = _make_j(lam, alpha)
            # term1 = Q diag(J_kk / sλ_k) Qᵀ
            jd = torch.diagonal(j, dim1=-2, dim2=-1)
            term1 = (q * (jd / soft_lam)[..., None, :]) @ q.mT
            cache = (lp, glp, dh, q, soft_lam, j, term1)
        else:
            lp, glp, dh, q, soft_lam, j, term1 = cache
        # term2 = Q D J D Qᵀ with D = diag((Qᵀr)/sλ)
        dvec = _rows(q.mT, r) / soft_lam
        term2 = (q * dvec[..., None, :]) @ j @ (dvec[..., :, None] * q.mT)
        tr1 = torch.einsum("cab,cabi->ci", term1, dh)
        tr2 = torch.einsum("cab,cabi->ci", term2, dh)
        grad_h = -(glp - 0.5 * tr1 + 0.5 * tr2)
        out = (lp, grad_h)
        return (out, cache) if return_cache else out

    def phasepoint(self, theta, r):
        lp, grad_h = self.dH_dtheta(theta, r)
        neg_k = self.neg_kinetic_energy(theta, r)
        return RiemannianPhasePoint(
            theta=theta, r=r, logdensity=clamp_nonfinite(lp),
            dHdtheta=grad_h, neg_k=clamp_nonfinite(neg_k))

    def momentum_from_normals(self, theta, z):
        """The momenta r ~ N(0, G(θ)) of standard normals `z (C, D)`:
        r = U⁻¹z with UᵀU = G⁻¹ (U the upper Cholesky factor)."""
        inv_g = torch.linalg.inv_ex(self._g(theta))[0]
        u = cholesky_upper(inv_g)
        return torch.linalg.solve_triangular(u, z[..., None],
                                             upper=True)[..., 0]

    def rand_momentum(self, generator, theta):
        """r ~ N(0, G(θ)) for every chain of `theta (C, D)`."""
        z = rand_normal(generator, theta.shape, theta.dtype, theta.device)
        return self.momentum_from_normals(theta, z)

    def init_phasepoint(self, generator, theta):
        return self.phasepoint(theta, self.rand_momentum(generator, theta))

"""Generalised (implicit) leapfrog for Riemannian HMC and the endpoint
transition (counterpart of `advancedhmc_tpu/riemannian/integrator.py`;
Girolami & Calderhead 2011 Eqs 16-18).

The two implicit updates run as fixed-count fixed-point loops (`n_fp`
iterations, no convergence test), Python loops over the batched chains,
with the θ-only SoftAbs terms cached across the momentum half-step's loop.
"""

from __future__ import annotations

import dataclasses

import torch

from ..hamiltonian import select_phasepoint
from ..integrators import _column
from ..trajectory import mh_accept_ratio
from ..utils import clamp_nonfinite
from .hamiltonian import RiemannianHamiltonian, RiemannianPhasePoint


@dataclasses.dataclass(frozen=True)
class GeneralizedLeapfrog:
    """Implicit leapfrog with `n_fp` fixed-point iterations; it has the
    integrator protocol, so that it slots into the NUTS tree (Riemannian
    NUTS)."""

    step_size: torch.Tensor
    n_fp: int = 6

    @property
    def nom_step_size(self):
        return self.step_size

    @property
    def current_step_size(self):
        return self.step_size

    def with_nom_step_size(self, eps):
        return dataclasses.replace(self, step_size=eps)

    def jitter(self, generator, n_chains=None):
        return self

    def temper_scale(self, i, is_half_first, n_steps):
        return None

    def step(self, h, z, eps, step_index=0, n_steps=1):
        return generalized_leapfrog_step(self, h, z, eps)


def generalized_leapfrog_step(integ: GeneralizedLeapfrog,
                              h: RiemannianHamiltonian,
                              z: RiemannianPhasePoint,
                              eps) -> RiemannianPhasePoint:
    """One implicit step of every chain; `eps` a scalar or per chain (C,),
    negative to integrate backwards.

    Eq 16: r½ = r₀ − ϵ/2 ∂H∂θ(θ₀, r½)   — fixed point in r½, θ-terms cached;
    Eq 17: θ₁ = θ₀ + ϵ/2 (∂H∂r(θ₀,r½) + ∂H∂r(θ₁,r½)) — fixed point in θ₁;
    Eq 18: r₁ = r½ − ϵ/2 ∂H∂θ(θ₁, r½).
    The new point stores ∂H∂θ at (θ₁, r½), as the JAX step does.
    """
    eps = _column(eps, z.theta)
    theta0, r0 = z.theta, z.r

    # Eq 16: iteration 1 reuses the phase point's ∂H∂θ, iteration 2
    # computes and caches the θ-only terms, the rest reuse them
    r_half = r0 - 0.5 * eps * z.dHdtheta
    (_, grad2), cache = h.dH_dtheta(theta0, r_half, return_cache=True)
    r_half = r0 - 0.5 * eps * grad2
    for _ in range(max(integ.n_fp - 2, 0)):
        _, grad_h = h.dH_dtheta(theta0, r_half, cache=cache)
        r_half = r0 - 0.5 * eps * grad_h

    # Eq 17: term1 = ∂H∂r(θ₀, r½) fixed
    term1 = h.velocity(theta0, r_half)
    theta_full = theta0
    for _ in range(integ.n_fp):
        theta_full = theta0 + 0.5 * eps * (term1
                                           + h.velocity(theta_full, r_half))

    # Eq 18: the explicit half kick at the new position
    lp, grad_h = h.dH_dtheta(theta_full, r_half)
    r_full = r_half - 0.5 * eps * grad_h
    neg_k = h.neg_kinetic_energy(theta_full, r_full)
    return RiemannianPhasePoint(
        theta=theta_full, r=r_full, logdensity=clamp_nonfinite(lp),
        dHdtheta=grad_h, neg_k=clamp_nonfinite(neg_k))


def transition_rmhmc(generator, h: RiemannianHamiltonian,
                     integ: GeneralizedLeapfrog, n_steps: int,
                     z: RiemannianPhasePoint):
    """Static endpoint-MH Riemannian transition of every chain: `n_steps`
    generalised leapfrog steps, each chain frozen after its first
    non-finite point, MH on the endpoint (one Exp(1) draw a chain), the
    momentum flipped. Returns (z_next, stats), the JAX function's stats
    with a chain axis."""
    h0 = z.energy()
    eps = integ.current_step_size
    zc = z
    done = torch.zeros_like(h0, dtype=torch.bool)
    for _ in range(n_steps):
        z_new = generalized_leapfrog_step(integ, h, zc, eps)
        zc = select_phasepoint(~done, z_new, zc)
        done = done | ~z_new.is_finite()
    e_prop = zc.energy()
    is_accept, alpha = mh_accept_ratio(generator, h0, e_prop)
    z_next = select_phasepoint(is_accept, zc, z)
    z_next = dataclasses.replace(z_next, r=-z_next.r)
    energy = z_next.energy()
    eps_t = torch.broadcast_to(torch.as_tensor(eps, dtype=h0.dtype,
                                               device=h0.device), h0.shape)
    stats = {
        "n_steps": torch.full_like(h0, n_steps, dtype=torch.int32),
        "is_accept": is_accept,
        "acceptance_rate": alpha,
        "log_density": z_next.logdensity,
        "hamiltonian_energy": energy,
        "hamiltonian_energy_error": energy - h0,
        "numerical_error": ~torch.isfinite(e_prop),
        "step_size": eps_t,
        "nom_step_size": eps_t,
    }
    return z_next, stats

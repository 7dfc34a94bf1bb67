"""Leapfrog integrator (counterpart of `advancedhmc_tpu/integrators.py`).

Only plain `Leapfrog` is on the main path; the jittered, tempered, composed
and external-solver integrators are queued under ROADMAP.md's "The rest
of the surface".
"""

from __future__ import annotations

import dataclasses

import torch

from .hamiltonian import Hamiltonian, PhasePoint


@dataclasses.dataclass(frozen=True)
class Leapfrog:
    """Leapfrog with a fixed step size."""

    step_size: torch.Tensor

    @property
    def nom_step_size(self):
        return self.step_size

    @property
    def current_step_size(self):
        return self.step_size

    def with_nom_step_size(self, eps):
        return dataclasses.replace(self, step_size=eps)

    def step(self, h, z, eps):
        """One step with signed step size `eps` (scalar or per chain)."""
        return leapfrog_step(h, z, eps)


def leapfrog_step(h: Hamiltonian, z: PhasePoint, eps) -> PhasePoint:
    """One kick-drift-kick step reusing the cached gradient.

    `eps` is a scalar or a (C,) tensor of signed step sizes (negative
    integrates backwards in time). Plain leapfrog needs nothing of the
    integrator, so unlike the JAX function this one does not take it.
    """
    eps = torch.as_tensor(eps, dtype=z.theta.dtype, device=z.theta.device)
    if eps.dim() == 1:
        eps = eps[:, None]
    r = z.r + 0.5 * eps * z.grad
    theta = z.theta + eps * h.velocity(r)
    logdensity, grad = h.target.logdensity_and_grad(theta)
    r = r + 0.5 * eps * grad
    return h.phasepoint(theta, r, logdensity=logdensity, grad=grad)

"""Symplectic integrators (counterpart of `advancedhmc_tpu/integrators.py`).

Every integrator has the JAX package's protocol: `nom_step_size` (what
adaptation moves), `current_step_size` (what a trajectory integrates at),
`with_nom_step_size(eps)`, `jitter(generator, n_chains=None)` (a new current
step size per trajectory; the identity but for `JitteredLeapfrog`),
`temper_scale(i, is_half_first, n_steps)` (the momentum multiplier of a
half step; None but for `TemperedLeapfrog`) and `step(h, z, eps,
step_index=0, n_steps=1)`. Step sizes are scalars or one per chain (C,);
a signed `eps` integrates backwards when negative.

Plain `Leapfrog` draws nothing in `jitter` and has no tempering, so its
step is the kick-drift-kick of `leapfrog_step` alone. `leapfrog_steps`
integrates a batch of chains n steps, `leapfrog_trajectory` keeps every
point of them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .hamiltonian import Hamiltonian, PhasePoint, select_phasepoint
from .utils import rand_uniform


def _column(x, like):
    """`x` (a number, a 0-d or a (C,) tensor) as a tensor that broadcasts
    against (C, dim) rows of `like`."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x[:, None] if x.dim() == 1 else x


class _Fixed:
    """The protocol of an integrator whose step size is `step_size`."""

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
        """One step with signed step size `eps` (scalar or per chain)."""
        return leapfrog_step(h, z, eps, self, step_index, n_steps)


@dataclasses.dataclass(frozen=True)
class Leapfrog(_Fixed):
    """Leapfrog with a fixed step size."""

    step_size: torch.Tensor


@dataclasses.dataclass(frozen=True)
class JitteredLeapfrog(_Fixed):
    """Leapfrog with a jittered step size per trajectory:
    ϵ = ϵ0·(1 + jitter·(2u − 1)), u ~ U(0, 1), one u per chain."""

    step_size0: torch.Tensor     # nominal step size (adapted)
    step_size: torch.Tensor      # current jittered step size
    jitter_frac: float = 0.1

    @classmethod
    def create(cls, step_size0, jitter_frac=0.1):
        eps0 = torch.as_tensor(step_size0)
        return cls(step_size0=eps0, step_size=eps0, jitter_frac=jitter_frac)

    @property
    def nom_step_size(self):
        return self.step_size0

    def with_nom_step_size(self, eps):
        # resets the current value too, as the JAX integrator does
        return dataclasses.replace(self, step_size0=eps, step_size=eps)

    def with_jitter(self, u):
        """The integrator at the step size of the uniform draws `u`."""
        return dataclasses.replace(
            self, step_size=self.step_size0 * (
                1 + self.jitter_frac * (2 * u - 1)))

    def jitter(self, generator, n_chains=None):
        """A new step size for each of `n_chains` chains (None: one per
        entry of the nominal step size)."""
        eps0 = torch.as_tensor(self.step_size0)
        shape = eps0.shape if n_chains is None else (n_chains,)
        return self.with_jitter(rand_uniform(generator, shape, eps0.dtype,
                                             eps0.device))


@dataclasses.dataclass(frozen=True)
class TemperedLeapfrog(_Fixed):
    """Leapfrog with momentum tempering α: the momentum is multiplied by
    sqrt(α) on the first half of the trajectory's half steps and divided by
    it on the second half."""

    step_size: torch.Tensor
    alpha: float = 1.05

    def temper_scale(self, i, is_half_first, n_steps):
        """sqrt(α) where the half-step counter 2i + 1 + !is_half_first (i
        from 0) is at most `n_steps`, else 1/sqrt(α); `i` and `n_steps` are
        ints or per-chain tensors."""
        eps = torch.as_tensor(self.step_size)
        i_temper = 2 * torch.as_tensor(i, device=eps.device) + 1 + (
            0 if is_half_first else 1)
        sqrt_a = torch.sqrt(torch.as_tensor(self.alpha, dtype=eps.dtype,
                                            device=eps.device))
        return torch.where(
            i_temper <= torch.as_tensor(n_steps, device=eps.device),
            sqrt_a, 1.0 / sqrt_a)


@dataclasses.dataclass(frozen=True)
class ComposedLeapfrog(_Fixed):
    """A palindromic composition of leapfrog steps with sub-step fractions
    γᵢ; `yoshida4` is the fourth-order triple jump."""

    step_size: torch.Tensor
    gammas: tuple = ()

    @classmethod
    def yoshida4(cls, step_size):
        w1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
        w0 = 1.0 - 2.0 * w1
        return cls(step_size=torch.as_tensor(step_size), gammas=(w1, w0, w1))

    def step(self, h, z, eps, step_index=0, n_steps=1):
        for g in self.gammas:
            z = leapfrog_step(h, z, g * torch.as_tensor(eps), self)
        return z


@dataclasses.dataclass(frozen=True)
class SolverIntegrator(_Fixed):
    """An external symplectic stepper:
    `stepper(q, p, eps, grad_fn, velocity_fn) -> (q', p')` on batched
    (C, dim) tensors, `eps` a number or a (C, 1) column of signed step
    sizes, `grad_fn(q)` = ∇ℓπ (C, dim) and `velocity_fn(p)` = M⁻¹p. It must
    be symplectic and time-reversible for the MH step to be exact; the
    target's value and gradient are evaluated once more after each step."""

    step_size: torch.Tensor
    stepper: Callable = None

    def step(self, h, z, eps, step_index=0, n_steps=1):
        def grad_fn(q):
            return h.target.logdensity_and_grad(q)[1]

        q, p = self.stepper(z.theta, z.r, _column(eps, z.theta), grad_fn,
                            h.velocity)
        logdensity, grad = h.target.logdensity_and_grad(q)
        return h.phasepoint(q, p, logdensity=logdensity, grad=grad)


def leapfrog_step(h: Hamiltonian, z: PhasePoint, eps, integrator=None,
                  step_index=0, n_steps=1) -> PhasePoint:
    """One kick-drift-kick step reusing the cached gradient.

    `eps` is a scalar or a (C,) tensor of signed step sizes (negative
    integrates backwards in time). `integrator` (JAX's first argument)
    gives the momentum tempering of step `step_index` of `n_steps`;
    without it, or for an integrator without tempering, nothing of it is
    needed.
    """
    eps = _column(eps, z.theta)
    scale = (None if integrator is None
             else integrator.temper_scale(step_index, True, n_steps))
    r = z.r if scale is None else z.r * _column(scale, z.r)
    r = r + 0.5 * eps * z.grad
    theta = z.theta + eps * h.velocity(r)
    logdensity, grad = h.target.logdensity_and_grad(theta)
    r = r + 0.5 * eps * grad
    scale = (None if integrator is None
             else integrator.temper_scale(step_index, False, n_steps))
    if scale is not None:
        r = r * _column(scale, r)
    return h.phasepoint(theta, r, logdensity=logdensity, grad=grad)


def leapfrog_steps(integrator, h: Hamiltonian, z: PhasePoint, n_steps: int,
                   fwd: bool = True) -> PhasePoint:
    """`n_steps` steps of `integrator` at its current step size (backwards
    unless `fwd`); each chain stops after its first non-finite point, which
    it keeps (its −Inf log density rejects downstream)."""
    eps = torch.as_tensor(integrator.current_step_size)
    eps = eps if fwd else -eps
    done = torch.zeros(z.theta.shape[0], dtype=torch.bool,
                       device=z.theta.device)
    for i in range(n_steps):
        z_new = integrator.step(h, z, eps, step_index=i, n_steps=n_steps)
        z = select_phasepoint(~done, z_new, z)
        done = done | ~z_new.is_finite()
    return z


def leapfrog_trajectory(integrator, h: Hamiltonian, z: PhasePoint,
                        n_steps: int, fwd: bool = True):
    """`n_steps` steps of `integrator` as `leapfrog_steps` takes them, with
    every point kept: (the trajectory, a PhasePoint of (n_steps, C, …)
    leaves, and the taken mask (n_steps, C)). A chain's steps after its
    first non-finite point are untaken (they repeat that point); the
    non-finite point itself is taken, and its −Inf log density weighs
    nothing downstream."""
    eps = torch.as_tensor(integrator.current_step_size)
    eps = eps if fwd else -eps
    done = torch.zeros(z.theta.shape[0], dtype=torch.bool,
                       device=z.theta.device)
    points, taken = [], []
    for i in range(n_steps):
        z_new = integrator.step(h, z, eps, step_index=i, n_steps=n_steps)
        z = select_phasepoint(~done, z_new, z)
        points.append(z)
        taken.append(~done)
        done = done | ~z_new.is_finite()
    stacked = PhasePoint(*(torch.stack([getattr(p, f) for p in points])
                           for f in ("theta", "r", "logdensity", "grad",
                                     "neg_k")))
    return stacked, torch.stack(taken)

"""Trajectories, the HMC kernel, the static-HMC transitions and the
log-space MH accept.

Counterpart of `advancedhmc_tpu/trajectory.py`, on a batch of chains (the
leading axis) where the JAX functions are written for one chain and
vmapped. A static criterion (`FixedNSteps`, `FixedIntegrationTime`) runs
`transition_static` with endpoint or multinomial sampling; a no-U-turn
criterion (classic, generalised or strict) runs NUTS (`nuts.py`) with
multinomial or slice sampling. The pairs are JAX's `check_ts_kind`'s.

A static trajectory's step count is one integer per chain (a per-chain ε
gives `FixedIntegrationTime` one count per chain): the host reads its
maximum once per transition and runs that many steps, the chains that are
done masked, as the JAX loop vmapped over chains runs the maximum.

Two switches set the precision of the NUTS U-turn check, as in the JAX
package. `stack_dtype` ("bfloat16" or "float16", or None for the state's
dtype) is the
dtype every checkpoint stack a criterion carries is stored in (r and the
momentum sums; classic's θ; strict's odd-leaf r): each checkpoint is
rounded to it when it is written. The span checks of the classic and the
generalised criterion take their other operand rounded to it too and round
their result to it (products exact, sums in float32), as the JAX check's
einsum does in the stacks' dtype; the strict checks read the rounded rows
back in the state's dtype. It is a stopping heuristic: the invariant
distribution does not change.
`uturn_precision` is the JAX package's XLA precision pin of that dot
(None, "default", "high", "highest"); it is accepted and changes nothing
here. A float32 torch dot is already exact float32, so every value gives
the result of "highest" on float32 stacks, and the stacks' rounding of
`stack_dtype` on reduced ones.
"""

from __future__ import annotations

import dataclasses

import torch

from .hamiltonian import FullMomentumRefreshment, Hamiltonian, \
    PartialMomentumRefreshment, PhasePoint, select_phasepoint
from .integrators import leapfrog_steps
from .termination import ENDPOINT, MULTINOMIAL, FixedIntegrationTime, \
    FixedNSteps, TerminationCriterion, check_ts_kind
from .utils import max_chains, rand_exponential, rand_uniform, \
    reduced_dtype
# the values of jax.lax.Precision that the JAX trajectory takes by name
UTURN_PRECISIONS = (None, "default", "high", "highest", "fastest", "float32",
                    "bfloat16", "tensorfloat32")


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """Integrator + termination criterion + trajectory sampler kind."""

    integrator: object
    criterion: TerminationCriterion
    ts_kind: str = MULTINOMIAL
    stack_dtype: object = None
    uturn_precision: object = None

    def __post_init__(self):
        check_ts_kind(self.ts_kind, self.criterion)
        reduced_dtype(self.stack_dtype, "stack_dtype")
        prec = self.uturn_precision
        if (prec.lower() if isinstance(prec, str) else prec) \
                not in UTURN_PRECISIONS:
            raise ValueError(f"unknown uturn_precision {prec!r}")

    @property
    def stack_torch_dtype(self):
        """The checkpoint stacks' torch dtype, or None for the state's."""
        return reduced_dtype(self.stack_dtype, "stack_dtype")

    def with_nom_step_size(self, eps):
        return dataclasses.replace(
            self, integrator=self.integrator.with_nom_step_size(eps))


@dataclasses.dataclass(frozen=True)
class HMCKernel:
    """Momentum refreshment (full or partial) + trajectory."""

    trajectory: Trajectory
    refreshment: object = FullMomentumRefreshment()

    def __post_init__(self):
        if not isinstance(self.refreshment, (FullMomentumRefreshment,
                                             PartialMomentumRefreshment)):
            raise TypeError(
                f"unknown refreshment {type(self.refreshment).__name__}")

    def with_nom_step_size(self, eps):
        return dataclasses.replace(
            self, trajectory=self.trajectory.with_nom_step_size(eps))


def mh_accept_ratio(generator, h_original, h_proposal):
    """Log-space MH accept per chain: H' < H + Exp(1); α = min(1, exp(H-H')).

    A NaN/Inf proposal energy (clamped upstream) yields accept=False, α=0.
    """
    e = rand_exponential(generator, h_original.shape, h_original.dtype,
                         h_original.device)
    accept = h_proposal < h_original + e
    alpha = torch.exp(torch.clamp(h_original - h_proposal, max=0.0))
    return accept, torch.nan_to_num(alpha, nan=0.0)


def _flip_momentum(z: PhasePoint) -> PhasePoint:
    """Negate the momentum (reversibility); the Gaussian kinetic energy is
    even in r, so the cached −K is unchanged."""
    return dataclasses.replace(z, r=-z.r)


def _num_static_steps(traj: Trajectory):
    """(static bound, count): the count an int32 tensor, 0-d or one per
    chain where the nominal step size is per chain."""
    c = traj.criterion
    eps = torch.as_tensor(traj.integrator.nom_step_size)
    if isinstance(c, FixedNSteps):
        return c.n_steps, torch.tensor(c.n_steps, dtype=torch.int32,
                                       device=eps.device)
    if isinstance(c, FixedIntegrationTime):
        # max(1, floor(λ/ε)) in ε's dtype, at most max_steps (a NaN ε gives
        # 0, as the JAX conversion of NaN to int32 does)
        n = torch.clamp(torch.floor(c.lam / eps), min=1.0,
                        max=float(c.max_steps))
        return c.max_steps, torch.nan_to_num(n, nan=0.0).to(torch.int32)
    raise TypeError(f"not a static criterion: {type(c)}")


def _per_chain(x, c):
    return torch.broadcast_to(torch.as_tensor(x), (c,))


def transition_static(generator, h: Hamiltonian, traj: Trajectory,
                      z: PhasePoint, coupled_key=None):
    """One static-HMC transition of every chain of `z`; returns (z_next,
    stats of (C,)).

    Endpoint sampling integrates the trajectory and accepts its end by MH
    (one Exp(1) draw a chain); multinomial sampling splits the trajectory
    at random into a backward and a forward part (one split draw a chain)
    and streams a reservoir over its points (one uniform a chain a step).
    `coupled_key`, a `torch.Generator`, shares one split draw among the
    chains (the reference's `rand_coupled`). The momentum is negated."""
    c = z.theta.shape[0]
    h0 = z.energy()
    if traj.ts_kind == ENDPOINT:
        z_prop, is_accept, alpha, numerical_error, n_steps = \
            _endpoint_proposal(generator, h, traj, z)
        z_next = select_phasepoint(is_accept, z_prop, z)
    elif traj.ts_kind == MULTINOMIAL:
        z_prop, is_accept, alpha, numerical_error, n_steps = \
            _multinomial_proposal(generator, h, traj, z, coupled_key)
        z_next = z_prop
    else:  # pragma: no cover (Trajectory refuses it)
        raise ValueError(traj.ts_kind)
    z_next = _flip_momentum(z_next)
    h_next = z_next.energy()
    integ = traj.integrator
    stats = {
        "n_steps": _per_chain(n_steps, c),
        "is_accept": _per_chain(is_accept, c),
        "acceptance_rate": alpha,
        "log_density": z_next.logdensity,
        "hamiltonian_energy": h_next,
        "hamiltonian_energy_error": h_next - h0,
        "numerical_error": numerical_error,
        "step_size": _per_chain(integ.current_step_size, c).to(h0),
        "nom_step_size": _per_chain(integ.nom_step_size, c).to(h0),
    }
    return z_next, stats


def _endpoint_proposal(generator, h, traj: Trajectory, z: PhasePoint):
    """Endpoint proposal + MH (one Exp(1) draw a chain): `FixedNSteps` runs
    its count; `FixedIntegrationTime` runs each chain's count, a chain
    stopping at its first non-finite point. Returns (z_prop, is_accept, α,
    numerical_error, n_steps)."""
    bound, n_steps = _num_static_steps(traj)
    integ = traj.integrator
    if isinstance(traj.criterion, FixedNSteps):
        z_prop = leapfrog_steps(integ, h, z, bound, fwd=True)
    else:
        eps = integ.current_step_size
        done = _per_chain(n_steps <= 0, z.theta.shape[0])
        z_prop = z
        for i in range(int(max_chains(n_steps))):
            z_new = integ.step(h, z_prop, eps, step_index=i, n_steps=n_steps)
            z_prop = select_phasepoint(~done, z_new, z_prop)
            done = done | ~z_new.is_finite() | (i + 1 >= n_steps)
    h_prop = z_prop.energy()
    is_accept, alpha = mh_accept_ratio(generator, z.energy(), h_prop)
    return z_prop, is_accept, alpha, ~torch.isfinite(h_prop), n_steps


def _multinomial_proposal(generator, h, traj: Trajectory, z: PhasePoint,
                          coupled_key=None):
    """Streaming multinomial sampling over a randomly split trajectory: the
    candidate is drawn from the trajectory's points with probability
    ∝ exp(−H); α is the trajectory mean of min(1, exp(H0 − H_i)). Each chain
    draws its split (n_fwd uniform on 0..L) and one uniform a step; the
    backward part runs first, then the forward part restarts from the
    origin. Chains whose count is done are masked."""
    c, dtype, dev = z.theta.shape[0], z.theta.dtype, z.theta.device
    _, n_steps = _num_static_steps(traj)
    n_steps = _per_chain(n_steps, c)
    integ = traj.integrator
    eps = _per_chain(integ.current_step_size, c).to(dtype)
    h0 = z.energy()
    if coupled_key is None:
        split = rand_uniform(generator, (c,), torch.float64, dev)
    else:      # one draw shared by the chains
        split = rand_uniform(coupled_key, (), torch.float64, dev)
    n_fwd = torch.minimum(torch.floor(split * (n_steps + 1)).to(torch.int32),
                          n_steps)
    n_bwd = n_steps - n_fwd

    # the reservoir starts at the origin, weight exp(−H0)
    z_edge = z_cand = z
    logw = -h0
    sum_alpha = torch.minimum(torch.ones_like(h0), torch.exp(h0 - h0))
    count = torch.ones_like(h0)
    done_dir = torch.zeros(c, dtype=torch.bool, device=dev)
    for t in range(int(max_chains(n_steps))):
        in_bwd = t < n_bwd
        switching = t == n_bwd    # the first forward step restarts at z
        z_from = select_phasepoint(switching, z, z_edge)
        done_dir = done_dir & ~switching
        z_new = integ.step(h, z_from, torch.where(in_bwd, -eps, eps),
                           step_index=torch.where(in_bwd, t, t - n_bwd),
                           n_steps=torch.where(in_bwd, n_bwd, n_fwd))
        active = ~done_dir & (t < n_steps)
        z_edge = select_phasepoint(active, z_new, z_from)
        done_dir = done_dir | ~z_new.is_finite()

        h_new = z_new.energy()
        lw_new = torch.where(active, -h_new,
                             torch.full_like(h_new, float("-inf")))
        logw = torch.logaddexp(logw, lw_new)
        u = rand_uniform(generator, (c,), dtype, dev)
        z_cand = select_phasepoint(torch.log(u) < lw_new - logw, z_new,
                                   z_cand)
        alpha_new = torch.nan_to_num(
            torch.exp(torch.clamp(h0 - h_new, max=0.0)), nan=0.0)
        sum_alpha = sum_alpha + torch.where(active, alpha_new, 0.0)
        count = count + active.to(dtype)
    numerical_error = ~torch.isfinite(z_cand.energy())
    return (z_cand, torch.ones_like(numerical_error), sum_alpha / count,
            numerical_error, n_steps)

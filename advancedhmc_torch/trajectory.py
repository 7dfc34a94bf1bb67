"""Trajectory configuration and the log-space MH accept.

Counterpart of `advancedhmc_tpu/trajectory.py:50,81,91`. The static-HMC
transitions (`transition_static`, endpoint sampling) are queued under
ROADMAP.md's "The rest of the surface".

Two switches set the precision of the NUTS U-turn check, as in the JAX
package. `stack_dtype` ("bfloat16", or None for the state's dtype) is the
dtype the checkpoint stacks are stored in: each checkpoint is rounded to it
when it is written, and the check's dot products take their other operand
rounded to it too and round their result to it (products exact, sums in
float32), as the JAX check's einsum does in the stacks' dtype. It is a
stopping heuristic: the invariant distribution does not change.
`uturn_precision` is the JAX package's XLA precision pin of that dot
(None, "default", "high", "highest"); it is accepted and changes nothing
here. A float32 torch dot is already exact float32, so every value gives
the result of "highest" on float32 stacks, and the stacks' rounding of
`stack_dtype` on reduced ones.
"""

from __future__ import annotations

import dataclasses

import torch

from .hamiltonian import FullMomentumRefreshment
from .termination import MULTINOMIAL, GeneralisedNoUTurn, TerminationCriterion
from .utils import rand_exponential, reduced_dtype, roadmap

_LATER = roadmap("surface")
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
        if not isinstance(self.criterion, GeneralisedNoUTurn):
            raise NotImplementedError(
                f"{type(self.criterion).__name__} is not ported yet " + _LATER)
        if self.ts_kind != MULTINOMIAL:
            raise NotImplementedError(
                f"the {self.ts_kind!r} trajectory sampler is not ported yet "
                + _LATER)
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
    """Momentum refreshment + trajectory."""

    trajectory: Trajectory
    refreshment: FullMomentumRefreshment = FullMomentumRefreshment()

    def __post_init__(self):
        if not isinstance(self.refreshment, FullMomentumRefreshment):
            raise NotImplementedError(
                "only full momentum refreshment is ported " + _LATER)

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

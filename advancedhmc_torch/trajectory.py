"""Trajectory configuration and the log-space MH accept.

Counterpart of `advancedhmc_tpu/trajectory.py:50,81,91`. The static-HMC
transitions (`transition_static`, endpoint sampling) are ROADMAP.md section
1, item 11.
"""

from __future__ import annotations

import dataclasses

import torch

from .hamiltonian import FullMomentumRefreshment
from .termination import MULTINOMIAL, GeneralisedNoUTurn, TerminationCriterion
from .utils import rand_exponential

_LATER = "(ROADMAP.md section 1, item 11)"


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
        if self.stack_dtype is not None or self.uturn_precision is not None:
            raise NotImplementedError(
                "reduced-precision U-turn stacks are not ported yet " + _LATER)

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

"""Termination criteria and trajectory-sampler kinds.

Counterpart of `advancedhmc_tpu/termination.py`: frozen dataclasses of
hyperparameters. The static criteria (`FixedNSteps`, `FixedIntegrationTime`)
run `trajectory.transition_static`; the generalised no-U-turn criterion runs
NUTS. `ClassicNoUTurn`, `StrictGeneralisedNoUTurn` and the SLICE sampler
are queued under ROADMAP.md's "The rest of the surface": constructing one of
those criteria raises, naming that item.
"""

from __future__ import annotations

import dataclasses

from .utils import roadmap


class TerminationCriterion:
    pass


class StaticTerminationCriterion(TerminationCriterion):
    pass


class DynamicTerminationCriterion(TerminationCriterion):
    pass


@dataclasses.dataclass(frozen=True)
class FixedNSteps(StaticTerminationCriterion):
    """Static HMC with a fixed number of leapfrog steps."""

    n_steps: int


@dataclasses.dataclass(frozen=True)
class FixedIntegrationTime(StaticTerminationCriterion):
    """Fixed total integration time λ: L = max(1, floor(λ/ϵ)) steps, at most
    `max_steps`. With a per-chain ϵ each chain has its own L."""

    lam: float
    max_steps: int = 1024


@dataclasses.dataclass(frozen=True)
class GeneralisedNoUTurn(DynamicTerminationCriterion):
    """Momentum-sum (ρ) criterion, Betancourt (2017) A.4.2."""

    max_depth: int = 10
    delta_max: float = 1000.0


@dataclasses.dataclass(frozen=True)
class _QueuedNoUTurn(DynamicTerminationCriterion):
    max_depth: int = 10
    delta_max: float = 1000.0

    def __post_init__(self):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet " + roadmap("surface"))


class ClassicNoUTurn(_QueuedNoUTurn):
    """Position-based U-turn criterion (Hoffman & Gelman 2014): not ported
    yet, constructing it raises."""


class StrictGeneralisedNoUTurn(_QueuedNoUTurn):
    """The generalised criterion with the left/right subtree checks: not
    ported yet, constructing it raises."""


ENDPOINT = "endpoint"
MULTINOMIAL = "multinomial"
SLICE = "slice"

_VALID_TS = (ENDPOINT, MULTINOMIAL, SLICE)


def check_ts_kind(ts_kind: str, criterion: TerminationCriterion):
    """The JAX package's check of a (sampler kind, criterion) pair."""
    if ts_kind not in _VALID_TS:
        raise ValueError(f"unknown trajectory sampler kind {ts_kind!r}")
    if isinstance(criterion, StaticTerminationCriterion) and ts_kind == SLICE:
        raise ValueError(
            "slice sampling is only defined for dynamic (NUTS) trajectories")
    if isinstance(criterion, DynamicTerminationCriterion) \
            and ts_kind == ENDPOINT:
        raise ValueError(
            "endpoint sampling is only defined for static trajectories")

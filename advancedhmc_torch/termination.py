"""Termination criteria and trajectory-sampler kinds.

Counterpart of `advancedhmc_tpu/termination.py`: frozen dataclasses of
hyperparameters. The static criteria (`FixedNSteps`, `FixedIntegrationTime`)
run `trajectory.transition_static`; the three no-U-turn criteria
(`ClassicNoUTurn`, `GeneralisedNoUTurn`, `StrictGeneralisedNoUTurn`) run
NUTS (`nuts.py`) with multinomial or slice sampling.
"""

from __future__ import annotations

import dataclasses


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
class ClassicNoUTurn(DynamicTerminationCriterion):
    """Position-based U-turn criterion, Eq. (9) of Hoffman & Gelman (2014)."""

    max_depth: int = 10
    delta_max: float = 1000.0


@dataclasses.dataclass(frozen=True)
class GeneralisedNoUTurn(DynamicTerminationCriterion):
    """Momentum-sum (ρ) criterion, Betancourt (2017) A.4.2."""

    max_depth: int = 10
    delta_max: float = 1000.0


@dataclasses.dataclass(frozen=True)
class StrictGeneralisedNoUTurn(DynamicTerminationCriterion):
    """The generalised criterion plus the left/right half-tree checks
    (stan#2800)."""

    max_depth: int = 10
    delta_max: float = 1000.0


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

"""Termination criteria and trajectory-sampler kinds.

Counterpart of `advancedhmc_tpu/termination.py`: frozen dataclasses of
hyperparameters. Only the generalised no-U-turn criterion with multinomial
sampling is on the main path; the others are queued under ROADMAP.md's
"The rest of the surface".
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
class GeneralisedNoUTurn(DynamicTerminationCriterion):
    """Momentum-sum (ρ) criterion, Betancourt (2017) A.4.2."""

    max_depth: int = 10
    delta_max: float = 1000.0


ENDPOINT = "endpoint"
MULTINOMIAL = "multinomial"
SLICE = "slice"

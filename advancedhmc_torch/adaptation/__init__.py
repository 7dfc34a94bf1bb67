"""Adaptation layer: dual averaging, the diagonal Welford estimator and the
Stan window schedule (counterpart of `advancedhmc_tpu/adaptation`)."""

from .massmatrix import WelfordVarState
from .stan import (
    MASSMATRIX,
    MM_LOWRANK,
    MM_NUTPIE,
    MM_UNIT,
    MM_WELFORD_COV,
    MM_WELFORD_VAR,
    NAIVE,
    NONE,
    STAN,
    STEPSIZE,
    AdaptorConfig,
    AdaptState,
    adapt_flags,
    stan_schedule,
)
from .stepsize import DualAveragingConfig, DualAveragingState, da_update

__all__ = [
    "AdaptState",
    "AdaptorConfig",
    "DualAveragingConfig",
    "DualAveragingState",
    "MASSMATRIX",
    "MM_LOWRANK",
    "MM_NUTPIE",
    "MM_UNIT",
    "MM_WELFORD_COV",
    "MM_WELFORD_VAR",
    "NAIVE",
    "NONE",
    "STAN",
    "STEPSIZE",
    "WelfordVarState",
    "adapt_flags",
    "da_update",
    "stan_schedule",
]

"""Adaptation layer: dual averaging, the mass-matrix estimators (Welford
variance and covariance, low-rank, nutpie, unit; the naive oracles), the
Stan window schedule, its transient depth caps, the fixed and manual
step sizes and ChEES's trajectory-length adaptation (counterpart
of `advancedhmc_tpu/adaptation`)."""

from .chees import CheesConfig, CheesState, chees_update, halton_sequence
from .massmatrix import (
    LowRankCovState,
    NaiveCov,
    NaiveVar,
    NutpieVarState,
    UnitMassMatrixState,
    WelfordCovState,
    WelfordVarState,
)
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
    adapt_step,
    adapt_step_batch,
    adapt_step_masked,
    stan_schedule,
    transient_depth_caps,
)
from .stepsize import DualAveragingConfig, DualAveragingState, \
    FixedStepSize, ManualSSAdaptor, da_update

__all__ = [
    "AdaptState",
    "AdaptorConfig",
    "CheesConfig",
    "CheesState",
    "DualAveragingConfig",
    "DualAveragingState",
    "FixedStepSize",
    "MASSMATRIX",
    "ManualSSAdaptor",
    "MM_LOWRANK",
    "MM_NUTPIE",
    "MM_UNIT",
    "MM_WELFORD_COV",
    "MM_WELFORD_VAR",
    "NAIVE",
    "NONE",
    "STAN",
    "STEPSIZE",
    "LowRankCovState",
    "NaiveCov",
    "NaiveVar",
    "NutpieVarState",
    "UnitMassMatrixState",
    "WelfordCovState",
    "WelfordVarState",
    "adapt_flags",
    "adapt_step",
    "adapt_step_batch",
    "adapt_step_masked",
    "chees_update",
    "da_update",
    "halton_sequence",
    "stan_schedule",
    "transient_depth_caps",
]

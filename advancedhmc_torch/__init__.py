"""advancedhmc_torch — the PyTorch/CUDA port of advancedhmc_tpu.

The JAX package `advancedhmc_tpu` is the reference; this package carries its
main path on one NVIDIA GPU (Hopper): cross-chain NUTS (generalised
no-U-turn, multinomial, diagonal metric) on the hierarchical logistic, with
the likelihood value+grad in a hand-written CUDA kernel
(`ops/fused_logistic.py`, `csrc/fused_logistic.cu`). Module names follow the
JAX package. Entry points run on CUDA unless `device="cpu"` is passed; the
kernels are built on first use.
"""

from .adaptation import (
    AdaptorConfig,
    AdaptState,
    DualAveragingConfig,
    DualAveragingState,
    WelfordVarState,
    adapt_flags,
    da_update,
    stan_schedule,
)
from .diagnostics import effective_sample_size, ess_bulk, rhat
from .hamiltonian import FullMomentumRefreshment, Hamiltonian, PhasePoint
from .integrators import Leapfrog, leapfrog_step
from .kinetic import GaussianKinetic
from .metrics import DiagEuclideanMetric, Metric, UnitEuclideanMetric, \
    make_metric
from .models.logistic import hierarchical_logistic
from .nuts import nuts_transition, nuts_transitions_fused
from .sampler import (
    HMCState,
    SampleResult,
    SampleSpec,
    fanout_warmup_state,
    fused_draw_phase,
    fused_warmup_phase_crosschain,
    init_state,
    sample,
)
from .stepsize_search import find_good_stepsize
from .target import LogDensityTarget
from .termination import GeneralisedNoUTurn
from .trajectory import HMCKernel, Trajectory, mh_accept_ratio

__all__ = [
    "AdaptState",
    "AdaptorConfig",
    "DiagEuclideanMetric",
    "DualAveragingConfig",
    "DualAveragingState",
    "FullMomentumRefreshment",
    "GaussianKinetic",
    "GeneralisedNoUTurn",
    "HMCKernel",
    "HMCState",
    "Hamiltonian",
    "Leapfrog",
    "LogDensityTarget",
    "Metric",
    "PhasePoint",
    "SampleResult",
    "SampleSpec",
    "Trajectory",
    "UnitEuclideanMetric",
    "WelfordVarState",
    "adapt_flags",
    "da_update",
    "effective_sample_size",
    "ess_bulk",
    "fanout_warmup_state",
    "find_good_stepsize",
    "fused_draw_phase",
    "fused_warmup_phase_crosschain",
    "hierarchical_logistic",
    "init_state",
    "leapfrog_step",
    "make_metric",
    "mh_accept_ratio",
    "nuts_transition",
    "nuts_transitions_fused",
    "rhat",
    "sample",
    "stan_schedule",
]

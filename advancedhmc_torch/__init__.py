"""advancedhmc_torch — the PyTorch/CUDA port of advancedhmc_tpu.

The JAX package `advancedhmc_tpu` is the reference; this package carries its
main path on one NVIDIA GPU (Hopper): NUTS (classic, generalised or strict
no-U-turn, multinomial or slice; unit, diagonal, dense or rank-update
metric) with per-chain or cross-chain Stan adaptation (Welford variance
or covariance, low-rank, nutpie; the transient depth caps), step by step
or fused, with every option of JAX `sample` (`mesh`: chain parallelism
over one process per GPU, `parallel`), and the ragged draw mode
(`fused_draw_phase_ragged`); the diagnostics (bulk, tail and
ragged ESS, R̂) and `SampleResult`'s exports; static HMC (endpoint or
multinomial sampling, fixed steps or integration time), the jittered,
tempered, composed and external-solver integrators, partial momentum
refreshment and the NUTS/HMC/HMCDA constructors; ChEES-HMC
(`sample_chees`); the relativistic kinetic energy; the Riemannian tier
(`riemannian`: SoftAbs RMHMC and Riemannian NUTS, `sample_rmhmc`);
checkpoints (`checkpoint`), the program cache (`aot_program`) and the
profiling helpers (`profiling`); on the
JAX package's model zoo (`models`: the hierarchical logistic, centred with
a float32 or bfloat16 design or non-centred, the log-Gaussian Cox
process, the Gaussians, Neal's funnel,
banana, eight schools, gdemo, the mixtures, the spiral, the declarative
distributions) and any transformed (`transforms`) or structured
(`target_from_pytree`) target, with the likelihood value+grad in a
hand-written CUDA kernel (`ops/fused_logistic.py`, `csrc/fused_logistic.cu`), and the JAX package's
two other kernels: the NUTS megakernel on block targets
(`ops/fused_nuts_kernel.py`, `csrc/fused_nuts.cu`) and the diagonal-Gaussian
leapfrog (`ops/fused_leapfrog.py`, `csrc/fused_leapfrog.cu`). Module names
follow the JAX package. Entry points run on CUDA unless `device="cpu"` is
passed; the kernels are built on first use.
"""

from .adaptation import (
    AdaptorConfig,
    AdaptState,
    DualAveragingConfig,
    DualAveragingState,
    LowRankCovState,
    NaiveCov,
    NaiveVar,
    NutpieVarState,
    UnitMassMatrixState,
    WelfordCovState,
    WelfordVarState,
    adapt_flags,
    adapt_step,
    adapt_step_batch,
    adapt_step_masked,
    da_update,
    stan_schedule,
    transient_depth_caps,
)
from .adaptation.chees import CheesConfig, CheesState, chees_update, \
    halton_sequence
from .chees import chees_tau_sweep, chees_transition, make_chees_draw_step, \
    make_chees_step, sample_chees
from .constructors import HMC, HMCDA, NUTS, SamplerConfig, make_integrator
from .diagnostics import (
    OnlineMoments,
    ebfmi,
    effective_sample_size,
    effective_sample_size_ragged,
    ess_bulk,
    ess_tail,
    online_init,
    online_summary,
    online_update,
    rhat,
    split_rhat,
    summarize,
)
from .experimental import fused_draw_phase_ragged
from .hamiltonian import FullMomentumRefreshment, Hamiltonian, \
    PartialMomentumRefreshment, PhasePoint
from .integrators import ComposedLeapfrog, JitteredLeapfrog, Leapfrog, \
    SolverIntegrator, TemperedLeapfrog, leapfrog_step, leapfrog_steps, \
    leapfrog_trajectory
from .kinetic import GaussianKinetic, RelativisticKinetic
from .metrics import DenseEuclideanMetric, DiagEuclideanMetric, Metric, \
    RankUpdateEuclideanMetric, UnitEuclideanMetric, make_metric
from .models import GDEMO_MEAN, banana, correlated_gaussian, eight_schools, \
    funnel_nc_to_centered, gaussian_mixture, gdemo, german_credit_logistic, \
    hierarchical_logistic, hierarchical_logistic_block, \
    hierarchical_logistic_nc, log_gaussian_cox, mvn_diag, neal_funnel, \
    neal_funnel_nc, spiral, std_gaussian, two_gaussian_mixtures_2d
from .nuts import nuts_transition, nuts_transitions_fused
from . import checkpoint, parallel, profiling, riemannian
from .aot import aot_program, aot_signature
from .sampler import (
    HMCState,
    SampleResult,
    SampleSpec,
    depth_cap_schedule,
    fanout_warmup_state,
    fused_draw_phase,
    fused_warmup_phase,
    fused_warmup_phase_crosschain,
    init_state,
    sample,
    sample_step,
)
from .stepsize_search import find_good_stepsize, find_good_stepsizes
from .target import BlockTarget, LogDensityTarget, as_target, \
    target_from_pytree
from .termination import ENDPOINT, MULTINOMIAL, SLICE, ClassicNoUTurn, \
    FixedIntegrationTime, FixedNSteps, GeneralisedNoUTurn, \
    StrictGeneralisedNoUTurn
from .trajectory import HMCKernel, Trajectory, mh_accept_ratio, \
    transition_static

__all__ = [
    "AdaptState",
    "AdaptorConfig",
    "BlockTarget",
    "CheesConfig",
    "CheesState",
    "ClassicNoUTurn",
    "ComposedLeapfrog",
    "DenseEuclideanMetric",
    "DiagEuclideanMetric",
    "DualAveragingConfig",
    "DualAveragingState",
    "ENDPOINT",
    "FixedIntegrationTime",
    "FixedNSteps",
    "FullMomentumRefreshment",
    "GDEMO_MEAN",
    "GaussianKinetic",
    "GeneralisedNoUTurn",
    "HMC",
    "HMCDA",
    "HMCKernel",
    "HMCState",
    "Hamiltonian",
    "JitteredLeapfrog",
    "Leapfrog",
    "LogDensityTarget",
    "LowRankCovState",
    "MULTINOMIAL",
    "Metric",
    "NUTS",
    "NaiveCov",
    "NaiveVar",
    "NutpieVarState",
    "OnlineMoments",
    "PartialMomentumRefreshment",
    "PhasePoint",
    "RankUpdateEuclideanMetric",
    "RelativisticKinetic",
    "SLICE",
    "SampleResult",
    "SampleSpec",
    "SamplerConfig",
    "SolverIntegrator",
    "StrictGeneralisedNoUTurn",
    "TemperedLeapfrog",
    "Trajectory",
    "UnitEuclideanMetric",
    "UnitMassMatrixState",
    "WelfordCovState",
    "WelfordVarState",
    "adapt_flags",
    "adapt_step",
    "adapt_step_batch",
    "adapt_step_masked",
    "aot_program",
    "aot_signature",
    "as_target",
    "banana",
    "chees_tau_sweep",
    "chees_transition",
    "chees_update",
    "checkpoint",
    "correlated_gaussian",
    "da_update",
    "depth_cap_schedule",
    "ebfmi",
    "effective_sample_size",
    "effective_sample_size_ragged",
    "eight_schools",
    "ess_bulk",
    "ess_tail",
    "fanout_warmup_state",
    "find_good_stepsize",
    "find_good_stepsizes",
    "funnel_nc_to_centered",
    "fused_draw_phase",
    "fused_draw_phase_ragged",
    "fused_warmup_phase",
    "fused_warmup_phase_crosschain",
    "gaussian_mixture",
    "gdemo",
    "german_credit_logistic",
    "halton_sequence",
    "hierarchical_logistic",
    "hierarchical_logistic_block",
    "hierarchical_logistic_nc",
    "init_state",
    "leapfrog_step",
    "leapfrog_steps",
    "leapfrog_trajectory",
    "log_gaussian_cox",
    "make_chees_draw_step",
    "make_chees_step",
    "make_integrator",
    "make_metric",
    "mh_accept_ratio",
    "mvn_diag",
    "neal_funnel",
    "neal_funnel_nc",
    "nuts_transition",
    "nuts_transitions_fused",
    "online_init",
    "online_summary",
    "online_update",
    "parallel",
    "profiling",
    "rhat",
    "riemannian",
    "sample",
    "sample_chees",
    "sample_step",
    "spiral",
    "split_rhat",
    "stan_schedule",
    "std_gaussian",
    "summarize",
    "target_from_pytree",
    "transient_depth_caps",
    "transition_static",
    "two_gaussian_mixtures_2d",
]

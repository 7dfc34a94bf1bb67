"""advancedhmc_torch — the PyTorch/CUDA port of advancedhmc_tpu.

The JAX package `advancedhmc_tpu` is the reference; this package carries its
main path on one NVIDIA GPU (Hopper): NUTS (generalised no-U-turn,
multinomial, unit or diagonal metric) with per-chain or cross-chain Stan
adaptation, step by step or fused, with every option of JAX `sample` but
`mesh`, on the hierarchical logistic (float32 or bfloat16 design), with
the likelihood value+grad in a hand-written CUDA kernel
(`ops/fused_logistic.py`, `csrc/fused_logistic.cu`), and the JAX package's
two other kernels: the NUTS megakernel on block targets
(`ops/fused_nuts_kernel.py`, `csrc/fused_nuts.cu`) and the diagonal-Gaussian
leapfrog (`ops/fused_leapfrog.py`, `csrc/fused_leapfrog.cu`). Module names
follow the JAX package. Entry points run on CUDA unless `device="cpu"` is passed; the
kernels are built on first use.
"""

from .adaptation import (
    AdaptorConfig,
    AdaptState,
    DualAveragingConfig,
    DualAveragingState,
    WelfordVarState,
    adapt_flags,
    adapt_step,
    adapt_step_batch,
    adapt_step_masked,
    da_update,
    stan_schedule,
)
from .diagnostics import (
    OnlineMoments,
    ebfmi,
    effective_sample_size,
    ess_bulk,
    online_init,
    online_summary,
    online_update,
    rhat,
    summarize,
)
from .hamiltonian import FullMomentumRefreshment, Hamiltonian, PhasePoint
from .integrators import Leapfrog, leapfrog_step
from .kinetic import GaussianKinetic
from .metrics import DiagEuclideanMetric, Metric, UnitEuclideanMetric, \
    make_metric
from .models.logistic import hierarchical_logistic, \
    hierarchical_logistic_block
from .nuts import nuts_transition, nuts_transitions_fused
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
from .target import BlockTarget, LogDensityTarget
from .termination import GeneralisedNoUTurn
from .trajectory import HMCKernel, Trajectory, mh_accept_ratio

__all__ = [
    "AdaptState",
    "AdaptorConfig",
    "BlockTarget",
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
    "OnlineMoments",
    "PhasePoint",
    "SampleResult",
    "SampleSpec",
    "Trajectory",
    "UnitEuclideanMetric",
    "WelfordVarState",
    "adapt_flags",
    "adapt_step",
    "adapt_step_batch",
    "adapt_step_masked",
    "da_update",
    "depth_cap_schedule",
    "ebfmi",
    "effective_sample_size",
    "ess_bulk",
    "fanout_warmup_state",
    "find_good_stepsize",
    "find_good_stepsizes",
    "fused_draw_phase",
    "fused_warmup_phase",
    "fused_warmup_phase_crosschain",
    "hierarchical_logistic",
    "hierarchical_logistic_block",
    "init_state",
    "leapfrog_step",
    "make_metric",
    "mh_accept_ratio",
    "nuts_transition",
    "nuts_transitions_fused",
    "online_init",
    "online_summary",
    "online_update",
    "rhat",
    "sample",
    "sample_step",
    "stan_schedule",
    "summarize",
]

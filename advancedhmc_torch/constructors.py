"""Sampler constructors (counterpart of `advancedhmc_tpu/constructors.py`).

* `NUTS(δ)`: multinomial sampling, the generalised no-U-turn criterion and
  Stan's windowed adaptation (any no-U-turn criterion by `criterion=`,
  slice sampling by `ts_kind="slice"`);
* `HMC(ϵ, L)`: endpoint sampling, a fixed step count, no adaptation;
* `HMCDA(δ, λ)`: endpoint sampling, a fixed integration time and
  dual-averaging step-size adaptation.

Each returns a `SamplerConfig` whose `.sample(...)` calls the port's
`sample` with the same arguments. As in the JAX package, `sample` finds the
initial step size by its search unless `init_eps` is passed: the
constructor's step size is the integrator's template, not the start. The
metric kinds map to mass-matrix estimators as in JAX (`_MM_FOR_METRIC`):
"dense" adapts with the Welford covariance, "rank_update" with the low-rank
estimator (`init_state` sizes the metric's rank to the adaptor's), and
"nutpie" with the nutpie estimator. As in JAX, "nutpie" is an estimator and
no metric kind: `SamplerConfig.sample` then needs a `metric=` (a diagonal
one), or `make_metric` raises its `ValueError`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .adaptation import (
    MM_LOWRANK,
    MM_NUTPIE,
    MM_UNIT,
    MM_WELFORD_COV,
    MM_WELFORD_VAR,
    NONE,
    STAN,
    STEPSIZE,
    AdaptorConfig,
    DualAveragingConfig,
)
from .hamiltonian import FullMomentumRefreshment
from .integrators import ComposedLeapfrog, JitteredLeapfrog, Leapfrog, \
    SolverIntegrator, TemperedLeapfrog
from .metrics import make_metric
from .sampler import SampleResult, sample
from .target import as_target
from .termination import ENDPOINT, MULTINOMIAL, FixedIntegrationTime, \
    FixedNSteps, GeneralisedNoUTurn
from .trajectory import HMCKernel, Trajectory
from .utils import resolve_device


def make_integrator(kind: str, eps=0.1, jitter_frac=0.1, temper_alpha=1.05,
                    stepper=None):
    """"leapfrog", "jitteredleapfrog" ("jittered"), "temperedleapfrog"
    ("tempered"), "yoshida4" ("composed") or "solver" ("external", with
    `stepper`, see `SolverIntegrator`) at step size `eps` (a number is held
    in float64)."""
    if not isinstance(eps, torch.Tensor):
        eps = torch.tensor(eps, dtype=torch.float64)
    if kind in ("leapfrog",):
        return Leapfrog(step_size=eps)
    if kind in ("jitteredleapfrog", "jittered"):
        return JitteredLeapfrog.create(eps, jitter_frac)
    if kind in ("temperedleapfrog", "tempered"):
        return TemperedLeapfrog(step_size=eps, alpha=temper_alpha)
    if kind in ("yoshida4", "composed"):
        return ComposedLeapfrog.yoshida4(eps)
    if kind in ("solver", "external"):
        if stepper is None:
            raise ValueError("kind='solver' requires stepper=...")
        return SolverIntegrator(step_size=eps, stepper=stepper)
    raise ValueError(f"unknown integrator kind {kind!r}")


_MM_FOR_METRIC = {
    "unit": MM_UNIT,
    "diag": MM_WELFORD_VAR,
    "diagonal": MM_WELFORD_VAR,
    "dense": MM_WELFORD_COV,
    "rank_update": MM_LOWRANK,
    "rankupdate": MM_LOWRANK,
    "nutpie": MM_NUTPIE,
}


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """A (kernel, metric kind, adaptor) bundle."""

    kernel: HMCKernel
    metric_kind: str
    adaptor: AdaptorConfig

    def sample(self, generator, target, init_theta, n_samples: int,
               n_adapts: Optional[int] = None, dim: Optional[int] = None,
               metric=None, init_eps=None, n_chains: Optional[int] = None,
               cross_chain: bool = False, drop_warmup: bool = False,
               dtype=torch.float32, device=None, **kwargs) -> SampleResult:
        """`sample(generator, as_target(target, dim), kernel, metric, ...)`
        on `device` (None means CUDA), the metric made from the kind (in
        `dtype`) unless given; every other keyword goes to `sample`."""
        target = as_target(target, dim=dim)
        device = resolve_device(device)
        if metric is None:
            metric = make_metric(self.metric_kind, target.dim, dtype=dtype,
                                 device=device)
        return sample(generator, target, self.kernel, metric, init_theta,
                      n_samples, n_adapts=n_adapts, adaptor=self.adaptor,
                      init_eps=init_eps, n_chains=n_chains,
                      cross_chain=cross_chain, drop_warmup=drop_warmup,
                      device=device, **kwargs)


def NUTS(delta: float = 0.8, max_depth: int = 10, delta_max: float = 1000.0,
         integrator: str = "leapfrog", metric: str = "diagonal",
         ts_kind: str = MULTINOMIAL, criterion=None,
         init_eps: float = 0.1) -> SamplerConfig:
    """NUTS(δ): Stan's windowed adaptation towards acceptance δ."""
    if criterion is None:
        criterion = GeneralisedNoUTurn(max_depth=max_depth,
                                       delta_max=delta_max)
    traj = Trajectory(integrator=make_integrator(integrator, init_eps),
                      criterion=criterion, ts_kind=ts_kind)
    kernel = HMCKernel(trajectory=traj, refreshment=FullMomentumRefreshment())
    adaptor = AdaptorConfig(kind=STAN,
                            mm_kind=_MM_FOR_METRIC.get(metric, MM_WELFORD_VAR),
                            da=DualAveragingConfig(delta=delta))
    return SamplerConfig(kernel=kernel, metric_kind=metric, adaptor=adaptor)


def HMC(eps: float = 0.1, n_leapfrog: int = 10, integrator: str = "leapfrog",
        metric: str = "diagonal", ts_kind: str = ENDPOINT) -> SamplerConfig:
    """HMC(ϵ, L): a static trajectory of L steps, no adaptation."""
    traj = Trajectory(integrator=make_integrator(integrator, eps),
                      criterion=FixedNSteps(n_leapfrog), ts_kind=ts_kind)
    kernel = HMCKernel(trajectory=traj, refreshment=FullMomentumRefreshment())
    return SamplerConfig(kernel=kernel, metric_kind=metric,
                         adaptor=AdaptorConfig(kind=NONE))


def HMCDA(delta: float = 0.8, lam: float = 1.0, integrator: str = "leapfrog",
          metric: str = "diagonal", max_steps: int = 1024,
          init_eps: float = 0.1) -> SamplerConfig:
    """HMCDA(δ, λ): integration time λ, ϵ adapted by dual averaging."""
    traj = Trajectory(
        integrator=make_integrator(integrator, init_eps),
        criterion=FixedIntegrationTime(lam=lam, max_steps=max_steps),
        ts_kind=ENDPOINT)
    kernel = HMCKernel(trajectory=traj, refreshment=FullMomentumRefreshment())
    adaptor = AdaptorConfig(kind=STEPSIZE, da=DualAveragingConfig(delta=delta))
    return SamplerConfig(kernel=kernel, metric_kind=metric, adaptor=adaptor)

"""One-call Riemannian HMC sampling loop (counterpart of
`advancedhmc_tpu/riemannian/sampler.py`).

Static RMHMC (generalised leapfrog, endpoint MH, `n_leapfrog` steps) or,
given a dynamic criterion, Riemannian NUTS through `nuts.nuts_transition`
over the position-dependent geometry. Step-size dual averaging runs on the
chains' mean acceptance for the first `n_adapts` iterations and is
finalised at the last of them; mass-matrix adaptation does not apply (the
metric is the model's geometry).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..adaptation import DualAveragingConfig, DualAveragingState, da_update
from ..target import LogDensityTarget
from ..termination import DynamicTerminationCriterion, FixedNSteps
from ..trajectory import Trajectory
from ..utils import resolve_device
from .hamiltonian import RiemannianHamiltonian
from .integrator import GeneralizedLeapfrog, transition_rmhmc
from .metric import DenseRiemannianMetric, SoftAbsMap


def sample_rmhmc(
    generator,
    target: LogDensityTarget,
    init_theta,
    n_samples: int,
    n_leapfrog: int = 8,
    step_size: float = 0.1,
    n_fp: int = 6,
    map_cfg=None,
    metric: Optional[DenseRiemannianMetric] = None,
    n_adapts: int = 0,
    da: DualAveragingConfig = DualAveragingConfig(delta=0.8),
    n_chains: Optional[int] = None,
    criterion=None,
    ts_kind: str = "multinomial",
    device=None,
):
    """Sample with SoftAbs-Riemannian HMC on `device` (None means CUDA).

    `init_theta` is (C, D), or (D,) repeated for `n_chains` chains. Each
    iteration draws every chain's momentum from N(0, G(θ)), then runs one
    transition: `transition_rmhmc` with `n_leapfrog` steps (or a
    `FixedNSteps` criterion's), or Riemannian NUTS for a dynamic
    `criterion`. Returns (thetas (n, C, D), stats dict of (n, C),
    (z, da_state))."""
    device = resolve_device(device)
    if metric is None:
        metric = DenseRiemannianMetric.from_hessian(
            target, map_cfg or SoftAbsMap(20.0))
    h = RiemannianHamiltonian(metric=metric, target=target)

    theta = torch.as_tensor(init_theta, device=device)
    if theta.dim() == 1:
        theta = theta[None].expand(n_chains or 1, -1)
    theta = theta.contiguous()
    dtype = theta.dtype

    dynamic = isinstance(criterion, DynamicTerminationCriterion)
    if criterion is not None and not dynamic:
        if not isinstance(criterion, FixedNSteps):
            raise ValueError(
                "criterion must be a dynamic (no-U-turn) criterion or "
                "FixedNSteps; use n_leapfrog= for the static path")
        n_leapfrog = int(criterion.n_steps)

    z = h.init_phasepoint(generator, theta)
    da_state = DualAveragingState.init(
        torch.as_tensor(step_size, dtype=dtype, device=device))
    if dynamic:
        from ..nuts import nuts_transition

    thetas, rows = [], []
    for i in range(n_samples):
        integ = GeneralizedLeapfrog(step_size=da_state.eps, n_fp=n_fp)
        z = h.phasepoint(z.theta, h.rand_momentum(generator, z.theta))
        if dynamic:
            z, stats = nuts_transition(
                generator, h, Trajectory(integ, criterion, ts_kind), z)
        else:
            z, stats = transition_rmhmc(generator, h, integ, n_leapfrog, z)
        if i < n_adapts:
            da_state = da_update(da, da_state,
                                 torch.mean(stats["acceptance_rate"]))
            if i == n_adapts - 1:
                da_state = da_state.finalize()
        thetas.append(z.theta)
        rows.append(stats)
    stats = {k: torch.stack([s[k] for s in rows]) for k in rows[0]}
    return torch.stack(thetas), stats, (z, da_state)

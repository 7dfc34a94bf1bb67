"""Carry state from the JAX package into the port.

Each function takes the JAX package's object (or any object with the same
attributes) whose leaves are arrays that `numpy.asarray` accepts, and builds
the port's counterpart on `device` (None means CUDA). Nothing of JAX is
imported: the arrays cross as numpy. The tests use this to start both
packages from one warmed state.
"""

from __future__ import annotations

import numpy as np
import torch

from .adaptation import AdaptState, CheesState, DualAveragingState, \
    FixedStepSize, LowRankCovState, NutpieVarState, UnitMassMatrixState, \
    WelfordCovState, WelfordVarState
from .diagnostics import OnlineMoments
from .hamiltonian import FullMomentumRefreshment, PartialMomentumRefreshment, \
    PhasePoint
from .integrators import ComposedLeapfrog, JitteredLeapfrog, Leapfrog, \
    SolverIntegrator, TemperedLeapfrog
from .metrics import DenseEuclideanMetric, DiagEuclideanMetric, \
    RankUpdateEuclideanMetric, UnitEuclideanMetric
from .sampler import HMCState
from .termination import ClassicNoUTurn, FixedIntegrationTime, \
    FixedNSteps, GeneralisedNoUTurn, StrictGeneralisedNoUTurn
from .trajectory import HMCKernel, Trajectory
from .utils import resolve_device


def tensor(a, device=None, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype,
                           device=resolve_device(device))


def model_data(x, y, device=None, dtype=None):
    """The design matrix and responses of a model, as tensors."""
    return tensor(x, device, dtype), tensor(y, device, dtype)


def phasepoint(z, device=None) -> PhasePoint:
    return PhasePoint(*(tensor(getattr(z, f), device) for f in
                        ("theta", "r", "logdensity", "grad", "neg_k")))


def riemannian_phasepoint(z, device=None):
    """A Riemannian phase point (θ, r, ℓπ, ∂H∂θ, −K), batched or not."""
    from .riemannian import RiemannianPhasePoint

    return RiemannianPhasePoint(*(tensor(getattr(z, f), device) for f in
                                  ("theta", "r", "logdensity", "dHdtheta",
                                   "neg_k")))


def riemannian_map(m):
    """The map of a `DenseRiemannianMetric` (or the map config itself):
    identity or SoftAbs with the same α. The metric's G and ∂G are
    functions of the other package's arrays and stay there: build the
    port's with `DenseRiemannianMetric.from_hessian` or by hand."""
    from .riemannian import IdentityMap, SoftAbsMap

    m = getattr(m, "map", m)
    kind = type(m).__name__
    if kind == "IdentityMap":
        return IdentityMap()
    if kind == "SoftAbsMap":
        return SoftAbsMap(alpha=float(m.alpha))
    raise TypeError(f"unknown Riemannian map {kind}")


def diag_metric(m_inv, device=None) -> DiagEuclideanMetric:
    """A diagonal metric from its M⁻¹ diagonal."""
    return DiagEuclideanMetric.create(tensor(m_inv, device))


def dense_metric(m, device=None) -> DenseEuclideanMetric:
    """A dense metric, shared or per chain, with the JAX package's own
    Cholesky factor (not recomputed)."""
    return DenseEuclideanMetric(m_inv=tensor(m.m_inv, device),
                                chol_u=tensor(m.chol_u, device))


def rank_update_metric(m, device=None) -> RankUpdateEuclideanMetric:
    """A rank-update metric, shared or per chain (the JAX package's metric
    vmapped: every leaf with a leading chain axis), with the JAX package's
    own Q and V factors: Q's columns are unique only up to sign, so only
    the carried factors map the same normals to the same momenta."""
    return RankUpdateEuclideanMetric(*(tensor(getattr(m, f), device) for f in
                                       ("a_diag", "b", "d", "q_full",
                                        "v_upper")))


def metric(m, device=None):
    """Any Euclidean metric of the JAX package, by class."""
    kind = type(m).__name__
    if kind == "UnitEuclideanMetric":
        return UnitEuclideanMetric(size=int(m.size),
                                   dtype=tensor(np.zeros((), m.dtype)).dtype,
                                   device=device)
    if kind == "DiagEuclideanMetric":
        return diag_metric(m.m_inv, device)
    if kind == "DenseEuclideanMetric":
        return dense_metric(m, device)
    if kind == "RankUpdateEuclideanMetric":
        return rank_update_metric(m, device)
    raise TypeError(f"unknown metric {kind}")


def dual_averaging_state(da, device=None) -> DualAveragingState:
    return DualAveragingState(*(tensor(getattr(da, f), device) for f in
                                ("m", "eps", "mu", "x_bar", "h_bar")))


def welford_var_state(mm, device=None) -> WelfordVarState:
    return WelfordVarState(
        *(tensor(getattr(mm, f), device) for f in ("n", "mean", "m2", "var")),
        n_min=int(mm.n_min))


def welford_cov_state(mm, device=None) -> WelfordCovState:
    return WelfordCovState(
        *(tensor(getattr(mm, f), device) for f in ("n", "mean", "m2", "cov")),
        n_min=int(mm.n_min))


def lowrank_state(mm, device=None) -> LowRankCovState:
    """A low-rank estimator, shared or per chain (n (C,) and each moment
    and factor with a leading chain axis)."""
    return LowRankCovState(
        *(tensor(getattr(mm, f), device) for f in
          ("n", "mean", "m2", "a_diag", "b", "d")),
        rank=int(mm.rank), n_min=int(mm.n_min))


def fixed_step_size(fss, device=None) -> FixedStepSize:
    """A `FixedStepSize` holding the same ϵ (a scalar or one a chain)."""
    return FixedStepSize(eps=tensor(fss.eps, device))


def nutpie_state(mm, device=None) -> NutpieVarState:
    return NutpieVarState(
        position=welford_var_state(mm.position, device),
        gradient=welford_var_state(mm.gradient, device),
        var=tensor(mm.var, device), n_min=int(mm.n_min))


def mm_state(mm, device=None):
    """Any mass-matrix estimator state of the JAX package, by class, shared
    or per chain."""
    kind = type(mm).__name__
    if kind == "UnitMassMatrixState":
        return UnitMassMatrixState(dim=int(mm.dim))
    convert_state = {"WelfordVarState": welford_var_state,
                     "WelfordCovState": welford_cov_state,
                     "LowRankCovState": lowrank_state,
                     "NutpieVarState": nutpie_state}.get(kind)
    if convert_state is None:
        raise TypeError(f"unknown mass-matrix state {kind}")
    return convert_state(mm, device)


def adapt_state(ad, device=None) -> AdaptState:
    """An adaptation state with any estimator, shared or per chain (the
    state `fused_warmup_phase` returns: ε (C,), the estimator's n (C,) and
    moments per chain)."""
    return AdaptState(da=dual_averaging_state(ad.da, device),
                      mm=mm_state(ad.mm, device))


def online_moments(om, device=None) -> OnlineMoments:
    """An `OnlineMoments` summary (n, mean, m2, the lag window and its
    products)."""
    return OnlineMoments(*(tensor(getattr(om, f), device) for f in
                           ("n", "mean", "m2", "lag_buf", "lag_acc")))


def chees_state(cs, device=None) -> CheesState:
    """A ChEES trajectory-length state (log T, its average, Adam's moments
    and count)."""
    return CheesState(*(tensor(getattr(cs, f), device) for f in
                        ("log_t", "log_t_avg", "m", "v", "count")))


def integrator(integ, device=None, stepper=None):
    """The integrator of the same class with the same step sizes and
    parameters. A `SolverIntegrator`'s stepper is a function of the other
    package's arrays: pass the port's own as `stepper`."""
    kind = type(integ).__name__
    if kind == "Leapfrog":
        return Leapfrog(step_size=tensor(integ.step_size, device))
    if kind == "JitteredLeapfrog":
        return JitteredLeapfrog(
            step_size0=tensor(integ.step_size0, device),
            step_size=tensor(integ.step_size, device),
            jitter_frac=float(integ.jitter_frac))
    if kind == "TemperedLeapfrog":
        return TemperedLeapfrog(step_size=tensor(integ.step_size, device),
                                alpha=float(integ.alpha))
    if kind == "ComposedLeapfrog":
        return ComposedLeapfrog(step_size=tensor(integ.step_size, device),
                                gammas=tuple(float(g) for g in integ.gammas))
    if kind == "SolverIntegrator":
        if stepper is None:
            raise ValueError("a SolverIntegrator needs the port's stepper=")
        return SolverIntegrator(step_size=tensor(integ.step_size, device),
                                stepper=stepper)
    raise TypeError(f"unknown integrator {kind}")


_NO_U_TURN = {c.__name__: c for c in (ClassicNoUTurn, GeneralisedNoUTurn,
                                       StrictGeneralisedNoUTurn)}


def criterion(crit):
    """A termination criterion of the same class and hyperparameters."""
    kind = type(crit).__name__
    if kind == "FixedNSteps":
        return FixedNSteps(int(crit.n_steps))
    if kind == "FixedIntegrationTime":
        return FixedIntegrationTime(float(crit.lam), int(crit.max_steps))
    if kind in _NO_U_TURN:
        return _NO_U_TURN[kind](max_depth=int(crit.max_depth),
                                delta_max=float(crit.delta_max))
    raise TypeError(f"unknown termination criterion {kind}")


def refreshment(ref):
    """A full or partial momentum refreshment."""
    if type(ref).__name__ == "PartialMomentumRefreshment":
        return PartialMomentumRefreshment(alpha=float(ref.alpha))
    return FullMomentumRefreshment()


def trajectory(traj, device=None, stepper=None) -> Trajectory:
    """A trajectory with the same integrator (`integrator`), criterion,
    sampler kind and precision switches (`stack_dtype`, `uturn_precision`,
    given by name)."""
    prec = traj.uturn_precision
    return Trajectory(
        integrator(traj.integrator, device, stepper),
        criterion(traj.criterion),
        traj.ts_kind,
        stack_dtype=(traj.stack_dtype if traj.stack_dtype is None
                     or isinstance(traj.stack_dtype, str)
                     else np.dtype(traj.stack_dtype).name),
        uturn_precision=None if prec is None
        else getattr(prec, "name", str(prec)).lower())


def kernel(k, device=None, stepper=None) -> HMCKernel:
    """An HMC kernel: its trajectory and its momentum refreshment."""
    return HMCKernel(trajectory(k.trajectory, device, stepper),
                     refreshment(k.refreshment))


def hmc_state(state, device=None) -> HMCState:
    """A whole `HMCState` with any metric and estimator: cross-chain (ε
    0-d, shared M⁻¹ and moments) or per chain (ε (C,), M⁻¹ and the
    estimator's n and moments with a leading chain axis); every leaf keeps
    its shape and bits."""
    return HMCState(
        iteration=int(np.asarray(state.iteration)),
        z=phasepoint(state.z, device),
        metric=metric(state.metric, device),
        adapt=adapt_state(state.adapt, device),
    )

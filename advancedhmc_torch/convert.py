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

from .adaptation import AdaptState, DualAveragingState, WelfordVarState
from .hamiltonian import PhasePoint
from .metrics import DiagEuclideanMetric
from .sampler import HMCState
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


def diag_metric(m_inv, device=None) -> DiagEuclideanMetric:
    """A diagonal metric from its M⁻¹ diagonal."""
    return DiagEuclideanMetric.create(tensor(m_inv, device))


def dual_averaging_state(da, device=None) -> DualAveragingState:
    return DualAveragingState(*(tensor(getattr(da, f), device) for f in
                                ("m", "eps", "mu", "x_bar", "h_bar")))


def welford_var_state(mm, device=None) -> WelfordVarState:
    return WelfordVarState(
        *(tensor(getattr(mm, f), device) for f in ("n", "mean", "m2", "var")),
        n_min=int(mm.n_min))


def hmc_state(state, device=None) -> HMCState:
    """A whole `HMCState` with a diagonal metric: cross-chain (ε 0-d, M⁻¹
    (dim,), Welford n 0-d) or per chain (ε (C,), M⁻¹ (C, dim), Welford n
    (C,) and its moments (C, dim)); every leaf keeps its shape and bits."""
    return HMCState(
        iteration=int(np.asarray(state.iteration)),
        z=phasepoint(state.z, device),
        metric=diag_metric(state.metric.m_inv, device),
        adapt=AdaptState(da=dual_averaging_state(state.adapt.da, device),
                         mm=welford_var_state(state.adapt.mm, device)),
    )

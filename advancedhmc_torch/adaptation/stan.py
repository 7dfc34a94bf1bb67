"""Adaptor configuration, composite state, Stan's windowed schedule, its
transient depth caps and the adaptation step.

PyTorch counterpart of `advancedhmc_tpu/adaptation/stan.py:48,76,94,129,
161,207`. The window schedule is computed on the host as boolean numpy
arrays indexed by iteration, so the sampler decides on the host which
adaptation steps run: `adapt_step` and `adapt_step_batch` take one
iteration's flags as Python booleans where the JAX functions mask with
traced ones. Inside the fused loop each chain is at its own iteration:
`adapt_step_masked` takes each chain's flags as (C,) boolean tensors and
masks, as the JAX function does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .massmatrix import (
    LowRankCovState,
    NutpieVarState,
    UnitMassMatrixState,
    WelfordCovState,
    WelfordVarState,
)
from ..utils import gather_chains
from .stepsize import DualAveragingConfig, DualAveragingState, da_update

# mass-matrix estimator kinds
MM_UNIT = "unit"
MM_WELFORD_VAR = "welford_var"
MM_WELFORD_COV = "welford_cov"
MM_NUTPIE = "nutpie"
MM_LOWRANK = "lowrank"

# adaptor kinds
NONE = "none"
STEPSIZE = "stepsize"
MASSMATRIX = "massmatrix"
NAIVE = "naive"
STAN = "stan"


@dataclasses.dataclass(frozen=True)
class AdaptorConfig:
    kind: str = STAN
    mm_kind: str = MM_WELFORD_VAR
    da: DualAveragingConfig = DualAveragingConfig()
    init_buffer: int = 75
    term_buffer: int = 50
    window_size: int = 25
    mm_rank: int = 8

    @property
    def uses_da(self):
        return self.kind in (STEPSIZE, NAIVE, STAN)

    @property
    def uses_mm(self):
        return self.kind in (MASSMATRIX, NAIVE, STAN) and self.mm_kind != MM_UNIT


_MM_STATES = {
    MM_UNIT: UnitMassMatrixState,
    MM_WELFORD_VAR: WelfordVarState,
    MM_WELFORD_COV: WelfordCovState,
    MM_NUTPIE: NutpieVarState,
    MM_LOWRANK: LowRankCovState,
}


@dataclasses.dataclass(frozen=True)
class AdaptState:
    """Composite adaptor state (dual averaging + mass matrix)."""

    da: DualAveragingState
    mm: object     # one of the estimators of `_MM_STATES`

    @classmethod
    def init(cls, cfg: AdaptorConfig, dim: int, eps0, dtype=torch.float32):
        """Shared state from a scalar ε, or one state per chain (dual
        averaging and the estimator's moments) from a (C,) ε; the low-rank
        estimator at rank `cfg.mm_rank`."""
        eps0 = torch.as_tensor(eps0, dtype=dtype)
        n_chains = eps0.shape[0] if eps0.dim() else None
        kw = {"rank": cfg.mm_rank} if cfg.mm_kind == MM_LOWRANK else {}
        return cls(da=DualAveragingState.init(eps0),
                   mm=_MM_STATES[cfg.mm_kind].init(
                       dim, dtype, eps0.device, n_chains=n_chains, **kw))


def stan_schedule(
    n_adapts: int,
    init_buffer: int = 75,
    term_buffer: int = 50,
    window_size: int = 25,
) -> Tuple[np.ndarray, np.ndarray]:
    """(in_window, window_end) boolean arrays of length n_adapts; entry t is
    adaptation iteration t+1."""
    window_start = init_buffer + 1
    window_end = n_adapts - term_buffer

    splits = []
    next_window = init_buffer + window_size
    w = window_size
    while next_window <= window_end:
        boundary = next_window + 2 * w
        if boundary > window_end:
            next_window = window_end
        splits.append(next_window)
        w *= 2
        next_window += w
    if splits and splits[-1] == n_adapts:
        splits.pop()

    i = np.arange(1, n_adapts + 1)
    in_window = (i >= window_start) & (i <= window_end)
    is_split = np.isin(i, np.asarray(splits, dtype=np.int64))
    return in_window, is_split


def transient_depth_caps(n_adapts: int, max_depth: int, cap: int,
                         init_len: int = 40, post_len: int = 16,
                         init_buffer: int = 75, term_buffer: int = 50,
                         window_size: int = 25) -> np.ndarray:
    """The transient-gated warmup depth caps ((n_adapts,) int32): `cap`
    for the first `init_len` iterations and for the `post_len` iterations
    after each Stan window reset, where dual averaging's ε transients grow
    the deepest trees, and `max_depth` elsewhere, so the equilibrium
    phases that set the final ε and M⁻¹ run at full depth. Feed it to
    `fused_warmup_phase_crosschain(..., depth_caps=...)`."""
    _, w_end = stan_schedule(n_adapts, init_buffer, term_buffer, window_size)
    caps = np.full(n_adapts, max_depth, np.int32)
    caps[:min(init_len, n_adapts)] = cap
    for r in np.nonzero(w_end)[0]:
        caps[r + 1:r + 1 + post_len] = cap
    return caps


def adapt_flags(cfg: AdaptorConfig, n_adapts: int, n_total: int):
    """Per-iteration flag arrays (length n_total), as numpy booleans."""
    is_adapt = np.arange(n_total) < n_adapts
    is_last = np.arange(n_total) == (n_adapts - 1)
    in_window = np.zeros(n_total, bool)
    window_end = np.zeros(n_total, bool)
    if cfg.kind == STAN and n_adapts > 0:
        in_w, w_end = stan_schedule(
            n_adapts, cfg.init_buffer, cfg.term_buffer, cfg.window_size)
        in_window[:n_adapts] = in_w
        window_end[:n_adapts] = w_end
    elif cfg.kind in (NAIVE, MASSMATRIX):
        in_window = is_adapt.copy()
    return {"is_adapt": is_adapt, "in_window": in_window,
            "window_end": window_end, "is_last": is_last}


def _mask(pred, new, old):
    """Per chain, the fields of `new` where `pred (C,)` holds, else those
    of `old` (a dataclass of (C, ...) tensors, or of such dataclasses)."""
    out = {}
    for f in dataclasses.fields(old):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if isinstance(a, torch.Tensor):
            p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
            out[f.name] = torch.where(p, a, b)
        elif dataclasses.is_dataclass(a):
            out[f.name] = _mask(pred, a, b)
    return dataclasses.replace(old, **out)


def _mm_push(cfg: AdaptorConfig, mm, theta, grad):
    """Push each chain's position (nutpie: and its gradient)."""
    if cfg.mm_kind == MM_NUTPIE:
        return mm.push(theta, grad)
    return mm.push(theta)


def _mm_push_batch(cfg: AdaptorConfig, mm, thetas, grads):
    """Fold the batch's positions (nutpie: and gradients) into shared
    moments."""
    if cfg.mm_kind == MM_NUTPIE:
        return mm.push_batch(thetas, grads)
    return mm.push_batch(thetas)


def _adapt_core(cfg: AdaptorConfig, st: AdaptState, push, alpha, flags):
    """One adaptation step, in the JAX package's order: dual-averaging
    update → Welford push (in a window) → estimate (window end) → reset of
    both (window end) → finalize (last adaptation step). `flags` holds one
    iteration's flags as booleans (a step that does not run is skipped), or
    each chain's as (C,) boolean tensors (every step is then masked chain
    by chain, as the JAX function masks with traced flags)."""

    def step(pred, update, old):
        if not isinstance(pred, torch.Tensor):
            return update(old) if pred else old
        return _mask(pred, update(old), old)

    is_adapt, window_end = flags["is_adapt"], flags["window_end"]
    da, mm = st.da, st.mm
    if cfg.uses_da:
        da = step(is_adapt, lambda d: da_update(cfg.da, d, alpha), da)
    if cfg.uses_mm:
        mm = step(is_adapt & flags["in_window"], push, mm)
        upd = flags["in_window" if cfg.kind in (NAIVE, MASSMATRIX)
                    else "window_end"]
        mm = step(is_adapt & upd, lambda m: m.update_estimate(), mm)
        mm = step(is_adapt & window_end, lambda m: m.reset(), mm)
    if cfg.uses_da and cfg.kind == STAN:
        da = step(is_adapt & window_end, lambda d: d.reset(), da)
    if cfg.uses_da:
        da = step(is_adapt & flags["is_last"], lambda d: d.finalize(), da)
    return AdaptState(da=da, mm=mm)


def adapt_step(cfg: AdaptorConfig, st: AdaptState, theta, grad, alpha,
               flags):
    """Per-chain adaptation: each chain's dual averaging on its own
    acceptance `alpha (C,)`, each chain's estimator on its own row of
    `theta (C, dim)` (nutpie: and of `grad`), as the JAX package's
    `vmap(adapt_step)`."""
    return _adapt_core(cfg, st, lambda mm: _mm_push(cfg, mm, theta, grad),
                       alpha, flags)


def adapt_step_masked(cfg: AdaptorConfig, st: AdaptState, theta, grad,
                      alpha, flags, where):
    """Per-chain adaptation with each chain's own flags: `flags` holds (C,)
    boolean tensors, and only the chains in `where (C,)` step (the JAX
    package's traced `adapt_step`, vmapped, then masked by the chains at a
    transition boundary); each pushes its row of `theta` (nutpie: and of
    `grad`)."""
    return _adapt_core(cfg, st, lambda mm: _mm_push(cfg, mm, theta, grad),
                       alpha, dict(flags, is_adapt=flags["is_adapt"] & where))


def adapt_step_batch(cfg: AdaptorConfig, st: AdaptState, thetas, grads,
                     alphas, flags):
    """Cross-chain adaptation: the whole (C, dim) batch of positions (nutpie:
    and of gradients `grads`) folded into shared moments, dual averaging on
    the batch-mean acceptance (each α clamped at 1). Under a chain shard
    the batch is gathered first, so every rank folds in the whole batch in
    the unsharded order."""
    thetas, alphas = gather_chains(thetas), gather_chains(alphas)
    if cfg.mm_kind == MM_NUTPIE:
        grads = gather_chains(grads)
    alpha = torch.mean(torch.clamp(alphas, max=1.0))
    return _adapt_core(
        cfg, st, lambda mm: _mm_push_batch(cfg, mm, thetas, grads), alpha,
        flags)

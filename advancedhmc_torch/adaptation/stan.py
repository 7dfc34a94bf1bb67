"""Adaptor configuration, composite state and Stan's windowed schedule.

PyTorch counterpart of `advancedhmc_tpu/adaptation/stan.py:48,76,94,161`. The
window schedule is computed on the host as boolean numpy arrays indexed by
iteration, so the sampler decides on the host which adaptation steps run.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .massmatrix import WelfordVarState
from .stepsize import DualAveragingConfig, DualAveragingState

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


@dataclasses.dataclass(frozen=True)
class AdaptState:
    """Composite adaptor state (dual averaging + mass matrix)."""

    da: DualAveragingState
    mm: WelfordVarState

    @classmethod
    def init(cls, cfg: AdaptorConfig, dim: int, eps0, dtype=torch.float32):
        if cfg.mm_kind != MM_WELFORD_VAR:
            raise NotImplementedError(
                f"mass-matrix estimator {cfg.mm_kind!r} is not ported yet "
                "(ROADMAP.md section 1, item 11)")
        eps0 = torch.as_tensor(eps0, dtype=dtype)
        return cls(da=DualAveragingState.init(eps0),
                   mm=WelfordVarState.init(dim, dtype, eps0.device))


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

"""Gaussian targets in the block form of the NUTS megakernel K2.

Counterparts of `advancedhmc_tpu/models/gaussian.py` `std_gaussian` (:11)
and `mvn_diag` (:23), in block form only: a diagonal Gaussian with
precisions `prec`, log density −½ Σ prec·θ² and gradient −prec ⊙ θ (the
target of the leapfrog kernel K3). The data is the (1, Dp) precision row,
zero on padded dims; its "gaussian" kind is compiled into K2's CUDA kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.counter_rng import _round_up
from ..target import BlockTarget
from ..utils import resolve_device


def _diag_gaussian_block(th, prec):
    return -0.5 * torch.sum(prec * th * th, 1, keepdim=True), -prec * th


def mvn_diag_block(variances, device=None):
    """Independent Gaussian with the given variances, on `device` (None
    means CUDA). Returns `(target, (prec (1, Dp),))`, Dp = round_up(dim,
    128). The precision is stored, so log density and gradient round as
    θ²·(1/var) where the JAX function divides by the variance."""
    device = resolve_device(device)
    var = np.asarray(variances, np.float64)
    prec = np.zeros((1, _round_up(var.shape[0], 128)), np.float32)
    prec[0, :var.shape[0]] = 1.0 / var
    return BlockTarget("gaussian", _diag_gaussian_block), (
        torch.as_tensor(prec, device=device),)


def std_gaussian_block(dim: int, device=None):
    """Standard normal on R^dim in block form (unit precisions)."""
    return mvn_diag_block(np.ones(dim), device=device)

"""Constrained-parameter transforms: sample on R^D, report in the
constrained space.

Counterpart of `advancedhmc_tpu/transforms.py`, batched: every transform
acts on the last axis of an array with any leading axes (the chains), so
`forward(x (…, size))` gives `(y (…, size'), logdet (…))`. A `Transform`
maps an unconstrained block to a constrained one with its log-|Jacobian|;
`transformed_target` composes per-block transforms with a constrained-space
log density into a `LogDensityTarget` (its gradient from autograd), and
`constrain`/`unconstrain` convert draws. All transforms are elementwise
except `Ordered` and `Simplex`, whose Jacobians are triangular: the
log-dets stay O(D).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from .target import LogDensityTarget


class Transform:
    """y = forward(x) with log|det ∂y/∂x|; inverse for initialisation."""

    size: int

    def forward(self, x):  # -> (y, logdet)
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Transform):
    size: int

    def forward(self, x):
        return x, x.new_zeros(x.shape[:-1])

    def inverse(self, y):
        return y


@dataclasses.dataclass(frozen=True)
class Positive(Transform):
    """y = exp(x): the log transform for scale-type parameters."""

    size: int

    def forward(self, x):
        return torch.exp(x), torch.sum(x, -1)

    def inverse(self, y):
        return torch.log(y)


@dataclasses.dataclass(frozen=True)
class Interval(Transform):
    """y = lo + (hi−lo)·sigmoid(x): bounded parameters."""

    size: int
    lo: float = 0.0
    hi: float = 1.0

    def forward(self, x):
        y = self.lo + (self.hi - self.lo) * torch.sigmoid(x)
        # log|dy/dx| = log(hi−lo) + log σ(x) + log σ(−x)
        logdet = torch.sum(math.log(self.hi - self.lo) + F.logsigmoid(x)
                           + F.logsigmoid(-x), -1)
        return y, logdet

    def inverse(self, y):
        p = (y - self.lo) / (self.hi - self.lo)
        return torch.log(p) - torch.log1p(-p)


@dataclasses.dataclass(frozen=True)
class Ordered(Transform):
    """y₁ = x₁, y_k = y_{k−1} + exp(x_k): strictly increasing vectors."""

    size: int

    def forward(self, x):
        incs = torch.cat([x[..., :1], torch.exp(x[..., 1:])], -1)
        return torch.cumsum(incs, -1), torch.sum(x[..., 1:], -1)

    def inverse(self, y):
        return torch.cat([y[..., :1], torch.log(torch.diff(y, dim=-1))], -1)


@dataclasses.dataclass(frozen=True)
class Simplex(Transform):
    """Stan's stick-breaking: x ∈ R^{K−1} → y on the K-simplex.

    `size` is the UNCONSTRAINED size K−1; forward returns K components.
    """

    size: int

    def _log_offsets(self, like):
        k = self.size
        return torch.log(k - torch.arange(k, dtype=like.dtype,
                                          device=like.device))

    def forward(self, x):
        z = torch.sigmoid(x - self._log_offsets(x))
        ones = torch.ones_like(x[..., :1])
        one_minus = torch.cat([ones, torch.cumprod(1.0 - z, -1)], -1)
        y = torch.cat([z, ones], -1) * one_minus
        logdet = torch.sum(torch.log(z) + torch.log1p(-z)
                           + torch.log(one_minus[..., :-1]), -1)
        return y, logdet

    def inverse(self, y):
        k = self.size
        rest = 1.0 - torch.cat([torch.zeros_like(y[..., :1]),
                                torch.cumsum(y[..., :-1], -1)], -1)[..., :k]
        z = y[..., :k] / rest
        return torch.log(z) - torch.log1p(-z) + self._log_offsets(y)


def _apply(transforms: Sequence[Transform], x):
    ys, off, logdet = [], 0, x.new_zeros(x.shape[:-1])
    for t in transforms:
        y, ld = t.forward(x[..., off:off + t.size])
        ys.append(y)
        logdet = logdet + ld
        off += t.size
    return ys, logdet


def transformed_target(logdensity_constrained: Callable,
                       transforms: Sequence[Transform],
                       names: Sequence[str] = None) -> LogDensityTarget:
    """Wrap a constrained-space log density into an unconstrained target.

    `logdensity_constrained(*blocks)` receives one constrained block per
    transform, each (C, size'), and returns (C,). The returned target's
    dimension is the total unconstrained size; its log density is
    ℓπ(T(x)) + log|det ∂T/∂x|, its gradient autograd's. It carries
    `transforms` (and `names`, one per transform, if given)."""
    dim = sum(t.size for t in transforms)
    if names is not None and len(names) != len(transforms):
        raise ValueError("need exactly one name per transform")

    def logdensity(x):
        ys, logdet = _apply(transforms, x)
        return logdensity_constrained(*ys) + logdet

    t = LogDensityTarget(logdensity, dim)
    object.__setattr__(t, "transforms", tuple(transforms))
    if names is not None:
        object.__setattr__(t, "names", tuple(names))
    return t


def constrain(transforms: Sequence[Transform], x):
    """Unconstrained draws (…, dim) → list of constrained blocks
    (…, size')."""
    return _apply(transforms, torch.as_tensor(x))[0]


def unconstrain(transforms: Sequence[Transform], *blocks):
    """Constrained blocks (…, size') → one unconstrained array (…, dim)."""
    return torch.cat([t.inverse(torch.as_tensor(b))
                      for t, b in zip(transforms, blocks)], -1)

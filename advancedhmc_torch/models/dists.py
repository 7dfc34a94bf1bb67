"""Standard distributions: declarative log densities composable with
`transforms.transformed_target`.

Counterpart of `advancedhmc_tpu/models/dists.py`, batched: `logpdf(y)` sums
the elementwise log densities over the LAST axis of y broadcast against the
parameters, so a block of chains (C, k) gives (C,) and a single block (k,)
a scalar, and parameters may carry the chain axis, (C, 1). Each
distribution's `default_transform(size)` maps its support onto R^size, so

    target_of(Gamma(2.0, 3.0), size=5)

is an unconstrained target for 5 iid Gamma variates, and hierarchical
models compose declaratively (see `gdemo_declarative`). Bounded
distributions guard their support: off-support elements give −inf
(`_sum_on_support`). Special functions come from `torch.lgamma`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ..target import LogDensityTarget
from ..transforms import Identity, Interval, Positive, Simplex, Transform, \
    transformed_target

_LOG_2PI = math.log(2.0 * math.pi)


def _as_y(y, *params):
    """`y` as a tensor: a tensor stays; numbers and lists take the dtype and
    device of the first tensor parameter (else the default dtype)."""
    if isinstance(y, torch.Tensor):
        return y
    like = next((p for p in params if isinstance(p, torch.Tensor)), None)
    if like is None:
        return torch.as_tensor(y, dtype=torch.get_default_dtype())
    return torch.as_tensor(y, dtype=like.dtype, device=like.device)


def _p(v, y):
    """A parameter as a tensor of y's dtype on y's device."""
    return torch.as_tensor(v, dtype=y.dtype, device=y.device)


def _float_param(v, other):
    """A parameter of an observation model as a floating tensor: a tensor
    stays (cast to the default float dtype if integral); a number or list
    takes the dtype of `other` if that is a floating tensor."""
    if not isinstance(v, torch.Tensor):
        float_other = isinstance(other, torch.Tensor) and \
            other.is_floating_point()
        v = torch.as_tensor(
            v, dtype=other.dtype if float_other else None,
            device=other.device if isinstance(other, torch.Tensor) else None)
    return v if v.is_floating_point() else v.to(torch.get_default_dtype())


def _sum(lp):
    return torch.sum(lp, -1) if lp.dim() else lp


def _sum_on_support(ok, lp_elem):
    """Sum elementwise log densities over the last axis with a support
    guard: off-support elements contribute −inf (so the block total is
    −inf) instead of a NaN or an improper constant."""
    return _sum(torch.where(ok, lp_elem, torch.full_like(lp_elem,
                                                         float("-inf"))))


def _lbeta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Distribution:
    """Base: `logpdf(y)` returns the SUM of elementwise log densities over
    the last axis (parameters broadcast against y); `default_transform(
    size)` maps the support onto R^size for unconstrained sampling."""

    def logpdf(self, y):
        raise NotImplementedError

    def default_transform(self, size: int) -> Transform:
        return Identity(size)


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def logpdf(self, y):
        y = _as_y(y, self.loc, self.scale)
        scale = _p(self.scale, y)
        z = (y - self.loc) / scale
        return _sum(-0.5 * z * z - torch.log(scale) - 0.5 * _LOG_2PI
                    + torch.zeros_like(y))


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def logpdf(self, y):
        y = _as_y(y, self.loc, self.scale)
        scale = _p(self.scale, y)
        ly = torch.log(torch.clamp(y, min=torch.finfo(y.dtype).tiny))
        z = (ly - self.loc) / scale
        return _sum_on_support(
            y > 0, -0.5 * z * z - ly - torch.log(scale) - 0.5 * _LOG_2PI)

    def default_transform(self, size):
        return Positive(size)


@dataclasses.dataclass(frozen=True)
class StudentT(Distribution):
    df: object = 3.0
    loc: object = 0.0
    scale: object = 1.0

    def logpdf(self, y):
        y = _as_y(y, self.df, self.loc, self.scale)
        v, scale = _p(self.df, y), _p(self.scale, y)
        z = (y - self.loc) / scale
        return _sum(torch.lgamma((v + 1.0) / 2.0) - torch.lgamma(v / 2.0)
                    - 0.5 * torch.log(v * math.pi) - torch.log(scale)
                    - (v + 1.0) / 2.0 * torch.log1p(z * z / v)
                    + torch.zeros_like(y))


@dataclasses.dataclass(frozen=True)
class Cauchy(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def logpdf(self, y):
        y = _as_y(y, self.loc, self.scale)
        scale = _p(self.scale, y)
        z = (y - self.loc) / scale
        return _sum(-math.log(math.pi) - torch.log(scale)
                    - torch.log1p(z * z) + torch.zeros_like(y))


@dataclasses.dataclass(frozen=True)
class Laplace(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def logpdf(self, y):
        y = _as_y(y, self.loc, self.scale)
        scale = _p(self.scale, y)
        return _sum(-torch.abs(y - self.loc) / scale
                    - torch.log(2.0 * scale) + torch.zeros_like(y))


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    rate: object = 1.0

    def logpdf(self, y):
        y = _as_y(y, self.rate)
        r = _p(self.rate, y)
        return _sum_on_support(y >= 0, torch.log(r) - r * y
                               + torch.zeros_like(y))

    def default_transform(self, size):
        return Positive(size)


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """Shape/rate parameterisation."""

    concentration: object = 1.0
    rate: object = 1.0

    def logpdf(self, y):
        y = _as_y(y, self.concentration, self.rate)
        a, b = _p(self.concentration, y), _p(self.rate, y)
        return _sum_on_support(
            y > 0, a * torch.log(b) - torch.lgamma(a)
            + (a - 1.0) * torch.log(y) - b * y)

    def default_transform(self, size):
        return Positive(size)


@dataclasses.dataclass(frozen=True)
class InverseGamma(Distribution):
    concentration: object = 2.0
    scale: object = 3.0

    def logpdf(self, y):
        y = _as_y(y, self.concentration, self.scale)
        a, b = _p(self.concentration, y), _p(self.scale, y)
        return _sum_on_support(
            y > 0, a * torch.log(b) - torch.lgamma(a)
            - (a + 1.0) * torch.log(y) - b / y)

    def default_transform(self, size):
        return Positive(size)


@dataclasses.dataclass(frozen=True)
class Beta(Distribution):
    a: object = 1.0
    b: object = 1.0

    def logpdf(self, y):
        y = _as_y(y, self.a, self.b)
        a, b = _p(self.a, y), _p(self.b, y)
        return _sum_on_support(
            (y > 0) & (y < 1),
            (a - 1.0) * torch.log(y) + (b - 1.0) * torch.log1p(-y)
            - _lbeta(a, b))

    def default_transform(self, size):
        return Interval(size, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    lo: object = 0.0
    hi: object = 1.0

    def logpdf(self, y):
        y = _as_y(y, self.lo, self.hi)
        lo, hi = _p(self.lo, y), _p(self.hi, y)
        return _sum_on_support((y >= lo) & (y <= hi),
                               -torch.log(hi - lo) + torch.zeros_like(y))

    def default_transform(self, size):
        return Interval(size, float(self.lo), float(self.hi))


@dataclasses.dataclass(frozen=True)
class Dirichlet(Distribution):
    """`alpha` is the (K,) concentration; logpdf takes the K-simplex block
    produced by the `Simplex` transform (unconstrained size K−1)."""

    alpha: tuple

    def logpdf(self, y):
        y = _as_y(y, self.alpha)
        a = _p(self.alpha, y)
        return (_sum_on_support(y > 0, (a - 1.0) * torch.log(y))
                + torch.lgamma(torch.sum(a, -1))
                - torch.sum(torch.lgamma(a), -1))

    def default_transform(self, size):
        # size = unconstrained size = K−1
        return Simplex(size)


@dataclasses.dataclass(frozen=True)
class BernoulliLogit(Distribution):
    """Observation-model helper: logpdf(k) of binary data k ∈ {0, 1} given
    `logits`, in the stable form k·lg − log(1 + e^lg). Typically used
    inside a log density, not as a sampled block."""

    logits: object = 0.0

    def logpdf(self, k):
        lg = _float_param(self.logits, k)
        k = _p(k, lg)
        return _sum(k * lg - torch.logaddexp(torch.zeros_like(lg), lg)
                    + torch.zeros_like(k))


@dataclasses.dataclass(frozen=True)
class Poisson(Distribution):
    rate: object = 1.0

    def logpdf(self, k):
        r = _float_param(self.rate, k)
        kf = _p(k, r)
        return _sum(kf * torch.log(r) - r - torch.lgamma(kf + 1.0))


def target_of(dist: Distribution, size: int = 1,
              transform: Optional[Transform] = None,
              name: str = "x") -> LogDensityTarget:
    """Any distribution → unconstrained target: its log density is
    logpdf(T(x)) + log|det ∂T/∂x| with T the distribution's default support
    transform (overridable)."""
    t = transform if transform is not None else dist.default_transform(size)
    return transformed_target(dist.logpdf, [t], names=[name])


def joint_target(blocks: Sequence[tuple], loglik=None) -> LogDensityTarget:
    """Declarative model: `blocks` is a sequence of (name, distribution,
    size[, transform]) prior blocks; `loglik(*values)` (optional) adds an
    observation log likelihood over the constrained block values, each
    (C, size). A block's distribution may instead be a CALLABLE
    `dist_fn(*previous_values) -> Distribution`, evaluated on the
    constrained values of the blocks before it (it needs an explicit
    transform)."""
    names, transforms, dist_specs = [], [], []
    for blk in blocks:
        if len(blk) == 3:
            name, dist, size = blk
            tr = None
        else:
            name, dist, size, tr = blk
        if tr is None:
            if isinstance(dist, Distribution):
                tr = dist.default_transform(size)
            else:
                raise ValueError(
                    f"block {name!r}: conditional (callable) priors need an "
                    "explicit transform")
        names.append(name)
        transforms.append(tr)
        dist_specs.append(dist)

    def logdensity(*values):
        lp = 0.0
        for i, (d, v) in enumerate(zip(dist_specs, values)):
            if callable(d) and not isinstance(d, Distribution):
                d = d(*values[:i])
            lp = lp + d.logpdf(v)
        if loglik is not None:
            lp = lp + loglik(*values)
        return lp

    return transformed_target(logdensity, transforms, names=names)


_GDEMO_OBS = (1.5, 2.0)


def gdemo_declarative() -> LogDensityTarget:
    """The conjugate gdemo model rebuilt from distribution primitives:
    s ~ InverseGamma(2, 3); m | s ~ N(0, √s); obs 1.5, 2.0 ~ N(m, √s).
    Posterior mean of (s, m) is (49/24, 7/6)."""
    return joint_target(
        [("s", InverseGamma(2.0, 3.0), 1),
         ("m", lambda s: Normal(0.0, torch.sqrt(s)), 1, Identity(1))],
        loglik=lambda s, m: Normal(m, torch.sqrt(s)).logpdf(
            m.new_tensor(_GDEMO_OBS)))

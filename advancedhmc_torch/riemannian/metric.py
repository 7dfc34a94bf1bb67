"""Riemannian metrics: a position-dependent G(θ) with the identity or the
SoftAbs map (counterpart of `advancedhmc_tpu/riemannian/metric.py`).

Batched over chains: `g_fn(θ (C, D)) → (C, D, D)` and `dg_fn(θ) →
(C, D, D, D)`, the last axis ∂/∂θᵢ. `DenseRiemannianMetric.from_hessian`
takes G = −∇²ℓπ and ∂G by `torch.func` on the single-chain function
θ ↦ ℓπ(θ) of the target's plain `logdensity` (never its value+grad, which
may be a kernel without second derivatives).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class IdentityMap:
    """G ↦ G."""


@dataclasses.dataclass(frozen=True)
class SoftAbsMap:
    """Eigendecomposition PSD-ification λ ↦ λ·coth(αλ) (Betancourt 2012)."""

    alpha: float = 20.0


def eigh(x):
    """`torch.linalg.eigh` of the symmetric matrices `x (…, D, D)`, NaN for
    a matrix with a non-finite entry (where torch would raise and JAX gives
    NaN)."""
    bad = ~torch.isfinite(x).all(-1).all(-1)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    lam, q = torch.linalg.eigh(torch.where(bad[..., None, None], eye, x))
    nan = float("nan")
    return (torch.where(bad[..., None], nan, lam),
            torch.where(bad[..., None, None], nan, q))


def softabs(x, alpha=20.0):
    """(softabs(X), Q, λ, softabs(λ)) of symmetric `x (…, D, D)`:
    softabs(X) = Q · diag(λ coth(αλ)) · Qᵀ, with the Taylor-safe form
    (1 + (αλ)²/3)/α where |αλ| < 1e-4."""
    lam, q = eigh(x)
    al = alpha * lam
    soft = torch.where(torch.abs(al) < 1e-4, (1.0 + al * al / 3.0) / alpha,
                       lam * (1.0 / torch.tanh(al)))
    g = (q * soft[..., None, :]) @ q.mT
    return g, q, lam, soft


def apply_map(map_cfg, x):
    if isinstance(map_cfg, IdentityMap):
        return x
    return softabs(x, map_cfg.alpha)[0]


@dataclasses.dataclass(frozen=True)
class DenseRiemannianMetric:
    """Position-dependent dense metric G(θ) with its derivative tensor:
    `g_fn(θ (C, D)) → (C, D, D)`, `dg_fn(θ) → (C, D, D, D)` with
    `dg[c, :, :, i] = ∂G/∂θᵢ`, and the map (identity or SoftAbs)."""

    size: int
    g_fn: Callable
    dg_fn: Callable
    map: object = IdentityMap()

    @property
    def dim(self):
        return self.size

    @classmethod
    def from_hessian(cls, target, map_cfg=None, jitter=0.0,
                     chunk_size: Optional[int] = None):
        """G(θ) = −∇²ℓπ(θ) (+ jitter·I) and ∂G by AD, each vmapped over the
        chains (`chunk_size` chains at a time where given, which bounds the
        memory the third derivatives take). The Hessian is reverse over
        reverse (`jacrev` twice); ∂G is `jacfwd` of it, as in the JAX
        package."""
        from torch.func import jacfwd, jacrev, vmap

        if map_cfg is None:
            map_cfg = SoftAbsMap(20.0)

        def single(theta):
            return target.logdensity(theta[None])[0]

        def g_one(theta):
            h = -jacrev(jacrev(single))(theta)
            if jitter:
                h = h + jitter * torch.eye(theta.shape[-1], dtype=theta.dtype,
                                           device=theta.device)
            return h

        g_batch = vmap(g_one, chunk_size=chunk_size)
        # the Jacobian puts ∂/∂θᵢ on the last axis: (D, D, D) a chain
        dg_batch = vmap(jacfwd(g_one), chunk_size=chunk_size)
        return cls(size=target.dim, g_fn=g_batch, dg_fn=dg_batch,
                   map=map_cfg)

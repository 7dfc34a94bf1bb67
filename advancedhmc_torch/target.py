"""Target density interface.

PyTorch counterpart of `advancedhmc_tpu/target.py`. The port's native form is
BATCHED: `logdensity(theta (C, dim)) -> (C,)` and
`logdensity_and_grad(theta (C, dim)) -> ((C,), (C, dim))`, where the JAX
package writes a single-chain function and batches it with `vmap`. The
default gradient comes from `torch.autograd`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def _autograd_value_and_grad(logdensity):
    def value_and_grad(theta):
        with torch.enable_grad():
            t = theta.detach().requires_grad_(True)
            lp = logdensity(t)
            (grad,) = torch.autograd.grad(lp.sum(), t)
        return lp.detach(), grad

    return value_and_grad


@dataclasses.dataclass(frozen=True, eq=False)
class LogDensityTarget:
    """A differentiable unnormalized log density on R^dim, batched over chains.

    Fields
    ------
    logdensity:
        `theta (C, dim) -> (C,)` log density.
    dim:
        Number of parameters.
    logdensity_and_grad:
        Optional `theta (C, dim) -> ((C,), (C, dim))`; defaults to the
        autograd gradient of `logdensity`.
    """

    logdensity: Callable
    dim: int
    logdensity_and_grad: Optional[Callable] = None

    def __post_init__(self):
        if self.logdensity_and_grad is None:
            object.__setattr__(self, "logdensity_and_grad",
                               _autograd_value_and_grad(self.logdensity))


@dataclasses.dataclass(frozen=True, eq=False)
class BlockTarget:
    """A value+grad over a zero-padded block of chains, the form the NUTS
    megakernel takes (the JAX package's `value_and_grad_block`).

    Fields
    ------
    kind:
        Names the version of the same function compiled into the CUDA
        kernel: "logistic" or "gaussian".
    value_and_grad:
        `(theta (B, Dp), *data) -> ((B, 1) logp, (B, Dp) grad)`, the plain
        PyTorch version, with the target's data passed at each call.
    p:
        The logistic's feature count (θ = (log σ, β₁..β_p)); 0 otherwise.
    """

    kind: str
    value_and_grad: Callable
    p: int = 0

    def __call__(self, theta, *data):
        return self.value_and_grad(theta, *data)


def as_target(obj, dim: Optional[int] = None) -> LogDensityTarget:
    """A `LogDensityTarget` from a target or a bare callable.

    The callable is in the port's BATCHED form: `logdensity(theta (C, dim))
    -> (C,)`, where the JAX function takes a single-chain `(dim,) ->
    scalar`; its gradient comes from autograd. `dim` is required for a bare
    callable. The target's tensors stay where the callable puts them, so
    it runs on the device of the θ it is given (CUDA unless the caller's
    state is on the CPU)."""
    if isinstance(obj, LogDensityTarget):
        return obj
    if callable(obj):
        if dim is None:
            raise ValueError("dim is required when wrapping a bare callable")
        return LogDensityTarget(logdensity=obj, dim=dim)
    raise TypeError(f"cannot interpret {type(obj)} as a log-density target")

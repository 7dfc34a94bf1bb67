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

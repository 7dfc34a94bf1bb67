"""Diagonal Welford mass-matrix estimator.

PyTorch counterpart of `advancedhmc_tpu/adaptation/massmatrix.py:38`, with
Stan's shrinkage estimate n/((n+5)(n-1))·M2 + 1e-3·5/(n+5) and n_min=10.
`push_batch` folds a whole (chains, dim) batch in with the exact
parallel-Welford combine (the cross-chain path). The dense, low-rank and
nutpie estimators are ROADMAP.md section 1, item 11.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import resolve_device

N_MIN_DEFAULT = 10
SHRINKAGE_EPS = 1.0e-3


def _shrunk(n, m2):
    nf = n.to(m2.dtype)
    return nf / ((nf + 5.0) * (nf - 1.0)) * m2 + SHRINKAGE_EPS * (
        5.0 / (nf + 5.0))


@dataclasses.dataclass(frozen=True)
class WelfordVarState:
    """Diagonal (variance) estimator."""

    n: torch.Tensor      # sample count (int32)
    mean: torch.Tensor   # (dim,)
    m2: torch.Tensor     # (dim,) sum of squared deviations
    var: torch.Tensor    # (dim,) current M⁻¹ estimate
    n_min: int = N_MIN_DEFAULT

    @classmethod
    def init(cls, dim, dtype=torch.float32, device=None,
             n_min=N_MIN_DEFAULT):
        """Empty moments on `device` (None means CUDA)."""
        device = resolve_device(device)
        z = torch.zeros(dim, dtype=dtype, device=device)
        return cls(n=torch.zeros((), dtype=torch.int32, device=device),
                   mean=z, m2=z, var=torch.ones_like(z), n_min=n_min)

    def push_batch(self, xs):
        """Fold in a (batch, dim) block via the exact parallel-Welford
        combine."""
        c = xs.shape[0]
        b_mean = xs.mean(0)
        b_m2 = torch.sum((xs - b_mean) ** 2, 0)
        n0f = self.n.to(xs.dtype)
        nf = n0f + c
        delta = b_mean - self.mean
        return dataclasses.replace(
            self, n=self.n + c, mean=self.mean + delta * (c / nf),
            m2=self.m2 + b_m2 + delta * delta * (n0f * c / nf))

    def update_estimate(self):
        """Refresh `var` if n ≥ n_min."""
        est = _shrunk(self.n, self.m2)
        return dataclasses.replace(
            self, var=torch.where(self.n >= self.n_min, est, self.var))

    def reset(self):
        """Zero the moments, keep the current estimate."""
        return dataclasses.replace(
            self, n=torch.zeros_like(self.n),
            mean=torch.zeros_like(self.mean), m2=torch.zeros_like(self.m2))

    @property
    def m_inv(self):
        return self.var

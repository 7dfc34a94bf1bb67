"""Diagonal Welford mass-matrix estimator.

PyTorch counterpart of `advancedhmc_tpu/adaptation/massmatrix.py:38`, with
Stan's shrinkage estimate n/((n+5)(n-1))·M2 + 1e-3·5/(n+5) and n_min=10.
`push_batch` folds a whole (chains, dim) batch into shared moments with the
exact parallel-Welford combine (the cross-chain path); `push` adds one
sample to each chain's own moments (the per-chain path, the JAX package's
vmapped `push`): n is then (C,) and the moments (C, dim). The dense,
low-rank and nutpie estimators are queued under ROADMAP.md's "The rest
of the surface".
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import resolve_device

N_MIN_DEFAULT = 10
SHRINKAGE_EPS = 1.0e-3


def _shrunk(n, m2):
    nf = n.to(m2.dtype)[..., None]     # over dim, per chain if n is (C,)
    return nf / ((nf + 5.0) * (nf - 1.0)) * m2 + SHRINKAGE_EPS * (
        5.0 / (nf + 5.0))


@dataclasses.dataclass(frozen=True)
class WelfordVarState:
    """Diagonal (variance) estimator."""

    n: torch.Tensor      # sample count (int32), () or per chain (C,)
    mean: torch.Tensor   # (dim,) or (C, dim)
    m2: torch.Tensor     # sum of squared deviations, as mean
    var: torch.Tensor    # current M⁻¹ estimate, as mean
    n_min: int = N_MIN_DEFAULT

    @classmethod
    def init(cls, dim, dtype=torch.float32, device=None,
             n_min=N_MIN_DEFAULT, n_chains=None):
        """Empty moments on `device` (None means CUDA): shared, or one set
        per chain when `n_chains` is given."""
        device = resolve_device(device)
        lead = () if n_chains is None else (n_chains,)
        z = torch.zeros(lead + (dim,), dtype=dtype, device=device)
        return cls(n=torch.zeros(lead, dtype=torch.int32, device=device),
                   mean=z, m2=z, var=torch.ones_like(z), n_min=n_min)

    def push(self, x):
        """Welford single-sample update of each chain's moments with its row
        of `x (C, dim)`."""
        n = self.n + 1
        nf = n.to(x.dtype)[..., None]
        delta = x - self.mean
        mean = self.mean + delta / nf
        m2 = self.m2 + delta * delta * ((nf - 1.0) / nf)
        return dataclasses.replace(self, n=n, mean=mean, m2=m2)

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
        """Refresh `var` where n ≥ n_min (chain by chain if n is (C,))."""
        est = _shrunk(self.n, self.m2)
        ok = (self.n >= self.n_min)[..., None]
        return dataclasses.replace(self, var=torch.where(ok, est, self.var))

    def reset(self):
        """Zero the moments, keep the current estimate."""
        return dataclasses.replace(
            self, n=torch.zeros_like(self.n),
            mean=torch.zeros_like(self.mean), m2=torch.zeros_like(self.m2))

    @property
    def m_inv(self):
        return self.var

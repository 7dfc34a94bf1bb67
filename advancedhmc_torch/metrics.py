"""Euclidean metrics (mass matrices): unit and diagonal.

PyTorch counterpart of `advancedhmc_tpu/metrics.py`. A metric is a small
immutable dataclass of tensors; momenta carry a leading chain axis, so
`velocity` and `neg_kinetic_energy` act on (C, dim) batches. The dense and
low-rank metrics are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from .utils import resolve_device

_LATER = "(ROADMAP.md section 1, item 11)"


class Metric:
    """Base class for Euclidean metrics (position-independent M⁻¹)."""

    dim: int

    def rand_momentum(self, generator, n_chains):
        raise NotImplementedError

    def velocity(self, r):
        """∂H∂r = M⁻¹ r, batched over chains."""
        raise NotImplementedError

    def neg_kinetic_energy(self, r):
        """-K(r) = -½ rᵀ M⁻¹ r per chain."""
        raise NotImplementedError

    def renew(self, m_inv):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UnitEuclideanMetric(Metric):
    """M⁻¹ = I."""

    size: int
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")

    @property
    def dim(self):
        return self.size

    def rand_momentum(self, generator, n_chains):
        return torch.randn((n_chains, self.size), generator=generator,
                           dtype=self.dtype, device=self.device)

    def velocity(self, r):
        return r

    def neg_kinetic_energy(self, r):
        return -0.5 * torch.sum(r * r, -1)

    def renew(self, m_inv):
        return self


@dataclasses.dataclass(frozen=True)
class DiagEuclideanMetric(Metric):
    """Diagonal M⁻¹ with cached sqrt."""

    m_inv: torch.Tensor        # (dim,)
    sqrt_m_inv: torch.Tensor   # (dim,)

    @classmethod
    def create(cls, m_inv):
        return cls(m_inv=m_inv, sqrt_m_inv=torch.sqrt(m_inv))

    @classmethod
    def identity(cls, dim, dtype=torch.float32, device="cpu"):
        return cls.create(torch.ones(dim, dtype=dtype, device=device))

    @property
    def dim(self):
        return self.m_inv.shape[-1]

    @property
    def dtype(self):
        return self.m_inv.dtype

    def rand_momentum(self, generator, n_chains):
        # r = z / sqrt(M⁻¹)
        z = torch.randn((n_chains, self.dim), generator=generator,
                        dtype=self.dtype, device=self.m_inv.device)
        return z / self.sqrt_m_inv

    def velocity(self, r):
        return self.m_inv * r

    def neg_kinetic_energy(self, r):
        return -0.5 * torch.sum(r * r * self.m_inv, -1)

    def renew(self, m_inv):
        return DiagEuclideanMetric.create(m_inv)


def make_metric(kind: str, dim: int, dtype=torch.float32,
                device=None) -> Metric:
    """"unit" or "diagonal" metric of size `dim` on `device` (None: CUDA)."""
    device = resolve_device(device)
    if kind == "unit":
        return UnitEuclideanMetric(size=dim, dtype=dtype, device=device)
    if kind in ("diag", "diagonal"):
        return DiagEuclideanMetric.identity(dim, dtype=dtype, device=device)
    if kind in ("dense", "rank_update", "rankupdate"):
        raise NotImplementedError(f"metric kind {kind!r} is not ported yet "
                                  + _LATER)
    raise ValueError(f"unknown metric kind: {kind!r}")

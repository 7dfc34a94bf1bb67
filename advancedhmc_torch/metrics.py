"""Euclidean metrics (mass matrices): unit, diagonal, dense and rank-update.

PyTorch counterpart of `advancedhmc_tpu/metrics.py`. A metric is a small
immutable dataclass of tensors; momenta carry a leading chain axis, so
`velocity` and `neg_kinetic_energy` act on (C, dim) batches. A diagonal
M⁻¹ is shared, (dim,), or per chain, (C, dim) (`per_chain`, the JAX
package's metric broadcast along the chain axis): every operation
broadcasts. A dense M⁻¹ is shared, (dim, dim), or per chain, (C, dim,
dim); the rank-update metric (diag(A) + B·D·Bᵀ) likewise. Momenta are
drawn as standard normals z (C, dim) and mapped by
`momentum_from_normals(z)`, so that a test can feed the JAX package's
normals.

The factorisations read a symmetrised input, ½(A + Aᵀ), as
`jnp.linalg.cholesky` and `eigh` do by default; a failed Cholesky gives NaN
(as in JAX) without a read back to the host (`cholesky_upper`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .utils import rand_normal, resolve_device


class Metric:
    """Base class for Euclidean metrics (position-independent M⁻¹)."""

    dim: int

    def rand_momentum(self, generator, n_chains):
        """Momenta (n_chains, dim) ~ N(0, M): standard normals mapped by
        `momentum_from_normals`."""
        z = rand_normal(generator, (n_chains, self.dim), self.dtype,
                        self.device)
        return self.momentum_from_normals(z)

    def momentum_from_normals(self, z):
        """The momenta of standard normals `z (C, dim)`."""
        raise NotImplementedError

    def velocity(self, r):
        """∂H∂r = M⁻¹ r, batched over chains."""
        raise NotImplementedError

    def neg_kinetic_energy(self, r):
        """-K(r) = -½ rᵀ M⁻¹ r per chain."""
        raise NotImplementedError

    def renew(self, m_inv):
        raise NotImplementedError

    def m_inv_matrix(self):
        """Dense M⁻¹, (dim, dim) or per chain (C, dim, dim)."""
        raise NotImplementedError

    def per_chain(self, n_chains):
        """The metric with its M⁻¹ repeated for each of `n_chains` chains
        (a metric without tensors is already per chain)."""
        return self

    def take(self, chains):
        """The metric of the chains `chains` (a slice): a per-chain M⁻¹'s
        rows; a shared metric is every chain's."""
        return self


@dataclasses.dataclass(frozen=True)
class UnitEuclideanMetric(Metric):
    """M⁻¹ = I, with momenta drawn on `device` (None means CUDA)."""

    size: int
    dtype: torch.dtype = torch.float32
    device: Optional[torch.device] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def dim(self):
        return self.size

    def momentum_from_normals(self, z):
        return z

    def velocity(self, r):
        return r

    def neg_kinetic_energy(self, r):
        return -0.5 * torch.sum(r * r, -1)

    def renew(self, m_inv):
        return self

    def m_inv_matrix(self):
        return torch.eye(self.size, dtype=self.dtype, device=self.device)


@dataclasses.dataclass(frozen=True)
class DiagEuclideanMetric(Metric):
    """Diagonal M⁻¹ with cached sqrt."""

    m_inv: torch.Tensor        # (dim,) or per chain (C, dim)
    sqrt_m_inv: torch.Tensor   # as m_inv

    @classmethod
    def create(cls, m_inv):
        return cls(m_inv=m_inv, sqrt_m_inv=torch.sqrt(m_inv))

    @classmethod
    def identity(cls, dim, dtype=torch.float32, device=None):
        """M⁻¹ = I on `device` (None means CUDA)."""
        return cls.create(torch.ones(dim, dtype=dtype,
                                     device=resolve_device(device)))

    @property
    def dim(self):
        return self.m_inv.shape[-1]

    @property
    def dtype(self):
        return self.m_inv.dtype

    @property
    def device(self):
        return self.m_inv.device

    def momentum_from_normals(self, z):
        # r = z / sqrt(M⁻¹)
        return z / self.sqrt_m_inv

    def velocity(self, r):
        return self.m_inv * r

    def neg_kinetic_energy(self, r):
        return -0.5 * torch.sum(r * r * self.m_inv, -1)

    def renew(self, m_inv):
        return DiagEuclideanMetric.create(m_inv)

    def m_inv_matrix(self):
        return torch.diag_embed(self.m_inv)

    def per_chain(self, n_chains):
        return DiagEuclideanMetric(
            m_inv=self.m_inv.expand(n_chains, -1).contiguous(),
            sqrt_m_inv=self.sqrt_m_inv.expand(n_chains, -1).contiguous())

    def take(self, chains):
        if self.m_inv.dim() == 1:
            return self
        return DiagEuclideanMetric(m_inv=self.m_inv[chains],
                                   sqrt_m_inv=self.sqrt_m_inv[chains])


def symmetrised(a):
    """½(A + Aᵀ) over the last two axes: what JAX's factorisations read."""
    return (a + a.mT) / 2


def cholesky_upper(a):
    """The upper Cholesky factor U of the symmetrised `a` (UᵀU = a), over
    any leading axes; where the factorisation fails, NaN on and above the
    diagonal (zero below), as `jnp.linalg.cholesky(a).T` gives, with
    nothing read back to the host."""
    low, info = torch.linalg.cholesky_ex(symmetrised(a))
    bad = (info != 0)[..., None, None]
    nan = torch.full_like(low, float("nan")).tril()
    return torch.where(bad, nan, low).mT


@dataclasses.dataclass(frozen=True)
class DenseEuclideanMetric(Metric):
    """Dense M⁻¹ with its cached upper Cholesky factor U (UᵀU = M⁻¹):
    momenta solve U r = z, so that cov(r) = M. Shared, (dim, dim), or per
    chain, (C, dim, dim)."""

    m_inv: torch.Tensor    # (dim, dim) or per chain (C, dim, dim)
    chol_u: torch.Tensor   # as m_inv, upper triangular

    @classmethod
    def create(cls, m_inv):
        return cls(m_inv=m_inv, chol_u=cholesky_upper(m_inv))

    @classmethod
    def identity(cls, dim, dtype=torch.float32, device=None):
        """M⁻¹ = I on `device` (None means CUDA)."""
        return cls.create(torch.eye(dim, dtype=dtype,
                                    device=resolve_device(device)))

    @property
    def dim(self):
        return self.m_inv.shape[-1]

    @property
    def dtype(self):
        return self.m_inv.dtype

    @property
    def device(self):
        return self.m_inv.device

    def momentum_from_normals(self, z):
        if self.chol_u.dim() == 2:
            return torch.linalg.solve_triangular(
                self.chol_u, z.mT, upper=True).mT
        return torch.linalg.solve_triangular(
            self.chol_u, z[:, :, None], upper=True)[:, :, 0]

    def velocity(self, r):
        # M⁻¹ r, each row summed as JAX's `m_inv @ r`: a shared M⁻¹ as one
        # product over the chains
        if self.m_inv.dim() == 2:
            return r @ self.m_inv.mT
        return torch.bmm(self.m_inv, r[:, :, None])[:, :, 0]

    def neg_kinetic_energy(self, r):
        return -0.5 * torch.sum(r * self.velocity(r), -1)

    def renew(self, m_inv):
        return DenseEuclideanMetric.create(m_inv)

    def m_inv_matrix(self):
        return self.m_inv

    def per_chain(self, n_chains):
        return DenseEuclideanMetric(
            m_inv=self.m_inv.expand(n_chains, -1, -1).contiguous(),
            chol_u=self.chol_u.expand(n_chains, -1, -1).contiguous())

    def take(self, chains):
        if self.m_inv.dim() == 2:
            return self
        return DenseEuclideanMetric(m_inv=self.m_inv[chains],
                                    chol_u=self.chol_u[chains])


@dataclasses.dataclass(frozen=True)
class RankUpdateEuclideanMetric(Metric):
    """M⁻¹ = diag(A) + B·D·Bᵀ (a Woodbury low-rank update; the Pathfinder
    metric), shared by the chains or per chain (every leaf with a leading
    chain axis: A (C, dim), B (C, dim, k), D (C, k, k)). Momenta use the
    factorisation U = √A, Q R = U⁻¹B (a complete QR), VᵀV = I + R D Rᵀ:
    r = U⁻¹ Q [V⁻¹ z₁:ₖ ; zₖ₊₁:]."""

    a_diag: torch.Tensor   # (dim,) positive diagonal A, or (C, dim)
    b: torch.Tensor        # (dim, k), or (C, dim, k)
    d: torch.Tensor        # (k, k) symmetric, or (C, k, k)
    q_full: torch.Tensor   # (dim, dim) orthogonal factor of qr(U⁻¹B)
    v_upper: torch.Tensor  # (k, k) upper Cholesky factor of I + R D Rᵀ

    @classmethod
    def create(cls, a_diag, b, d):
        """The factorisation of (A, B, D), shared or, with a leading chain
        axis on each, per chain (one batched QR and Cholesky)."""
        dim, k = b.shape[-2:]
        lead = a_diag.shape[:-1]
        if k == 0:
            q_full = torch.eye(dim, dtype=a_diag.dtype,
                               device=a_diag.device).expand(
                                   lead + (dim, dim)).contiguous()
            v_upper = a_diag.new_zeros(lead + (0, 0))
        else:
            q_full, r = torch.linalg.qr(b / torch.sqrt(a_diag)[..., None],
                                        mode="complete")
            r = r[..., :k, :]
            inner = torch.eye(k, dtype=a_diag.dtype,
                              device=a_diag.device) + r @ d @ r.mT
            v_upper = cholesky_upper(inner)
        return cls(a_diag=a_diag, b=b, d=d, q_full=q_full, v_upper=v_upper)

    @classmethod
    def identity(cls, dim, dtype=torch.float32, device=None, rank=0):
        """M⁻¹ = I carried at rank `rank` (B = 0): an adapting run
        (mm_kind "lowrank") renews it in place at that rank."""
        a = torch.ones(dim, dtype=dtype, device=resolve_device(device))
        return cls.create(a, a.new_zeros((dim, rank)),
                          a.new_zeros((rank, rank)))

    @property
    def dim(self):
        return self.a_diag.shape[-1]

    @property
    def rank(self):
        return self.b.shape[-1]

    @property
    def dtype(self):
        return self.a_diag.dtype

    @property
    def device(self):
        return self.a_diag.device

    def _rows(self, m, x):
        """Each row of `x (C, n)` times the matrix `m` transposed: one
        product for a shared (n', n) `m`, a `bmm` per chain (C, n', n)."""
        if m.dim() == 2:
            return x @ m.mT
        return torch.bmm(m, x[:, :, None])[:, :, 0]

    def momentum_from_normals(self, z):
        k = self.rank
        if k > 0:
            if self.v_upper.dim() == 2:
                head = torch.linalg.solve_triangular(
                    self.v_upper, z[:, :k].mT, upper=True).mT
            else:
                head = torch.linalg.solve_triangular(
                    self.v_upper, z[:, :k, None], upper=True)[:, :, 0]
            z = torch.cat([head, z[:, k:]], 1)
        return self._rows(self.q_full, z) / torch.sqrt(self.a_diag)

    def velocity(self, r):
        # A r + B (D (Bᵀ r))
        out = self.a_diag * r
        if self.rank > 0:
            btr = self._rows(self.b.mT, r)
            out = out + self._rows(self.b, self._rows(self.d, btr))
        return out

    def neg_kinetic_energy(self, r):
        # -(rᵀ A r + (Bᵀr)ᵀ D (Bᵀr)) / 2
        quad = torch.sum(r * r * self.a_diag, -1)
        if self.rank > 0:
            btr = self._rows(self.b.mT, r)
            quad = quad + torch.sum(btr * self._rows(self.d, btr), -1)
        return -0.5 * quad

    def renew(self, m_inv):
        """Rank-preserving: an (a, b, d) triple (from `LowRankCovState`;
        d the diagonal of D or D itself, shared or per chain) rebuilds the
        factorisation at its rank; a plain diagonal (from the Welford-var
        or nutpie estimators) becomes A with the low-rank part zeroed at
        the current rank."""
        if isinstance(m_inv, (tuple, list)):
            a, b, d = m_inv
            if d.dim() == b.dim() - 1:
                d = torch.diag_embed(d)
            return RankUpdateEuclideanMetric.create(a, b, d)
        lead = m_inv.shape[:-1]
        return RankUpdateEuclideanMetric.create(
            m_inv, m_inv.new_zeros(lead + (self.dim, self.rank)),
            m_inv.new_zeros(lead + (self.rank, self.rank)))

    def m_inv_matrix(self):
        out = torch.diag_embed(self.a_diag)
        if self.rank > 0:
            out = out + self.b @ self.d @ self.b.mT
        return out

    def per_chain(self, n_chains):
        return RankUpdateEuclideanMetric(*(
            x.expand((n_chains,) + x.shape).contiguous() for x in (
                self.a_diag, self.b, self.d, self.q_full, self.v_upper)))

    def take(self, chains):
        if self.a_diag.dim() == 1:
            return self
        return RankUpdateEuclideanMetric(*(
            x[chains] for x in (self.a_diag, self.b, self.d, self.q_full,
                                self.v_upper)))


def make_metric(kind: str, dim: int, dtype=torch.float32, device=None,
                rank: int = 0) -> Metric:
    """"unit", "diagonal", "dense" or "rank_update" metric of size `dim`
    on `device` (None: CUDA); `rank` (rank_update only) reserves low-rank
    slots for an adapting run (mm_kind "lowrank")."""
    device = resolve_device(device)
    if kind == "unit":
        return UnitEuclideanMetric(size=dim, dtype=dtype, device=device)
    if kind in ("diag", "diagonal"):
        return DiagEuclideanMetric.identity(dim, dtype=dtype, device=device)
    if kind == "dense":
        return DenseEuclideanMetric.identity(dim, dtype=dtype, device=device)
    if kind in ("rank_update", "rankupdate"):
        return RankUpdateEuclideanMetric.identity(dim, dtype=dtype,
                                                  device=device, rank=rank)
    raise ValueError(f"unknown metric kind: {kind!r}")

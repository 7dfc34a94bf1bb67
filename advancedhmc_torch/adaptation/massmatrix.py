"""Online mass-matrix estimators: Welford variance and covariance, the
low-rank covariance, nutpie, the unit no-op, and the store-everything
oracles.

PyTorch counterpart of `advancedhmc_tpu/adaptation/massmatrix.py`, with
Stan's shrinkage estimate n/((n+5)(n-1))·M2 + 1e-3·5/(n+5)·I and n_min=10.
`push_batch` folds a whole (chains, dim) batch into shared moments with the
exact parallel-Welford combine (the cross-chain path); `push` adds one
sample to each chain's own moments (the per-chain path, the JAX package's
vmapped `push`): n is then (C,) and the moments (C, dim) or, for the
covariances, (C, dim, dim).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..metrics import symmetrised
from ..utils import resolve_device

N_MIN_DEFAULT = 10
SHRINKAGE_EPS = 1.0e-3


def _per_n(n, like):
    """`n` in `like`'s dtype, with an axis of 1 for each axis `like` has
    beyond it (per chain if n is (C,))."""
    return n.to(like.dtype).reshape(n.shape + (1,) * (like.dim() - n.dim()))


def _shrunk(n, m2, identity_like):
    """Stan's regularised estimate from n samples' moments `m2`; the
    shrinkage goes on `identity_like` (ones for a variance, I for a
    covariance), not on every entry."""
    nf = _per_n(n, m2)
    return nf / ((nf + 5.0) * (nf - 1.0)) * m2 + SHRINKAGE_EPS * (
        5.0 / (nf + 5.0)) * identity_like


def _init_moments(dim, dtype, device, n_chains, dense):
    """(n, mean, m2) of no samples: shared, or one set per chain."""
    device = resolve_device(device)
    lead = () if n_chains is None else (n_chains,)
    tail = (dim, dim) if dense else (dim,)
    return (torch.zeros(lead, dtype=torch.int32, device=device),
            torch.zeros(lead + (dim,), dtype=dtype, device=device),
            torch.zeros(lead + tail, dtype=dtype, device=device))


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _cov_push(st, x):
    """M2 += (x − μ_new)(x − μ_old)ᵀ, each chain with its row of `x`."""
    n = st.n + 1
    delta = x - st.mean
    mean = st.mean + delta / _per_n(n, x)
    return dataclasses.replace(st, n=n, mean=mean,
                               m2=st.m2 + _outer(x - mean, delta))


def _cov_push_batch(st, xs):
    """Fold a (batch, dim) block into shared covariance moments (the exact
    parallel-Welford combine)."""
    c = xs.shape[0]
    b_mean = xs.mean(0)
    centred = xs - b_mean
    b_m2 = centred.T @ centred
    n0f = st.n.to(xs.dtype)
    nf = n0f + c
    delta = b_mean - st.mean
    return dataclasses.replace(
        st, n=st.n + c, mean=st.mean + delta * (c / nf),
        m2=st.m2 + b_m2 + _outer(delta, delta) * (n0f * c / nf))


def _reset(st):
    """Zero the moments, keep the current estimate."""
    return dataclasses.replace(
        st, n=torch.zeros_like(st.n), mean=torch.zeros_like(st.mean),
        m2=torch.zeros_like(st.m2))


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
        n, mean, m2 = _init_moments(dim, dtype, device, n_chains, False)
        return cls(n=n, mean=mean, m2=m2, var=torch.ones_like(mean),
                   n_min=n_min)

    def push(self, x):
        """Welford single-sample update of each chain's moments with its row
        of `x (C, dim)`."""
        n = self.n + 1
        nf = _per_n(n, x)
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
        est = _shrunk(self.n, self.m2, torch.ones_like(self.m2))
        ok = (self.n >= self.n_min)[..., None]
        return dataclasses.replace(self, var=torch.where(ok, est, self.var))

    def reset(self):
        """Zero the moments, keep the current estimate."""
        return _reset(self)

    @property
    def m_inv(self):
        return self.var


@dataclasses.dataclass(frozen=True)
class WelfordCovState:
    """Dense (covariance) estimator: shared, or per chain with n (C,), the
    means (C, dim) and M2 and the estimate (C, dim, dim)."""

    n: torch.Tensor      # sample count (int32), () or per chain (C,)
    mean: torch.Tensor   # (dim,) or (C, dim)
    m2: torch.Tensor     # (dim, dim) or (C, dim, dim)
    cov: torch.Tensor    # current M⁻¹ estimate, as m2
    n_min: int = N_MIN_DEFAULT

    @classmethod
    def init(cls, dim, dtype=torch.float32, device=None,
             n_min=N_MIN_DEFAULT, n_chains=None):
        """Empty moments on `device` (None means CUDA), shared or per
        chain; the estimate starts at I."""
        n, mean, m2 = _init_moments(dim, dtype, device, n_chains, True)
        eye = torch.eye(dim, dtype=dtype, device=m2.device)
        return cls(n=n, mean=mean, m2=m2,
                   cov=eye.expand_as(m2).contiguous(), n_min=n_min)

    def push(self, x):
        """M2 += (x − μ_new)(x − μ_old)ᵀ for each chain's row of `x`."""
        return _cov_push(self, x)

    def push_batch(self, xs):
        return _cov_push_batch(self, xs)

    def update_estimate(self):
        eye = torch.eye(self.m2.shape[-1], dtype=self.m2.dtype,
                        device=self.m2.device)
        est = _shrunk(self.n, self.m2, eye)
        ok = (self.n >= self.n_min).reshape(self.n.shape + (1, 1))
        return dataclasses.replace(self, cov=torch.where(ok, est, self.cov))

    def reset(self):
        return _reset(self)

    @property
    def m_inv(self):
        return self.cov


@dataclasses.dataclass(frozen=True)
class LowRankCovState:
    """Rank-preserving low-rank + diagonal covariance estimator for the
    `RankUpdateEuclideanMetric` (M⁻¹ = diag(A) + B·D·Bᵀ), shared by the
    chains or per chain (n (C,), each other leaf with a leading chain
    axis). Welford covariance moments, and an estimate step that takes
    the top-k eigenpairs of the diagonally whitened covariance:

        Σ = shrunk(M2);  A = diag(Σ);  S = A^{-1/2} Σ A^{-1/2}
        eigh(S) → (λ, V);  keep the k λ furthest from 1 (|log λ|)
        B = √A · V_k,  D = diag(λ_k − 1)

    with `n_refine` passes refitting A to the diagonal of Σ − B·D·Bᵀ (per
    chain, one batched `eigh` a pass). The estimate is the (a_diag, b, d)
    triple that `RankUpdateEuclideanMetric.renew` takes."""

    n: torch.Tensor        # sample count (int32), () or per chain (C,)
    mean: torch.Tensor     # (dim,) or (C, dim)
    m2: torch.Tensor       # (dim, dim) or (C, dim, dim)
    a_diag: torch.Tensor   # (dim,) current diagonal of M⁻¹, or (C, dim)
    b: torch.Tensor        # (dim, k) or (C, dim, k)
    d: torch.Tensor        # (k,) diagonal of D, or (C, k)
    rank: int = 8
    n_min: int = N_MIN_DEFAULT

    @classmethod
    def init(cls, dim, dtype=torch.float32, device=None,
             n_min=N_MIN_DEFAULT, rank=8, n_chains=None):
        """Empty moments on `device` (None means CUDA), shared or, given
        `n_chains`, one set per chain; the rank is at most `dim`."""
        rank = min(rank, dim)
        n, mean, m2 = _init_moments(dim, dtype, device, n_chains, True)
        lead = mean.shape[:-1]
        return cls(n=n, mean=mean, m2=m2, a_diag=torch.ones_like(mean),
                   b=mean.new_zeros(lead + (dim, rank)),
                   d=mean.new_zeros(lead + (rank,)), rank=rank, n_min=n_min)

    def push(self, x):
        return _cov_push(self, x)

    def push_batch(self, xs):
        return _cov_push_batch(self, xs)

    def update_estimate(self, n_refine: int = 3):
        dim = self.m2.shape[-1]
        eye = torch.eye(dim, dtype=self.m2.dtype, device=self.m2.device)
        sigma = _shrunk(self.n, self.m2, eye)
        # n ∈ {0, 1} gives NaN (inf·0 in the shrinkage factor): masked out
        # by `ok` below, but eigh must still see finite input
        sigma = torch.where(torch.isfinite(sigma), sigma, eye)
        sig_diag = torch.clamp(torch.diagonal(sigma, dim1=-2, dim2=-1),
                               min=1e-10)

        def factor(a):
            inv_sqrt_a = 1.0 / torch.sqrt(a)
            s = inv_sqrt_a[..., :, None] * sigma * inv_sqrt_a[..., None, :]
            lam, v = torch.linalg.eigh(symmetrised(s))
            lam = torch.clamp(lam, min=1e-8)
            score = torch.abs(torch.log(lam))
            idx = torch.argsort(-score, dim=-1, stable=True)[..., :self.rank]
            v_k = torch.gather(v, -1, idx[..., None, :].expand(
                v.shape[:-1] + idx.shape[-1:]))
            return (torch.sqrt(a)[..., :, None] * v_k,
                    torch.gather(lam, -1, idx) - 1.0)

        a = sig_diag
        b_new, d_new = factor(a)
        for _ in range(n_refine):
            low_diag = torch.sum(b_new * b_new * d_new[..., None, :], -1)
            a = torch.clamp(sig_diag - low_diag, min=1e-10)
            b_new, d_new = factor(a)
        ok = _per_n(self.n >= self.n_min, self.a_diag).bool()
        return dataclasses.replace(
            self, a_diag=torch.where(ok, a, self.a_diag),
            b=torch.where(ok[..., None], b_new, self.b),
            d=torch.where(ok, d_new, self.d))

    def reset(self):
        return _reset(self)

    @property
    def m_inv(self):
        """(a_diag, b, d) for `RankUpdateEuclideanMetric.renew`."""
        return (self.a_diag, self.b, self.d)


@dataclasses.dataclass(frozen=True)
class NutpieVarState:
    """Nutpie's estimator: sqrt(var(θ) / var(∇ℓπ)) from paired position
    and gradient Welford-variance states, shared or per chain."""

    position: WelfordVarState
    gradient: WelfordVarState
    var: torch.Tensor      # current M⁻¹ estimate, (dim,) or (C, dim)
    n_min: int = N_MIN_DEFAULT

    @classmethod
    def init(cls, dim, dtype=torch.float32, device=None,
             n_min=N_MIN_DEFAULT, n_chains=None):
        pos = WelfordVarState.init(dim, dtype, device, n_min, n_chains)
        return cls(position=pos,
                   gradient=WelfordVarState.init(dim, dtype, device, n_min,
                                                 n_chains),
                   var=torch.ones_like(pos.mean), n_min=n_min)

    @property
    def n(self):
        return self.position.n

    def push(self, theta, grad):
        """Needs the position and the gradient there."""
        return dataclasses.replace(self, position=self.position.push(theta),
                                   gradient=self.gradient.push(grad))

    def push_batch(self, thetas, grads):
        return dataclasses.replace(
            self, position=self.position.push_batch(thetas),
            gradient=self.gradient.push_batch(grads))

    def update_estimate(self):
        """sqrt(shrunk var θ / shrunk var ∇) where n ≥ n_min."""
        p, g = self.position, self.gradient
        est = torch.sqrt(_shrunk(p.n, p.m2, torch.ones_like(p.m2))
                         / _shrunk(g.n, g.m2, torch.ones_like(g.m2)))
        ok = (self.n >= self.n_min)[..., None]
        return dataclasses.replace(self, var=torch.where(ok, est, self.var))

    def reset(self):
        return dataclasses.replace(self, position=self.position.reset(),
                                   gradient=self.gradient.reset())

    @property
    def m_inv(self):
        return self.var


@dataclasses.dataclass(frozen=True)
class UnitMassMatrixState:
    """No-op estimator, M⁻¹ = I."""

    dim: int

    @classmethod
    def init(cls, dim, dtype=torch.float32, device=None,
             n_min=N_MIN_DEFAULT, n_chains=None):
        return cls(dim=dim)

    def push(self, *args):
        return self

    def push_batch(self, *args):
        return self

    def update_estimate(self):
        return self

    def reset(self):
        return self

    @property
    def m_inv(self):
        return None


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class NaiveVar:
    """Store-everything variance estimator, on the host in numpy: the
    tests' ground truth for `WelfordVarState`."""

    def __init__(self):
        self.samples = []

    def push(self, x):
        self.samples.append(_host(x))

    def reset(self):
        self.samples = []

    @property
    def estimate(self):
        assert len(self.samples) >= 2, "need at least two samples"
        return np.var(np.stack(self.samples), axis=0, ddof=1)


class NaiveCov:
    """Store-everything covariance estimator (the tests' ground truth for
    `WelfordCovState`)."""

    def __init__(self):
        self.samples = []

    def push(self, x):
        self.samples.append(_host(x))

    def reset(self):
        self.samples = []

    @property
    def estimate(self):
        assert len(self.samples) >= 2, "need at least two samples"
        return np.cov(np.stack(self.samples), rowvar=False, ddof=1)

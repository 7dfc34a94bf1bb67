"""Relativistic momentum sampling (counterpart of
`advancedhmc_tpu/riemannian/relativistic.py`).

The magnitude u = |w| of the whitened momentum has the density
∝ u^{D-1} exp(-mc²√(u²/(m²c²)+1)), which depends only on (m, c, dim): it
is drawn by inverting a table of its CDF built once on the host (a copy of
the JAX package's table, built the same way with numpy), and the direction
is uniform on the sphere. Per chain one uniform and one row of D normals
are drawn, in that order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..hamiltonian import mass_inv_diag
from ..kinetic import RelativisticKinetic
from ..metrics import Metric
from ..utils import rand_normal, rand_uniform


@lru_cache(maxsize=None)
def magnitude_table(m: float, c: float, dim: int, n_grid: int = 4096):
    """(u grid, CDF) in float64 numpy: the inverse-CDF table of u = |w|,
    pdf(u) ∝ u^{D-1} exp(-mc²√(u²/(m²c²)+1))."""
    def log_pdf(u):
        with np.errstate(divide="ignore"):
            return (dim - 1) * np.log(u) - m * c**2 * np.sqrt(
                u**2 / (m**2 * c**2) + 1.0
            )

    # bracket: mode is O(sqrt(dim)·max(1, 1/(mc))); expand until 60-nat drop
    u_hi = max(10.0, 10.0 * np.sqrt(dim) * max(1.0, 1.0 / (m * c)))
    peak = np.max(log_pdf(np.linspace(1e-6, u_hi, 512)))
    while log_pdf(u_hi) > peak - 60.0:
        u_hi *= 2.0
    u = np.linspace(0.0, u_hi, n_grid)
    lp = log_pdf(np.maximum(u, 1e-12))
    p = np.exp(lp - lp.max())
    p[0] = 0.0
    cdf = np.cumsum((p[1:] + p[:-1]) * 0.5)
    cdf = np.concatenate([[0.0], cdf])
    cdf /= cdf[-1]
    return u, cdf


def interp(x, xp, fp):
    """`jnp.interp(x, xp, fp)` with its defaults (ends held constant) on
    tensors: the right-sided search, the segment's lerp, and the
    previous point where a segment is shorter than the spacing of the
    dtype's epsilon."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(
        np.dtype(str(xp.dtype).removeprefix("torch."))).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def momentum_from_draws(kinetic: RelativisticKinetic, metric: Metric, p, n):
    """The momenta (C, dim) of the uniforms `p (C,)` and the normals
    `n (C, dim)`: u = interp(p, cdf, u grid), w = u·n/|n|, r = w (unit
    metric) or w / sqrt(M⁻¹) (diagonal, shared or per chain), computed in
    the dtype of `n`."""
    m_inv = mass_inv_diag(metric)
    u_grid, cdf = magnitude_table(float(kinetic.m), float(kinetic.c),
                                  n.shape[-1])
    u_grid = torch.as_tensor(u_grid, dtype=n.dtype, device=n.device)
    cdf = torch.as_tensor(cdf, dtype=n.dtype, device=n.device)
    u = interp(p, cdf, u_grid)
    w = u[:, None] * n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    # rᵀM⁻¹r = |w|² ⇒ r = w / sqrt(M⁻¹)
    return w if m_inv is None else w / metric.sqrt_m_inv


def rand_momentum_relativistic(kinetic: RelativisticKinetic, metric: Metric,
                               generator, n_chains):
    """Momenta (n_chains, dim) of the relativistic kinetic energy on a unit
    or diagonal metric, in the metric's dtype on its device."""
    mass_inv_diag(metric)        # raises for any other metric
    p = rand_uniform(generator, (n_chains,), metric.dtype, metric.device)
    n = rand_normal(generator, (n_chains, metric.dim), metric.dtype,
                    metric.device)
    return momentum_from_draws(kinetic, metric, p, n)

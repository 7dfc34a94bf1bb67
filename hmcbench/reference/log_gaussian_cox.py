"""Plain float64 reference of the log-Gaussian Cox process on a grid.

    f = μ·1 + σ·L₀·z,   z ~ N(0, I_N),   L₀L₀ᵀ = C₀,
    C₀(i, j) = exp(−δ(i, j) / (side·β)),   y_i ~ Poisson(m·exp(f_i)),

over side × side cells of the unit square (N = side², m = 1/N, δ the
distance between cells in grid units), with β = 1/33, σ² = 1.91 and μ =
log 126 − σ²/2 (Girolami & Calderhead 2011, §8), log σ ~ N(0, 1) sampled
too. θ = (log σ, z₁..z_N) and, with η = σ·L₀·z and c = μ + log m,

    ℓ(θ) = −½(log σ)² − ½|z|² + Σ_i y_i·η_i − exp(c + η_i),

the constant terms (y_i·c, log y_i!) left out, as the program leaves them
out; a comparison of values rests on that convention. The data come from
this file's own copy of the generator that the program documents (C₀ and
its Cholesky factor in float64 on the device, z from
`numpy.random.default_rng(data_seed)`, then the counts from the same
generator), so that the reference takes nothing that the program made.
Plain torch in float64; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SIGMA2 = 1.91
BETA = 1.0 / 33.0
MU = math.log(126.0) - SIGMA2 / 2.0


def grid_factor(side: int, device) -> torch.Tensor:
    """The Cholesky factor L₀ (N, N) of C₀, float64 on `device` (cells
    numbered row by row)."""
    idx = torch.arange(side * side, device=device)
    row = (idx // side).to(torch.float64)
    col = (idx % side).to(torch.float64)
    dr = row[:, None] - row[None, :]
    dc = col[:, None] - col[None, :]
    cov = torch.exp(-torch.sqrt(dr * dr + dc * dc) / (side * BETA))
    del dr, dc
    return torch.linalg.cholesky(cov)


def synthetic_data(side: int, seed: int, device):
    """(L₀ float64 on `device`, counts (N,) float64 numpy)."""
    l0 = grid_factor(side, device)
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.normal(size=side * side), device=device)
    f = MU + math.sqrt(SIGMA2) * (l0 @ z).cpu().numpy()
    y = rng.poisson(np.exp(f) / (side * side)).astype(np.float64)
    return l0, y


class Reference:
    """The configuration's log density and gradient in float64 on `device`,
    taken in blocks of `block` rows of θ so that large batches fit."""

    def __init__(self, cfg: dict, device, block: int = 4096):
        side = math.isqrt(cfg["n_rows"])
        if side * side != cfg["n_rows"] or cfg["n_features"] != cfg["n_rows"]:
            raise ValueError("the grid's cells are the rows and the features")
        self.l0, y = synthetic_data(side, cfg["data_seed"], device)
        self.y = torch.as_tensor(y, dtype=torch.float64, device=device)
        self.c = MU - math.log(side * side)
        self.block = block

    def _value_and_grad(self, theta):
        theta = theta.to(device=self.l0.device, dtype=torch.float64)
        ls, z = theta[:, 0], theta[:, 1:]
        s = torch.exp(ls)
        eta = s[:, None] * (z @ self.l0.T)
        rate = torch.exp(self.c + eta)
        lp = (-0.5 * ls * ls - 0.5 * torch.sum(z * z, -1)
              + torch.sum(self.y * eta - rate, -1))
        r = self.y - rate
        g_ls = -ls + torch.sum(r * eta, -1)
        g_z = s[:, None] * (r @ self.l0) - z
        return lp, torch.cat([g_ls[:, None], g_z], 1)

    def value_and_grad(self, theta):
        """(lp (C,), grad (C, N + 1)) in float64 for θ (C, N + 1)."""
        lps, grads = [], []
        for lo in range(0, theta.shape[0], self.block):
            lp, g = self._value_and_grad(theta[lo:lo + self.block])
            lps.append(lp)
            grads.append(g)
        return torch.cat(lps), torch.cat(grads)

"""The log-Gaussian Cox process on a square grid, the standard hard target of
the HMC literature (Møller, Syversveen & Waagepetersen 1998), in the
setting of Girolami & Calderhead 2011 (arXiv:0907.1100, §8): the unit
square cut into side × side cells, N = side² of them, each of area
m = 1/N, a latent Gaussian field f over the cells' centres and the counts
of points in each cell,

    f = μ·1 + σ·L₀·z,   z ~ N(0, I_N),   L₀L₀ᵀ = C₀,
    C₀(i, j) = exp(−δ(i, j) / (side·β)),   y_i ~ Poisson(m·exp(f_i)),

δ the distance between cells in grid units, β = 1/33, σ² = 1.91, μ =
log 126 − σ²/2. The data are simulated from the model at these values
from `seed`, as Girolami & Calderhead simulate theirs. Beyond their
setting, where σ is fixed, log σ is sampled too, under log σ ~ N(0, 1):

    θ = (log σ, z),   dim = N + 1,
    ℓ(θ) = −½(log σ)² − ½|z|² + Σ_i y_i·η_i − exp(c + η_i),   η = σ·L₀·z,

with c = μ + log m and the constant terms (y_i·c, log y_i!) left out. That
is the non-centred hierarchy of `hierarchical_logistic_nc` term for term,
over the "design" L₀ (N × N, lower-triangular) with the Poisson-log link
and offset c in place of the Bernoulli-logit, so the value+grad is
`noncentred_target`'s: on the card one call of K1 (its wide path above
N = 128) with the Poisson link, then the non-centred chain rule.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.fused_logistic import mode_of
from ..target import LogDensityTarget
from ..utils import reduced_dtype, resolve_device, round_to
from .logistic import noncentred_target

SIGMA2 = 1.91                        # σ² of the simulation (G & C §8)
BETA = 1.0 / 33.0                    # the covariance's length scale
MU = math.log(126.0) - SIGMA2 / 2.0  # the field's mean


def lgcp_factor(side: int, device) -> torch.Tensor:
    """L₀ (N, N) float64 on `device`: the Cholesky factor of C₀ over the
    side × side grid (cells numbered row by row), without jitter."""
    idx = torch.arange(side * side, device=device)
    row = (idx // side).to(torch.float64)
    col = (idx % side).to(torch.float64)
    dr = row[:, None] - row[None, :]
    dc = col[:, None] - col[None, :]
    cov = torch.exp(-torch.sqrt(dr * dr + dc * dc) / (side * BETA))
    del dr, dc
    return torch.linalg.cholesky(cov)


def lgcp_data(side: int, seed: int, device):
    """(L₀ (N, N) float64 on `device`, counts (N,) float64 numpy): the
    field's z from `numpy.random.default_rng(seed)`, then the counts from
    the same generator."""
    l0 = lgcp_factor(side, device)
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.normal(size=side * side), device=device)
    f = MU + math.sqrt(SIGMA2) * (l0 @ z).cpu().numpy()
    y = rng.poisson(np.exp(f) / (side * side)).astype(np.float64)
    return l0, y


def log_gaussian_cox(side: int = 64, seed: int = 0, x_dtype=None,
                     dtype=torch.float32, device=None) -> LogDensityTarget:
    """The log-Gaussian Cox process on a `side` × `side` grid on `device`
    (None means CUDA), dim side² + 1. C₀ and L₀ are made once per target in
    float64 on `device` (the card's Cholesky where it is CUDA) and L₀ kept
    in `dtype`; `x_dtype="bfloat16"` (or "float16") stores L₀ rounded to
    that dtype from float64, as the logistic's switch rounds its design, and
    runs K1 in the matching mode on the card."""
    xd = reduced_dtype(x_dtype, "x_dtype")
    device = resolve_device(device)
    l0, y_np = lgcp_data(side, seed, device)
    x = round_to(l0, xd).to(dtype).contiguous()
    del l0
    y = torch.as_tensor(y_np, dtype=dtype, device=device)
    offset = MU - math.log(side * side)     # c = μ + log m
    return noncentred_target(x, y, mode_of(xd, None), link="poisson",
                             offset=offset)

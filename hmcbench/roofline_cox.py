"""The work of the log-Gaussian Cox process's value+grad (K1 with the
Poisson link over the grid's triangular factor L₀).

What the model needs, whatever implements it: one call at C chains over N
cells takes the two products η = σ·L₀·z and L₀ᵀ·r over the factor's
N(N + 1)/2 entries on and below the diagonal, 2·C·N(N + 1) FLOPs in all
(a kernel that also multiplies the zeros above the diagonal, or runs
3xTF32's three products, does more than this work), and reads those
entries, y (float32) and θ once and writes ℓ and ∇ once. Peaks and
bandwidth are `roofline.py`'s.
"""

from __future__ import annotations

from hmcbench.roofline import PEAK_BYTES_PER_S, PEAK_FLOPS

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def value_grad_flops(chains: int, cells: int) -> float:
    """FLOPs of one value+grad call: the two triangular products."""
    return 2.0 * chains * cells * (cells + 1)


def value_grad_bytes(chains: int, cells: int,
                     design_dtype: str = "float32") -> float:
    """Bytes of one value+grad call: the factor's triangle, y (float32)
    and θ read once, ℓ and ∇ (float32) written once."""
    dim = cells + 1
    return (cells * (cells + 1) // 2 * _ITEMSIZE[design_dtype] + 4 * cells
            + 4 * chains * dim              # θ in
            + 4 * chains * dim + 4 * chains)   # ∇ and ℓ out


def least_time_s(chains: int, cells: int,
                 design_dtype: str = "float32") -> float:
    """The least time one call could take on the card: the larger of its
    FLOPs over the peak and its bytes over the bandwidth."""
    return max(value_grad_flops(chains, cells) / PEAK_FLOPS[design_dtype],
               value_grad_bytes(chains, cells, design_dtype)
               / PEAK_BYTES_PER_S)

"""Peaks of the card and the work of the logistic value+grad (K1).

The work is what the model needs, whatever implements it: one call of the
likelihood's value+grad at C chains over a design of N rows and p features
takes the two products logits = β·xᵀ and ∇β = r·x, 2·C·N·p FLOPs each, and
reads the design, y and θ once and writes ℓ and ∇ once. A kernel that runs
more passes (3xTF32's three products) does more than this work, and one
that runs fewer does not earn a share above 100 %.

Peaks are NVIDIA's published dense rates of one H100 SXM at 700 W: for a
float32 design TF32 on the tensor cores (the fastest rate at which float32
inputs can enter a product), for a 2-byte design bf16/fp16; HBM3 at
3.35 TB/s. The card's power limit is printed beside every reading.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def value_grad_flops(chains: int, rows: int, features: int) -> float:
    """FLOPs of one value+grad call: the two products."""
    return 4.0 * chains * rows * features


def value_grad_bytes(chains: int, rows: int, features: int,
                     design_dtype: str = "float32") -> float:
    """Bytes of one value+grad call: the design, y (float32) and θ read
    once, ℓ and ∇ (float32) written once."""
    dim = features + 1
    return (rows * features * _ITEMSIZE[design_dtype] + 4 * rows
            + 4 * chains * dim            # θ in
            + 4 * chains * dim + 4 * chains)   # ∇ and ℓ out


def least_time_s(chains: int, rows: int, features: int,
                 design_dtype: str = "float32") -> float:
    """The least time one call could take on the card: the larger of its
    FLOPs over the peak and its bytes over the bandwidth."""
    return max(value_grad_flops(chains, rows, features)
               / PEAK_FLOPS[design_dtype],
               value_grad_bytes(chains, rows, features, design_dtype)
               / PEAK_BYTES_PER_S)

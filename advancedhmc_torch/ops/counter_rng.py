"""The splitmix32 counter stream of the NUTS megakernel (K2).

PyTorch counterpart of `advancedhmc_tpu/ops/fused_nuts_kernel.py:40-102`
(`_round_up`, `_splitmix32`, `_bits`, `_uniform`, `_normal`,
`_exponential`; `_tz` and `_t_ones` are `utils.trailing_zeros` and
`utils.trailing_ones`). torch has no uint32, so the 32-bit words live in int64
tensors masked to 32 bits (as `utils._popcount32` does); products are formed
in two 16-bit halves so that no int64 product overflows. Bits and uniforms
are bit-equal to the JAX functions; normals and exponentials differ only by
the float32 rounding of `log`/`cos` in the two libraries.

A draw is a pure function of (counter, index, salt): `bits_at` takes the
index explicitly, so the batched plain megakernel can give every chain its
own counter and its own row of a chain block; `_bits` & co. take a (rows,
cols) shape as the JAX functions do and use the row-major lane index.
"""

from __future__ import annotations

import math

import torch

_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_TWO_PI = 2.0 * math.pi


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _mul32(x, c: int):
    """(x · c) mod 2³² for int64 tensors holding uint32 values."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _u32(x):
    """An int tensor or Python int as uint32 bits in int64 (int32 wraps)."""
    return torch.as_tensor(x, dtype=torch.int64) & _U32


def _splitmix32(x):
    """Counter-based 32-bit mixer (splitmix32)."""
    x = (_u32(x) + _GOLDEN) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x735A2D97)
    x = x ^ (x >> 15)
    return x


def rng_base(seed: int, block):
    """`seed·7919 + block·104729` in wrapping int32 arithmetic, as uint32
    bits: the counter offset of a chain block (fused_nuts_kernel.py:122)."""
    return (_mul32(_u32(seed), 7919) + _mul32(_u32(block), 104729)) & _U32


def bits_at(ctr, idx, salt: int):
    """Random uint32s (in int64) at lane indices `idx` for counter `ctr`."""
    idx = _u32(idx)
    base = (_mul32(_u32(ctr), 2654435761) + _mul32(_u32(salt), 40503)) & _U32
    return _splitmix32(_splitmix32((idx + base) & _U32)
                       ^ _mul32(idx, _GOLDEN))


def uniform_at(ctr, idx, salt: int):
    """U(0, 1] in float32 from the 24 high bits: (u24 + 1) / 2²⁴."""
    u24 = bits_at(ctr, idx, salt) >> 8
    return (u24.to(torch.float32) + 1.0) * (1.0 / 16777216.0)


def normal_at(ctr, idx, salt: int):
    """Standard normals by Box-Muller from salts `salt` and `salt + 101`."""
    u1 = uniform_at(ctr, idx, salt)
    u2 = uniform_at(ctr, idx, salt + 101)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI * u2)


def exponential_at(ctr, idx, salt: int):
    return -torch.log(uniform_at(ctr, idx, salt))


def _lane_index(shape):
    rows, cols = shape
    return (torch.arange(rows, dtype=torch.int64)[:, None] * cols
            + torch.arange(cols, dtype=torch.int64)[None, :])


def _bits(ctr, shape, salt):
    return bits_at(ctr, _lane_index(shape), salt)


def _uniform(ctr, shape, salt):
    return uniform_at(ctr, _lane_index(shape), salt)


def _normal(ctr, shape, salt):
    return normal_at(ctr, _lane_index(shape), salt)


def _exponential(ctr, shape, salt):
    return exponential_at(ctr, _lane_index(shape), salt)


"""Small numeric / random helpers shared across the port.

PyTorch counterpart of `advancedhmc_tpu/utils.py`. Every helper works on a
leading chain axis; randomness comes from an explicit `torch.Generator`
(which lives on the device the draws are made on) instead of JAX keys.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means CUDA.

    There is no silent CPU fallback: without CUDA the caller must ask for
    the CPU explicitly (`device="cpu"`), as the tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# Where ROADMAP.md queues each part the port lacks: (section, item, title).
# The one place in the package that knows the roadmap's numbering; a test
# holds every entry to ROADMAP.md.
ROADMAP_ITEMS = {
    "options": (1, 1, "The other options of JAX `sample`"),
    "surface": (1, 2, "The rest of the surface"),
}


def roadmap(key):
    """Where ROADMAP.md queues the part `key`, as the end of a message."""
    section, item, title = ROADMAP_ITEMS[key]
    return f"(ROADMAP.md section {section}, item {item}: {title})"


def not_ported(what, options):
    """Raise for options of the JAX function `what` that the port lacks:
    `mesh` (multi-GPU, with the rest of the surface) and the other options
    each have their item."""
    if options:
        key = "surface" if "mesh" in options else "options"
        raise NotImplementedError(
            f"{what} options {sorted(options)} are not ported yet "
            + roadmap(key))


def reduced_dtype(dtype, what):
    """The torch dtype of a reduced-precision switch (`x_dtype`,
    `resid_dtype`, `stack_dtype`): None, or bfloat16 given as
    "bfloat16"/"bf16" or `torch.bfloat16` (the dtype the JAX bench and
    tests use). Any other dtype raises, naming its ROADMAP.md item."""
    if dtype is None:
        return None
    if dtype is torch.bfloat16 or str(dtype).lower() in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise NotImplementedError(
        f"{what}={dtype!r}: only bfloat16 is ported as a reduced dtype "
        + roadmap("options"))


def round_to(x, dtype):
    """`x` rounded to `dtype` (None: unchanged) and back to its own dtype."""
    return x if dtype is None else x.to(dtype).to(x.dtype)


def logaddexp(a, b):
    """Numerically stable log(exp(a) + exp(b)) that tolerates -inf inputs."""
    return torch.logaddexp(a, b)


def rand_exponential(generator, shape, dtype, device):
    """Exp(1) variates (MH-in-log-space accepts)."""
    return torch.empty(shape, dtype=dtype, device=device).exponential_(
        generator=generator)


def rand_sign(generator, shape, device):
    """+1/-1 with equal probability (NUTS doubling direction), int32."""
    bit = torch.randint(0, 2, shape, generator=generator, device=device,
                        dtype=torch.int32)
    return 2 * bit - 1


def maxabs(a, b):
    """Elementwise, the argument with the larger absolute value."""
    return torch.where(a.abs() > b.abs(), a, b)


def _popcount32(u):
    """Set bits of each value of an int64 tensor holding uint32 values.

    torch has no popcount, so this is the SWAR bit count; it runs in int64 so
    that the shifts of values with bit 31 set stay logical.
    """
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return (((u * 0x01010101) & _U32) >> 24).to(torch.int32)


def _trailing_zeros_u32(u):
    low = u & ((-u) & _U32)                 # lowest set bit (0 for u == 0)
    return _popcount32((low - 1) & _U32)    # 32 for u == 0, as uint32 wraps


def trailing_ones(i):
    """Number of trailing one-bits of each non-negative int32 value."""
    u = i.to(torch.int64) & _U32
    return _trailing_zeros_u32((~u) & _U32)


def trailing_zeros(i):
    """Number of trailing zero-bits of each int32 value; 32 for 0."""
    return _trailing_zeros_u32(i.to(torch.int64) & _U32)


def clamp_nonfinite(x, replacement=float("-inf")):
    """Replace non-finite entries with `replacement` (the PhasePoint -Inf
    clamp: non-finite log densities auto-reject downstream)."""
    return torch.where(torch.isfinite(x), x,
                       torch.full_like(x, replacement))

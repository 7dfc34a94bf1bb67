"""Small numeric / random helpers shared across the port.

PyTorch counterpart of `advancedhmc_tpu/utils.py`. Every helper works on a
leading chain axis; randomness comes from an explicit `torch.Generator`
(which lives on the device the draws are made on) instead of JAX keys.

The chain shard. Under `sample(mesh=...)` each process holds a contiguous
block of the chains (`parallel.mesh`), and `chain_shard` makes that block
known here, to the one chokepoint of per-chain random draws and to the
collectives that make the loop's exits and the cross-chain reductions
global. Every per-chain variate (`rand_uniform`, `rand_normal`,
`rand_exponential`, `rand_sign`: a shape that leads with the chain axis)
is drawn at the global shape (C_global, ...) from a generator that every
rank holds in the same state, and the rank keeps its own rows: each
chain's stream is then bit for bit the one of the unsharded run, at the
price of W× the random numbers a rank draws. The collectives
(`gather_chains`, `all_chains`, `any_chain`, `max_chains`) gather or
reduce over the shard's process group; under gloo a CUDA tensor is copied
through host memory first (`_wire`, the one place that does it), since
gloo lacks some collectives on CUDA tensors. Without a shard every helper
is the plain single-process operation.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib

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


# the reduced dtypes of the precision switches, by the names they take
_REDUCED = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float16": torch.float16, "f16": torch.float16,
            "half": torch.float16}


def as_dtype(dtype):
    """A torch dtype given as one or by name ("bfloat16", "bf16",
    "float16", "float32", ...); None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).lower()
    found = _REDUCED.get(name, getattr(torch, name, None))
    if not isinstance(found, torch.dtype):
        raise ValueError(f"not a dtype: {dtype!r}")
    return found


def reduced_dtype(dtype, what):
    """The torch dtype of a reduced-precision switch (`x_dtype`,
    `resid_dtype`, `stack_dtype`): None, or bfloat16 or float16, given by
    name or as the torch dtype."""
    found = as_dtype(dtype)
    if found not in (None, torch.bfloat16, torch.float16):
        raise ValueError(f"{what}={dtype!r}: a reduced dtype is bfloat16 or "
                         "float16")
    return found


def round_to(x, dtype):
    """`x` rounded to `dtype` (None: unchanged) and back to its own dtype.
    A float64 `x` goes to float16 in one rounding, as numpy's and XLA's
    casts take it: torch's own cast goes through float32 and can round
    twice, so the float32 value is rounded to odd first (toward zero, its
    last bit set where the cast was inexact), which a second rounding to
    float16, 13 bits shorter, leaves correct."""
    if dtype is None:
        return x
    if dtype == torch.float16 and x.dtype == torch.float64:
        f = x.to(torch.float32)
        back = f.to(torch.float64)
        bits = f.view(torch.int32)
        bits = torch.where(back.abs() > x.abs(), bits - 1, bits) | (
            back != x).to(torch.int32)
        return bits.view(torch.float32).to(dtype).to(x.dtype)
    return x.to(dtype).to(x.dtype)


def logaddexp(a, b):
    """Numerically stable log(exp(a) + exp(b)) that tolerates -inf inputs."""
    return torch.logaddexp(a, b)


@dataclasses.dataclass(frozen=True)
class ChainShard:
    """This process's block of the chain batch: rank `rank` of `world`
    holds chains [rank·C/W, (rank+1)·C/W) of every chain-major tensor;
    `group` is the process group, `device` where its collectives'
    tensors live (the GPU under NCCL, the host under gloo)."""

    rank: int
    world: int
    group: object
    device: torch.device


_SHARD = contextvars.ContextVar("chain_shard", default=None)


@contextlib.contextmanager
def chain_shard(shard):
    """Run the block with `shard` (a `ChainShard`, or None: unsharded) as
    the current chain shard (of this thread or task)."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


def current_shard():
    return _SHARD.get()


def local_chains(n_chains):
    """How many of `n_chains` (the whole batch) this rank holds; they must
    divide evenly over the ranks."""
    sh = _SHARD.get()
    if sh is None:
        return n_chains
    if n_chains % sh.world:
        raise ValueError(f"the chain count {n_chains} must divide evenly "
                         f"over the mesh's {sh.world} processes")
    return n_chains // sh.world


def chain_index(n_chains, device=None):
    """The indices, in the whole batch of `n_chains`, of this rank's
    chains (all of them without a shard)."""
    c, sh = local_chains(n_chains), _SHARD.get()
    lo = 0 if sh is None else sh.rank * c
    return torch.arange(lo, lo + c, device=device)


def chain_block(x):
    """This rank's rows of `x`, a tensor whose leading axis is the whole
    chain batch (`x` itself without a shard)."""
    c, sh = local_chains(x.shape[0]), _SHARD.get()
    return x if sh is None else x[sh.rank * c:(sh.rank + 1) * c]


def _draw_chains(draw, shape, chains=True):
    """`draw(shape)` where `shape` leads with the chain axis: under a shard,
    drawn at the global shape and this rank's rows kept (see the module
    docstring). A 0-d shape, or `chains=False`, is a draw every rank makes
    alike (a coupled direction table, a replicated search)."""
    shape = tuple(shape)
    sh = _SHARD.get()
    if sh is None or not chains or not shape:
        return draw(shape)
    c = shape[0]
    return draw((c * sh.world,) + shape[1:])[sh.rank * c:(sh.rank + 1) * c]


def rand_uniform(generator, shape, dtype, device):
    """U[0, 1) variates, one row a chain."""
    return _draw_chains(lambda s: torch.rand(
        s, generator=generator, dtype=dtype, device=device), shape)


def rand_normal(generator, shape, dtype, device):
    """Standard normal variates, one row a chain."""
    return _draw_chains(lambda s: torch.randn(
        s, generator=generator, dtype=dtype, device=device), shape)


def rand_exponential(generator, shape, dtype, device):
    """Exp(1) variates (MH-in-log-space accepts), one row a chain."""
    return _draw_chains(lambda s: torch.empty(
        s, dtype=dtype, device=device).exponential_(generator=generator),
        shape)


def rand_sign(generator, shape, device, chains=True):
    """+1/-1 with equal probability (NUTS doubling direction), int32: one a
    chain, or with `chains=False` a table every chain shares."""
    bit = _draw_chains(lambda s: torch.randint(
        0, 2, s, generator=generator, device=device, dtype=torch.int32),
        shape, chains)
    return 2 * bit - 1


def _wire(sh, x):
    """`x` as a collective of the shard's group takes it: contiguous,
    booleans as uint8, on the group's device. That device is the host
    under gloo, so this is the one place where a CUDA tensor is copied
    through host memory for gloo, which lacks some collectives on CUDA
    tensors; the result goes back to `x`'s device."""
    y = x.to(torch.uint8) if x.dtype == torch.bool else x
    return y.to(sh.device).contiguous()


def gather_chains(x, dim=0):
    """`x` with its chain axis `dim` gathered from every rank, in rank
    order (the whole batch); `x` itself without a shard. The result is
    laid out in memory as `x` is (a transposed view stays one), so that a
    reduction over it sums in the unsharded run's order."""
    sh = _SHARD.get()
    if sh is None:
        return x
    import torch.distributed as dist

    order = sorted(range(x.dim()), key=lambda i: -x.stride(i))
    src = _wire(sh, x.permute(order))
    parts = [torch.empty_like(src) for _ in range(sh.world)]
    dist.all_gather(parts, src, group=sh.group)
    out = torch.cat(parts, order.index(dim)).to(device=x.device,
                                                 dtype=x.dtype)
    return out.permute([order.index(i) for i in range(x.dim())])


def _all_reduce(x, op):
    """`x` (a small tensor) reduced over the ranks with the reduction `op`
    ("MIN", "MAX"); `x` itself without a shard."""
    sh = _SHARD.get()
    if sh is None:
        return x
    import torch.distributed as dist

    y = _wire(sh, x)
    dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=sh.group)
    return y.to(device=x.device, dtype=x.dtype)


def all_chains_t(flag):
    """Whether `flag` holds for every chain of every rank, as a 0-d device
    bool tensor (no host read)."""
    if _SHARD.get() is None:
        return flag.all()
    return _all_reduce(flag.all().to(torch.int32), "MIN").bool()


def all_chains(flag) -> bool:
    """Whether `flag` holds for every chain of every rank (a host read)."""
    return bool(all_chains_t(flag))


def any_chain(flag) -> bool:
    """Whether `flag` holds for some chain of any rank (a host read)."""
    return not all_chains(~flag)


def max_chains(x):
    """The largest entry of `x` over every rank's chains, a 0-d tensor."""
    return _all_reduce(x.max(), "MAX")


def first_chain(x):
    """Row 0 of the whole chain batch of `x` (the first rank's first
    row), on every rank."""
    return gather_chains(x[:1])[0]


def check_generators(generator):
    """Raise unless every rank's generator is in the same state: the
    sharded draws are the unsharded run's only if each rank draws the same
    stream. A hash of the state is gathered; nothing without a shard."""
    sh = _SHARD.get()
    if sh is None:
        return
    digest = hashlib.sha256(generator.get_state().cpu().numpy().tobytes())
    h = torch.tensor([int.from_bytes(digest.digest()[:7], "little")],
                     dtype=torch.int64, device=sh.device)
    hs = gather_chains(h)
    if bool((hs != hs[0]).any()):
        raise ValueError(
            "the ranks' generators differ: every rank of a mesh must pass a "
            "generator in the same state (the same seed), as JAX passes the "
            f"same key; state hashes by rank {hs.tolist()}")


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

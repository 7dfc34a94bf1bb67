"""Target density interface.

PyTorch counterpart of `advancedhmc_tpu/target.py`. The port's native form is
BATCHED: `logdensity(theta (C, dim)) -> (C,)` and
`logdensity_and_grad(theta (C, dim)) -> ((C,), (C, dim))`, where the JAX
package writes a single-chain function and batches it with `vmap`. The
default gradient comes from `torch.autograd`. `target_from_pytree` takes a
log density over nested dicts, lists and tuples of tensors, raveled in
`jax.tree_util`'s order (`ravel_pytree`).
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Optional

import torch


def _autograd_value_and_grad(logdensity):
    def value_and_grad(theta):
        with torch.enable_grad():
            t = theta.detach().requires_grad_(True)
            lp = logdensity(t)
            (grad,) = torch.autograd.grad(lp.sum(), t)
        return lp.detach(), grad

    return value_and_grad


@dataclasses.dataclass(frozen=True, eq=False)
class LogDensityTarget:
    """A differentiable unnormalized log density on R^dim, batched over chains.

    Fields
    ------
    logdensity:
        `theta (C, dim) -> (C,)` log density.
    dim:
        Number of parameters.
    logdensity_and_grad:
        Optional `theta (C, dim) -> ((C,), (C, dim))`; defaults to the
        autograd gradient of `logdensity`.
    """

    logdensity: Callable
    dim: int
    logdensity_and_grad: Optional[Callable] = None

    def __post_init__(self):
        if self.logdensity_and_grad is None:
            object.__setattr__(self, "logdensity_and_grad",
                               _autograd_value_and_grad(self.logdensity))


@dataclasses.dataclass(frozen=True, eq=False)
class BlockTarget:
    """A value+grad over a zero-padded block of chains, the form the NUTS
    megakernel takes (the JAX package's `value_and_grad_block`).

    Fields
    ------
    kind:
        Names the version of the same function compiled into the CUDA
        kernel: "logistic" or "gaussian".
    value_and_grad:
        `(theta (B, Dp), *data) -> ((B, 1) logp, (B, Dp) grad)`, the plain
        PyTorch version, with the target's data passed at each call.
    p:
        The logistic's feature count (θ = (log σ, β₁..β_p)); 0 otherwise.
    """

    kind: str
    value_and_grad: Callable
    p: int = 0

    def __call__(self, theta, *data):
        return self.value_and_grad(theta, *data)


def _children(tree):
    """(names, kids, make) of a node in `jax.tree_util`'s order: a dict's
    values by sorted key (an OrderedDict's in insertion order), a list's,
    tuple's or namedtuple's in turn, named by key, field or position;
    `make(kids)` builds the node anew. None for a leaf."""
    if isinstance(tree, dict):
        keys = (list(tree) if isinstance(tree, collections.OrderedDict)
                else sorted(tree))
        return ([str(k) for k in keys], [tree[k] for k in keys],
                lambda vals: type(tree)(zip(keys, vals)))
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)     # a namedtuple
        return ([str(n) for n in fields or range(len(tree))], list(tree),
                (lambda vals: type(tree)(*vals)) if fields
                else (lambda vals: type(tree)(vals)))
    return None


def _flatten(tree):
    """(leaves, rebuild) of nested dicts, lists, tuples and namedtuples in
    `_children`' order, None without leaves, anything else a leaf;
    `rebuild(leaves)` gives the tree back with new leaves."""
    if tree is None:
        return [], lambda leaves: None
    node = _children(tree)
    if node is None:
        return [tree], lambda leaves: leaves[0]
    kids = [_flatten(v) for v in node[1]]

    def rebuild(leaves):
        out, off = [], 0
        for kid_leaves, rebuild_kid in kids:
            out.append(rebuild_kid(leaves[off:off + len(kid_leaves)]))
            off += len(kid_leaves)
        return node[2](out)

    return [leaf for kid in kids for leaf in kid[0]], rebuild


def leaves_with_names(tree, prefix=()):
    """[(name, leaf)] in `_flatten`'s order, each name the leaf's path
    joined with "." (the JAX package's names of a pytree's leaves; "" for
    a bare leaf)."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [(".".join(prefix), tree)]
    return [pair for name, kid in zip(node[0], node[1])
            for pair in leaves_with_names(kid, prefix + (name,))]


def ravel_pytree(tree):
    """(flat, unravel): the leaves of `tree` raveled and concatenated in
    `jax.flatten_util.ravel_pytree`'s order, in their promoted dtype, and
    `unravel(x (…, n))`, which gives the tree back with leaves (…, *shape)
    cut from the last axis of `x` (any leading axes, the chains, kept; the
    leaves in x's dtype)."""
    leaves, rebuild = _flatten(tree)
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    shapes = [tuple(leaf.shape) for leaf in leaves]
    sizes = [math.prod(sh) for sh in shapes]
    if leaves:
        dtype = leaves[0].dtype
        for leaf in leaves[1:]:
            dtype = torch.promote_types(dtype, leaf.dtype)
        flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    else:
        flat = torch.zeros(0)

    def unravel(x):
        out, off = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(x[..., off:off + size].reshape(x.shape[:-1] + shape))
            off += size
        return rebuild(out)

    return flat, unravel


def target_from_pytree(logdensity_fn, example) -> LogDensityTarget:
    """Wrap a log density over structured parameters: `logdensity_fn(tree)`
    takes the tree of `example` with a leading chain axis on every leaf
    ((C, *shape)) and returns (C,). The sampler sees the flat vector
    (`ravel_pytree`'s order, the JAX package's); the target carries
    `unravel` to map draws back."""
    flat_example, unravel = ravel_pytree(example)

    def flat_logdensity(x):
        return logdensity_fn(unravel(x))

    t = LogDensityTarget(flat_logdensity, int(flat_example.numel()))
    object.__setattr__(t, "unravel", unravel)
    return t


def as_target(obj, dim: Optional[int] = None) -> LogDensityTarget:
    """A `LogDensityTarget` from a target or a bare callable.

    The callable is in the port's BATCHED form: `logdensity(theta (C, dim))
    -> (C,)`, where the JAX function takes a single-chain `(dim,) ->
    scalar`; its gradient comes from autograd. `dim` is required for a bare
    callable. The target's tensors stay where the callable puts them, so
    it runs on the device of the θ it is given (CUDA unless the caller's
    state is on the CPU)."""
    if isinstance(obj, LogDensityTarget):
        return obj
    if callable(obj):
        if dim is None:
            raise ValueError("dim is required when wrapping a bare callable")
        return LogDensityTarget(logdensity=obj, dim=dim)
    raise TypeError(f"cannot interpret {type(obj)} as a log-density target")

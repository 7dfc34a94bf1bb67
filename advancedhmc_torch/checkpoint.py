"""Checkpoint / resume for sampler state (counterpart of
`advancedhmc_tpu/checkpoint.py`).

A state (`HMCState`, or any tree of frozen dataclasses, tuples, lists and
dicts of tensors) is flattened into named leaves — tensors, and
`HMCState.iteration` — and written to one npz with a MANIFEST: one
(path, shape, dtype) record per leaf, in flatten order, the paths built
from field names ("z.theta", "adapt.da.eps"). Loading validates the stored
manifest field by field against a like-structured state and raises a
`ValueError` naming the offending field (a different chain count,
dimension, metric kind or per-chain against shared adaptation), not an
index. A same-width or widening dtype load warns and casts; a narrowing
one (float64 → float32, a kind change) raises unless
`allow_narrowing=True`. Each leaf is restored on the like state's device
and in its dtype. Files are read with `numpy.load(allow_pickle=False)`:
no pickle is ever loaded.

The port's state carries no PRNG key: the randomness lives in the caller's
`torch.Generator`. `save_state` stores the generator's state as a uint8
leaf when one is given, and `load_state` restores it into a given
generator, so that N + N transitions from a checkpoint are bitwise the 2N
of one run (the counterpart of JAX checkpointing its key). The JAX
module's branch for files written before the manifest existed (a
`__treedef__` string) is not ported: the port has no such files.
"""

from __future__ import annotations

import dataclasses
import json
import warnings

import numpy as np
import torch

MANIFEST_KEY = "__manifest__"
GENERATOR_KEY = "__generator__"
# Python numbers that are leaves (the rest, such as n_min or a rank, are
# configuration and come from the like state)
_NUMBER_LEAVES = ("iteration",)


def _items(node):
    """(names, kids, make) of a dataclass, dict (sorted keys), tuple or
    list node, or None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        fields = [f.name for f in dataclasses.fields(node)]
        kids = [getattr(node, f) for f in fields]
        keep = [i for i, k in enumerate(kids)
                if _is_tree(k) or fields[i] in _NUMBER_LEAVES]
        names = [fields[i] for i in keep]

        def make(vals):
            return dataclasses.replace(node, **dict(zip(names, vals)))

        return names, [kids[i] for i in keep], make
    if isinstance(node, dict):
        keys = sorted(node)
        return ([str(k) for k in keys], [node[k] for k in keys],
                lambda vals: type(node)(zip(keys, vals)))
    if isinstance(node, (tuple, list)):
        return ([str(i) for i in range(len(node))], list(node),
                lambda vals: type(node)(vals))
    return None


def _is_tree(x):
    """Whether `x` holds leaves: a tensor, or a node that may."""
    return (isinstance(x, torch.Tensor) or isinstance(x, (dict, tuple, list))
            or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def _flatten(tree, path=""):
    """([(path, leaf)], rebuild) in flatten order; `rebuild(leaves)` gives
    the tree back with new leaves."""
    node = _items(tree) if not isinstance(tree, torch.Tensor) else None
    if node is None:
        return [(path or "<root>", tree)], lambda leaves: leaves[0]
    names, kids, make = node
    subs = [_flatten(k, f"{path}.{n}" if path else n)
            for n, k in zip(names, kids)]

    def rebuild(leaves):
        out, off = [], 0
        for sub_leaves, sub_rebuild in subs:
            out.append(sub_rebuild(leaves[off:off + len(sub_leaves)]))
            off += len(sub_leaves)
        return make(out)

    return [pl for sub in subs for pl in sub[0]], rebuild


def _to_numpy(name, leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(f"leaf {name!r} is bfloat16, which npz cannot "
                             "hold; cast it before saving")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _manifest_of(tree):
    """[(path, shape, dtype), ...] per leaf, in flatten order."""
    out = []
    for name, leaf in _flatten(tree)[0]:
        a = _to_numpy(name, leaf)
        out.append((name, list(a.shape), str(a.dtype)))
    return out


def _validate_manifest(stored, like_tree, what="checkpoint",
                       allow_narrowing=False):
    """Compare a stored manifest against `like_tree`'s structure; raise with
    a field-level message on any mismatch. Same-width and widening dtype
    differences warn (and the leaf is cast); narrowing ones raise unless
    `allow_narrowing`."""
    expected = _manifest_of(like_tree)
    if len(stored) != len(expected):
        s_paths = [m[0] for m in stored]
        e_paths = [m[0] for m in expected]
        missing = [p for p in e_paths if p not in s_paths]
        extra = [p for p in s_paths if p not in e_paths]
        raise ValueError(
            f"{what} structure mismatch: stored {len(stored)} leaves, "
            f"expected {len(expected)}."
            + (f" missing: {missing}" if missing else "")
            + (f" unexpected: {extra}" if extra else ""))
    for i, ((sp, ss, sd), (ep, es, ed)) in enumerate(zip(stored, expected)):
        if sp != ep:
            raise ValueError(
                f"{what} field {i} is {sp!r} but the target structure has "
                f"{ep!r} at that position (different spec or version?)")
        if list(ss) != list(es):
            raise ValueError(
                f"{what} field {sp!r} has shape {tuple(ss)} but the target "
                f"expects {tuple(es)} (different chain count, dimension, or "
                "adaptor configuration?)")
        if sd != ed:
            sdt, edt = np.dtype(sd), np.dtype(ed)
            narrowing = (edt.kind != sdt.kind) or (edt.itemsize < sdt.itemsize)
            if narrowing and not allow_narrowing:
                raise ValueError(
                    f"{what} field {sp!r} stored as {sd} but the target "
                    f"expects {ed}: loading would narrow (lose precision or "
                    "change kind). Pass allow_narrowing=True to cast anyway.")
            warnings.warn(f"{what} field {sp!r} stored as {sd}, loading as "
                          f"{ed}")


def _restore(a, like):
    """The stored array `a` as a leaf like `like`: a tensor in its dtype on
    its device, or a Python number of its type."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(a))
        return t.to(device=like.device, dtype=like.dtype)
    return type(like)(a.item())


def _load_leaves(data, prefix, like_tree, what, allow_narrowing=False):
    """Validate the stored manifest and rebuild `like_tree` from the
    `prefix`-keyed npz entries."""
    pairs, rebuild = _flatten(like_tree)
    if MANIFEST_KEY not in data.files:
        raise ValueError(f"{what} has no manifest")
    stored = json.loads(bytes(data[MANIFEST_KEY]).decode())
    _validate_manifest(stored, like_tree, what=what,
                       allow_narrowing=allow_narrowing)
    n_stored = sum(1 for k in data.files if k.startswith(prefix))
    if n_stored != len(pairs):
        raise ValueError(f"{what} has {n_stored} leaves but the target "
                         f"structure has {len(pairs)}")
    return rebuild([_restore(data[f"{prefix}{i}"], like)
                    for i, (_, like) in enumerate(pairs)])


def _state_payload(state, prefix):
    pairs, _ = _flatten(state)
    payload = {MANIFEST_KEY: np.frombuffer(
        json.dumps(_manifest_of(state)).encode(), dtype=np.uint8)}
    for i, (name, leaf) in enumerate(pairs):
        payload[f"{prefix}{i}"] = _to_numpy(name, leaf)
    return payload


def _load(path):
    return np.load(path, allow_pickle=False)


def save_state(path: str, state, generator=None) -> None:
    """Write `state` (and the state of `generator`, if given) to one npz."""
    payload = _state_payload(state, "leaf_")
    if generator is not None:
        payload[GENERATOR_KEY] = generator.get_state().numpy()
    np.savez(path, **payload)


def load_state(path: str, like, allow_narrowing: bool = False,
               generator=None):
    """Load a checkpoint into the structure of `like` (same spec/shape run).

    The stored manifest (per-leaf path/shape/dtype) is validated against
    `like`: a structure mismatch raises naming the offending FIELD.
    Narrowing dtype loads raise unless `allow_narrowing=True`. With
    `generator`, the stored generator state is restored into it (a
    checkpoint saved without one raises).
    """
    data = _load(path)
    state = _load_leaves(data, "leaf_", like, what="checkpoint",
                         allow_narrowing=allow_narrowing)
    if generator is not None:
        if GENERATOR_KEY not in data.files:
            raise ValueError("the checkpoint holds no generator state")
        generator.set_state(torch.from_numpy(data[GENERATOR_KEY].copy()))
    return state


def save_result(path: str, result) -> None:
    """Persist a `SampleResult` (draws, stats, warmup stats, online
    summary, final state) to one npz; `load_result` reads it back, the
    final state with manifest and shape validation."""
    payload = {}
    if result.thetas is not None:
        payload["thetas"] = _to_numpy("thetas", result.thetas)
    for group in ("stats", "warmup_stats", "online"):
        for k, v in (getattr(result, group) or {}).items():
            payload[f"{group}.{k}"] = _to_numpy(f"{group}.{k}", v)
    if result.final_state is not None:
        payload.update(_state_payload(result.final_state, "state.leaf_"))
    np.savez(path, **payload)


def load_result(path: str, like_state=None, allow_narrowing: bool = False,
                device=None):
    """Load a `SampleResult` saved by `save_result`: the draws and stats as
    tensors on `device` (None means CUDA), and `final_state` restored into
    the structure of `like_state` where one is given (else None).
    Narrowing dtype loads of the state raise unless
    `allow_narrowing=True` (see `load_state`)."""
    from .sampler import SampleResult
    from .utils import resolve_device

    device = resolve_device(device)
    data = _load(path)
    groups = {"stats": {}, "warmup_stats": {}, "online": {}}
    thetas = None
    for k in data.files:
        if k.startswith("state.leaf_") or k == MANIFEST_KEY:
            continue
        t = torch.from_numpy(np.array(data[k])).to(device)
        if k == "thetas":
            thetas = t
        else:
            grp, name = k.split(".", 1)
            groups[grp][name] = t
    final_state = None
    if like_state is not None:
        final_state = _load_leaves(data, "state.leaf_", like_state,
                                   what="saved state",
                                   allow_narrowing=allow_narrowing)
    return SampleResult(
        thetas=thetas, stats=groups["stats"],
        warmup_stats=groups["warmup_stats"] or None,
        final_state=final_state, online=groups["online"] or None)

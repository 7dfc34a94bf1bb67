"""The program cache: a process's kernel libraries, found without `nvcc`.

PyTorch counterpart of `advancedhmc_tpu/aot.py`. The JAX module stores the
traced StableHLO of a program so that a later process skips the Python
trace. The port traces no program: its eager PyTorch code runs as it is
called, and its one-time bring-up cost per process is the `nvcc` build
and the loading of the kernel libraries (`ops/_build.py`, which keeps each
built library under a name keyed by a hash of its sources). So the
artifact here is a manifest of the libraries a program loads.

The manifest saves no `nvcc` run over `_build`'s own cache: a library
built once is reused by any later process, with or without a manifest.
What it adds is the label (`source` says whether this program, at these
shapes, has run on this installation before) and the loading of the
listed libraries at `aot_program` instead of inside the first call;
`scripts/bringup_compare.py` times a fresh process's bring-up with and
without it.


* `aot_signature(program_id, example_args)` keys a program as JAX's does:
  the torch version, the device kind, `program_id`, the structure of the
  arguments and each leaf's shape and dtype. `program_id` must capture
  everything about the program that the arguments do not show.
* `aot_program(fn, example_args, program_id=...)` returns `(call,
  source)`. `call(*args)` is `fn(*args)`, bit for bit (it runs `fn`); it
  raises if the arguments' structure, shapes or dtypes differ from the
  example's. With a valid manifest in the cache `source` is "cache" and
  the listed libraries are loaded at once, without `nvcc` (a library that
  is missing, or whose sources changed, makes the manifest stale).
  Otherwise `source` is "trace", and the first call records the libraries
  that it loads and writes the manifest for the next process.

The manifest is JSON (`<signature>.json`), never a pickle. The cache
directory (`cache_dir`, else `AHMC_AOT_DIR` read at each call, else
`advancedhmc_torch/_build/aot` beside the libraries) is created 0o700,
and one that another user owns or others may write is refused before
anything in it is read. A manifest is written whole to a temporary file
and renamed into place; the temporary file is removed if that fails, and
a manifest that cannot be written is not an error of the call. A
manifest that does not parse, or lists other libraries than the sources
now give, falls back to "trace" and is overwritten.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import stat
import sys
import tempfile
from pathlib import Path

import torch

from .ops import _build

__all__ = ["aot_program", "aot_signature"]

_FORMAT = 1


def _describe(tree, leaves, devices=None):
    """The structure of `tree` as a string; its tensors' (shape, dtype)
    and other leaves' type names are appended to `leaves`, the tensors'
    devices to `devices`."""
    if isinstance(tree, torch.Tensor):
        leaves.append(f"{tuple(tree.shape)}:{tree.dtype}")
        if devices is not None:
            devices.append(tree.device)
        return "*"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kids = ",".join(
            f"{f.name}={_describe(getattr(tree, f.name), leaves, devices)}"
            for f in dataclasses.fields(tree))
        return f"{type(tree).__qualname__}({kids})"
    if isinstance(tree, dict):
        kids = ",".join(f"{k!r}:{_describe(tree[k], leaves, devices)}"
                        for k in sorted(tree, key=repr))
        return "{" + kids + "}"
    if isinstance(tree, (tuple, list)):
        kids = ",".join(_describe(x, leaves, devices) for x in tree)
        return f"{type(tree).__name__}[{kids}]"
    leaves.append(type(tree).__name__)
    return "*"


def _layout(example_args):
    leaves = []
    return _describe(tuple(example_args), leaves), leaves


def _device_kind(example_args):
    """The kind of the first CUDA device among the arguments' tensors, or
    "cpu"."""
    devices = []
    _describe(tuple(example_args), [], devices)
    for dev in devices:
        if dev.type == "cuda":
            return torch.cuda.get_device_name(dev)
    return "cpu"


def aot_signature(program_id: str, example_args) -> str:
    """The cache key of the program `program_id` on arguments shaped like
    `example_args`: the torch version, the device kind, `program_id`, the
    arguments' structure and each leaf's shape and dtype."""
    structure, leaves = _layout(example_args)
    parts = [torch.__version__, _device_kind(example_args), program_id,
             structure] + leaves
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:20]


def _cache_dir(cache_dir):
    """The cache directory, made 0o700 if it is new; refused if another
    user owns it or others may write to it."""
    d = Path(cache_dir or os.environ.get("AHMC_AOT_DIR")
             or _build.BUILD_DIR / "aot")
    d.mkdir(mode=0o700, parents=True, exist_ok=True)
    st = d.stat()
    if st.st_uid != os.getuid() or st.st_mode & (stat.S_IWGRP
                                                 | stat.S_IWOTH):
        raise PermissionError(
            f"program cache {d} is owned by another user or writable by "
            "others; use a private directory (AHMC_AOT_DIR or cache_dir)")
    return d


def _write_atomic(path: Path, text: str) -> None:
    """Write `text` to `path` whole, or leave `path` as it was."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def _read_manifest(path: Path, sig: str):
    """The libraries a valid manifest lists ({name: file name}), or None:
    no file, not JSON, another signature or format, or a library whose
    sources changed or whose file is gone."""
    try:
        data = json.loads(path.read_text())
        if data.get("format") != _FORMAT or data.get("signature") != sig:
            return None
        libs = dict(data["libraries"])
    except (OSError, ValueError, TypeError, KeyError, AttributeError):
        return None
    for name, file in libs.items():
        if name not in _build.SOURCES:
            return None
        built = _build.library_path(name)
        if built.name != file or not built.exists():
            return None
    return libs


def aot_program(fn, example_args, *, program_id: str, cache_dir=None,
                verbose: bool = False):
    """Return `(call, source)`: `call(*args)` is `fn(*args)` for arguments
    shaped like `example_args`, and `source` is "cache" (the manifest was
    found and its libraries are loaded, no `nvcc`) or "trace" (the first
    call writes the manifest). See the module docstring."""
    example_args = tuple(example_args)
    d = _cache_dir(cache_dir)
    sig = aot_signature(program_id, example_args)
    path = d / f"{sig}.json"
    layout = _layout(example_args)
    libs = _read_manifest(path, sig)
    if libs is not None:
        for name in libs:
            _build.load(name)
        if verbose:
            print(f"# aot: {program_id}: {sorted(libs)} loaded from {path}",
                  file=sys.stderr)
    elif verbose:
        print(f"# aot: {program_id}: no valid manifest at {path}; the first "
              "call writes it", file=sys.stderr)
    pending = [libs is None]

    def call(*args):
        if _layout(args) != layout:
            raise ValueError(
                f"aot program {program_id!r}: the arguments' structure, "
                "shapes or dtypes differ from the example's")
        if not pending[0]:
            return fn(*args)
        with _build.recording() as names:
            out = fn(*args)
        manifest = {"format": _FORMAT, "signature": sig,
                    "program_id": program_id, "torch": torch.__version__,
                    "device": _device_kind(example_args),
                    "libraries": {n: _build.library_path(n).name
                                  for n in sorted(names)}}
        pending[0] = False
        try:
            _write_atomic(path, json.dumps(manifest, indent=1) + "\n")
        except OSError as e:      # a full or read-only disk: never fatal
            if verbose:
                print(f"# aot: {program_id}: manifest not written ({e!r})",
                      file=sys.stderr)
            return out
        if verbose:
            print(f"# aot: {program_id}: wrote {path} ({sorted(names)})",
                  file=sys.stderr)
        return out

    return call, "cache" if libs is not None else "trace"

#!/usr/bin/env python3
"""A parent commit's kernels against this tree's on one card: K1's wide path
and K3 timed in turns (parent, this, this, parent) at their paths' shapes,
and the other kernels held bit for bit against the parent's.

Run from the root of the repository on a machine with one CUDA card, with
the parent's tree unpacked in a directory that .gitignore lists:

    mkdir -p _archive/parent
    git archive <parent> | tar -x -C _archive/parent
    python3 scripts/parent_compare.py _archive/parent

The parent's `advancedhmc_torch` is imported beside this tree's, under the
name `parent_advancedhmc_torch` (the package's modules import each other
relatively), and both sides are called through their own public wrappers,
whatever the libraries' entry points look like. The parent's kernels are
built by its own `ops/_build.py` into its own `_build` directory. Then:

* K1 wide (p = 999, n = 1000; chip_smoke.WIDE_TIMED) at C = 1024 and 1,
  through each side's `fused_logistic_value_grad(x, y)` (its design
  prepared at the first call): each side's device time (a CUDA graph of 20
  calls replayed between CUDA events), in the order parent, this, this,
  parent, beside each side's error against float64;
* K3 at chip_smoke.K3_SHAPES, through each side's
  `fused_gaussian_leapfrog`: the same turns, beside each side's largest
  error against this tree's plain loop;
* K1 narrow (the 100-D model, `logistic_value_grad`) at C = 32768, 4096,
  13 and 1 over 1000 and 300 rows, K2 narrow (the 100-D logistic at three
  step sizes and the Gaussian) and K2 wide (p = 999 and p = 200 over 997
  rows), through `fused_nuts`: the parent's outputs and this tree's,
  bitwise equal or not.

Prints one line per comparison, the card's name and power limit, and last
a JSON object with the results. It exits with 1 if K1 or K2 gives other
bits than the parent's.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import K3_SHAPES, WIDE_TIMED  # noqa: E402
from k1_wide_ablation import graph_ms  # noqa: E402

PARENT = "parent_advancedhmc_torch"
MODULES = {"k1": "ops.fused_logistic", "k2": "ops.fused_nuts_kernel",
           "k3": "ops.fused_leapfrog",
           "logistic": "models.logistic", "gaussian": "models.gaussian"}


def side(package):
    """The modules a comparison calls, of the package named `package`."""
    return types.SimpleNamespace(**{
        key: importlib.import_module(f"{package}.{name}")
        for key, name in MODULES.items()})


def load_parent(parent):
    """The parent's package, imported as PARENT, its kernels built in
    parallel by its own build module."""
    pkg = pathlib.Path(parent).resolve() / "advancedhmc_torch"
    spec = importlib.util.spec_from_file_location(
        PARENT, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = module
    spec.loader.exec_module(module)
    importlib.import_module(f"{PARENT}.ops._build").build(
        "fused_logistic", "fused_nuts", "fused_leapfrog")
    return side(PARENT)


def design(n, p):
    from advancedhmc_torch.models.logistic import _synthetic_data

    x_np, y_np = _synthetic_data(n, p)
    return (torch.as_tensor(x_np, dtype=torch.float32, device="cuda"),
            torch.as_tensor(y_np, dtype=torch.float32, device="cuda"))


def k2_cases(m):
    """(label, `fused_nuts` arguments) of side `m`, its targets built by
    its own models from the same seeds."""
    tgt, data = m.gaussian.std_gaussian_block(5, device="cuda")
    yield "K2 gaussian", (tgt, torch.zeros(8, 5, device="cuda"),
                          torch.ones(5, device="cuda"), 0.5, 42, data, 5,
                          80, 6, 8)
    for p, n_rows, chains, eps, log_sigma, m_inv in (
            (99, 1000, 512, 0.03, -0.7, 2e-3),
            (99, 1000, 512, 0.02, -0.7, 2e-3),
            (99, 1000, 512, 2.4, -0.7, 2e-3),
            (999, 1000, 256, 0.3, -1.5, 5e-3),
            (200, 997, 256, 0.3, -1.5, 5e-3)):
        dim = p + 1
        tgt, data = m.logistic.hierarchical_logistic_block(
            n=n_rows, p=p, d_pad=-(-dim // 128) * 128, device="cuda")
        th0 = torch.as_tensor(
            0.05 * np.random.default_rng(p).normal(size=(chains, dim)),
            dtype=torch.float32, device="cuda")
        th0[:, 0] = log_sigma
        yield (f"K2 logistic p={p} n={n_rows} eps={eps}",
               (tgt, th0, torch.full((dim,), m_inv, device="cuda"), eps, 3,
                data, dim, 4, 6, 256))


def main():
    if not torch.cuda.is_available():
        sys.exit("parent_compare: no CUDA device; this script runs on the "
                 "card")
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    sides = {"parent": load_parent(sys.argv[1]),
             "this": side("advancedhmc_torch")}
    gen = torch.Generator(device="cuda").manual_seed(3)
    result, unchanged = {}, True
    for c, p, n in WIDE_TIMED:
        x, y = design(n, p)
        theta = 0.1 * torch.randn(c, p + 1, generator=gen, device="cuda")
        lp64, g64 = sides["this"].k1.plain_logistic_value_grad(
            theta.double(), x.double(), y.double())
        calls = {name: (lambda a=m.k1.fused_logistic_value_grad(x, y):
                        a(theta)) for name, m in sides.items()}
        ms = {name: [] for name in sides}
        for name in ("parent", "this", "this", "parent"):
            ms[name].append(graph_ms(calls[name]))
        row = {}
        for name, fn in calls.items():
            lp, g = fn()
            torch.cuda.synchronize()
            row[name] = dict(
                ms=ms[name],
                grad_err64=float((g.double() - g64).abs().max()),
                lp_err64=float((lp.double() - lp64).abs().max()))
        result[f"K1 wide C={c} p={p} n={n}"] = row
        print(f"# K1 wide C={c}: parent {ms['parent'][0]:.4f} "
              f"{ms['parent'][1]:.4f} ms, this {ms['this'][0]:.4f} "
              f"{ms['this'][1]:.4f} ms (parent, this, this, parent); error "
              f"vs float64: grad {row['parent']['grad_err64']:.3e} / "
              f"{row['this']['grad_err64']:.3e}, lp "
              f"{row['parent']['lp_err64']:.3e} / "
              f"{row['this']['lp_err64']:.3e}", flush=True)
    for c, d, n_steps, eps in K3_SHAPES:
        args = (torch.randn(c, d, generator=gen, device="cuda"),
                torch.randn(c, d, generator=gen, device="cuda"),
                torch.linspace(0.5, 2.0, d, device="cuda"),
                torch.linspace(0.8, 1.2, d, device="cuda"), eps, n_steps)
        ref = sides["this"].k3.reference_gaussian_leapfrog(*args)
        calls = {name: (lambda f=m.k3.fused_gaussian_leapfrog: f(*args))
                 for name, m in sides.items()}
        ms = {name: [] for name in sides}
        for name in ("parent", "this", "this", "parent"):
            ms[name].append(graph_ms(calls[name]))
        row = {}
        for name, fn in calls.items():
            out = fn()
            torch.cuda.synchronize()
            row[name] = dict(ms=ms[name], max_abs_err=max(
                float((a - b).abs().max()) for a, b in zip(out, ref)))
        result[f"K3 C={c} D={d} L={n_steps}"] = row
        print(f"# K3 C={c} D={d} L={n_steps}: parent {ms['parent'][0]:.4f} "
              f"{ms['parent'][1]:.4f} ms, this {ms['this'][0]:.4f} "
              f"{ms['this'][1]:.4f} ms (parent, this, this, parent); max|Δ| "
              f"vs the plain loop {row['parent']['max_abs_err']:.3e} / "
              f"{row['this']['max_abs_err']:.3e}", flush=True)
    for n in (1000, 300):
        x, y = design(n, 99)
        for c in (32768, 4096, 13, 1):
            theta = 0.3 * torch.randn(c, 100, generator=gen, device="cuda")
            old, new = (m.k1.logistic_value_grad(theta, x, y)
                        for m in sides.values())
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(old, new))
            unchanged &= same
            result[f"K1 narrow C={c} n={n}"] = dict(same_bits=same)
            print(f"# K1 narrow C={c} n={n}: same bits {same}", flush=True)
    for (label, old_args), (_, new_args) in zip(
            k2_cases(sides["parent"]), k2_cases(sides["this"])):
        old = sides["parent"].k2.fused_nuts(*old_args)
        new = sides["this"].k2.fused_nuts(*new_args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(old, new))
        unchanged &= same
        result[label] = dict(same_bits=same)
        print(f"# {label}: same bits {same}", flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(gpu)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "unchanged_bits": unchanged, "results": result}))
    sys.exit(0 if unchanged else 1)


if __name__ == "__main__":
    main()

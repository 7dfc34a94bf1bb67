#!/usr/bin/env python3
"""A fresh process's bring-up with and without the program cache
(`advancedhmc_torch.aot_program`), on one card.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/bringup_compare.py

The kernel libraries are built first (`ops/_build.py`, not timed), so no
turn starts `nvcc`. Then each turn is a fresh process that makes the
100-D logistic target (1000 rows) and 32768 chains' θ, and times, host
clock with a synchronise at each end: the lookup (`aot_program`, or
nothing for the plain turn), the first value+grad call (which loads K1's
library unless the lookup did, and lays the design out) and a second
call. The turns run plain, trace, cache, cache, trace, plain; a trace turn
starts from an empty cache directory and a cache turn reads the manifest
the trace turn before it wrote. Every turn must give the same bits (a
digest of the outputs). The script prints each turn, the card's name and
power limit, and last one JSON object with the turns and each kind's mean.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

CHILD = r"""
import hashlib, json, sys, time
import torch
import advancedhmc_torch as ah

mode, cache = sys.argv[1], sys.argv[2]
torch.backends.cuda.matmul.allow_tf32 = False
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
target = ah.hierarchical_logistic(n=1000, p=99, device="cuda")
gen = torch.Generator(device="cuda").manual_seed(0)
theta = 0.3 * torch.randn(32768, 100, generator=gen, device="cuda")
torch.cuda.synchronize()
t0 = time.perf_counter()
if mode == "plain":
    fn, src = target.logdensity_and_grad, "plain"
else:
    fn, src = ah.aot_program(target.logdensity_and_grad, (theta,),
                             program_id="k1_value_grad", cache_dir=cache)
torch.cuda.synchronize()
t1 = time.perf_counter()
lp, g = fn(theta)
torch.cuda.synchronize()
t2 = time.perf_counter()
fn(theta)
torch.cuda.synchronize()
t3 = time.perf_counter()
digest = hashlib.sha256(lp.cpu().numpy().tobytes()
                        + g.cpu().numpy().tobytes()).hexdigest()[:16]
print("BRINGUP " + json.dumps(dict(
    source=src, lookup_s=t1 - t0, first_call_s=t2 - t1,
    second_call_s=t3 - t2, bring_up_s=t2 - t0, digest=digest)), flush=True)
"""


def turn(mode, cache):
    out = subprocess.run(
        [sys.executable, "-c", CHILD, mode, str(cache)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=600)
    if out.returncode:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"the {mode} turn failed (rc {out.returncode})")
    line = [x for x in out.stdout.splitlines() if x.startswith("BRINGUP ")]
    return json.loads(line[-1][len("BRINGUP "):])


def main():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from advancedhmc_torch.ops import _build

    chip_smoke.require_cuda()
    _build.build(*_build.SOURCES)
    caches = [_build.BUILD_DIR / f"bringup_aot_{i}" for i in (1, 2)]
    for d in caches:
        shutil.rmtree(d, ignore_errors=True)
    plan = [("plain", caches[0]), ("aot", caches[0]), ("aot", caches[0]),
            ("aot", caches[0]), ("aot", caches[1]), ("plain", caches[1])]
    turns = []
    try:
        for mode, cache in plan:
            r = turn(mode, cache)
            print(json.dumps(r), flush=True)
            turns.append(r)
    finally:
        for d in caches:
            shutil.rmtree(d, ignore_errors=True)
    expected = ["plain", "trace", "cache", "cache", "trace", "plain"]
    if [r["source"] for r in turns] != expected:
        raise SystemExit(f"sources {[r['source'] for r in turns]}, "
                         f"expected {expected}")
    if len({r["digest"] for r in turns}) != 1:
        raise SystemExit("the turns gave different bits")
    means = {}
    for kind in ("plain", "trace", "cache"):
        rows = [r for r in turns if r["source"] == kind]
        means[kind] = {k: sum(r[k] for r in rows) / len(rows)
                       for k in ("lookup_s", "first_call_s",
                                 "second_call_s", "bring_up_s")}
    print(chip_smoke.gpu_line(), flush=True)
    print(json.dumps({"turns": turns, "means": means}), flush=True)


if __name__ == "__main__":
    main()

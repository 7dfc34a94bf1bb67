#!/usr/bin/env python3
"""Phase 3 of `chip_smoke.py` (the main path: 32768 chains of the 100-D
logistic, the cross-chain fused warmup and the fused draws on the pair
body) in a parent commit's tree and in this one, timed in turns (parent,
this, this, parent) on one card.

Run from the root of the repository on a machine with one CUDA card, with
the parent's tree unpacked in a directory that .gitignore lists:

    mkdir -p _archive/parent
    git archive <parent> | tar -x -C _archive/parent
    python3 scripts/phase3_compare.py _archive/parent

Each turn is a fresh process started in its tree, which builds that tree's
kernels (`chip_smoke.phase_build`, not timed) and runs its
`chip_smoke.phase_main(seed)`. A turn prints its init, warmup and draw
walls (host clock, each phase ended by a synchronise, as `sample` times
them), the whole call's wall, K1's launches and the leaf-loop iterations a
transition of the decorrelation and the draws. The script prints the
card's name and power limit, then as its last line one JSON object with
every turn and each side's mean walls.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys, torch
import chip_smoke as cs
cs.require_cuda()
cs.phase_build()
res, launches, wall, by_chains, iters = cs.phase_main({seed})
t = res.timings
print("PHASE3 " + json.dumps(dict(
    init_s=t["init_s"], warmup_s=t["warmup_s"], draws_s=t["draws_s"],
    wall_s=wall, k1_launches=launches,
    leaf_iterations_per_transition=iters)), flush=True)
"""


def turn(tree, seed):
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(seed=seed)], cwd=tree,
        env=dict(os.environ, PYTHONPATH=str(tree)), capture_output=True,
        text=True, timeout=900)
    if out.returncode:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"phase 3 failed in {tree} (rc {out.returncode})")
    line = [x for x in out.stdout.splitlines() if x.startswith("PHASE3 ")]
    return json.loads(line[-1][len("PHASE3 "):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="the parent commit's unpacked tree")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    chip_smoke.require_cuda()
    trees = {"parent": pathlib.Path(args.parent).resolve(), "this": ROOT}
    turns = []
    for side in ("parent", "this", "this", "parent"):
        r = dict(side=side, **turn(trees[side], args.seed))
        print(json.dumps(r), flush=True)
        turns.append(r)
    means = {side: {k: sum(r[k] for r in turns if r["side"] == side) / 2
                    for k in ("init_s", "warmup_s", "draws_s", "wall_s")}
             for side in trees}
    print(chip_smoke.gpu_line(), flush=True)
    print(json.dumps({"turns": turns, "means": means}), flush=True)


if __name__ == "__main__":
    main()

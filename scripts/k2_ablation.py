#!/usr/bin/env python3
"""Where K2's time goes on the card: variants of the NUTS megakernel, each
with one part changed, timed beside the real one on the same inputs.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/k2_ablation.py            # the 100-D model
    python3 scripts/k2_ablation.py --wide     # the 1000-D model (p > 128)
    python3 scripts/k2_ablation.py --wide --deep   # ... every group deep

Each variant is a copy of `advancedhmc_torch/csrc/fused_nuts.cu` and its
headers `csrc/logistic_tile.cuh`, `csrc/logistic_wide_tile.cuh` with one
text edit (the script fails if an edit no
longer applies). All variants build in parallel with the port's nvcc flags
into `advancedhmc_torch/_build/k2_ablation/`. Each runs one call of 16
transitions at max_depth 6 over 32768 chains of the 100-D logistic (1000
rows), from 0.05·N(0, 1) starts with log σ = −0.7, M⁻¹ = 0.02 and ε = 0.3
(trees of depth ~4; the main path's are ~3), timed with CUDA events over 3
calls, twice. A block walks its leaves in lock step until its slowest
chain is done, so besides the time per call the script gives the time per
block iteration (the call's time over the mean, over blocks, of the
slowest chain's leaves plus one).

  kernel        the kernel as it is
  row_major     the design tiles staged from a row-major (n, p) copy of
                xᵀ, warps over rows and lanes over columns, as K1 stages
                them, instead of from xᵀ with lanes over rows
  three_per_sm  three resident blocks per SM instead of four (168
                registers, no spills)
  two_per_sm    two resident blocks per SM
  no_tile       the logistic's tile loop taken out (likelihood 0, data
                gradient 0): what the bookkeeping and the lock step cost.
                It samples another density, so its trees differ; compare
                its time per block iteration

With `--wide` the variants are those of the wide instance
(`WideLogisticTarget`), on 1024 chains of the 1000-D logistic (p = 999,
1000 rows) from starts with log σ = −1.5, M⁻¹ = 5e-3 and ε = 0.3 (trees
of depth ~4), 16 transitions. Each of its 16 groups of 64 chains is a
cluster of R blocks that split the rows and walk the chains (R = 11 on an
H100, which holds all 16 such clusters at once); the groups run side by
side, so the time per group iteration is over the slowest group's
iterations.

  kernel          the kernel as it is
  no_mma          neither product issues its mma (staging, barriers, the
                  epilogue, the cluster's sums and the walk remain)
  one_mma         one TF32 mma per product instead of three
  no_stage_x      the x tiles' 4-byte cp.async copies are not issued
  no_stage_beta   β's chunks are not copied from the scratch
  one_barrier     one barrier per step of stage A instead of two (a race,
                  timing only)
  no_leaf         no chunks (no staging, products or sums; the gradient
                  vectors keep what the walk left): what the walk, the
                  barriers and the lock step cost
  one_rank        clusters of one block (kMaxRanks = 1): each group's
                  rows and walk on one block, as before the cluster design
  no_cluster_sum  the rank-ordered sums of the gradient chunks through
                  distributed shared memory are not taken (the barriers
                  stay; the gradient vectors keep what the walk left)
  ranks_16        16 ranks a cluster (2 row tiles a rank; the card holds
                  14 such clusters, so two groups wait for a second wave)
  ranks_12        12 ranks a cluster (3 row tiles a rank, the last rank
                  none; one wave)
  ranks_8         8 ranks a cluster (4 row tiles a rank, one wave)
  one_per_sm      16 KB more shared memory a block, so that an SM holds
                  one block; the ranks by the kernel's rule at that
                  occupancy
  one_per_sm_8    one block an SM and 8 ranks a cluster (128 blocks)

For the wide instance each line also gives the SMs that held a block (the
SM ids the kernel leaves in the chains' records, `fused_nuts_sms_used`).

`--deep` takes ε = 0.0375 instead of 0.3: every chain's tree reaches
max_depth in every transition, so every group iterates 1009 times, as in
chip_smoke.py's phase 10, and a group that waits for a later wave adds its
whole time to the call's.

Prints one line per variant, the card's name and power limit, and last a
JSON object with the times.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

H, W, CU = "logistic_tile.cuh", "logistic_wide_tile.cuh", "fused_nuts.cu"
# the narrow logistic instances' launch bound (the Gaussian's reads the same)
_MIN_BLOCKS = "static constexpr int kMinBlocks = 4;"
EDITS = {   # variant: [(file, old text, new text)]
    "kernel": [],
    "row_major": [(CU,
        "    const bool valid = j0 + lane < n;\n"
        "    const float* src = xt + (valid ? j0 + lane : 0);\n"
        "    for (int k = warp; k < p; k += kWarps) {\n"
        "      logistic_tile::cp_async4(xs + lane * S + k, src + "
        "(size_t)(1 + k) * n,\n"
        "                               valid);\n"
        "    }\n",
        "    for (int r = warp; r < kTileRows; r += kWarps) {\n"
        "      const bool ok = j0 + r < n;\n"
        "      const float* row = xt + (size_t)(ok ? j0 + r : 0) * p;\n"
        "      for (int k = lane; k < p; k += 32) {\n"
        "        logistic_tile::cp_async4(xs + r * S + k, row + k, ok);\n"
        "      }\n"
        "    }\n"
        "    const bool valid = j0 + lane < n;\n")],
    "three_per_sm": [(CU, _MIN_BLOCKS,
                      "static constexpr int kMinBlocks = 3;")],
    "two_per_sm": [(CU, _MIN_BLOCKS,
                    "static constexpr int kMinBlocks = 2;")],
    "no_tile": [(CU,
        "    const int n_tiles = (n + kTileRows - 1) / kTileRows;",
        "    const int n_tiles = 0;")],
}


def _ranks(r):
    """The edit that fixes the wide instance's ranks per cluster at r."""
    return (CU, "  for (int r = 1; r <= most; ++r) {",
            f"  for (int r = {r}; r <= {r}; ++r) {{")


# 16 KB more shared memory a block of the wide instance, so that an SM
# holds one block (the rank rule then weighs the clusters the card holds
# at one block an SM)
_ONE_PER_SM = (CU, "(size_t)kChains * kResStride + kPanelRows + kChains + 4;",
               "(size_t)kChains * kResStride + kPanelRows + kChains + 4 + "
               "4096;")
WIDE_EDITS = {
    "kernel": [],
    "no_mma": [(W, "logistic_tile::mma_3xtf32(d[q][j], a_hi, a_lo, b_hi, "
                "b_lo);", ""),
               (W, "logistic_tile::mma_3xtf32(d[nt], a_hi, a_lo, b_hi, "
                "b_lo);", "")],
    "one_mma": [(H,
        "  mma_tf32(d, a_lo, b_hi);\n  mma_tf32(d, a_hi, b_lo);\n", "")],
    "no_stage_x": [(CU,
        "        logistic_tile::cp_async4(\n"
        "            dst + lane * S + k,\n"
        "            xt + (ok ? (size_t)(1 + k0 + k) * n + j0 + lane : 0), "
        "ok);\n", "")],
    "no_stage_beta": [(CU,
        "          logistic_tile::cp_async4(bs + r * S + k, src + (ok ? k0 + "
        "k : 0),\n                                   ok);\n", "")],
    "one_barrier": [(CU,
        "        __syncthreads();  // both buffers are free for the steps "
        "after next\n", "")],
    "no_leaf": [(CU, "    const int n_chunks = (p + kChunk - 1) / kChunk;",
                 "    const int n_chunks = 0;")],
    "one_rank": [(CU, "constexpr int kMaxRanks = 16;",
                  "constexpr int kMaxRanks = 1;")],
    "no_cluster_sum": [(CU,
        "for (int e = tid; e < span * kChunk; e += kThreads) {",
        "for (int e = tid; e < 0; e += kThreads) {")],
    **{f"ranks_{r}": [_ranks(r)] for r in (16, 12, 8)},
    "one_per_sm": [_ONE_PER_SM],
    "one_per_sm_8": [_ONE_PER_SM, _ranks(8)],
}
# (edits, rows, dim, chains, log σ start, M⁻¹, ptxas entry of the instance)
MODES = {
    "narrow": (EDITS, 1000, 100, 32768, -0.7, 0.02, "LogisticTargetILi13E"),
    "wide": (WIDE_EDITS, 1000, 1000, 1024, -1.5, 5e-3, "WideLogisticTarget"),
}
T, MAX_DEPTH, EPS, SEED, BLOCK_CHAINS = 16, 6, 0.3, 3, 256
DEEP_EPS = 0.0375


def build_all(mode):
    from advancedhmc_torch.ops import _build

    edits_by_variant, instance = MODES[mode][0], MODES[mode][-1]
    csrc = ROOT / "advancedhmc_torch" / "csrc"
    out = _build.BUILD_DIR / "k2_ablation" / mode
    procs = {}
    for name, edits in edits_by_variant.items():
        texts = {f: (csrc / f).read_text() for f in (H, W, CU)}
        for f, old, new in edits:
            if old not in texts[f]:
                raise RuntimeError(f"variant {name}: edit does not apply")
            texts[f] = texts[f].replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / CU)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    from advancedhmc_torch.ops import fused_nuts_kernel as k2

    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        k2._kernel(lib)
        libs[name] = (lib, _registers(report, instance))
    return libs


def _registers(report, instance):
    """Registers and spill stores of the instance whose mangled name holds
    `instance` (ptxas)."""
    import re

    for entry in report.split("Compiling entry function")[1:]:
        if instance in entry.split("\n")[0]:
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            return int(regs.group(1)), int(spill.group(1))
    return None, None


def call(lib, theta0, m_inv, d0, y, n, eps=EPS):
    """One call of `lib`'s kernel: (thetas, stats, the scratch it left)."""
    from advancedhmc_torch.ops import fused_nuts_kernel as k2

    return k2._launch(lib, 0, theta0, m_inv, eps, SEED, d0, y, n,
                      theta0.shape[1], T, MAX_DEPTH, BLOCK_CHAINS)


def cuda_ms(fn, reps=3):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("k2_ablation: no CUDA device; this script runs on the card")
    from advancedhmc_torch.models.logistic import hierarchical_logistic_block
    from advancedhmc_torch.ops.counter_rng import _round_up

    mode = "wide" if "--wide" in sys.argv[1:] else "narrow"
    eps = DEEP_EPS if "--deep" in sys.argv[1:] else EPS
    _, n_rows, dim, chains, log_sigma, m_inv_value, _ = MODES[mode]
    libs = build_all(mode)
    _, (xt, y) = hierarchical_logistic_block(
        n=n_rows, p=dim - 1, d_pad=_round_up(dim, 128), device="cuda")
    x = xt[1:dim].T.contiguous()        # the row_major variant's copy
    y = y.reshape(-1)
    theta0 = torch.as_tensor(
        0.05 * np.random.default_rng(0).normal(size=(chains, dim)),
        dtype=torch.float32, device="cuda")
    theta0[:, 0] = log_sigma
    m_inv = torch.full((dim,), m_inv_value, device="cuda")
    block = libs["kernel"][0].fused_nuts_chains_per_block()
    ref = None
    result = {}
    for name, (lib, (regs, spills)) in libs.items():
        d0 = x if name == "row_major" else xt
        out = call(lib, theta0, m_inv, d0, y, n_rows, eps)
        torch.cuda.synchronize()
        if ref is None:
            ref = out
        same = all(torch.equal(a, b) for a, b in zip(out[:2], ref[:2]))
        # the wide instance leaves each chain's SM in the scratch
        sms = (lib.fused_nuts_sms_used(chains, dim, MAX_DEPTH,
                                       out[2].data_ptr())
               if mode == "wide" else None)
        leaves = out[1][0].sum(0).double()                  # (C,)
        iters = leaves.reshape(-1, block).amax(1) + 1
        ms = [cuda_ms(lambda: call(lib, theta0, m_inv, d0, y, n_rows, eps))
              for _ in range(2)]
        per_sm = lib.fused_nuts_blocks_per_sm(0, dim)
        ranks, clusters = ctypes.c_int(), ctypes.c_int()
        lib.fused_nuts_cluster_shape(0, chains, dim, n_rows,
                                     ctypes.byref(ranks),
                                     ctypes.byref(clusters))
        # the 100-D model's 512 blocks share the SMs' slots over the call,
        # the 1000-D model's 16 groups run side by side until the slowest
        # is done
        per_call = iters.max() if mode == "wide" else iters.mean()
        result[name] = dict(
            ms=ms, block_iterations_mean=float(iters.mean()),
            block_iterations_max=float(iters.max()),
            ms_per_block_iteration=ms[0] / float(per_call),
            mean_depth=float(out[1][1].double().mean()),
            registers=regs, spill_store_bytes=spills, blocks_per_sm=per_sm,
            ranks_per_cluster=ranks.value, resident_clusters=clusters.value,
            sms_used=sms, same_bits=same)
        print(f"# {name:14s} {ms[0]:8.2f} {ms[1]:8.2f} ms per call, "
              f"{1e3 * result[name]['ms_per_block_iteration']:7.1f} µs per "
              f"block iteration ({float(iters.mean()):.1f} mean, "
              f"{float(iters.max()):.0f} max), depth "
              f"{result[name]['mean_depth']:.3f}, {regs} registers, "
              f"{spills} B spill stores, {per_sm} blocks per SM, "
              f"{ranks.value} ranks a cluster ({clusters.value} resident), "
              f"{sms} SMs used, "
              f"same bits as the kernel {same}", flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(gpu)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "mode": mode,
                      "eps": eps, "variants": result}))


if __name__ == "__main__":
    main()

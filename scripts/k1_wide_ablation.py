#!/usr/bin/env python3
"""Where the time of K1's wide variant (p > 128) goes on the card: variants
of the kernel, each with one part taken out or changed, timed beside the
real one.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/k1_wide_ablation.py

Each variant is a copy of `advancedhmc_torch/csrc/fused_logistic.cu` and
its headers `csrc/logistic_tile.cuh`, `csrc/logistic_wide_tile.cuh` with
text edits (the script fails if an edit no
longer applies), built in parallel with the port's nvcc flags into
`advancedhmc_torch/_build/k1_wide_ablation/`. Each is timed with CUDA
events over 20 calls, twice, on the hierarchical logistic's synthetic
design at (C, p, n) = (1024, 999, 1000), (4096, 999, 1000), (4096, 200,
1000) and (1, 999, 1000), and compared with float64. Variants other than
`kernel` compute something else: their times bound what the part costs,
their errors are not K1's.

  kernel        the kernel as it is
  no_mma        neither product issues its mma (staging, barriers, the
                epilogue and the cluster's sums remain)
  no_mma_a      stage A's product issues no mma
  no_mma_b      stage B's product issues no mma
  one_mma       one TF32 mma per product instead of three
  local_sum     the cluster's sums read only the rank's own partial (no
                distributed shared memory reads; the barriers remain)
  no_sum        no cluster sums and no cluster barriers in stage B
  warps4        4 warps a block (one per 16 chains) instead of 8
  split8        at most 8 blocks per cluster (the portable size), not 16
  warps4_split8 both
  one_per_sm    launch bounds for one block per SM (255 registers) instead
                of two (128)
  no_stage_x    the x tiles' 4-byte cp.async copies are not issued (the
                commits, waits and barriers remain)
  no_stage_beta β's chunks are not copied
  one_barrier   one barrier per step of stages A and B instead of two (the
                one after the step's product goes; a race, timing only)

Prints each variant's registers and spills (ptxas), one line per variant
and shape, the card's name and power limit, and
last a JSON object with the times.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from k1_ablation import call, cuda_ms  # noqa: E402

H, W, CU = "logistic_tile.cuh", "logistic_wide_tile.cuh", "fused_logistic.cu"
_MMA_A = "logistic_tile::mma_3xtf32(d[q][j], a_hi, a_lo, b_hi, b_lo);"
_MMA_B = "logistic_tile::mma_3xtf32(d[nt], a_hi, a_lo, b_hi, b_lo);"
_REMOTE = "cluster.map_shared_rank(part, q)[c * S + k]"
_SUM_SYNC = ("      cluster.sync();\n      // every rank's partial, in rank "
             "order")
_SUM_SYNC2 = ("      cluster.sync();  // no rank writes its partial while "
              "another reads it")
_WARPS = "constexpr int kWideWarps = 8;"
_SPLIT = "constexpr int kWideMaxSplit = 16;"
_MIN_BLOCKS = "constexpr int kWideMinBlocks = 2;"
_STAGE_X = "cp_async4(dst + r * S + k, src + (ok ? k0 + k : 0), ok);"
_STAGE_BETA = "cp_async4(bs + r * S + k, src + (ok ? k0 + k : 0), ok);"
_BARRIER_A = ("      __syncthreads();  // both buffers are free for the steps "
              "after next\n")
_GRAD_CALL = "xs + buf * kTileRows * S, nt0, n_nt, acc);"
_BARRIER_B = _GRAD_CALL + "\n        __syncthreads();"
EDITS = {   # variant: [(file, old text, new text)]
    "kernel": [],
    "no_mma": [(W, _MMA_A, ""), (W, _MMA_B, "")],
    "no_mma_a": [(W, _MMA_A, "")],
    "no_mma_b": [(W, _MMA_B, "")],
    "one_mma": [(H,
        "  mma_tf32(d, a_lo, b_hi);\n  mma_tf32(d, a_hi, b_lo);\n", "")],
    "local_sum": [(CU, _REMOTE, "part[c * S + k]")],
    "no_sum": [(CU, _REMOTE, "part[c * S + k]"),
               (CU, _SUM_SYNC, "      __syncthreads();\n      // every "
                "rank's partial, in rank order"),
               (CU, _SUM_SYNC2, "      __syncthreads();")],
    # the kernel's configuration: warps per block, blocks per cluster, the
    # launch bounds' blocks per SM
    "warps4": [(CU, _WARPS, "constexpr int kWideWarps = 4;")],
    "split8": [(CU, _SPLIT, "constexpr int kWideMaxSplit = 8;")],
    "warps4_split8": [(CU, _WARPS, "constexpr int kWideWarps = 4;"),
                      (CU, _SPLIT, "constexpr int kWideMaxSplit = 8;")],
    "one_per_sm": [(CU, _MIN_BLOCKS, "constexpr int kWideMinBlocks = 1;")],
    # the staging and the barriers of the steps
    "no_stage_x": [(CU, _STAGE_X, "")],
    "no_stage_beta": [(CU, _STAGE_BETA, "")],
    "one_barrier": [(CU, _BARRIER_A, ""), (CU, _BARRIER_B, _GRAD_CALL)],
}
SHAPES = ((1024, 999, 1000), (4096, 999, 1000), (4096, 200, 1000),
          (1, 999, 1000))


def build_all():
    from advancedhmc_torch.ops import _build

    csrc = ROOT / "advancedhmc_torch" / "csrc"
    out = _build.BUILD_DIR / "k1_wide_ablation"
    procs = {}
    for name, edits in EDITS.items():
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
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        wide = report.split("fused_logistic_wide_kernel")[-1]
        regs = re.search(r"Used (\d+) registers", wide)
        spill = re.search(r"(\d+) bytes spill stores", wide)
        print(f"# {name}: the wide kernel uses {regs.group(1)} registers, "
              f"{spill.group(1)} bytes of spill stores (ptxas)", flush=True)
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.fused_logistic_value_grad_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("k1_wide_ablation: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from advancedhmc_torch.models.logistic import _synthetic_data
    from advancedhmc_torch.ops.fused_logistic import \
        plain_logistic_value_grad

    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = {}
    for c, p, n in SHAPES:
        x_np, y_np = _synthetic_data(n, p)
        x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
        y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
        theta = 0.1 * torch.randn(c, p + 1, generator=gen, device="cuda")
        lp64, g64 = plain_logistic_value_grad(theta.double(), x.double(),
                                              y.double())
        ref = call(libs["kernel"], theta, x, y)
        for name, lib in libs.items():
            lp, g = call(lib, theta, x, y)
            torch.cuda.synchronize()
            same = torch.equal(lp, ref[0]) and torch.equal(g, ref[1])
            ms = [cuda_ms(lambda: call(lib, theta, x, y)) for _ in range(2)]
            err_g = float((g.double() - g64).abs().max())
            err_lp = float((lp.double() - lp64).abs().max())
            key = f"{name} C={c} p={p} n={n}"
            result[key] = dict(ms=ms, grad_err64=err_g, lp_err64=err_lp,
                               same_bits=same)
            print(f"# C={c} p={p} {name:10s} {ms[0]:.4f} {ms[1]:.4f} ms, vs "
                  f"float64 grad {err_g:.3e} lp {err_lp:.3e}, same bits as "
                  f"the kernel {same}", flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(gpu)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "variants": result}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the time of K1's wide path (p > 128) goes on the card: variants of
its kernels, each with one part taken out or changed, timed beside the
real one.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/k1_wide_ablation.py

Each variant is a copy of `advancedhmc_torch/csrc/fused_logistic.cu` (and
the header it includes, `csrc/logistic_tile.cuh`) with text edits to the
code of its `wide` namespace and the wide path's host code after it (the
script fails if an edit no longer applies), built in parallel with the
port's nvcc flags into `advancedhmc_torch/_build/k1_wide_ablation/`. Each
runs on the hierarchical logistic's synthetic design at (C, p, n) =
(1024, 999, 1000), (1, 999, 1000) and (4096, 999, 1000), its design
prepared by its own library from the planes of
`ops.fused_logistic.wide_layout`. Its device time is a CUDA graph of 20
calls replayed between CUDA events, twice, and it is compared with
float64. Variants other than `kernel`, `no_promote`, `stages2`, `stages3`,
`no_split` and `a_copies` compute something else: their times bound what
a part costs, their errors are not K1's.

  kernel      the kernels as they are
  no_mma      no wgmma (the pipeline, the A fragments' reads and the
              epilogues remain)
  one_mma     one TF32 product per k-step instead of three (1xTF32)
  no_promote  one wgmma accumulator through all of K, no promotion
  stages2     a ring of 2 stages instead of kStages (4)
  stages3     a ring of 3
  no_split    no split of K across a cluster at small C
  a_copies    A copied by the producer warpgroup's cp.async even where its
              rows are aligned for TMA
  stage_a     stage A alone
  stage_b     stage B alone (on the scratch's leftovers)

Prints each variant's registers and spills (ptxas) of the GEMM kernels
(stage A with A by TMA and with A copied, stage B), one line per variant
and shape, the card's name and power limit, and last a JSON object with
the times.
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

H, CU = "logistic_tile.cuh", "fused_logistic.cu"


def _set(name, old, new):
    return (CU, f"constexpr {name} = {old};", f"constexpr {name} = {new};")


# the three products of a k-step in `issue_stage`
PRODUCTS = ("    wgmma_tf32(d, lo[kk], b_hi + o, add);\n"
            "    wgmma_tf32(d, hi[kk], b_lo + o, 1);\n"
            "    wgmma_tf32(d, hi[kk], b_hi + o, 1);\n")
RELEASE = "      if (lane == 0) mbar_arrive(&empty[s]);"
AFTER_LOOP = "    // every wgmma of the warpgroups is done with the ring"
EDITS = {   # variant: [(file, old text, new text)]
    "kernel": [],
    "no_mma": [(CU, PRODUCTS, "    if (!add) {\n#pragma unroll\n"
                "      for (int r = 0; r < kAcc; ++r) d[r] = 0.f;\n"
                "    }\n")],
    "one_mma": [(CU, PRODUCTS, "    wgmma_tf32(d, hi[kk], b_hi + o, add);\n")],
    # d starts at zero and every product adds into it; acc takes it once
    "no_promote": [
        (CU, "const int add = kk == 0 ? 0 : 1;", "const int add = 1;"),
        (CU, "      promote(acc, d);\n" + RELEASE, RELEASE),
        (CU, AFTER_LOOP, "    promote(acc, d);\n" + AFTER_LOOP)],
    "stages2": [_set("int kStages", 4, 2)],
    "stages3": [_set("int kStages", 4, 3)],
    "no_split": [_set("int kMaxSplit", 8, 1)],
    "a_copies": [
        (CU, "const bool tma = dim % 4 == 0", "const bool tma = false"),
        (CU, "launch_gemm<1, true, stage_b_mode(Mode)>(",
         "launch_gemm<1, false, stage_b_mode(Mode)>("),
        (CU, "setup_kernel<1, true, stage_b_mode(Mode)>(s)",
         "setup_kernel<1, false, stage_b_mode(Mode)>(s)")],
    "stage_a": [(CU, "  {   // stage B:", "  if (false) {   // stage B:")],
    "stage_b": [(CU, "  {   // stage A:", "  if (false) {   // stage A:")],
}
SHAPES = ((1024, 999, 1000), (1, 999, 1000), (4096, 999, 1000))
# (the float32 mode's instances: template arguments stage, A by TMA, mode)
GEMMS = (("stage_a", "gemm_kernelILi0ELb1ELi0E"),
         ("stage_a_copies", "gemm_kernelILi0ELb0ELi0E"),
         ("stage_b", "gemm_kernelILi1ELb1ELi0E"))


def build_all():
    from advancedhmc_torch.ops import _build
    from advancedhmc_torch.ops import fused_logistic as k1

    csrc = ROOT / "advancedhmc_torch" / "csrc"
    out = _build.BUILD_DIR / "k1_wide_ablation"
    procs = {}
    for name, edits in EDITS.items():
        texts = {f: (csrc / f).read_text() for f in (H, CU)}
        for f, old, new in edits:
            # the edits apply to the wide path alone, each at one place
            at = texts[f].index("namespace wide {")
            head, wide = texts[f][:at], texts[f][at:]
            if wide.count(old) != 1:
                raise RuntimeError(f"variant {name}: edit does not apply")
            texts[f] = head + wide.replace(old, new)
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
        regs = {}
        for entry in report.split("Compiling entry function")[1:]:
            for label, pattern in GEMMS:
                if pattern in entry.split("\n")[0]:
                    regs[label] = (
                        int(re.search(r"Used (\d+) registers", entry)[1]),
                        int(re.search(r"(\d+) bytes spill stores", entry)[1]))
        print(f"# {name}: registers, spill-store bytes (ptxas) {regs}; "
              f"wgmma serialised: {'serialized' in report}", flush=True)
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        k1._kernel(lib)
        libs[name] = (lib, regs)
    return libs


def prepare(lib, planes, t_planes, n, dim):
    """`lib`'s prepared design of the planes (the buffer of its maps)."""
    buf = ctypes.create_string_buffer(lib.fused_logistic_wide_design_bytes())
    err = lib.fused_logistic_wide_prepare(
        ctypes.addressof(buf), planes.data_ptr(), t_planes.data_ptr(), n,
        dim, planes.shape[1], planes.shape[2])
    if err != 0:
        raise RuntimeError(f"design preparation failed with CUDA error {err}")
    return buf


def call(lib, design, theta, x, y):
    c, dim = theta.shape
    n = x.shape[0]
    lp = torch.empty(c, device="cuda")
    grad = torch.empty(c, dim, device="cuda")
    scratch = torch.empty(lib.fused_logistic_wide_scratch_floats(c, n),
                          device="cuda")
    launched = ctypes.c_int(0)
    err = lib.fused_logistic_value_grad_f32(
        theta.data_ptr(), x.data_ptr(), y.data_ptr(), lp.data_ptr(),
        grad.data_ptr(), c, dim, n, 0, 0, ctypes.addressof(design),
        scratch.data_ptr(), torch.cuda.current_stream().cuda_stream,
        ctypes.byref(launched))
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return lp, grad


def graph_ms(fn, reps=20, replays=2):
    """Device time of one call: `reps` calls captured in a CUDA graph,
    replayed between CUDA events (the host's cost per call is not in it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def main():
    if not torch.cuda.is_available():
        sys.exit("k1_wide_ablation: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from advancedhmc_torch.models.logistic import _synthetic_data
    from advancedhmc_torch.ops import fused_logistic as k1

    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = {}
    for c, p, n in SHAPES:
        x_np, y_np = _synthetic_data(n, p)
        x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
        y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
        planes, t_planes = k1.wide_layout(x)
        theta = 0.1 * torch.randn(c, p + 1, generator=gen, device="cuda")
        lp64, g64 = k1.plain_logistic_value_grad(theta.double(), x.double(),
                                                 y.double())
        ref = None
        for name, (lib, regs) in libs.items():
            design = prepare(lib, planes, t_planes, n, p + 1)
            lp, g = call(lib, design, theta, x, y)
            torch.cuda.synchronize()
            if ref is None:
                ref = (lp, g)
            same = torch.equal(lp, ref[0]) and torch.equal(g, ref[1])
            ms = [graph_ms(lambda: call(lib, design, theta, x, y))
                  for _ in range(2)]
            err_g = float((g.double() - g64).abs().max())
            err_lp = float((lp.double() - lp64).abs().max())
            key = f"{name} C={c} p={p} n={n}"
            result[key] = dict(ms=ms, grad_err64=err_g, lp_err64=err_lp,
                               same_bits=same, ptxas=regs)
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

#!/usr/bin/env python3
"""Where the time of K3 (the Gaussian leapfrog kernel) goes on the card:
variants of its kernel, each with one choice changed, timed beside the real
one at `chip_smoke.py`'s K3 shapes.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/k3_ablation.py

Each variant is a copy of `advancedhmc_torch/csrc/fused_leapfrog.cu` with
text edits (the script fails if an edit no longer applies at exactly one
place), built in parallel with the port's nvcc flags into
`advancedhmc_torch/_build/k3_ablation/`. Its device time is a CUDA graph of
20 calls replayed between CUDA events, twice; its largest error against
the plain loop is printed beside it.

  kernel       the kernel as it is
  unroll8      the step loop unrolled 8 times instead of 16
  unroll32     32 times
  warps6       E rule aims at 6 warps' tasks an SM instead of kWarpsPerSM
               (larger E)
  warps24      24 (smaller E)
  e1           E = 1 at every size: most tasks, no ILP
  blocks2      2 resident blocks an SM in the grid instead of kBlocksPerSM
  blocks8      8
  no_energies  the energy terms left out (computes something else: its
               time bounds what they cost)
  unmerged     the step-by-step kick order: half-kick, drift, half-kick a
               step (three FMAs instead of two)

Then the kernel and `unroll8` at (16384, 128) for L = 0, 25, 400 and 1600
beside 100: the slope is the cost of a step, the rest the loads, stores
and energies.

Prints one line per variant and shape, the card's name and power limit,
and last a JSON object with the times.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CU = "fused_leapfrog.cu"


def _set(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


STEPS = ("#pragma unroll 16\n"
         "  for (int s = 1; s < n_steps; ++s) {\n"
         "#pragma unroll\n"
         "    for (int e = 0; e < E; ++e) {\n"
         "      th[e] = fmaf(a, rr[e], th[e]);\n"
         "      rr[e] = fmaf(nb, th[e], rr[e]);\n"
         "    }\n"
         "  }\n")
UNMERGED = STEPS.replace("      rr[e] = fmaf(nb, th[e], rr[e]);\n",
                         "      rr[e] = fmaf(half_nb, th[e], rr[e]);\n"
                         "      rr[e] = fmaf(half_nb, th[e], rr[e]);\n")
ENERGIES = ("        p[e] += pr * th[e] * th[e];\n"
            "        q[e] += mi * rr[e] * rr[e];\n")
EDITS = {   # variant: [(old text, new text)]
    "kernel": [],
    "unroll8": [(STEPS, STEPS.replace("unroll 16", "unroll 8"))],
    "unroll32": [(STEPS, STEPS.replace("unroll 16", "unroll 32"))],
    "warps6": [_set("kWarpsPerSM", 12, 6)],
    "warps24": [_set("kWarpsPerSM", 12, 24)],
    "e1": [_set("kMaxE", 8, 1)],
    "blocks2": [_set("kBlocksPerSM", 4, 2)],
    "blocks8": [_set("kBlocksPerSM", 4, 8)],
    "no_energies": [(ENERGIES, "")],
    "unmerged": [(STEPS, UNMERGED)],
}


def build_all():
    from advancedhmc_torch.ops import _build
    from advancedhmc_torch.ops import fused_leapfrog as k3

    src = (ROOT / "advancedhmc_torch" / "csrc" / CU).read_text()
    out = _build.BUILD_DIR / "k3_ablation"
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: edit does not apply")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / CU).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / CU)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        k3._kernel(lib)
        libs[name] = lib
    return libs


def call(lib, th, r, prec, m_inv, eps, n_steps):
    c, d = th.shape
    outs = (torch.empty_like(th), torch.empty_like(r),
            torch.empty(c, device=th.device), torch.empty(c, device=th.device))
    err = lib.fused_leapfrog_f32(
        th.data_ptr(), r.data_ptr(), prec.data_ptr(), m_inv.data_ptr(),
        float(eps), int(n_steps), c, d, *(o.data_ptr() for o in outs),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return outs


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
        sys.exit("k3_ablation: no CUDA device; this script runs on the card")
    import chip_smoke as cs
    from advancedhmc_torch.ops import fused_leapfrog as k3

    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(3)
    inputs = []
    for c, d, n_steps, eps in cs.K3_SHAPES:
        th = torch.randn(c, d, generator=gen, device="cuda")
        r = torch.randn(c, d, generator=gen, device="cuda")
        prec = torch.linspace(0.5, 2.0, d, device="cuda")
        m_inv = torch.linspace(0.8, 1.2, d, device="cuda")
        args = (th, r, prec, m_inv, eps, n_steps)
        inputs.append((c, d, n_steps, args,
                       k3.reference_gaussian_leapfrog(*args)))
    times = {}
    for name, lib in libs.items():
        for c, d, n_steps, args, ref in inputs:
            out = call(lib, *args)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
            ms = graph_ms(lambda: call(lib, *args))
            times.setdefault(name, {})[f"{c}x{d}x{n_steps}"] = ms
            print(f"# {name} C={c} D={d} L={n_steps}: {ms:.4f} ms, max|Δ| "
                  f"{err:.3e}, bound {cs.k3_bound_ms(c, d, n_steps)[0]:.5f} "
                  "ms", flush=True)
    c, d, _, eps = cs.K3_SHAPES[2]
    th = torch.randn(c, d, generator=gen, device="cuda")
    r = torch.randn(c, d, generator=gen, device="cuda")
    prec = torch.linspace(0.5, 2.0, d, device="cuda")
    m_inv = torch.linspace(0.8, 1.2, d, device="cuda")
    for name in ("kernel", "unroll8"):
        for n_steps in (0, 25, 400, 1600):
            args = (th, r, prec, m_inv, eps, n_steps)
            ms = graph_ms(lambda: call(libs[name], *args))
            times[name][f"{c}x{d}x{n_steps}"] = ms
            print(f"# {name} C={c} D={d} L={n_steps}: {ms:.4f} ms, "
                  f"{2 * (2 * n_steps + 1) * c * d / ms / 1e9:.1f} TFLOP/s "
                  "of FMAs", flush=True)
    print(cs.gpu_line())
    print(json.dumps(times))


if __name__ == "__main__":
    main()

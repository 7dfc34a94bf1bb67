#!/usr/bin/env python3
"""Where K1's time goes on the card: variants of the kernel, each with one
part of the warp tile taken out or changed, timed beside the real one.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/k1_ablation.py

Each variant is a copy of `advancedhmc_torch/csrc/fused_logistic.cu` and
`csrc/logistic_tile.cuh` with one text edit (the script fails if an edit no
longer applies). All variants build in parallel with the port's
nvcc flags into `advancedhmc_torch/_build/k1_ablation/`. Each is timed with
CUDA events over 20 calls, twice, at the draw phase's 32768 chains and the
warmup pool's 4096 (the 100-D model over 1000 rows), and compared with
float64. Variants other than `kernel` and `cvt_split` compute something
else: their times bound what that part costs, their errors are not K1's.

  kernel     the kernel as it is
  cvt_split  the TF32 rounding by `cvt.rna.tf32.f32` instead of integer ops
  no_split   operands passed to the tensor cores unsplit (one product's
             worth of rounding, still three mma)
  one_mma    one TF32 mma per product instead of three
  cheap_epi  the epilogue without exp, log1p and the division
  one_chain  each product one accumulation chain through all of n (the
             tensor cores' truncating adds: the accuracy the short chains buy)
  three_per_sm  three resident blocks per SM (168 registers) instead of four

Beside them it measures the rate of `mma.sync.m16n8k8` in TF32 alone: a
probe kernel in which every warp of 132 x 16 blocks runs 8 independent
accumulator chains of 4096 mma on register operands (2048 operations each).

Prints one line per variant and shape, the probe's rate, the card's name
and power limit, and last a JSON object with the times.
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

H, CU = "logistic_tile.cuh", "fused_logistic.cu"
EDITS = {   # variant: [(file, old text, new text)]
    "kernel": [],
    "cvt_split": [(H,
        "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
        '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : '
        '"f"(v));\n  return r;')],
    "no_split": [(H,
        "  hi = to_tf32(v);\n  lo = to_tf32(v - __uint_as_float(hi));",
        "  hi = __float_as_uint(v);\n  lo = hi;")],
    "one_mma": [(H,
        "  mma_tf32(d, a_lo, b_hi);\n  mma_tf32(d, a_hi, b_lo);\n", "")],
    "cheap_epi": [(H,
        "  const float e = expf(-fabsf(l));\n"
        "  const float softplus = fmaxf(l, 0.f) + log1pf(e);\n"
        "  const float inv = 1.f / (1.f + e);\n"
        "  const float sig = l >= 0.f ? inv : e * inv;",
        "  const float softplus = l;\n  const float sig = 0.25f * l;")],
    "one_chain": [
        (H, "mma_3xtf32(d[j], a_hi[q], a_lo[q], b_hi, b_lo);",
         "mma_3xtf32(logit[j], a_hi[q], a_lo[q], b_hi, b_lo);"),
        (H, "mma_3xtf32(d[nt], r_hi[j], r_lo[j], b_hi, b_lo);",
         "mma_3xtf32(grad[nt], r_hi[j], r_lo[j], b_hi, b_lo);")],
    "three_per_sm": [(CU, "__launch_bounds__(kThreads, 4)",
                      "__launch_bounds__(kThreads, 3)")],
}
N_ROWS, DIM = 1000, 100
CHAINS = (32768, 4096)
PEAK_TF32_FLOPS = 495e12      # H100 SXM, dense, 700 W (NVIDIA data sheet)

MMA_PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void probe(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f800000u + threadIdx.x * 3 + i;
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run_probe(float* out, int blocks, int threads, int iters,
                         void* stream) {
  probe<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
PROBE_BLOCKS, PROBE_THREADS, PROBE_ITERS = 132 * 16, 128, 512


def build_all():
    from advancedhmc_torch.ops import _build
    from advancedhmc_torch.ops import fused_logistic as k1

    csrc = ROOT / "advancedhmc_torch" / "csrc"
    out = _build.BUILD_DIR / "k1_ablation"
    procs = {}
    for name, edits in EDITS.items():
        texts = {f: (csrc / f).read_text() for f in (H, CU)}
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
             str(d / "fused_logistic.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (out / "mma_probe.cu").write_text(MMA_PROBE)
    (out / "mma_probe").mkdir(parents=True, exist_ok=True)
    procs["mma_probe"] = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out / "mma_probe" / "lib.so"), str(out / "mma_probe.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        if name == "mma_probe":
            lib.run_probe.argtypes = [ctypes.c_void_p] + [
                ctypes.c_int] * 3 + [ctypes.c_void_p]
        else:
            k1._kernel(lib)     # the entry's argument types
        libs[name] = lib
    return libs


def mma_rate(lib):
    """TF32 operations per second of mma.sync alone (the probe)."""
    out = torch.empty(PROBE_BLOCKS * PROBE_THREADS, device="cuda")

    def run():
        err = lib.run_probe(out.data_ptr(), PROBE_BLOCKS, PROBE_THREADS,
                            PROBE_ITERS,
                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"probe launch failed with CUDA error {err}")

    ms = cuda_ms(run, reps=10)
    mmas = PROBE_BLOCKS * PROBE_THREADS // 32 * PROBE_ITERS * 8
    return ms, 2048.0 * mmas / (ms * 1e-3)


def call(lib, theta, x, y):
    c, dim = theta.shape
    lp = torch.empty(c, device="cuda")
    grad = torch.empty(c, dim, device="cuda")
    err = lib.fused_logistic_value_grad_f32(
        theta.data_ptr(), x.data_ptr(), y.data_ptr(), lp.data_ptr(),
        grad.data_ptr(), c, dim, x.shape[0], 0, 0, 0, 0.0, None, None,
        torch.cuda.current_stream().cuda_stream,
        ctypes.byref(ctypes.c_int()))
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return lp, grad


def cuda_ms(fn, reps=20):
    for _ in range(3):
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
        sys.exit("k1_ablation: no CUDA device; this script runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from advancedhmc_torch.models.logistic import _synthetic_data
    from advancedhmc_torch.ops.fused_logistic import \
        plain_logistic_value_grad

    libs = build_all()
    probe = libs.pop("mma_probe")
    x_np, y_np = _synthetic_data(N_ROWS, DIM - 1)
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = {}
    for c in CHAINS:
        theta = 0.3 * torch.randn(c, DIM, generator=gen, device="cuda")
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
            result[f"{name} C={c}"] = dict(ms=ms, grad_err64=err_g,
                                           lp_err64=err_lp, same_bits=same)
            print(f"# C={c} {name:10s} {ms[0]:.4f} {ms[1]:.4f} ms, vs "
                  f"float64 grad {err_g:.3e} lp {err_lp:.3e}, same bits as "
                  f"the kernel {same}", flush=True)
    probe_ms, rate = mma_rate(probe)
    result["mma_probe"] = dict(ms=probe_ms, tflops=rate / 1e12,
                               share_of_peak=rate / PEAK_TF32_FLOPS)
    print(f"# mma.sync m16n8k8 TF32 alone: {rate / 1e12:.1f} TFLOP/s, "
          f"{rate / PEAK_TF32_FLOPS:.3f} of the dense TF32 peak", flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(gpu)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "variants": result}))


if __name__ == "__main__":
    main()

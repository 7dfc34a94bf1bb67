#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`advancedhmc_torch`).

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build the CUDA kernels from `advancedhmc_torch/csrc/` with nvcc (sm_90a);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and at ragged shapes, and time both;
3. drive the main path through `advancedhmc_torch.sample`: NUTS
   (multinomial, generalised no-U-turn, max_depth 6, diagonal metric) on the
   100-D hierarchical logistic over 1000 rows, Stan cross-chain warmup
   (δ 0.55, κ 0.8, 128 iterations in blocks of 8, gradient-seeded M⁻¹) on a
   4096-chain pool fanned out to 32768 chains, 32 decorrelation transitions,
   then 256 fused draws (16 per call), with every kernel's launch count set
   to 0 just before and read just after;
4. check the results: finite draws of the expected shape, divergence,
   acceptance and posterior-moment gates;
5. profile one fused draw call (device time by kernel, idle share).

It prints the main path's results as one JSON line, the kernels' line
(`{"kernels": [...]}`), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

# The 100-D posterior as the JAX package sampled it on a TPU v5e (BENCH_r05):
# mean log σ, sd log σ, |mean β|. The TPU demoted the design matrix to bf16
# inside its matmuls, which perturbs the posterior by more than the Monte
# Carlo error of 32768 × 256 draws, so the bands are wider than MCSE.
REF_MEAN_LOGSIGMA, REF_SD_LOGSIGMA, REF_BETA_NORM = -0.7101, 0.10823, 4.71274
TOL_MEAN_LOGSIGMA, TOL_SD_REL, TOL_BETA_NORM = 0.03, 0.20, 0.1
DELTA = 0.55

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): float32 on
# the CUDA cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

N_ROWS, DIM = 1000, 100
N_CHAINS, WARMUP_CHAINS = 32768, 4096
N_WARMUP, WARMUP_BLOCK, N_DECOR = 128, 8, 32
N_DRAWS, FUSE, MAX_DEPTH = 256, 16, 6
ESS_CHAINS = 512


def log(msg):
    print(msg, flush=True)


def require_cuda():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of one call of `fn`, over `reps` calls after a
    warm-up, from CUDA events."""
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


# ------------------------------------------------------------------ phase 1
def phase_build():
    from advancedhmc_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build(*_build.SOURCES)
    log(f"# build: {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        report = path.with_name(path.name + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"#   {name}: {line.strip()}")


# ------------------------------------------------------------------ phase 2
def k1_bound_ms(c, dim, n):
    """Least time for one K1 call: the larger of the float32 operations of
    the two products (4·C·p·n) over the CUDA-core peak and the bytes of θ,
    x, y in and lp, grad out over the memory rate."""
    p = dim - 1
    flops = 4.0 * c * p * n
    nbytes = 4.0 * (c * dim + n * p + n + c + c * dim)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_k1():
    """K1 against its plain version on the card; returns its timing rows."""
    from advancedhmc_torch.models.logistic import _synthetic_data
    from advancedhmc_torch.ops import fused_logistic as k1

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst = [], 0.0
    # (chains, n): the draw phase, the warmup pool, the step-size search
    # (one chain) and a ragged chain count on a ragged row count
    for c, n, timed in ((N_CHAINS, N_ROWS, True),
                        (WARMUP_CHAINS, N_ROWS, True),
                        (1, 300, False), (13, 300, False)):
        x_np, y_np = _synthetic_data(n, DIM - 1)
        x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
        y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
        theta = 0.3 * torch.randn(c, DIM, generator=gen, device="cuda")
        lp, g = k1.logistic_value_grad(theta, x, y)
        lp_p, g_p = k1.plain_logistic_value_grad(theta, x, y)
        # float64 reference of the same inputs, for the kernel's true error
        lp_64, g_64 = k1.plain_logistic_value_grad(
            theta.double(), x.double(), y.double())
        torch.cuda.synchronize()
        if lp.shape != (c,) or g.shape != (c, DIM):
            raise RuntimeError(f"K1 shapes {tuple(lp.shape)}, "
                               f"{tuple(g.shape)} at C={c}")
        # float32 sums over n rows in another order than cuBLAS: hold both
        # outputs to 1e-4 of their largest magnitude
        err_g = float((g - g_p).abs().max())
        err_lp = float((lp - lp_p).abs().max())
        tol_g = 1e-4 * float(g_p.abs().max())
        tol_lp = 1e-4 * max(1.0, float(lp_p.abs().max()))
        err64 = float((g.double() - g_64).abs().max())
        ok = (bool(torch.isfinite(lp).all() and torch.isfinite(g).all())
              and err_g <= tol_g and err_lp <= tol_lp
              and bool((g[:, 0] == 0).all()))
        log(f"# K1 C={c} n={n}: max|Δgrad| {err_g:.3e} (tol {tol_g:.3e}), "
            f"max|Δlp| {err_lp:.3e} (tol {tol_lp:.3e}), vs float64 "
            f"{err64:.3e}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"K1 disagrees with its plain version at C={c}")
        worst = max(worst, err_g, err_lp)
        if timed:
            reps = 20 if c >= N_CHAINS else 50
            ms = cuda_ms(lambda: k1.logistic_value_grad(theta, x, y), reps)
            plain_ms = cuda_ms(
                lambda: k1.plain_logistic_value_grad(theta, x, y), reps)
            bound_ms, bound_by = k1_bound_ms(c, DIM, n)
            rows.append(dict(chains=c, n=n, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            log(f"# K1 C={c}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by})")
    return rows, worst


# ------------------------------------------------------------------ phase 3
def main_path_spec():
    import advancedhmc_torch as ah

    target = ah.hierarchical_logistic(n=N_ROWS, p=DIM - 1,
                                      dtype=torch.float32, device="cuda")
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.05, device="cuda")),
        ah.GeneralisedNoUTurn(max_depth=MAX_DEPTH)))
    adaptor = ah.AdaptorConfig(
        kind="stan", da=ah.DualAveragingConfig(delta=DELTA, kappa=0.8),
        init_buffer=75, term_buffer=50, window_size=25)
    return target, kernel, adaptor


def phase_main(seed):
    import numpy as np

    import advancedhmc_torch as ah
    from advancedhmc_torch.ops import fused_logistic as k1

    target, kernel, adaptor = main_path_spec()
    # starting points from numpy, as the tests make their inputs
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(size=(N_CHAINS, DIM)),
        dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    metric = ah.make_metric("diagonal", DIM, device="cuda")
    torch.cuda.synchronize()

    k1.logistic_value_grad.launches = 0
    t0 = time.perf_counter()
    res = ah.sample(
        gen, target, kernel, metric, theta0, N_WARMUP + N_DRAWS,
        n_adapts=N_WARMUP, adaptor=adaptor, init_mass_matrix="gradient",
        cross_chain=True, fuse_draws=FUSE, fuse_warmup=True,
        fuse_warmup_block=WARMUP_BLOCK, drop_warmup=True,
        warmup_chains=WARMUP_CHAINS, fanout_decorrelate=N_DECOR,
        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.logistic_value_grad.launches
    return res, launches, wall


# ------------------------------------------------------------------ phase 4
def phase_results(res, launches, wall, seed):
    from advancedhmc_torch.diagnostics import effective_sample_size

    th = res.thetas
    if tuple(th.shape) != (N_DRAWS, N_CHAINS, DIM):
        raise RuntimeError(f"draws have shape {tuple(th.shape)}")
    if not bool(torch.isfinite(th).all()):
        raise RuntimeError("non-finite draws")
    st = res.stats
    t_draw = res.timings["draws_s"]
    # bench.py's estimator: pooled bulk ESS of a 512-chain subsample, scaled
    # by C/512 (bench.py prints the unscaled median as median_pooled_ess)
    ess_512 = effective_sample_size(th[:, :ESS_CHAINS])
    ess = ess_512 * (N_CHAINS / ESS_CHAINS)
    median_ess = float(ess.quantile(0.5))   # numpy's median, as bench.py
    ls = th[:, :, 0].double()
    out = {
        "effective_samples_per_s_per_chip": median_ess / t_draw,
        "leapfrog_steps_per_s":
            float(st["n_steps"].double().sum()) / t_draw,
        "median_pooled_ess": median_ess,
        "median_pooled_ess_512": float(ess_512.quantile(0.5)),
        "ess_per_s_incl_warmup":
            median_ess / (res.timings["warmup_s"] + t_draw),
        "min_ess_per_s": float(ess.min()) / t_draw,
        "accept_mean": float(st["acceptance_rate"].double().mean()),
        "divergence_rate": float(st["numerical_error"].double().mean()),
        "mean_logsigma": float(ls.mean()),
        "sd_logsigma": float(ls.std(correction=0)),
        "mean_beta_norm":
            float(th[:, :, 1:].double().mean((0, 1)).norm()),
        "mean_tree_depth": float(st["tree_depth"].double().mean()),
        "step_size": float(res.final_state.adapt.da.eps),
        "init_s": res.timings["init_s"],
        "warmup_s": res.timings["warmup_s"],
        "draws_s": t_draw,
        "wall_s": wall,
        "k1_launches": launches,
        "seed": seed, "chains": N_CHAINS, "warmup_chains": WARMUP_CHAINS,
        "warmup": N_WARMUP, "draws": N_DRAWS, "fuse": FUSE,
        "device": torch.cuda.get_device_name(0),
    }
    log(json.dumps(out))
    gates = {
        "k1 launched": launches > 0,
        "divergence_rate <= 1e-3": out["divergence_rate"] <= 1e-3,
        f"|accept - {DELTA}| <= 0.1": abs(out["accept_mean"] - DELTA) <= 0.1,
        f"|mean_logsigma - ({REF_MEAN_LOGSIGMA})| <= {TOL_MEAN_LOGSIGMA}":
            abs(out["mean_logsigma"] - REF_MEAN_LOGSIGMA)
            <= TOL_MEAN_LOGSIGMA,
        f"sd_logsigma within {TOL_SD_REL:.0%} of {REF_SD_LOGSIGMA}":
            abs(out["sd_logsigma"] / REF_SD_LOGSIGMA - 1) <= TOL_SD_REL,
        f"|mean_beta_norm - {REF_BETA_NORM}| <= {TOL_BETA_NORM}":
            abs(out["mean_beta_norm"] - REF_BETA_NORM) <= TOL_BETA_NORM,
        "ESS finite": math.isfinite(median_ess) and median_ess > 0,
    }
    for name, ok in gates.items():
        log(f"# gate {name}: {'ok' if ok else 'FAIL'}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"main-path gates failed: {failed}")
    return out


# ------------------------------------------------------------------ phase 5
def phase_profile(res):
    """Device time by kernel over one fused draw call of 16 transitions on
    the final state, and the share of the wall the device was idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from advancedhmc_torch import SampleSpec, fused_draw_phase

    target, kernel, adaptor = main_path_spec()
    spec = SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                      cross_chain=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fused_draw_phase(gen, spec, res.final_state, FUSE, FUSE)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side kernel events only: an operator's entry repeats the time
    # of the kernels it launched
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        log("# profile: no device time recorded (not measured)")
        return
    rows.sort(key=lambda r: -r[1])
    log(f"# profile of one fused draw call: wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.1f} ms (sum of kernel times), idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for key, ms, count in rows[:12]:
        log(f"#   {ms:9.2f} ms {100 * ms / busy_ms:5.1f}%  x{count:<6d} "
            f"{key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the starting points and the sampler")
    args = ap.parse_args(argv)
    require_cuda()
    import advancedhmc_torch  # noqa: F401  (fails outside a checkout)
    gpu = gpu_line()
    log(f"# card: {gpu}")
    phase_build()
    k1_rows, k1_err = phase_k1()
    res, launches, wall = phase_main(args.seed)
    out = phase_results(res, launches, wall, args.seed)
    log(f"# main path: warmup {out['warmup_s']:.1f} s, draws "
        f"{out['draws_s']:.1f} s, K1 launches {launches}")
    phase_profile(res)

    draw_row = k1_rows[0]
    kernels = {"kernels": [{
        "name": "fused_logistic_value_grad",
        "route": "cuda",
        "source": "advancedhmc_torch/csrc/fused_logistic.cu",
        "replaces": "advancedhmc_tpu/ops/fused_logistic.py:53",
        "launches": launches,
        "max_abs_err": k1_err,
        "max_err": k1_err,
        "ms": draw_row["ms"],
        "kernel_ms": draw_row["ms"],
        "plain_ms": draw_row["plain_ms"],
        "bound_ms": draw_row["bound_ms"],
        "bound_by": draw_row["bound_by"],
        "library_ms": None,
        "shapes": k1_rows,
    }]}
    log(json.dumps(kernels))
    log(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

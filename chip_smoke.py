#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`advancedhmc_torch`).

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build the CUDA kernels from `advancedhmc_torch/csrc/` with nvcc (sm_90a):
   K1 (logistic value+grad), K2 (the NUTS megakernel), K3 (the Gaussian
   leapfrog); print each library's ptxas registers and spills;
2. hold K1 against its plain PyTorch version on the card, at the shapes the
   main path gives it and at ragged shapes, check that two calls give the
   same bits, print its registers, spills and shared memory per block, and
   time both; then K1's bfloat16-operand mode (`x_dtype="bfloat16"`) at
   the same chain counts: against the mode's float64 reference (its plain
   twin held to the same gate), two calls bitwise equal, one launch a
   call, timed beside its plain twin, cuBLAS's two bf16 products and its
   bound;
2b. hold K3 against its plain version at the four shapes of the Pallas
   microbenchmark, the JAX test's ragged one, the reference's GPU test
   (1000 chains × 5-D), a D that does not divide a block and a D longer
   than a block, check one launch a call and that two calls give the same
   bits, print each instance's registers and spills and each shape's
   launch, then time it at every shape (its path);
3. drive the main path through `advancedhmc_torch.sample`: NUTS on the
   leaf-pair body, as bench.py runs it (multinomial, generalised no-U-turn,
   max_depth 6, diagonal metric) on the
   100-D hierarchical logistic over 1000 rows, Stan cross-chain warmup
   (δ 0.55, κ 0.8, 128 iterations in blocks of 8, gradient-seeded M⁻¹) on a
   4096-chain pool fanned out to 32768 chains, 32 decorrelation transitions,
   then 256 fused draws (16 per call), with every kernel's launch count set
   to 0 just before and read just after, and the target's value+grad
   calls (each one K1 launch) tallied by chain count, and the leaf-loop
   iterations per transition;
3b. from phase 3's final state, the draw phase (32 draws) with the
   leaf-pair body on and off in turns (on, off, off, on): each run's wall,
   leaf-loop iterations per transition and ESS/s, each gated as phase 4;
4. check the results: finite draws of the expected shape, divergence,
   acceptance and posterior-moment gates;
5. profile one fused draw call (2 transitions) on the leaf-pair body inside
   `profiling.trace` (device time by kernel, idle share; the Chrome trace
   it writes must name K1's kernel), then 18d;
6. the megakernel draw phase: from phase 3's warmed state (ε, M⁻¹, the
   32768 positions), 16 calls of K2 with 16 transitions each, threading the
   positions, with divergence, moment and tree-depth gates (the first
   call's inputs also go through K2's plain version: timed, compared and
   gated on the share of chains that agree); it prints K2's registers and
   spills by instance, its chains and shared memory per block, resident
   blocks per SM, and the share of lock-step leaf iterations that some
   chain of the block needed;
7. hold K2 against its plain version: the logistic on 4096 warmed chains
   at max_depth 6 and 8, forced-deep trees (depth 6 of 6, 8 of 8), mostly
   divergent trees at 3ε, and the JAX megakernel test's Gaussian; each
   case also runs K2 twice and checks that the two give the same bits;
8. the default path of `advancedhmc_torch.sample`: per-chain Stan
   adaptation (δ 0.8, buffers 50/25/25, gradient-seeded M⁻¹) and one
   `sample_step` per iteration, on 4096 chains of the same model and NUTS,
   120 iterations of which 100 adapt, every other `sample` argument at its
   default; then 16 fused draws (8 per call) at each chain's own ε and
   M⁻¹ from its final state. Gated on finite draws, divergence,
   acceptance, the posterior moments, the per-chain ε (4096,) and M⁻¹
   (4096, 100), the fused draws' step size, and K1's launches (counted
   from 0 over the phase) against the target's value+grad calls;
9. the wide path: K1's wide kernel (p > 128) against float64 and its plain
   version at six shapes up to p = 2047, two calls bitwise equal, timed at
   the path's shapes beside its bound, its plain version and cuBLAS's two
   products; then `sample()` on the 1000-D hierarchical logistic (p = 999,
   n = 1000) at 1024 chains with the main path's NUTS and cross-chain
   warmup (128 iterations, the whole batch, no fan-out) and 32 fused
   draws (16 per call), with every kernel's launch count set to 0 just
   before and read just after. Gated on finite draws, divergence,
   acceptance, K1's calls against the target's value+grad calls and its
   launches against two a call (the wide path's two GEMMs), and
   the posterior moments against the JAX package's (scripts/
   wide_reference.py, four runs) within 4 combined MCSEs plus 3 standard
   deviations between the JAX runs; K1's bfloat16 mode is checked and
   timed as in phase 2 at the path's shapes (C = 1024 and 1, p = 999);
   9c: K1's Poisson-log link over the 64 × 64 log-Gaussian Cox process's
   factor L₀ (4096 × 4096, the lgcp64.chees cell), at its chain count
   and the step-size search's one chain, in float32 and bfloat16, held
   as in phase 2 with the other mode as the control, and timed beside the
   model's least time (hmcbench/roofline_cox.py);
10. the megakernel on the 1000-D model (K2's wide instance, p > 128): from
   phase 9's final state (ε, M⁻¹, the 1024 positions), K2 against its plain
   version on call 1's inputs, on forced-deep (ε/8, depth 6 of 6) and
   mostly divergent (3ε) trees of 256 warmed chains, at p = 129 and at
   p = 200 over n = 997 rows, each with a bitwise repeat; then four calls
   of 16 transitions with K2's launch count set to 0 just before and read
   just after, gated on finite draws, divergence, tree depth and launches;
   then the eager fused draws for 16 transitions from the same state,
   whose cross-chain moments at transition 16 must agree with K2's. It
   prints the wide instance's registers, spills, shared memory, blocks per
   SM, ranks (blocks) per cluster of 64 chains, blocks, the clusters the
   card holds at once and the SMs that held a block;
11. the JAX bench's own 1000-D configuration: phase 9's run with the design
   stored in bfloat16 (bench.py's default at dim ≥ 512), so K1 runs its
   bfloat16 mode at every leaf (its calls and launches counted from 0),
   gated by bench.py's bf16 posterior-equivalence gate (importance
   weights to the exact float64 posterior: sd(log w) ≤ 0.5, reweighting
   ESS fraction ≥ 0.5) and phase 9's divergence, acceptance and moment
   gates; its walls and ESS/s printed beside phase 9's;
12. the other options of `sample` at the 100-D model's width: (a) the
   per-chain fused warmup on 4096 chains (phase 8's settings) and fused
   draws thinned by 2, its walls and leaf iterations beside phase 8's;
   (b) phase 3's configuration with the three-phase depth-capped warmup
   and ε re-anchor, two chain chunks, bfloat16 U-turn stacks and online
   collection, 32 draws; (c) 8 coupled steps from (a)'s warmed state;
   each gated on divergence, acceptance and BENCH_r05's moments (b's from
   its online summary);
13. ChEES-HMC at the JAX bench's configuration (bench.py:915-1090 at its
   defaults): the 100-D logistic at 32768 chains, the gradient-seeded M⁻¹,
   ε0 from the search on chain 0, T0 4, δ 0.75, Stan windows 75/50/25, 256
   warmup iterations through `make_chees_step` and 256 draws through
   `make_chees_draw_step` (max_steps 64), every kernel's count set to 0
   just before and read just after; gated on finite draws, the
   numerical-error rate, acceptance, one step count for every chain at
   every iteration, the finalized T, the moments around BENCH_r05's ChEES
   values and K1's calls and launches against the target's value+grad
   calls; prints the walls, ESS/s (bench.py's estimator), leapfrog steps
   per second beside the JAX package's TPU v5e figures, and profiles one
   draw chunk of 16 iterations (K1's share of the device time, the idle
   share);
14. the static path through the constructors from phase 3's ε, M⁻¹ and
   4096 of its positions: HMC(ε, L ≈ 1/ε) with endpoint and with
   multinomial sampling, HMCDA(0.8, 1) with phase 3's M⁻¹ (150
   iterations, 100 adapting) and NUTS with the jittered leapfrog on the
   fused loop (32 draws, 8 a call), each gated on finite draws,
   divergence, acceptance, the moments and K1's launches.
15. the dense and rank-update metrics and the Welford-cov, low-rank and
   nutpie estimators at the same width, each run with every kernel's count
   set to 0 just before and read just after, K1's calls held to the
   target's value+grad calls and gated on finite draws, divergence,
   acceptance (15a–c: in [δ − 0.1, δ + 0.2], the band the JAX package's
   dual averaging leaves room for) and phase 4's moments: (a) the JAX
   bench's nutpie run (`AHMC_BENCH_MM_KIND=nutpie AHMC_BENCH_WARMUP=256`:
   phase 3 with the cross-chain warmup step by step, cut to 100
   iterations, 64 draws),
   gated on M⁻¹ having moved from the gradient seed and on the median of
   M⁻¹ over the draws' variance; (b) phase 3 with a dense metric and the
   Welford covariance from the identity, 100 warmup iterations in fused
   blocks of 2 and 64 draws, gated on M⁻¹'s symmetry, its
   Cholesky factor, its distance to the draws' covariance and the
   covariance of 2^18 momentum draws, its ESS/s printed beside phase 3's;
   (c) `NUTS(0.55, max_depth=6, metric="rank_update")` (the low-rank
   estimator at rank 8) on 1024 chains, 100 warmup iterations in fused
   blocks of 2, gated on a positive-definite M⁻¹
   and the momentum draws; (d) the per-chain fused warmup on 512 chains,
   with nutpie on the diagonal metric and with a per-chain dense metric
   (each chain's factor checked), 8 draws; (a)-(d) warm 100 iterations,
   one Stan window (buffers 50/25/25);
16. the classic and strict criteria, slice sampling and the model zoo, each
   run with every kernel's count set to 0 just before and read just after:
   (a) bench.py's `AHMC_BENCH_MODEL=logistic_nc` at its defaults (the
   non-centred hierarchy at phase 3's width, NUTS, schedule and chains; 150
   warmup iterations and 128 draws, not 256 + 256), its value+grad through
   K1 first held to its float64 and float32 analytic routes at C = 32768,
   4096 and 1, its draws mapped to (log σ, σ·β̃) and gated as phase 3
   (accept in phase 15's band); (b) phase 3's draw phase (32 draws) from
   its final state with classic + multinomial, strict + multinomial and
   generalised + slice, beside phase 3b's generalised runs; (c) phase 3's
   configuration with strict + slice in the warmup blocks too, 32 draws;
   (d) each new model's value+grad at 4096 chains against the port's
   float64 CPU path, then `NUTS(0.8, max_depth=4).sample` step by step on
   256 chains (40 + 20) of gdemo (against GDEMO_MEAN), a Gaussian mixture
   (its mean), eight schools and banana (finite, divergence share printed)
   and German credit (K1 narrow at p = 24; against the JAX package's
   posterior, `scripts/zoo_reference.py`);
17. bench.py's two last configurations at phase 3's width, each with
   every kernel's count set to 0 just before and read just after, K1's
   calls held to the target's value+grad calls: (a) `AHMC_BENCH_TCAP=4`:
   phase 3's configuration driven as bench.py drives it (`init_state`,
   `fused_warmup_phase_crosschain` with `transient_depth_caps`' schedule,
   `fanout_warmup_state`, `fused_draw_phase`), its walls and ε beside
   phase 3's, gated as phase 4 and on no capped warmup iteration deeper
   than the cap, 128 draws; (b) `AHMC_BENCH_RAGGED=1.5`: one
   `fused_draw_phase_ragged` call from phase 3's final state (t_min 128,
   t_max 192, the single-leaf body), bench.py's figures (draws a chain,
   `collected_vs_rect`, ESS/s from the ragged ESS of 512 chains) beside
   phase 3's ESS/s and phase 3b's single-body draws, gated on the counts,
   `is_accept` past them, the count-weighted moments, divergence,
   acceptance and the ragged ESS on the card within 1e-3 of the CPU's;
18. the relativistic kinetic energy, the Riemannian tier, checkpoints and
   profiling: (a) phase 3's configuration with
   `SampleSpec(kinetic=RelativisticKinetic(m=1, c=2))`, driven as 17a, 64
   draws, every kernel's count set to 0 just before and read just after,
   gated as phase 4 (acceptance in phase 15's band) with K1's calls held to
   the target's value+grad calls; (b) `riemannian.sample_rmhmc` (SoftAbs)
   on Neal's funnel (dim 10, σ_v 3) in float64 at 4096 chains started at
   exact draws, static (8 generalised leapfrog steps, 6 fixed-point
   iterations) and Riemannian NUTS (max_depth 5), dual averaging then
   draws, gated on E[v] = 0 and sd(v) = 3 within 5 MCSEs, its result
   through `SampleResult.save`/`checkpoint.load_result` bitwise; (c)
   SoftAbs RMHMC on the 100-D logistic in float32 from 256 of phase 3's
   final positions, one transition (K1 in every ∂H∂θ), K1's calls against
   the value+grad calls, one ∂H∂θ through K1 within 1e-4 of the float64
   route, finite energies, the time of one generalised leapfrog step beside
   the Hessian, ∂G, the batched `eigh` and K1, and the peak device memory;
   (d) right after phase 5: phase 3's final state and generator through
   `checkpoint.save_state`/`load_state` into a zeroed state and a new
   generator, 16 fused draws from each bitwise equal, and
   `profiling.throughput_report` on phase 3's result equal to phase 4's
   leapfrog steps/s to 1e-9;
19. chain parallelism, the program cache and the fused loop's last
   options: (a) right after phase 4, phase 3 exactly through `sample(mesh=
   parallel.mesh_of_all_devices())` in a one-rank NCCL group, its draws,
   stats, ε and M⁻¹ bitwise phase 3's (compared by digests of their bits)
   and K1's launches and calls by chain count equal; (b) two ranks
   sharing the card under gloo (this script started twice with
   `--mesh-worker`), phase 3's configuration at 4096 chains (warming 1024,
   64 iterations in blocks of 4, 4 decorrelation, 16 draws) against the
   same run in this process, after K1 is held at C and at C/2 on the same
   rows: bitwise where K1's bits do not depend on the chain count, else ε,
   acceptance and mean log σ within stated bands; (c) and (d) run while
   (b)'s ranks run: (c) `aot_program` on one fused cross-chain warmup
   block of phase 3's configuration at 1024 chains, "trace" then "cache",
   both calls bitwise the block's, the manifest naming K1's library; (d)
   one fused draw call from phase 3's state on the 100-D model with a
   float16 design (K1's float16 mode at every leaf), the draws in a
   bfloat16 buffer, `stage_slots` (taken, a no-op in the port) and
   `unroll` 2, against the same call at the defaults but the buffer: the
   same bits.
K1's float16-operand mode (`x_dtype="float16"`) is checked and timed in
phases 2 and 9a as its bfloat16 mode is.

Kernel times are device times: a CUDA graph of 20-50 launches replayed
between CUDA events, so that the wrapper's host cost is not in them; the
back-to-back time through the wrapper is printed beside as `wrapper_ms`.

After each phase it prints the time since the start (`# clock:`). It
prints the main path's results as one JSON line, the kernels' line
(`{"kernels": [...]}`), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
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
# the CUDA cores, TF32 on the tensor cores (dense), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

N_ROWS, DIM = 1000, 100
N_CHAINS, WARMUP_CHAINS = 32768, 4096
N_WARMUP, WARMUP_BLOCK, N_DECOR = 128, 8, 32
N_DRAWS, FUSE, MAX_DEPTH = 256, 16, 6
PAIR = True        # bench.py's AHMC_BENCH_PAIR default: the leaf-pair body
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


def wrapper_ms(fn, reps):
    """Mean time of one call of `fn` issued back to back, over `reps` calls
    after a warm-up, from CUDA events: where the wrapper's host cost (output
    allocation, input checks, the ctypes call) exceeds the kernel, this is
    the host's time, not the device's."""
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


def device_ms(fn, reps, replays=3):
    """Mean device time of one call of `fn`: `reps` calls captured once in a
    CUDA graph (their outputs allocated once, in the graph's pool), the
    graph replayed `replays` times between CUDA events. The host issues one
    replay, so its cost per call is not in the time. The launch counts end
    as they were: capture records the kernels without launching them, and
    the replays launch them without passing the wrappers."""
    counts = read_launches()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: the wrappers' per-launch attribute and occupancy queries are
    # not stream work and stay out of the graph
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    for name, wrapper, attr in _counters():
        setattr(wrapper, attr, counts[name])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def _counters():
    """(name, wrapper, attribute) of every kernel's launch count, and of
    K1's count of calls (the wide path launches two kernels a call)."""
    from advancedhmc_torch.ops import fused_leapfrog, fused_logistic, \
        fused_nuts_kernel

    k1 = fused_logistic.logistic_value_grad
    return (("fused_logistic_value_grad", k1, "launches"),
            (K1_CALLS, k1, "calls"),
            (K1_BF16, k1, "bf16_launches"),
            (K1_BF16_CALLS, k1, "bf16_calls"),
            (K1_F16, k1, "f16_launches"),
            (K1_F16_CALLS, k1, "f16_calls"),
            ("fused_nuts", fused_nuts_kernel.fused_nuts, "launches"),
            ("fused_gaussian_leapfrog",
             fused_leapfrog.fused_gaussian_leapfrog, "launches"))


K1_CALLS = "fused_logistic_value_grad calls"
# K1's bfloat16-operand mode (`x_dtype="bfloat16"`), counted apart as well
K1_BF16 = "fused_logistic_value_grad (bfloat16 operands)"
K1_BF16_CALLS = K1_BF16 + " calls"
# and its float16-operand mode (`x_dtype="float16"`)
K1_F16 = "fused_logistic_value_grad (float16 operands)"
K1_F16_CALLS = K1_F16 + " calls"


def k1_operand_dtype(mode):
    """The dtype K1's `mode` rounds its operands to (float32: none)."""
    from advancedhmc_torch.ops import fused_logistic as k1

    return k1._ROUNDING[mode][0] or torch.float32


def k1_control_mode(mode):
    """The mode whose kernel must fail `mode`'s gate (check_k1): float32's
    and float16's is bfloat16's, bfloat16's float32's."""
    from advancedhmc_torch.ops import fused_logistic as k1

    return k1.MODE_F32 if mode == k1.MODE_BF16 else k1.MODE_BF16


def k1_counter_keys(mode):
    """The launch and call counters of K1's `mode` (read_launches)."""
    from advancedhmc_torch.ops import fused_logistic as k1

    return {k1.MODE_BF16: (K1_BF16, K1_BF16_CALLS),
            k1.MODE_F16: (K1_F16, K1_F16_CALLS)}.get(
        mode, ("fused_logistic_value_grad", K1_CALLS))


def reset_launches():
    """Set every kernel's launch count, and K1's calls, to 0 (just before
    a path runs)."""
    for _, wrapper, attr in _counters():
        setattr(wrapper, attr, 0)


def read_launches():
    """Every kernel's launch count, and K1's calls (just after a path
    ran)."""
    torch.cuda.synchronize()
    return {name: getattr(wrapper, attr)
            for name, wrapper, attr in _counters()}


# ------------------------------------------------------------------ phase 1
def phase_build():
    import re

    from advancedhmc_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build(*_build.SOURCES)
    log(f"# build: {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        report = path.with_name(path.name + ".log")
        if not report.exists():
            continue
        text = report.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        log(f"#   {name}: {len(regs)} kernel(s), {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, {spills} bytes of spills "
            "(ptxas)")


# ------------------------------------------------------------------ phase 2
def launches_a_call(fn):
    """The kernel launches one call of `fn` issues: the launch calls among
    the CUDA runtime and driver events of a torch.profiler session (CUDA
    activity), or None where it recorded none. Counted from the launch
    events, not from the kernel records: a session that follows others in
    a process can lose kernel records while it keeps every launch
    (ROADMAP §3, F5)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "LaunchKernel" in str(e.get("name")) for e in events) \
        or None


def time_k1(theta, x, y, design, mode):
    """K1's timing row at one shape in `mode`. The kernel is the call the
    main path runs, the hierarchical model's value+grad with the prior
    folded in: its device time (a CUDA graph of its launches), the
    wrapper's back-to-back time and its launches a call. Beside it, device
    times of the likelihood alone (the call without the prior) and of the
    route before the prior was folded in (the likelihood call, then
    `hierarchical_prior` and the two sums in PyTorch; with its launches a
    call), the plain version's (prior included), cuBLAS doing the two
    products alone (logits = β·xᵀ, grad = r·x; a yardstick the port never
    calls) on the mode's operand type (float32, bfloat16 in MODE_BF16,
    float16 in MODE_F16), and the bound. Above p = 128 `design` is x's
    prepared WideDesign."""
    from advancedhmc_torch.ops import fused_logistic as k1

    (c, dim), n = theta.shape, x.shape[0]
    reps = 20 if c * dim >= N_CHAINS * DIM else 50
    dt = k1_operand_dtype(mode)
    beta, xo = theta[:, 1:].contiguous().to(dt), x.to(dt)
    resid = torch.rand(c, n, device=theta.device).to(dt)

    def kernel():
        return k1.logistic_value_grad(theta, x, y, design, mode, prior=True)

    def likelihood():
        return k1.logistic_value_grad(theta, x, y, design, mode)

    def unfused():
        lp_pri, g_pri = k1.hierarchical_prior(theta, dim - 1)
        lp, g = likelihood()
        return lp_pri + lp, g_pri + g

    row = dict(
        chains=c, dim=dim, n=n, mode=mode,
        ms=device_ms(kernel, reps),
        wrapper_ms=wrapper_ms(kernel, reps),
        launches=launches_a_call(kernel),
        likelihood_ms=device_ms(likelihood, reps),
        unfused_ms=device_ms(unfused, reps),
        unfused_launches=launches_a_call(unfused),
        plain_ms=device_ms(lambda: k1.plain_logistic_value_grad(
            theta, x, y, mode, prior=True), reps),
        cublas_ms=device_ms(lambda: (beta @ xo.T, resid @ xo), reps))
    row["bound_ms"], row["bound_by"], side = k1_bound_ms(c, dim, n, mode)
    row.update(side)
    (side_name, side_ms), = side.items()
    log(f"# K1 mode {mode} C={c} dim={dim} n={n}: kernel with the prior "
        f"{row['ms']:.4f} ms on the device, {row['launches']} launches a call "
        f"({row['wrapper_ms']:.4f} ms back to back through the wrapper); "
        f"the likelihood alone {row['likelihood_ms']:.4f} ms; the unfused "
        f"route (likelihood, prior and sums in PyTorch) "
        f"{row['unfused_ms']:.4f} ms, {row['unfused_launches']} launches a "
        f"call; plain {row['plain_ms']:.4f} ms, cuBLAS's two {dt} products "
        f"{row['cublas_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}; {side_name} {side_ms:.4f} ms)")
    return row


def k1_bound_ms(c, dim, n, mode):
    """Least time for one K1 call in `mode`: the larger of its operations
    over the peak of their type and the bytes of θ, x, y in and lp, grad
    out over the memory rate. At float32 accuracy the operations are
    3xTF32 (three TF32 products for each of the two, 3·4·C·p·n) at the
    TF32 peak. In MODE_BF16 (MODE_F16) the function is two products of
    bfloat16 (float16) operands summed in float32: 4·C·p·n operations at
    the bf16 (fp16, the same) peak, with x read in 2 bytes. Also returns one
    side figure by name: in float32 the CUDA-core bound (4·C·p·n at the
    float32 peak), the bound before the kernel used the tensor cores; in
    the 2-byte modes the one TF32 pass of each product that the kernels
    run, with x in float32, the bound of the kernels as written (the
    design kept in float32)."""
    p = dim - 1
    flops = 4.0 * c * p * n
    nbytes = 4.0 * (c * dim + n * p + n + c + c * dim)
    if k1_operand_dtype(mode) != torch.float32:
        t_ops = flops / PEAK_BF16_FLOPS
        t_bytes = (nbytes - 2.0 * n * p) / PEAK_BYTES
        side = {"bound_ms_one_tf32_pass": 1e3 * max(
            flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES)}
    else:
        t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
        side = {"bound_ms_f32_cuda_cores": 1e3 * max(
            flops / PEAK_F32_FLOPS, t_bytes)}
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", side)


def check_k1(theta, x, y, design, mode, control_design, prior=False,
             link="logistic", offset=0.0):
    """K1 in `mode` under `link` (offset c = `offset` for the Poisson-log
    link) at one shape on the card: finite outputs of the right
    shape (without the prior a zero column 0), two calls bitwise equal (no
    atomics), one call counted with its launches (one up to p = 128, two
    above), and the kernel held to the mode's float64 reference (its
    roundings, exact sums; `ops.fused_logistic.rounding_reference`, plus
    the float64 `hierarchical_prior` at the unrounded θ where `prior` is
    on) and to its plain twin, the plain twin to the reference, each to
    1e-4 of the largest magnitude (float32 sums in other orders): of
    column 0 and of the other columns apart, since the prior's ∂/∂log σ
    (≈ −p) would otherwise set the scale of the likelihood's columns. In MODE_BF16 (MODE_F16) the gradient's
    gate adds, per element, what the residual's rounding to bfloat16
    (float16) can move where a logit error of 2^-14 carries a residual
    across a rounding midpoint (two float32 evaluations can round it to
    neighbouring values: one step times |x|); in MODE_F32 that allowance is
    zero. The negative control: the kernel in `k1_control_mode` on the same
    inputs
    (`control_design` laid out in that mode above p = 128) must fail the
    gate. Returns (launches a call, largest difference from the plain
    twin)."""
    from advancedhmc_torch.ops import fused_logistic as k1

    c, dim = theta.shape
    other = k1_control_mode(mode)
    launch_key, call_key = k1_counter_keys(mode)
    before = read_launches()
    kw = dict(link=link, offset=offset)
    lp, g = k1.logistic_value_grad(theta, x, y, design, mode, prior, **kw)
    after = read_launches()
    lp2, g2 = k1.logistic_value_grad(theta, x, y, design, mode, prior, **kw)
    lp_c, g_c = k1.logistic_value_grad(theta, x, y, control_design, other,
                                       prior, **kw)
    lp_p, g_p = k1.plain_logistic_value_grad(theta, x, y, mode, prior, **kw)
    lp_r, g_r, allow, n_near = k1.rounding_reference(theta, x, y, mode,
                                                     **kw)
    if prior:
        lp_pri, g_pri = k1.hierarchical_prior(theta.double(), dim - 1)
        lp_r, g_r = lp_r + lp_pri, g_r + g_pri
    torch.cuda.synchronize()
    per_call = after[launch_key] - before[launch_key]
    # column 0's scale and the other columns' (one row, broadcast); without
    # the prior column 0 is held to exactly 0 below instead
    tol_g = 1e-4 * torch.cat([g_r[:, :1].abs().max().reshape(1),
                              g_r[:, 1:].abs().max().expand(dim - 1)])
    tol_lp = 1e-4 * max(1.0, float(lp_r.abs().max()))
    cols = slice(0 if prior else 1, None)

    def excess(gg, ll, g_to=g_r, lp_to=lp_r):
        """How far (grad, lp) exceed the gate against (g_to, lp_to)."""
        return (float(((gg.double() - g_to.double()).abs() - allow
                       - tol_g)[:, cols].max()),
                float((ll.double() - lp_to.double()).abs().max()) - tol_lp)

    ex_k, ex_p, ex_kp = excess(g, lp), excess(g_p, lp_p), \
        excess(g, lp, g_p, lp_p)
    ex_c = excess(g_c, lp_c)
    err = max(float((g - g_p).abs().max()), float((lp - lp_p).abs().max()))
    same = torch.equal(lp, lp2) and torch.equal(g, g2)
    ok = (lp.shape == (c,) and g.shape == (c, dim)
          and bool(torch.isfinite(lp).all() and torch.isfinite(g).all())
          and max(ex_k + ex_p + ex_kp) <= 0 and max(ex_c) > 0 and same
          and (prior or bool((g[:, 0] == 0).all()))
          and per_call == (1 if dim <= 129 else 2)
          and after[call_key] - before[call_key] == 1)
    log(f"# K1 mode {mode} link {link} C={c} p={dim - 1} n={x.shape[0]}"
        f"{' with the prior' if prior else ''}: vs the mode's float64 "
        f"reference max(|Δgrad| - allowance - tol) {ex_k[0]:.3e} (tol "
        f"{float(tol_g[0]):.3e} in column 0, {float(tol_g[-1]):.3e} "
        f"beyond; plain twin {ex_p[0]:.3e}; {n_near} residuals near a "
        f"rounding midpoint), max|Δlp| {ex_k[1] + tol_lp:.3e} (tol "
        f"{tol_lp:.3e}), vs the plain twin {err:.3e} (less the allowance "
        f"and tol {ex_kp[0]:.3e}), two calls "
        f"bitwise equal {same}, {per_call} launches a call; the kernel in "
        f"mode {other} exceeds the gate by {ex_c[0]:.3e} (grad), "
        f"{ex_c[1]:.3e} (lp), which must be > 0: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"K1 in mode {mode} disagrees with its reference "
                           f"at C={c}, p={dim - 1}, prior {prior}, link "
                           f"{link}")
    return per_call, err


def ptxas_instances(lib_name, k_steps_pattern):
    """(p bound, registers, spill-store bytes, mangled name) of each kernel
    in a library's ptxas report; the p bound is 8 × the k-steps that
    `k_steps_pattern` finds in the kernel's mangled name, or None."""
    import re

    from advancedhmc_torch.ops import _build

    path = _build.library_path(lib_name)
    text = path.with_name(path.name + ".log").read_text()
    for entry in text.split("Compiling entry function")[1:]:
        name = entry.split("\n")[0]
        ks = re.search(k_steps_pattern, name)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        if regs and spill:
            yield (8 * int(ks.group(1)) if ks else None, regs.group(1),
                   spill.group(1), name)


def k1_report():
    """K1's registers and spills by instance (ptxas), and its shared memory
    per block, resident blocks per SM and blocks per cluster at the main
    path's shapes."""
    import ctypes
    import re

    from advancedhmc_torch.ops import _build
    from advancedhmc_torch.ops import fused_logistic as k1

    lib = _build.load("fused_logistic")
    k1._kernel(lib)
    for p_max, regs, spill, name in ptxas_instances(
            "fused_logistic", r"fused_logistic_kernelILi(\d+)E"):
        if p_max:       # the wide path's kernels: k1_wide_report
            mode = re.search(
                r"fused_logistic_kernelILi\d+ELi(\d)ELi(\d)E", name)
            log(f"# K1 instance p <= {p_max}, mode {mode.group(1)}, link "
                f"{mode.group(2)}: {regs} registers, {spill} bytes of spill "
                "stores (ptxas)")
    per_sm, split = ctypes.c_int(), ctypes.c_int()
    for c in (N_CHAINS, WARMUP_CHAINS, 1):
        lib.fused_logistic_launch_shape(c, DIM, N_ROWS, k1.MODE_F32,
                                        ctypes.byref(per_sm),
                                        ctypes.byref(split))
        log(f"# K1 C={c} n={N_ROWS}: {lib.fused_logistic_smem_bytes(DIM)} "
            f"bytes of shared memory per block, {per_sm.value} blocks per "
            f"SM, {split.value} blocks per cluster")


def phase_k1(mode):
    """K1 in `mode` against its reference on the card (check_k1; at the
    timed shapes also with the model's prior folded in, the main path's
    call); returns its timing rows, the largest difference from its plain
    twin and the launches a call by timed chain count."""
    from advancedhmc_torch.models.logistic import _synthetic_data

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst, launched = [], 0.0, {}
    # (chains, n): the draw phase, the warmup pool, the step-size search
    # (one chain, timed over the main path's rows) and a ragged chain count
    # on a ragged row count
    for c, n, timed in ((N_CHAINS, N_ROWS, True),
                        (WARMUP_CHAINS, N_ROWS, True), (1, N_ROWS, True),
                        (1, 300, False), (13, 300, False)):
        x_np, y_np = _synthetic_data(n, DIM - 1)
        x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
        y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
        theta = 0.3 * torch.randn(c, DIM, generator=gen, device="cuda")
        per_call, err = check_k1(theta, x, y, None, mode, None)
        worst = max(worst, err)
        if timed:
            # the main path's call: the model's prior folded in
            per_call, err = check_k1(theta, x, y, None, mode, None, True)
            worst = max(worst, err)
            launched[c] = per_call
            rows.append(time_k1(theta, x, y, None, mode))
    return rows, worst, launched


# ----------------------------------------------------------------- phase 2b
# (chains, dims, steps, ε): scripts/microbench_pallas.py's four shapes,
# tests/test_pallas_ops.py's ragged case, the reference's GPU test (1000
# chains of a 5-D target), a D that does not divide a block, and a D longer
# than a block (a block a chain, in chunks)
K3_SHAPES = ((1024, 8, 100, 0.05), (4096, 128, 100, 0.05),
             (16384, 128, 100, 0.05), (65536, 8, 100, 0.05),
             (20, 5, 17, 0.12), (1000, 5, 100, 0.05), (333, 37, 50, 0.05),
             (64, 5000, 20, 0.05))
K3_TOL = 2e-5      # relative and absolute, as tests/test_pallas_ops.py


def k3_bound_ms(c, d, n_steps):
    """Least time for one K3 call: the function's least work, (2L + 1) FMAs
    an element (the half-kicks of consecutive steps merged) and the two
    energy terms (3 operations each), over the float32 CUDA-core peak,
    against θ, r, prec, m_inv in and θ′, r′, pot, kin out over the memory
    rate."""
    flops = c * d * (2.0 * (2 * n_steps + 1) + 6)
    nbytes = 4.0 * (4 * c * d + 2 * c + 2 * d)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_k3():
    """K3 against its plain version on the card, two calls bitwise equal,
    one launch a call; returns its timing rows, the largest error and the
    launches of the timed eager calls."""
    from advancedhmc_torch.ops import fused_leapfrog as k3

    # registers and spill stores of each instance, by elements a thread
    # (0: the long-chain kernel)
    import re

    ptxas = {}
    for _, regs, spill, name in ptxas_instances("fused_leapfrog", r"^$"):
        e = re.search(r"leapfrog_rowsILi(\d+)E", name)
        if e:
            ptxas[int(e.group(1))] = (int(regs), int(spill))
    log("# K3 instances (rows a task: registers, spill-store bytes; "
        f"ptxas): {ptxas}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases, worst = [], 0.0
    for c, d, n_steps, eps in K3_SHAPES:
        th = torch.randn(c, d, generator=gen, device="cuda")
        r = torch.randn(c, d, generator=gen, device="cuda")
        prec = torch.linspace(0.5, 2.0, d, device="cuda")
        m_inv = torch.linspace(0.8, 1.2, d, device="cuda")
        args = (th, r, prec, m_inv, eps, n_steps)
        before = k3.fused_gaussian_leapfrog.launches
        out = k3.fused_gaussian_leapfrog(*args)
        one_launch = k3.fused_gaussian_leapfrog.launches == before + 1
        again = k3.fused_gaussian_leapfrog(*args)
        ref = k3.reference_gaussian_leapfrog(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        ok = one_launch and same and all(
            bool(torch.isfinite(a).all()) and bool(
                ((a - b).abs() <= K3_TOL + K3_TOL * b.abs()).all())
            for a, b in zip(out, ref))
        shape = k3.launch_shape(c, d)
        log(f"# K3 C={c} D={d} L={n_steps}: max|Δ| {err:.3e} (tol "
            f"{K3_TOL:g} abs + rel), two calls bitwise equal {same}, one "
            f"launch a call {one_launch}; launch {shape}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"K3 failed its checks at C={c}, D={d}")
        worst = max(worst, err)
        cases.append((c, d, n_steps, args, shape))

    rows = [dict(chains=c, dims=d, steps=n_steps, **shape, ms=device_ms(
        lambda: k3.fused_gaussian_leapfrog(*args), 20))
        for c, d, n_steps, args, shape in cases]
    # the microbenchmark's path: the kernel called eagerly through its
    # wrapper at every shape (3 + 20 calls each), with the launch counts
    # set to 0 just before and read just after
    reset_launches()
    for row, (c, d, n_steps, args, _) in zip(rows, cases):
        row["wrapper_ms"] = wrapper_ms(
            lambda: k3.fused_gaussian_leapfrog(*args), 20)
    launches = read_launches()
    for row, (c, d, n_steps, args, _) in zip(rows, cases):
        row["plain_ms"] = device_ms(
            lambda: k3.reference_gaussian_leapfrog(*args), 5, replays=1)
        row["bound_ms"], row["bound_by"] = k3_bound_ms(c, d, n_steps)
        row["registers"], row["spill_store_bytes"] = \
            ptxas[row["rows_per_task"]]
        log(f"# K3 C={c} D={d} L={n_steps}: kernel {row['ms']:.4f} ms on the "
            f"device ({row['wrapper_ms']:.4f} ms back to back through the "
            f"wrapper), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / row['ms']:.2f} of the bound")
    return rows, worst, launches["fused_gaussian_leapfrog"]


# ------------------------------------------------------------------ phase 3
def count_by_chains(target):
    """`target` with its value+grad calls tallied by chain count
    (θ.shape[0]); on the card each of them is one K1 call (one launch up
    to p = 128, two above)."""
    tally = collections.Counter()
    value_and_grad = target.logdensity_and_grad

    def counted(theta):
        tally[int(theta.shape[0])] += 1
        return value_and_grad(theta)

    return dataclasses.replace(target, logdensity_and_grad=counted), tally


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


def phase_main(seed, gen=None, mesh=None):
    """Phase 3 through `sample`, drawing from `gen` (a CUDA generator
    seeded with `seed` unless given: 18d checkpoints it afterwards), with
    the chain axis on `mesh` if one is given (phase 19a)."""
    import advancedhmc_torch as ah

    target, kernel, adaptor = main_path_spec()
    target, by_chains = count_by_chains(target)
    theta0 = _main_theta0(seed)
    if gen is None:
        gen = torch.Generator(device="cuda").manual_seed(seed)
    metric = ah.make_metric("diagonal", DIM, device="cuda")
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    res = ah.sample(
        gen, target, kernel, metric, theta0, N_WARMUP + N_DRAWS,
        n_adapts=N_WARMUP, adaptor=adaptor, init_mass_matrix="gradient",
        cross_chain=True, fuse_draws=FUSE, fuse_warmup=True,
        fuse_warmup_block=WARMUP_BLOCK, drop_warmup=True,
        warmup_chains=WARMUP_CHAINS, fanout_decorrelate=N_DECOR,
        fuse_pair=PAIR, mesh=mesh, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()["fused_logistic_value_grad"]
    by_chains = dict(sorted(by_chains.items(), reverse=True))
    # every leaf is one K1 call, and the pair body runs two leaves an
    # iteration; at the full width run the decorrelation and the draws
    iters = by_chains.get(N_CHAINS, 0) / (2 if PAIR else 1) / (
        N_DECOR + N_DRAWS)
    log(f"# main path (pair body {PAIR}): K1 launches by chain count "
        f"{by_chains}; {iters:.2f} leaf-loop iterations per transition of "
        f"the decorrelation and the draws")
    if sum(by_chains.values()) != launches:
        raise RuntimeError(f"K1 calls by chain count {by_chains} do not add "
                           f"up to its {launches} launches")
    return res, launches, wall, by_chains, iters


# ------------------------------------------------------------------ phase 4
REF_MOMENTS = (REF_MEAN_LOGSIGMA, REF_SD_LOGSIGMA, REF_BETA_NORM)


def _moment_gates(th, ref=REF_MOMENTS):
    """Phase 4's posterior-moment gates on draws `th` (n, C, dim)."""
    ls = th[:, :, 0].double()
    return _gate_moments({
        "mean_logsigma": float(ls.mean()),
        "sd_logsigma": float(ls.std(correction=0)),
        "mean_beta_norm": float(th[:, :, 1:].double().mean((0, 1)).norm())},
        ref)


def _gate_moments(out, ref=REF_MOMENTS):
    """Phase 4's gates on the moments `out` (mean log σ, sd log σ, |mean
    β|) around `ref` (BENCH_r05's NUTS moments unless given); returns (out,
    gates)."""
    mean_ls, sd_ls, beta = ref
    gates = {
        f"|mean_logsigma - ({mean_ls})| <= {TOL_MEAN_LOGSIGMA}":
            abs(out["mean_logsigma"] - mean_ls) <= TOL_MEAN_LOGSIGMA,
        f"sd_logsigma within {TOL_SD_REL:.0%} of {sd_ls}":
            abs(out["sd_logsigma"] / sd_ls - 1) <= TOL_SD_REL,
        f"|mean_beta_norm - {beta}| <= {TOL_BETA_NORM}":
            abs(out["mean_beta_norm"] - beta) <= TOL_BETA_NORM,
    }
    return out, gates


def _draw_gates(out, moment_gates):
    """Phase 4's gates on the draws' divergence, acceptance and moments."""
    return {
        "divergence_rate <= 1e-3": out["divergence_rate"] <= 1e-3,
        f"|accept - {DELTA}| <= 0.1": abs(out["accept_mean"] - DELTA) <= 0.1,
        **moment_gates,
    }


def phase_results(res, launches, wall, seed, iters):
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
    moments, moment_gates = _moment_gates(th)
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
        **moments,
        "mean_tree_depth": float(st["tree_depth"].double().mean()),
        "step_size": float(res.final_state.adapt.da.eps),
        "init_s": res.timings["init_s"],
        "warmup_s": res.timings["warmup_s"],
        "draws_s": t_draw,
        "wall_s": wall,
        "k1_launches": launches,
        "pair": PAIR,
        "leaf_iterations_per_transition": iters,
        "seed": seed, "chains": N_CHAINS, "warmup_chains": WARMUP_CHAINS,
        "warmup": N_WARMUP, "draws": N_DRAWS, "fuse": FUSE,
        "device": torch.cuda.get_device_name(0),
    }
    log(json.dumps(out))
    gates = {
        "k1 launched": launches > 0,
        **_draw_gates(out, moment_gates),
        "ESS finite": math.isfinite(median_ess) and median_ess > 0,
    }
    for name, ok in gates.items():
        log(f"# gate {name}: {'ok' if ok else 'FAIL'}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"main-path gates failed: {failed}")
    return out


# ----------------------------------------------------------------- phase 3b
# The draw phase from phase 3's final state with the leaf-pair body on and
# off, in turns (on, off, off, on), a seed each; PAIR_TURN_DRAWS draws a
# turn, cut from phase 3's 256 to 128 to leave room for phase 16, to 64
# for phase 17, then to 32 for phase 18
PAIR_TURNS = (True, False, False, True)
PAIR_TURN_DRAWS = 32


def phase_pair_turns(res):
    """Times phase 3's draw phase (PAIR_TURN_DRAWS transitions, FUSE a
    call) from its final state on each body in turns; each run's wall,
    leaf-loop iterations per transition (its K1 calls over the leaves an
    iteration), ESS/s and the gates of phase 4. Returns the rows."""
    from advancedhmc_torch import SampleSpec, fused_draw_phase
    from advancedhmc_torch.diagnostics import effective_sample_size

    target, kernel, adaptor = main_path_spec()
    target, by_chains = count_by_chains(target)
    spec = SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                      cross_chain=True)
    rows, failed = [], []
    for turn, pair in enumerate(PAIR_TURNS):
        gen = torch.Generator(device="cuda").manual_seed(30 + turn)
        by_chains.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, th, st = fused_draw_phase(gen, spec, res.final_state,
                                     PAIR_TURN_DRAWS, FUSE, pair=pair)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ess = effective_sample_size(th[:, :ESS_CHAINS]) * (
            N_CHAINS / ESS_CHAINS)
        median_ess = float(ess.quantile(0.5))
        moments, gates = _moment_gates(th)
        row = {
            "pair": pair, "wall_s": wall,
            "leaf_iterations_per_transition":
                by_chains[N_CHAINS] / (2 if pair else 1) / PAIR_TURN_DRAWS,
            "k1_calls": by_chains[N_CHAINS],
            "effective_samples_per_s_per_chip": median_ess / wall,
            "median_pooled_ess": median_ess,
            "leapfrog_steps_per_s":
                float(st["n_steps"].double().sum()) / wall,
            "accept_mean": float(st["acceptance_rate"].double().mean()),
            "divergence_rate": float(st["numerical_error"].double().mean()),
            "mean_tree_depth": float(st["tree_depth"].double().mean()),
            **moments,
        }
        gates = {"draws finite": bool(torch.isfinite(th).all()),
                 **_draw_gates(row, gates)}
        del th, st
        log(f"# pair body {pair}: draws {wall:.2f} s, "
            f"{row['leaf_iterations_per_transition']:.2f} leaf-loop "
            f"iterations per transition, ESS/s "
            f"{row['effective_samples_per_s_per_chip']:.0f}, accept "
            f"{row['accept_mean']:.4f}, depth {row['mean_tree_depth']:.3f}")
        for name, ok in gates.items():
            log(f"# gate (pair body {pair}) {name}: {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"pair body {pair}: {name}")
        rows.append(row)
    log(json.dumps({"pair_turns": rows}))
    if failed:
        raise RuntimeError(f"phase 3b gates failed: {failed}")
    return rows


# ------------------------------------------------------------------ phase 5
# one fused draw call of PROFILE_T transitions, not phase 3's FUSE (16): the
# trace of a 16-transition call (81.5 MB, 264247 events) took ≈ 32 s to
# write and read back, of 4 transitions (32.7 MB) ≈ 17 s, over the
# script's clock
PROFILE_T = 2


def phase_profile(res):
    """Device time by kernel over one fused draw call of PROFILE_T
    transitions on the final state, on the leaf-pair body (phase 3's),
    inside `profiling.trace` (18d: the Chrome trace it writes must name
    K1's kernel), and the share of the wall the device was idle. Cut from
    a call on each body to make room for phase 18, then from 16
    transitions to PROFILE_T to bring the script under its clock."""
    import os
    import tempfile

    from advancedhmc_torch import SampleSpec, fused_draw_phase, profiling

    target, kernel, adaptor = main_path_spec()
    spec = SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                      cross_chain=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    with tempfile.TemporaryDirectory() as d:
        out = profile_call(f"one fused draw call of {PROFILE_T} transitions "
                           f"(pair body {PAIR})",
                           lambda: fused_draw_phase(gen, spec,
                                                    res.final_state,
                                                    PROFILE_T, PROFILE_T,
                                                    pair=PAIR),
                           logdir=d)
        path = os.path.join(d, profiling.TRACE_FILE)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    k1_events = sum(1 for e in events if e.get("cat") == "kernel"
                    and "fused_logistic" in e.get("name", ""))
    log(f"# 18d: profiling.trace wrote {size} bytes, {len(events)} events, "
        f"{k1_events} of them K1's kernel (fused_logistic_kernel)")
    _finish_gates("18d", {"the trace names K1's kernel": k1_events > 0})
    return out


def profile_call(label, fn, logdir=None):
    """Device time by kernel over one call of `fn` under `torch.profiler`
    (through `profiling.trace` into `logdir` where one is given), the
    wall, and the share of the wall the device was idle. Returns
    {wall_ms, busy_ms, idle_share, k1_ms, k1_share}, or None where the
    profiler recorded no device time (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from advancedhmc_torch import profiling

    torch.cuda.synchronize()
    with (profiling.trace(logdir) if logdir is not None else
          profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA])) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side kernel events only: an operator's entry repeats the time
    # of the kernels it launched
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        log(f"# profile of {label}: no device time recorded (not measured)")
        return None
    rows.sort(key=lambda r: -r[1])
    k1_ms = sum(r[1] for r in rows if "fused_logistic" in r[0])
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms), "k1_ms": k1_ms,
           "k1_share": k1_ms / busy_ms}
    log(f"# profile of {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (sum of kernel times), idle share "
        f"{out['idle_share']:.3f}, K1 {k1_ms:.1f} ms "
        f"({100 * out['k1_share']:.1f} % of the device time), "
        f"{sum(r[2] for r in rows)} kernels")
    for key, ms, count in rows[:12]:
        log(f"#   {ms:9.2f} ms {100 * ms / busy_ms:5.1f}%  x{count:<6d} "
            f"{key[:90]}")
    return out


# ------------------------------------------------------------------ phase 6
# The megakernel draw phase (the counterpart of scripts/bench_megakernel.py):
# from phase 3's warmed state, MEGA_CALLS calls of MEGA_T transitions each,
# threading the positions, a new seed per call.
MEGA_CALLS, MEGA_T, MEGA_SEED0, MEGA_BLOCK = 16, 16, 12, 256
# K2 against its plain version: both draw the same counter stream, but a
# float32 rounding difference can decide a near-tie the other way and send
# a chain down another tree (or pick another candidate of the same tree),
# so this share of the chains, not all, must agree at every transition, in
# the integer outputs and in θ within K2_THETA_TOL. (At full width 9 of
# 32768 chains pick another candidate; every other case agrees in full.)
K2_AGREE_SHARE = 0.999
K2_THETA_TOL = 1e-3
K2_DEPTH_TOL = 0.5


def k2_bound_ms(n_steps_sum, c, dim, n, T):
    """Least time for one K2 call on the logistic: the operations of every
    leaf's value+grad at float32 accuracy on the tensor cores, 3xTF32
    (three TF32 products for each of the two, 3·4·p·n per leaf; Σ n_steps
    leaves, plus one per chain at the start) over the TF32 peak, against
    θ₀, M⁻¹, the design and y in and θ (T, C, dim) and three (T, C) int32
    outputs out over the memory rate. Also returns the float32 CUDA-core
    figure (4·p·n per leaf over that peak), the bound before K2 used the
    tensor cores."""
    p = dim - 1
    flops = 4.0 * p * n * (n_steps_sum + c)
    nbytes = 4.0 * (c * dim + dim + n * p + n + T * c * dim + 3 * T * c)
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * max(flops / PEAK_F32_FLOPS, t_bytes))


def k2_report():
    """K2's registers and spills by instance (ptxas), and its chains per
    block, shared memory per block and resident blocks per SM on the
    100-D logistic."""
    from advancedhmc_torch.ops import _build
    from advancedhmc_torch.ops import fused_nuts_kernel as k2

    lib = _build.load("fused_nuts")
    k2._kernel(lib)
    for p_max, regs, spill, mangled in ptxas_instances(
            "fused_nuts", r"LogisticTargetILi(\d+)E"):
        name = (f"logistic p <= {p_max}" if p_max else "logistic p > 128"
                if "WideLogisticTarget" in mangled else "gaussian")
        log(f"# K2 instance {name}: {regs} registers, {spill} bytes of "
            "spill stores (ptxas)")
    shape = dict(chains_per_block=lib.fused_nuts_chains_per_block(),
                 smem_bytes_per_block=lib.fused_nuts_smem_bytes(0, DIM),
                 blocks_per_sm=lib.fused_nuts_blocks_per_sm(0, DIM))
    shape["warps_per_sm"] = shape["blocks_per_sm"] * (
        shape["chains_per_block"] // 16)
    log(f"# K2 logistic dim={DIM}: {shape['chains_per_block']} chains per "
        f"block, {shape['smem_bytes_per_block']} bytes of shared memory per "
        f"block, {shape['blocks_per_sm']} blocks ({shape['warps_per_sm']} "
        "warps) per SM")
    return shape


def lockstep_share(leaves, group):
    """Of the leaf iterations that blocks of `group` consecutive chains
    walk in lock step (each until its slowest chain is done), the share
    that some chain needed; `leaves` (calls, C) is each chain's Σ n_steps
    per call."""
    calls, c = leaves.shape
    tiles = leaves[:, :c - c % group].reshape(calls, -1, group)
    return float(tiles.sum() / (group * tiles.amax(2)).sum())


def k2_agreement(out, ref, theta_transitions=None):
    """How K2's outputs agree with its plain version's, chain by chain.

    `share`: chains whose integer outputs (n_steps, depth, diverged) agree
    at every transition; `share_theta`: chains that also agree in θ within
    K2_THETA_TOL at every transition, or at the first `theta_transitions`
    (the gated share); `max_abs_err`: max |Δθ| over all chains and
    transitions; `max_abs_err_agreeing`: over the latter. Each
    chain that departs is counted by what differs at its first departing
    transition: `divergence` (either version diverged there: ΔH crossed
    1000 on one side only, or at another leaf), `candidate` (the same tree,
    another draw) or `tree` (another tree, no divergence). Over the chains
    whose integer outputs agree: `dtheta_quantiles`, quantiles of each
    chain's max |Δθ|, and `dtheta_max_by_transition`, the max over them
    at each transition."""
    ints = (out[1] != ref[1]) | (out[2] != ref[2]) | (out[3] != ref[3])
    dtheta = (out[0] - ref[0]).abs().amax(2)                     # (T, C)
    same_ints = ~ints.any(0)
    d_same = dtheta[:, same_ints].double()
    qs = (0.5, 0.9, 0.99, 1.0)
    departs = ints.clone()
    departs[:theta_transitions] |= dtheta[:theta_transitions] > K2_THETA_TOL
    bad = departs.any(0)
    t0 = departs.int().argmax(0)[bad][None]          # first departure
    cols = bad.nonzero()[:, 0][None]
    div = (out[3] | ref[3])[t0, cols]
    cand = ~div & ~ints[t0, cols]
    dmax = dtheta.amax(0)
    return dict(
        share=float((~ints.any(0)).double().mean()),
        share_theta=float((~bad).double().mean()),
        theta_transitions=theta_transitions or out[0].shape[0],
        max_abs_err=float(dmax.max()),
        max_abs_err_agreeing=float(dmax[~bad].max()) if bool(
            (~bad).any()) else 0.0,
        departures=dict(divergence=int(div.sum()), candidate=int(cand.sum()),
                        tree=int((~div & ~cand).sum())),
        dtheta_quantiles=dict(zip(qs, torch.quantile(
            d_same.amax(0), torch.tensor(qs, dtype=torch.float64,
                                         device=d_same.device)).tolist()))
        if d_same.numel() else {},
        dtheta_max_by_transition=d_same.amax(1).tolist()
        if d_same.numel() else [])


def _events_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _logistic_block():
    from advancedhmc_torch.models.logistic import hierarchical_logistic_block

    return hierarchical_logistic_block(n=N_ROWS, p=DIM - 1, d_pad=128,
                                       device="cuda")


def phase_megakernel(res, main_out):
    from advancedhmc_torch.diagnostics import effective_sample_size
    from advancedhmc_torch.ops import fused_nuts_kernel as k2

    fs = res.final_state
    eps = float(fs.adapt.da.eps)
    m_inv = fs.metric.m_inv.to(torch.float32).contiguous()
    th_start = fs.z.theta.to(torch.float32).contiguous()
    target, data = _logistic_block()
    shape = k2_report()

    def run(fn, seed, th0):
        return fn(target, th0, m_inv, eps, seed, data, DIM, MEGA_T,
                  MAX_DEPTH, MEGA_BLOCK)

    # the first call's inputs through the kernel and its plain version:
    # compared (gated below) and timed, not counted
    first, _ = _events_ms(lambda: run(k2.fused_nuts, MEGA_SEED0, th_start))
    plain, plain_ms = _events_ms(
        lambda: run(k2.plain_fused_nuts, MEGA_SEED0, th_start))
    agree0 = k2_agreement(first, plain)
    del plain

    reset_launches()
    t0 = time.perf_counter()
    outs, events, th0 = [], [], th_start
    for rep in range(MEGA_CALLS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = run(k2.fused_nuts, MEGA_SEED0 + rep, th0)
        e1.record()
        outs.append(out)
        events.append((e0, e1))
        th0 = out[0][-1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()["fused_nuts"]
    call_ms = [a.elapsed_time(b) for a, b in events]
    bounds = [k2_bound_ms(float(o[1].double().sum()), N_CHAINS, DIM, N_ROWS,
                          MEGA_T) for o in outs]
    # a block iterates until its slowest chain is done: the share of those
    # leaf iterations that some chain needed, at K2's block and at PR 2's
    # block of 8 chains
    leaves = torch.stack([o[1].sum(0) for o in outs]).double()   # (calls, C)
    lockstep = lockstep_share(leaves, shape["chains_per_block"])
    lockstep8 = lockstep_share(leaves, 8)

    th = torch.cat([o[0] for o in outs])
    n_steps = torch.cat([o[1] for o in outs])
    depth = torch.cat([o[2] for o in outs])
    div = torch.cat([o[3] for o in outs])
    del outs
    if tuple(th.shape) != (MEGA_CALLS * MEGA_T, N_CHAINS, DIM) or \
            not bool(torch.isfinite(th).all()):
        raise RuntimeError(f"megakernel draws: shape {tuple(th.shape)} or "
                           "non-finite values")
    ess_512 = effective_sample_size(th[:, :ESS_CHAINS])
    median_ess = float(ess_512.quantile(0.5)) * (N_CHAINS / ESS_CHAINS)
    moments, moment_gates = _moment_gates(th)
    lf = float(n_steps.double().sum())
    phase3_call_ms = 1e3 * main_out["draws_s"] / (N_DRAWS // FUSE)
    out = {
        "phase": "megakernel draws",
        "calls": MEGA_CALLS, "transitions_per_call": MEGA_T,
        "chains": N_CHAINS, "max_depth": MAX_DEPTH,
        "block_chains": MEGA_BLOCK, "step_size": eps,
        "wall_s": wall,
        "call_ms_mean": sum(call_ms) / len(call_ms),
        "call_ms_min": min(call_ms), "call_ms_max": max(call_ms),
        "bound_ms_mean": sum(b[0] for b in bounds) / len(bounds),
        "bound_by": bounds[0][1],
        "bound_ms_f32_cuda_cores_mean":
            sum(b[2] for b in bounds) / len(bounds),
        "n_steps_total": lf,
        **shape,
        "tile_lockstep_share": lockstep,
        "lockstep_share_8_chains": lockstep8,
        "leapfrog_steps_per_s": lf / wall,
        "mean_tree_depth": float(depth.double().mean()),
        "divergence_rate": float(div.double().mean()),
        **moments,
        "median_pooled_ess": median_ess,
        "effective_samples_per_s_per_chip": median_ess / wall,
        "k2_launches": launches,
        "first_call_plain_ms": plain_ms,
        "first_call_agreement": agree0,
        "phase3_draw_call_ms": phase3_call_ms,
        "phase3_mean_tree_depth": main_out["mean_tree_depth"],
        "phase3_effective_samples_per_s_per_chip":
            main_out["effective_samples_per_s_per_chip"],
    }
    log(json.dumps(out))
    log(f"# megakernel: {out['call_ms_mean']:.1f} ms per call of "
        f"{MEGA_T} transitions (bound {out['bound_ms_mean']:.1f} ms, "
        f"{out['bound_by']}, 3xTF32 on the tensor cores; "
        f"{out['bound_ms_f32_cuda_cores_mean']:.1f} ms by float32 on the "
        f"CUDA cores); phase 3's fused draw call {phase3_call_ms:.1f} ms; "
        f"lock-step share {lockstep:.4f} at {shape['chains_per_block']} "
        f"chains per block ({lockstep8:.4f} at 8)")
    gates = {
        f"k2 launched {MEGA_CALLS} times": launches == MEGA_CALLS,
        "divergence_rate <= 1e-3": out["divergence_rate"] <= 1e-3,
        **moment_gates,
        f"|mean depth - phase 3's| <= {K2_DEPTH_TOL}":
            abs(out["mean_tree_depth"] - main_out["mean_tree_depth"])
            <= K2_DEPTH_TOL,
        "ESS finite": math.isfinite(median_ess) and median_ess > 0,
        f"call 1 agrees with the plain version (share >= {K2_AGREE_SHARE})":
            agree0["share_theta"] >= K2_AGREE_SHARE,
    }
    for name, ok in gates.items():
        log(f"# gate {name}: {'ok' if ok else 'FAIL'}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"megakernel gates failed: {failed}")
    return out


# ------------------------------------------------------------------ phase 7
def _gaussian_moments_ok(out):
    """tests/test_pallas_ops.py's checks of the megakernel's Gaussian."""
    d = out[0][20:].reshape(-1, 5).double()
    return (float(d.mean(0).abs().max()) < 0.35
            and float((d.var(0, correction=0) - 1).abs().max()) < 0.45
            and not bool(out[3].any())
            and 2 <= float(out[2].double().mean()) <= 4)


def phase_k2_parity(res):
    """K2 against its plain version on the card, each case gated on the
    share of agreeing chains and on reaching what it is there to reach:

    * the logistic on the first 4096 warmed chains at the warmed ε (T 8,
      max_depth 6 and 8; trees of depth ~3);
    * forced-deep trees on the first 512 warmed chains: ε/8 at max_depth 6
      (every tree stops at the depth cap) and ε/32 at max_depth 8 (trees
      of depth 8, whose leaves 128.. share checkpoint slot S − 1 with leaf
      0): the U-turn spans at k ≥ 3 and the deep checkpoint slots;
    * 3ε on 4096 chains: most trees diverge;
    * the JAX megakernel test's Gaussian (8 chains × 5-D, ε 0.5, seed 42,
      max_depth 6, T 80, blocks of 8), with that test's moment and depth
      checks."""
    from advancedhmc_torch.models.gaussian import std_gaussian_block

    fs = res.final_state
    eps = float(fs.adapt.da.eps)
    m_inv = fs.metric.m_inv.to(torch.float32).contiguous()
    target, data = _logistic_block()
    g_target, g_data = std_gaussian_block(5, device="cuda")

    def logistic(c, e, T, s):
        th0 = fs.z.theta[:c].to(torch.float32).contiguous()
        return (target, th0, m_inv, e, 99, data, DIM, T, s, MEGA_BLOCK)

    # (name, arguments, what the case must reach)
    cases = [(f"logistic C=4096 T=8 max_depth={s}", logistic(4096, eps, 8, s),
              None) for s in (6, 8)]
    cases += [
        ("logistic deep eps/8 C=512 T=4 max_depth=6",
         logistic(512, eps / 8, 4, 6),
         ("mean depth >= 5.5", lambda o: _mean_depth(o) >= 5.5)),
        ("logistic deep eps/32 C=512 T=2 max_depth=8",
         logistic(512, eps / 32, 2, 8),
         ("mean depth >= 7.5", lambda o: _mean_depth(o) >= 7.5)),
        ("logistic divergent 3eps C=4096 T=8 max_depth=6",
         logistic(4096, 3 * eps, 8, 6),
         ("divergence rate >= 0.5",
          lambda o: float(o[3].double().mean()) >= 0.5)),
        ("gaussian C=8 D=5 T=80 max_depth=6",
         (g_target, torch.zeros(8, 5, device="cuda"),
          torch.ones(5, device="cuda"), 0.5, 42, g_data, 5, 80, 6, 8),
         ("the JAX test's moments and depth", _gaussian_moments_ok)),
    ]
    return k2_parity_rows(cases, K2_AGREE_SHARE)


def _mean_depth(out):
    return float(out[2].double().mean())


def k2_parity_rows(cases, share, theta_transitions=None):
    """Each case (name, arguments, what it must reach or None) through K2
    and its plain version, gated on `share` of the chains agreeing (θ at
    every transition, or at the first `theta_transitions`), on two K2 calls
    giving the same bits and on what the case must reach; returns a row per
    case."""
    from advancedhmc_torch.ops import fused_nuts_kernel as k2

    rows = []
    for name, args, reach in cases:
        out, ms = _events_ms(lambda: k2.fused_nuts(*args))
        ref, plain_ms = _events_ms(lambda: k2.plain_fused_nuts(*args))
        agree = k2_agreement(out, ref, theta_transitions)
        del ref
        # no atomics: a second call on the same inputs gives the same bits
        same = all(torch.equal(a, b)
                   for a, b in zip(out, k2.fused_nuts(*args)))
        ok = (bool(torch.isfinite(out[0]).all())
              and agree["share_theta"] >= share and same
              and (reach is None or reach[1](out)))
        log(f"# K2 {name}: chains agreeing in n_steps/depth/diverged "
            f"{agree['share']:.5f}, and in θ within {K2_THETA_TOL:g} (over "
            f"{agree['theta_transitions']} transitions) "
            f"{agree['share_theta']:.5f} (gate >= {share}), "
            f"max|Δθ| {agree['max_abs_err']:.3e} (agreeing chains "
            f"{agree['max_abs_err_agreeing']:.3e}), departures "
            f"{agree['departures']}, mean depth {_mean_depth(out):.3f}, "
            f"divergence {float(out[3].double().mean()):.4f}"
            + (f" (gate {reach[0]})" if reach else "")
            + f", two calls bitwise equal {same}, kernel {ms:.2f} ms, plain "
            f"{plain_ms:.1f} ms: {'ok' if ok else 'FAIL'}")
        log(f"#   max|Δθ| of the chains whose integers agree: quantiles "
            f"{json.dumps(agree['dtheta_quantiles'])}; max by transition "
            f"{json.dumps(agree['dtheta_max_by_transition'])}")
        if not ok:
            raise RuntimeError(f"K2 disagrees with its plain version or "
                               f"with itself: {name}")
        rows.append(dict(case=name, **agree, mean_depth=_mean_depth(out),
                         same_bits=same, ms=ms, plain_ms=plain_ms))
    return rows


# ------------------------------------------------------------------ phase 8
# `sample` at its defaults: per-chain adaptation, step by step
# 200 iterations, not 400, keep the phase under 100 s on the card (at 400
# it took 157-168 s, at 300 about 110 s) beside phase 15; 150 adapt, so
# one Stan window (its end at 100) remains; then, to bring the script
# under its 1200 s clock, 120 of which 100 adapt with the buffers cut from
# 75/50/25 to 50/25/25 (still one window, then 25 iterations of dual
# averaging after its reset, as phase 15's runs), and 20 draws, at ≈ 0.41
# s an iteration on an H100
DEF_CHAINS, DEF_SAMPLES, DEF_ADAPTS = 4096, 120, 100
DEF_BUFFERS = (50, 25, 25)
DEF_DELTA, DEF_TOL_ACCEPT = 0.8, 0.15
# (the fused draws cut from 64 to 32 to leave room for phase 17, then to 16
# for the clock)
DEF_DRAWS, DEF_FUSE = 16, 8


def phase_defaults(seed):
    """Drive `sample` at its defaults, then per-chain fused draws from its
    final state; returns the phase's results and K1's launches by chain
    count."""
    import numpy as np

    import advancedhmc_torch as ah
    from advancedhmc_torch.diagnostics import effective_sample_size

    target, kernel, _ = main_path_spec()
    target, by_chains = count_by_chains(target)
    adaptor = ah.AdaptorConfig(
        kind="stan", da=ah.DualAveragingConfig(delta=DEF_DELTA),
        init_buffer=DEF_BUFFERS[0], term_buffer=DEF_BUFFERS[1],
        window_size=DEF_BUFFERS[2])
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(size=(DEF_CHAINS, DIM)),
        dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    metric = ah.make_metric("diagonal", DIM, device="cuda")
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    res = ah.sample(gen, target, kernel, metric, theta0, DEF_SAMPLES,
                    n_adapts=DEF_ADAPTS, adaptor=adaptor,
                    init_mass_matrix="gradient", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_sample = read_launches()["fused_logistic_value_grad"]
    fs = res.final_state
    spec = ah.SampleSpec(target=target, kernel=kernel, adaptor=adaptor)
    t0 = time.perf_counter()
    _, th_f, st_f = ah.fused_draw_phase(gen, spec, fs, DEF_DRAWS, DEF_FUSE)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    launches = read_launches()["fused_logistic_value_grad"]
    by_chains = dict(sorted(by_chains.items(), reverse=True))
    log(f"# default path: K1 launches by chain count {by_chains}")

    th = res.thetas[DEF_ADAPTS:]
    st = {k: v[DEF_ADAPTS:] for k, v in res.stats.items()}
    n_draw = DEF_SAMPLES - DEF_ADAPTS
    t_draw = res.timings["draws_s"]
    ess = effective_sample_size(th[:, :ESS_CHAINS]) * (
        DEF_CHAINS / ESS_CHAINS)
    median_ess = float(ess.quantile(0.5))
    eps, m_inv = fs.adapt.da.eps, fs.metric.m_inv
    depth = res.stats["tree_depth"]
    out = {
        "phase": "default path",
        "chains": DEF_CHAINS, "samples": DEF_SAMPLES, "adapts": DEF_ADAPTS,
        "init_s": res.timings["init_s"],
        "warmup_s": res.timings["warmup_s"],
        "draws_s": t_draw, "wall_s": wall,
        "warmup_s_per_iteration": res.timings["warmup_s"] / DEF_ADAPTS,
        "draws_s_per_iteration": t_draw / n_draw,
        "leapfrog_steps_per_s": float(st["n_steps"].double().sum()) / t_draw,
        "effective_samples_per_s_per_chip": median_ess / t_draw,
        "median_pooled_ess": median_ess,
        "accept_mean": float(st["acceptance_rate"].double().mean()),
        "divergence_rate": float(st["numerical_error"].double().mean()),
        "mean_tree_depth": float(st["tree_depth"].double().mean()),
        # the loop runs each transition until its slowest chain is done
        "leaf_iterations_per_transition":
            float(res.stats["n_steps"].amax(1).double().mean()),
        "depth_histogram_warmup": torch.bincount(
            depth[:DEF_ADAPTS].flatten(), minlength=MAX_DEPTH + 1).tolist(),
        "depth_histogram_draws": torch.bincount(
            depth[DEF_ADAPTS:].flatten(), minlength=MAX_DEPTH + 1).tolist(),
        "step_size_median": float(eps.median()),
        "step_size_min": float(eps.min()), "step_size_max": float(eps.max()),
        "k1_launches": launches, "k1_launches_sample": k1_sample,
        "fused_draws": DEF_DRAWS, "fused_s": fused_s,
        "fused_accept_mean": float(st_f["acceptance_rate"].double().mean()),
        "fused_mean_tree_depth": float(st_f["tree_depth"].double().mean()),
        "device": torch.cuda.get_device_name(0),
    }
    moments, gates = _moment_gates(th)
    moments_f, gates_f = _moment_gates(th_f)
    out.update(moments)
    out.update({f"fused_{k}": v for k, v in moments_f.items()})
    log(json.dumps(out))
    log(f"# default path: init {out['init_s']:.1f} s, warmup "
        f"{out['warmup_s']:.1f} s, draws {t_draw:.1f} s "
        f"({1e3 * out['draws_s_per_iteration']:.0f} ms per iteration, "
        f"{out['leaf_iterations_per_transition']:.1f} leaf iterations per "
        f"transition), fused draws {fused_s:.1f} s, K1 launches {launches}")
    gates = {
        "draws finite": tuple(th.shape) == (n_draw, DEF_CHAINS, DIM)
        and bool(torch.isfinite(th).all()),
        "divergence_rate <= 1e-3": out["divergence_rate"] <= 1e-3,
        f"|accept - {DEF_DELTA}| <= {DEF_TOL_ACCEPT}":
            abs(out["accept_mean"] - DEF_DELTA) <= DEF_TOL_ACCEPT,
        **gates,
        f"final eps ({DEF_CHAINS},), finite, > 0":
            tuple(eps.shape) == (DEF_CHAINS,)
            and bool(torch.isfinite(eps).all() and (eps > 0).all()),
        f"final M^-1 ({DEF_CHAINS}, {DIM}), finite, > 0":
            tuple(m_inv.shape) == (DEF_CHAINS, DIM)
            and bool(torch.isfinite(m_inv).all() and (m_inv > 0).all()),
        "fused draws finite": bool(torch.isfinite(th_f).all()),
        **{f"fused draws {k}": v for k, v in gates_f.items()},
        "fused draws' step_size is each chain's eps": torch.equal(
            st_f["step_size"], eps.expand(DEF_DRAWS, -1)),
        "k1 launched": launches > 0,
        "k1 launches = value+grad calls": sum(by_chains.values())
        == launches,
    }
    for name, ok in gates.items():
        log(f"# gate {name}: {'ok' if ok else 'FAIL'}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"default-path gates failed: {failed}")
    return out, by_chains


# ------------------------------------------------------------------ phase 9
# The repo's 1000-D hierarchical logistic (README's 10/100/1000-D
# portfolio; bench.py at AHMC_BENCH_DIM=1000) through sample()'s main path,
# at the widest chain count of its recorded table: 1024 chains, the whole
# batch warmed (bench.py: no fan-out below 4096 chains), the design in
# float32 (bench.py's AHMC_BENCH_X_DTYPE=float32) and the single-leaf loop
# (AHMC_BENCH_PAIR=0), the two switches the port has.
# Draws cut from 128 to 64: at 128 the phase took 115.5 s on an H100
# (draws 75.5 s), over the ~90 s it may take; the width, the chains and the
# warmup are not cut. Then to 32 (here and in phase 11, ≈ 15 s each on an
# H100) to bring the script under its 1200 s clock. The moments are still
# held to the JAX runs of 64 draws below: the gate's floor of 3 standard
# deviations between those runs (≈ 2.3 in |mean β|, ≈ 0.3 in mean log σ)
# is far wider than a run's drift between its first and second 32 draws
# (0.27-0.40 in |mean β|).
WIDE_ROWS, WIDE_DIM, WIDE_CHAINS = 1000, 1000, 1024
WIDE_WARMUP, WIDE_DRAWS, WIDE_FUSE = 128, 32, 16
# K1's wide kernel against its plain version at (C, p, n): the step-size
# search, ragged C and n, the path's width and four times it, p = 200 (past
# the narrow instances' 128), and twice the path's p
WIDE_SHAPES = ((1, 999, 1000), (1000, 999, 997), (1024, 999, 1000),
               (4096, 999, 1000), (4096, 200, 1000), (1024, 2047, 1000),
               (16384, 999, 1000))
# the path's shapes and the hlr1000.chees benchmark cell's chain count,
# each also checked with the prior folded in
WIDE_TIMED = ((1024, 999, 1000), (1, 999, 1000), (16384, 999, 1000))
# The JAX package's posterior: scripts/wide_reference.py runs JAX `sample`
# in float64 on the CPU with this phase's settings, 1024 chains × 64 draws,
# one run per seed:
#   JAX_PLATFORMS=cpu python scripts/wide_reference.py --chains 1024 \
#       --draws 64 --seeds S          (S = 0, 1, 2, 3; ~16 min each)
# Each run's (mean log σ, MCSE), (sd log σ, MCSE), (|mean β|, MCSE) and
# acceptance rate; no run diverged.
WIDE_REF_RUNS = (
    ((-1.4216668142360107, 0.014786840366395047),
     (0.3595792036087667, 0.010455875095400911),
     (5.5764722904037605, 0.005783396450034072), 0.6458364642068548),
    ((-1.2700725133612583, 0.018609043787471937),
     (0.44021924780082866, 0.0131585810535188),
     (6.756374980012899, 0.008272404134484353), 0.6168769385735674),
    ((-1.3531486543634053, 0.016313066555488833),
     (0.39181934903290466, 0.011535079983333628),
     (6.0816745275004855, 0.007114198814788947), 0.6440173588980289),
    ((-1.5169276618034264, 0.012723630936283965),
     (0.3149433063840599, 0.008996965716361332),
     (4.950331363037433, 0.004198786347971704), 0.6254673169370746),
)
WIDE_MOMENTS = ("mean_logsigma", "sd_logsigma", "mean_beta_norm")
# At this configuration 128 warmup iterations do not reach stationarity:
# within each JAX run |mean β| moves by 0.27-0.40 between the first and the
# second 32 draws, and the runs differ by far more than their MCSEs
# (|mean β| 4.95-6.76 against MCSEs of 0.004-0.008), since every chain of
# a run shares its warmup's ε and M⁻¹. So each moment is gated at 4 × the
# combined MCSE (the reference mean's and this run's) plus a floor of 3 ×
# the standard deviation between the JAX runs, which measures how far one
# run of this configuration lands from another.
WIDE_K_MCSE, WIDE_K_RUNS = 4.0, 3.0
# acceptance: every JAX run lies outside δ ± 0.1 (0.617-0.646), so the gate
# is |accept − the JAX runs' mean (0.633)| <= 0.1
WIDE_TOL_ACCEPT = 0.1


def wide_reference(runs=WIDE_REF_RUNS):
    """Over the JAX runs: each moment's mean, the MCSE of that mean, the
    standard deviation between runs; and the mean acceptance rate."""
    n = len(runs)
    ref = {}
    for i, name in enumerate(WIDE_MOMENTS):
        vals = [run[i][0] for run in runs]
        mean = sum(vals) / n
        ref[name] = dict(
            mean=mean,
            mcse=math.sqrt(sum(run[i][1] ** 2 for run in runs)) / n,
            sd_between_runs=math.sqrt(
                sum((v - mean) ** 2 for v in vals) / (n - 1)))
    return ref, sum(run[3] for run in runs) / n


# the wide path's kernels, by a part of their mangled names
# (template arguments: stage, A by TMA, mode; mode 0 is float32, 1 the
# bfloat16 operands)
WIDE_K1_KERNELS = (("stage_a", "gemm_kernelILi0ELb1ELi0E"),
                   ("stage_a_copies", "gemm_kernelILi0ELb0ELi0E"),
                   ("stage_b", "gemm_kernelILi1ELb1ELi0E"),
                   ("stage_a_bf16", "gemm_kernelILi0ELb1ELi1E"),
                   ("stage_a_copies_bf16", "gemm_kernelILi0ELb0ELi1E"),
                   ("stage_b_bf16", "gemm_kernelILi1ELb1ELi1E"))


def k1_wide_report(launched):
    """The wide path's kernels (stage A with θ by TMA, where its rows are
    aligned, and copied, and stage B): registers and
    spills (ptxas), whether ptxas serialised the wgmma, and at the path's
    shapes each launch's blocks, split-K ranks, blocks per SM, shared
    memory and threads a block, and the launches a call (`launched`, by
    chain count: counted by the wrapper in phase_wide_k1)."""
    from advancedhmc_torch.ops import _build
    from advancedhmc_torch.ops import fused_logistic as k1

    entries = list(ptxas_instances("fused_logistic", r"^$"))
    out = {}
    for label, pattern in WIDE_K1_KERNELS:
        (regs, spill), = [(r, sp) for _, r, sp, name in entries
                          if pattern in name]
        out[label] = dict(registers=int(regs), spill_store_bytes=int(spill))
    path = _build.library_path("fused_logistic")
    out["wgmma_serialized"] = "serialized" in path.with_name(
        path.name + ".log").read_text()
    for c, p, n in WIDE_TIMED:
        out[f"C={c}"] = dict(k1.wide_launch_shape(c, p + 1, n),
                             launches_per_call=launched[c])
    log("# K1 wide: " + ", ".join(
        f"{k} {out[k]['registers']} registers, {out[k]['spill_store_bytes']} "
        "bytes of spill stores" for k, _ in WIDE_K1_KERNELS)
        + f" (ptxas; wgmma serialised: {out['wgmma_serialized']})")
    for c, _, _ in WIDE_TIMED:
        sh = out[f"C={c}"]
        log(f"# K1 wide C={c}: {sh['launches_per_call']} launches a call "
            f"(counted); stage A {sh['stage_a_blocks']} blocks (clusters of "
            f"{sh['stage_a_ranks']} split-K ranks), stage B "
            f"{sh['stage_b_blocks']} ({sh['stage_b_ranks']}); "
            f"{sh['threads_per_block']} threads, "
            f"{sh['smem_bytes_per_block']} bytes of shared memory and "
            f"{sh['blocks_per_sm']} blocks per SM")
    return out


def phase_wide_k1(mode):
    """K1's wide path in `mode` against its reference on the card
    (check_k1) at WIDE_SHAPES, over the design prepared once a shape;
    at the path's shapes (WIDE_TIMED) also with the model's prior folded
    in, and timing rows; returns (rows, largest difference
    from the plain twin, launches a call by timed chain count)."""
    from advancedhmc_torch.models.logistic import _synthetic_data
    from advancedhmc_torch.ops import fused_logistic as k1

    other = k1_control_mode(mode)
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, worst, launched = [], 0.0, {}
    for c, p, n in WIDE_SHAPES:
        x_np, y_np = _synthetic_data(n, p)
        x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
        y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
        design = k1.WideDesign(x, mode)
        theta = 0.1 * torch.randn(c, p + 1, generator=gen, device="cuda")
        control = k1.WideDesign(x, other)
        per_call, err = check_k1(theta, x, y, design, mode, control)
        worst = max(worst, err)
        if (c, p, n) in WIDE_TIMED:
            # the main path's call: the model's prior folded in
            per_call, err = check_k1(theta, x, y, design, mode, control,
                                     True)
            worst = max(worst, err)
            launched[c] = per_call
            rows.append(time_k1(theta, x, y, design, mode))
    return rows, worst, launched


# phase 9c: the lgcp64.chees cell's grid side, and its chain counts (the
# draws and the step-size search)
COX_SIDE = 64
COX_CHAINS = (2048, 1)


def phase_cox_k1(modes):
    """K1's Poisson-log link over the log-Gaussian Cox process's factor
    L₀ (made once, float64 Cholesky on the card) with the model's offset c,
    at θ' = (log σ, σ·z) as the model's route passes it (log σ uniform in
    [−1, 1], z normal): check_k1 in each of `modes` (the control the other
    mode) and a timing row at each of COX_CHAINS, its bound the model's
    least time (`hmcbench.roofline_cox.least_time_s`: the triangle's
    products, not the dense ones K1 runs). Returns (rows, largest
    difference from the plain twin)."""
    from advancedhmc_torch.models import lgcp
    from advancedhmc_torch.ops import fused_logistic as k1
    from hmcbench import roofline_cox

    cells = COX_SIDE * COX_SIDE
    l0, y_np = lgcp.lgcp_data(COX_SIDE, 0, "cuda")
    x = l0.float().contiguous()
    del l0
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    offset = lgcp.MU - math.log(cells)
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows, worst = [], 0.0
    for mode in modes:
        design = k1.WideDesign(x, mode)
        control = k1.WideDesign(x, k1_control_mode(mode))
        dtype = {k1.MODE_F32: "float32",
                 k1.MODE_BF16: "bfloat16"}[mode]
        for c in COX_CHAINS:
            ls = 2.0 * torch.rand(c, 1, generator=gen, device="cuda") - 1.0
            z = torch.randn(c, cells, generator=gen, device="cuda")
            theta = torch.cat([ls, torch.exp(ls) * z], 1)
            per_call, err = check_k1(theta, x, y, design, mode, control,
                                     link="poisson", offset=offset)
            worst = max(worst, err)

            def kernel():
                return k1.logistic_value_grad(theta, x, y, design, mode,
                                              link="poisson", offset=offset)

            reps = 20
            row = dict(chains=c, dim=cells + 1, n=cells, mode=mode,
                       link="poisson", launches=per_call,
                       ms=device_ms(kernel, reps),
                       wrapper_ms=wrapper_ms(kernel, reps),
                       plain_ms=device_ms(lambda: k1.plain_logistic_value_grad(
                           theta, x, y, mode, link="poisson",
                           offset=offset), reps),
                       bound_ms=1e3 * roofline_cox.least_time_s(c, cells,
                                                                dtype))
            t_ops = (roofline_cox.value_grad_flops(c, cells)
                     / roofline_cox.PEAK_FLOPS[dtype])
            row["bound_by"] = "operations" if t_ops >= (
                roofline_cox.value_grad_bytes(c, cells, dtype)
                / roofline_cox.PEAK_BYTES_PER_S) else "bytes"
            row["roofline_share"] = row["bound_ms"] / row["ms"]
            log(f"# K1 Poisson link mode {mode} C={c} N={cells}: "
                f"{row['ms']:.4f} ms on the device, {per_call} launches a "
                f"call ({row['wrapper_ms']:.4f} ms back to back through the "
                f"wrapper); plain {row['plain_ms']:.4f} ms; the model's "
                f"least time {row['bound_ms']:.4f} ms ({row['bound_by']}; the "
                f"kernel at {100 * row['roofline_share']:.2f} % of it)")
            rows.append(row)
        del design, control
    return rows, worst


def wide_spec():
    import advancedhmc_torch as ah

    target = ah.hierarchical_logistic(n=WIDE_ROWS, p=WIDE_DIM - 1,
                                      dtype=torch.float32, device="cuda")
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.05, device="cuda")),
        ah.GeneralisedNoUTurn(max_depth=MAX_DEPTH)))
    adaptor = ah.AdaptorConfig(
        kind="stan", da=ah.DualAveragingConfig(delta=DELTA, kappa=0.8),
        init_buffer=75, term_buffer=50, window_size=25)
    return target, kernel, adaptor


def _wide_moments(th):
    """The three moments and their MCSEs from the pooled bulk ESS (as
    scripts/wide_reference.py computes them)."""
    from advancedhmc_torch.diagnostics import effective_sample_size

    ess = effective_sample_size(th).double()
    ls = th[:, :, 0].double()
    beta_mean = th[:, :, 1:].double().mean((0, 1))
    beta_sd = th[:, :, 1:].double().std((0, 1), correction=0)
    norm = float(beta_mean.norm())
    sd_ls = float(ls.std(correction=0))
    out = {"mean_logsigma": float(ls.mean()), "sd_logsigma": sd_ls,
           "mean_beta_norm": norm}
    mcse = {"mean_logsigma": sd_ls / math.sqrt(float(ess[0])),
            "sd_logsigma": sd_ls / math.sqrt(2 * float(ess[0])),
            "mean_beta_norm": float(torch.sqrt(torch.sum(
                (beta_mean / norm) ** 2 * beta_sd ** 2 / ess[1:])))}
    return out, mcse, ess


def phase_wide(seed):
    """Drive sample() on the 1000-D model at 1024 chains, with every
    kernel's launch count set to 0 just before and read just after, and
    gate the result against the JAX package's posterior; returns the
    phase's results and sample()'s."""
    import numpy as np

    import advancedhmc_torch as ah

    target, kernel, adaptor = wide_spec()
    target, by_chains = count_by_chains(target)
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(
            size=(WIDE_CHAINS, WIDE_DIM)),
        dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    metric = ah.make_metric("diagonal", WIDE_DIM, device="cuda")
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    res = ah.sample(
        gen, target, kernel, metric, theta0, WIDE_WARMUP + WIDE_DRAWS,
        n_adapts=WIDE_WARMUP, adaptor=adaptor, init_mass_matrix="gradient",
        cross_chain=True, fuse_draws=WIDE_FUSE, fuse_warmup=True,
        fuse_warmup_block=WARMUP_BLOCK, drop_warmup=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    by_chains = dict(sorted(by_chains.items(), reverse=True))
    k1_launches = launches["fused_logistic_value_grad"]
    k1_calls = launches[K1_CALLS]
    log(f"# wide path: K1 calls by chain count {by_chains}")

    th, st = res.thetas, res.stats
    t_draw = res.timings["draws_s"]
    moments, mcse, ess = _wide_moments(th)
    median_ess = float(ess.quantile(0.5))
    out = {
        "phase": "wide path",
        "chains": WIDE_CHAINS, "dim": WIDE_DIM, "rows": WIDE_ROWS,
        "warmup": WIDE_WARMUP, "draws": WIDE_DRAWS, "fuse": WIDE_FUSE,
        "init_s": res.timings["init_s"], "warmup_s": res.timings["warmup_s"],
        "draws_s": t_draw, "wall_s": wall,
        "effective_samples_per_s_per_chip": median_ess / t_draw,
        "median_pooled_ess": median_ess,
        "ess_per_s_incl_warmup":
            median_ess / (res.timings["warmup_s"] + t_draw),
        "min_ess_per_s": float(ess.min()) / t_draw,
        "leapfrog_steps_per_s": float(st["n_steps"].double().sum()) / t_draw,
        "accept_mean": float(st["acceptance_rate"].double().mean()),
        "divergence_rate": float(st["numerical_error"].double().mean()),
        "mean_tree_depth": float(st["tree_depth"].double().mean()),
        "leaf_iterations_per_transition":
            float(st["n_steps"].amax(1).double().mean()),
        "step_size": float(res.final_state.adapt.da.eps),
        **moments, "mcse": mcse,
        "k1_launches": k1_launches, "k1_calls": k1_calls,
        "k1_calls_by_chains": by_chains,
        "launches": launches, "seed": seed,
        "device": torch.cuda.get_device_name(0),
    }
    log(json.dumps(out))
    log(f"# wide path: init {out['init_s']:.1f} s, warmup "
        f"{out['warmup_s']:.1f} s, draws {t_draw:.1f} s, "
        f"{out['leaf_iterations_per_transition']:.1f} leaf iterations per "
        f"draw transition, K1 calls {k1_calls}, launches {k1_launches}")
    ref, ref_accept = wide_reference()
    out["reference"] = dict(moments=ref, accept_mean=ref_accept)
    gates = {
        f"draws finite, shape {(WIDE_DRAWS, WIDE_CHAINS, WIDE_DIM)}":
            tuple(th.shape) == (WIDE_DRAWS, WIDE_CHAINS, WIDE_DIM)
            and bool(torch.isfinite(th).all()),
        "divergence_rate <= 1e-3": out["divergence_rate"] <= 1e-3,
        f"|accept - JAX's {ref_accept:.4f}| <= {WIDE_TOL_ACCEPT}":
            abs(out["accept_mean"] - ref_accept) <= WIDE_TOL_ACCEPT,
        "k1 launched": k1_launches > 0,
        "k1 calls = value+grad calls": sum(by_chains.values()) == k1_calls,
        "k1 launches = 2 a call (stage A, stage B)":
            k1_launches == 2 * k1_calls,
        "no other kernel launched": launches["fused_nuts"] == 0
        and launches["fused_gaussian_leapfrog"] == 0,
    }
    for name in WIDE_MOMENTS:
        r = ref[name]
        floor = WIDE_K_RUNS * r["sd_between_runs"]
        tol = WIDE_K_MCSE * math.hypot(r["mcse"], mcse[name]) + floor
        gates[f"|{name} - JAX's {r['mean']:.4f}| <= {tol:.4f} (4 MCSE + "
              f"3 sd between JAX runs, {floor:.4f})"] = \
            abs(moments[name] - r["mean"]) <= tol
    for name, ok in gates.items():
        log(f"# gate {name}: {'ok' if ok else 'FAIL'}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"wide-path gates failed: {failed}")
    return out, res


# ----------------------------------------------------------------- phase 10
# The megakernel on the 1000-D model (K2's wide instance): from phase 9's
# final state, WIDE_K2_CALLS calls of MEGA_T transitions at max_depth
# MAX_DEPTH, threading the positions, a new seed per call.
WIDE_K2_CALLS, WIDE_K2_SEED0 = 4, 40
# K2 against its plain version at p > 128. At 1000-D a float32 rounding
# difference in lp is ~10x the 100-D one (K1's wide kernel: up to 5.1e-4),
# so near-ties flip more often than K2_AGREE_SHARE allows for: on the card
# one chain of the 256 divergent ones (0.0039) departed, so the share is
# the floor, 0.99. And the warmed 1000-D dynamics amplify rounding: from
# phase 9's state the largest |Δθ| over 1024 chains doubled about every
# transition, 8e-6 at transition 1, 9e-5 at 4, 8.8e-4 at 8, 4.2e-3 at 11
# (the median chain's stayed near 1e-6, and the integer outputs of every
# chain agreed at all 16), so θ is held to K2_THETA_TOL over the first
# WIDE_K2_THETA_T transitions and the integers over all of them.
WIDE_K2_AGREE_SHARE = 0.99
WIDE_K2_THETA_T = 4
# p = 129 (one column in the last chunk of 128) and p = 200 over a ragged
# n = 997 rows, 256 chains: a start (log σ, β ~ N(0, 0.05²)), M⁻¹ and ε at
# which trees of depth ~4 and no divergence occur
WIDE_K2_MODELS = ((129, 1000), (200, 997))
WIDE_K2_LOG_SIGMA0, WIDE_K2_M_INV, WIDE_K2_EPS = -1.5, 5e-3, 0.3
# K2's draws against the eager path's at transition 16: given the start and
# a frozen ε and M⁻¹ the chains are independent, so each cross-chain moment
# must agree within this many combined standard errors (both runs start
# from the same positions, which only narrows their difference)
WIDE_K2_K_SE = 4.0


def k2_wide_report(args):
    """The wide instance's registers and spills (ptxas), and at the 1000-D
    model (`args`, phase 10's call 1) its shared memory per block, resident
    blocks per SM, ranks (blocks) per cluster of 64 chains, blocks,
    clusters the card holds at once, and the SMs that held a block."""
    import ctypes

    from advancedhmc_torch.ops import _build
    from advancedhmc_torch.ops import fused_nuts_kernel as k2

    target, th0, m_inv, eps, seed, data, dim, _, max_depth, bc = args
    lib = _build.load("fused_nuts")
    k2._kernel(lib)
    (regs, spill), = [(r, sp) for _, r, sp, mangled in ptxas_instances(
        "fused_nuts", r"LogisticTargetILi(\d+)E")
        if "WideLogisticTarget" in mangled]
    per_group = lib.fused_nuts_chains_per_block()
    ranks, clusters = ctypes.c_int(), ctypes.c_int()
    lib.fused_nuts_cluster_shape(0, WIDE_CHAINS, WIDE_DIM, WIDE_ROWS,
                                 ctypes.byref(ranks), ctypes.byref(clusters))
    groups = -(-WIDE_CHAINS // per_group)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = dict(registers=int(regs), spill_store_bytes=int(spill),
               chains_per_block=per_group,
               smem_bytes_per_block=int(lib.fused_nuts_smem_bytes(
                   0, WIDE_DIM)),
               blocks_per_sm=lib.fused_nuts_blocks_per_sm(0, WIDE_DIM),
               ranks_per_cluster=ranks.value, groups=groups,
               blocks=groups * ranks.value,
               resident_clusters=clusters.value, sms=sms,
               sms_used=k2.sms_used(target, th0, m_inv, eps, seed, data,
                                    dim, max_depth, bc))
    log(f"# K2 wide (p > 128): {regs} registers, {spill} bytes of spill "
        f"stores (ptxas); dim={WIDE_DIM}: {out['smem_bytes_per_block']} "
        f"bytes of shared memory per block, {out['blocks_per_sm']} blocks "
        f"per SM; C={WIDE_CHAINS}: {groups} groups of {per_group} chains, "
        f"each a cluster of {ranks.value} blocks ({out['blocks']} blocks; "
        f"the card holds {clusters.value} such clusters at once), on "
        f"{out['sms_used']} of {sms} SMs")
    return out


def cross_chain_moments(th):
    """Mean log σ, sd log σ and |mean β| across the chains of θ (C, dim),
    each with its standard error for independent chains: the sd's from the
    spread of the squared deviations, |mean β|'s by the delta method with
    the full covariance of β across chains (the spread of each chain's β
    projected on the mean's direction; β's components move together while
    the chains drift, so the diagonal alone understates it)."""
    th = th.double()
    c = th.shape[0]
    ls, beta = th[:, 0], th[:, 1:]
    sd = float(ls.std(correction=0))
    dev2 = (ls - ls.mean()) ** 2
    mean_b = beta.mean(0)
    norm = float(mean_b.norm())
    along = beta @ (mean_b / norm)                  # (C,)
    return {
        "mean_logsigma": (float(ls.mean()), sd / math.sqrt(c)),
        "sd_logsigma": (sd, float(dev2.std()) / math.sqrt(c) / (2 * sd)),
        "mean_beta_norm": (norm, float(along.std()) / math.sqrt(c)),
    }


def phase_wide_megakernel(res, wide_out):
    """K2 on the 1000-D model from phase 9's final state: against its plain
    version, then its draws (launches counted from 0) against the eager
    fused draws' law."""
    import numpy as np

    from advancedhmc_torch import SampleSpec, fused_draw_phase
    from advancedhmc_torch.models.logistic import hierarchical_logistic_block
    from advancedhmc_torch.ops import fused_nuts_kernel as k2

    fs = res.final_state
    eps = float(fs.adapt.da.eps)
    m_inv = fs.metric.m_inv.to(torch.float32).contiguous()
    th_start = fs.z.theta.to(torch.float32).contiguous()
    target, data = hierarchical_logistic_block(
        n=WIDE_ROWS, p=WIDE_DIM - 1, d_pad=1024, device="cuda")

    def warmed(th0, e, T, seed=WIDE_K2_SEED0):
        return (target, th0.contiguous(), m_inv, e, seed, data, WIDE_DIM, T,
                MAX_DEPTH, MEGA_BLOCK)

    shape = k2_wide_report(warmed(th_start, eps, MEGA_T))

    def model(p, n):
        tgt, dat = hierarchical_logistic_block(n=n, p=p, d_pad=256,
                                               device="cuda")
        th0 = torch.as_tensor(
            0.05 * np.random.default_rng(p).normal(size=(256, p + 1)),
            dtype=torch.float32, device="cuda")
        th0[:, 0] = WIDE_K2_LOG_SIGMA0
        return (tgt, th0, torch.full((p + 1,), WIDE_K2_M_INV, device="cuda"),
                WIDE_K2_EPS, 7, dat, p + 1, 8, MAX_DEPTH, MEGA_BLOCK)

    # (a) against the plain version, each case twice through K2
    rows = k2_parity_rows([
        (f"wide p=999 C={WIDE_CHAINS} T={MEGA_T} (call 1's inputs)",
         warmed(th_start, eps, MEGA_T), None),
        (f"wide deep eps/8 C=256 T=4 max_depth={MAX_DEPTH}",
         warmed(th_start[:256], eps / 8, 4),
         ("mean depth >= 5.5", lambda o: _mean_depth(o) >= 5.5)),
        ("wide divergent 3eps C=256 T=8",
         warmed(th_start[:256], 3 * eps, 8),
         ("divergence rate >= 0.5",
          lambda o: float(o[3].double().mean()) >= 0.5)),
        *[(f"wide p={p} n={n} C=256 T=8", model(p, n),
           ("mean depth >= 2", lambda o: _mean_depth(o) >= 2.0))
          for p, n in WIDE_K2_MODELS],
    ], WIDE_K2_AGREE_SHARE, WIDE_K2_THETA_T)

    # (b) the draws, with the launch counts set to 0 just before
    reset_launches()
    t0 = time.perf_counter()
    outs, events, th0 = [], [], th_start
    for rep in range(WIDE_K2_CALLS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = k2.fused_nuts(*warmed(th0, eps, MEGA_T, WIDE_K2_SEED0 + rep))
        e1.record()
        outs.append(out)
        events.append((e0, e1))
        th0 = out[0][-1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    call_ms = [a.elapsed_time(b) for a, b in events]
    leaves = torch.stack([o[1].sum(0) for o in outs]).double()   # (calls, C)
    bounds = [k2_bound_ms(float(lv.sum()), WIDE_CHAINS, WIDE_DIM, WIDE_ROWS,
                          MEGA_T) for lv in leaves]
    lockstep = [lockstep_share(lv[None], shape["chains_per_block"])
                for lv in leaves]
    # the blocks run side by side, so a call lasts as long as its slowest
    # block, which iterates as often as its chain with the most leaves
    iters = leaves.amax(1)
    depth = [float(o[2].double().mean()) for o in outs]
    div = float(torch.cat([o[3] for o in outs]).double().mean())
    finite = all(tuple(o[0].shape) == (MEGA_T, WIDE_CHAINS, WIDE_DIM)
                 and bool(torch.isfinite(o[0]).all()) for o in outs)
    k2_last = outs[0][0][-1]
    del outs

    # (c) the eager fused draws from the same state, ε and M⁻¹
    w_target, w_kernel, w_adaptor = wide_spec()
    spec = SampleSpec(target=w_target, kernel=w_kernel, adaptor=w_adaptor,
                      cross_chain=True)
    gen = torch.Generator(device="cuda").manual_seed(WIDE_K2_SEED0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, th_eager, st_eager = fused_draw_phase(gen, spec, fs, MEGA_T, MEGA_T)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t1
    mom_k2 = cross_chain_moments(k2_last)
    mom_eager = cross_chain_moments(th_eager[-1])

    out = {
        "phase": "wide megakernel",
        "calls": WIDE_K2_CALLS, "transitions_per_call": MEGA_T,
        "chains": WIDE_CHAINS, "dim": WIDE_DIM, "rows": WIDE_ROWS,
        "max_depth": MAX_DEPTH, "block_chains": MEGA_BLOCK,
        "step_size": eps, "wall_s": wall,
        "call_ms": call_ms, "call_ms_mean": sum(call_ms) / len(call_ms),
        "bound_ms": [b[0] for b in bounds],
        "bound_ms_mean": sum(b[0] for b in bounds) / len(bounds),
        "bound_by": bounds[0][1],
        "n_steps_total": float(leaves.sum()),
        "lockstep_share": lockstep,
        "leaf_iterations": iters.tolist(),
        "ms_per_leaf_iteration": [m / float(i) for m, i in
                                  zip(call_ms, iters)],
        "mean_tree_depth_by_call": depth,
        "mean_tree_depth": sum(depth) / len(depth),
        "divergence_rate": div,
        "k2_launches": launches["fused_nuts"], "launches": launches,
        **shape,
        "eager_16_transitions_s": eager_s,
        "eager_mean_tree_depth": float(
            st_eager["tree_depth"].double().mean()),
        "moments_k2": mom_k2, "moments_eager": mom_eager,
        "phase9_mean_tree_depth": wide_out["mean_tree_depth"],
        "device": torch.cuda.get_device_name(0),
    }
    log(json.dumps(out))
    log(f"# wide megakernel: {out['call_ms_mean']:.1f} ms per call of "
        f"{MEGA_T} transitions at C={WIDE_CHAINS} (bound "
        f"{out['bound_ms_mean']:.2f} ms, {out['bound_by']}), "
        f"{sum(out['ms_per_leaf_iteration']) / WIDE_K2_CALLS:.3f} ms per "
        f"lock-step leaf iteration; lock-step share "
        f"{', '.join(f'{x:.4f}' for x in lockstep)}; the eager fused "
        f"draws took {eager_s:.1f} s for {MEGA_T} transitions")
    gates = {
        f"draws finite, shape {(MEGA_T, WIDE_CHAINS, WIDE_DIM)}": finite,
        "divergence_rate <= 1e-3": div <= 1e-3,
        f"|mean depth - phase 9's| <= {K2_DEPTH_TOL}":
            abs(out["mean_tree_depth"] - wide_out["mean_tree_depth"])
            <= K2_DEPTH_TOL,
        f"k2 launched {WIDE_K2_CALLS} times":
            launches["fused_nuts"] == WIDE_K2_CALLS,
        f"k2 wide in clusters of more than one block ("
        f"{shape['ranks_per_cluster']}, {shape['resident_clusters']} "
        f"resident)": shape["ranks_per_cluster"] > 1
        and shape["resident_clusters"] >= 1,
    }
    for name in WIDE_MOMENTS:
        (a, se_a), (b, se_b) = mom_k2[name], mom_eager[name]
        tol = WIDE_K2_K_SE * math.hypot(se_a, se_b)
        gates[f"|{name} K2 {a:.4f} - eager {b:.4f}| <= {tol:.4f} "
              f"({WIDE_K2_K_SE:g} combined SEs) at transition {MEGA_T}"] = \
            abs(a - b) <= tol
    for name, ok in gates.items():
        log(f"# gate {name}: {'ok' if ok else 'FAIL'}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"wide megakernel gates failed: {failed}")
    out["shapes"] = rows
    return out


# ----------------------------------------------------------------- phase 11
# The JAX bench's own 1000-D configuration: phase 9's settings with the
# design stored in bfloat16 (bench.py stores it so by default at dim ≥ 512,
# AHMC_BENCH_X_DTYPE), so K1 runs its bfloat16 mode at every leaf. Gated as
# bench.py gates that run: importance weights of 4096 draws from the
# bf16-design posterior to the exact one (the exact log density in float64
# from the model's float64 data), sd(log w) ≤ 0.5 and reweighting ESS
# fraction ≥ 0.5; then phase 9's gates.
BF16_GATE_DRAWS, BF16_MAX_SD_LOGW, BF16_MIN_ESS_FRAC = 4096, 0.5, 0.5


def bf16_posterior_gate(target, thetas, p):
    """bench.py's bf16-X posterior-equivalence gate on draws `thetas`:
    (sd(log w), reweighting ESS fraction)."""
    import numpy as np

    from advancedhmc_torch.models.logistic import _synthetic_data

    x64, y64 = _synthetic_data(WIDE_ROWS, p)
    flat = thetas.reshape(-1, p + 1)
    idx = np.random.default_rng(0).choice(
        flat.shape[0], min(BF16_GATE_DRAWS, flat.shape[0]), replace=False)
    sub = flat[torch.as_tensor(idx, device=flat.device)]
    sub64 = sub.double().cpu().numpy()
    ls, beta = sub64[:, 0], sub64[:, 1:]
    logits = beta @ x64.T
    lp_e = (-0.5 * ls ** 2 - 0.5 * (beta ** 2).sum(1) * np.exp(-2 * ls)
            - p * ls + (y64[None] * logits
                        - np.logaddexp(0.0, logits)).sum(1))
    lp_b = target.logdensity(sub).double().cpu().numpy()
    logw = lp_e - lp_b
    w = np.exp(logw - logw.max())
    w /= w.sum()
    return float(logw.std()), float(1.0 / (len(w) * np.sum(w ** 2)))


def phase_wide_bf16(seed, wide_out):
    """Drive sample() on the 1000-D model with the bf16 design (phase 9's
    settings otherwise), K1's bf16-mode counts set to 0 just before and
    read just after; gate as bench.py and phase 9. Returns the results."""
    import numpy as np

    import advancedhmc_torch as ah

    _, kernel, adaptor = wide_spec()
    target = ah.hierarchical_logistic(n=WIDE_ROWS, p=WIDE_DIM - 1,
                                      dtype=torch.float32,
                                      x_dtype="bfloat16", device="cuda")
    target, by_chains = count_by_chains(target)
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(
            size=(WIDE_CHAINS, WIDE_DIM)),
        dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    metric = ah.make_metric("diagonal", WIDE_DIM, device="cuda")
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    res = ah.sample(
        gen, target, kernel, metric, theta0, WIDE_WARMUP + WIDE_DRAWS,
        n_adapts=WIDE_WARMUP, adaptor=adaptor, init_mass_matrix="gradient",
        cross_chain=True, fuse_draws=WIDE_FUSE, fuse_warmup=True,
        fuse_warmup_block=WARMUP_BLOCK, drop_warmup=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    calls = sum(by_chains.values())
    th, st = res.thetas, res.stats
    t_draw = res.timings["draws_s"]
    moments, mcse, ess = _wide_moments(th)
    median_ess = float(ess.quantile(0.5))
    sd_logw, ess_frac = bf16_posterior_gate(target, th, WIDE_DIM - 1)
    out = {
        "phase": "wide path, bf16 design",
        "chains": WIDE_CHAINS, "dim": WIDE_DIM, "rows": WIDE_ROWS,
        "warmup": WIDE_WARMUP, "draws": WIDE_DRAWS, "fuse": WIDE_FUSE,
        "x_dtype": "bfloat16",
        "init_s": res.timings["init_s"], "warmup_s": res.timings["warmup_s"],
        "draws_s": t_draw, "wall_s": wall,
        "effective_samples_per_s_per_chip": median_ess / t_draw,
        "median_pooled_ess": median_ess,
        "accept_mean": float(st["acceptance_rate"].double().mean()),
        "divergence_rate": float(st["numerical_error"].double().mean()),
        "mean_tree_depth": float(st["tree_depth"].double().mean()),
        "leaf_iterations_per_transition":
            float(st["n_steps"].amax(1).double().mean()),
        "step_size": float(res.final_state.adapt.da.eps),
        **moments, "mcse": mcse,
        "bf16x_logw_sd": sd_logw, "bf16x_rew_ess_frac": ess_frac,
        "k1_bf16_launches": launches[K1_BF16],
        "k1_bf16_calls": launches[K1_BF16_CALLS],
        "value_grad_calls": calls, "launches": launches, "seed": seed,
        "phase9": {k: wide_out[k] for k in (
            "warmup_s", "draws_s", "effective_samples_per_s_per_chip",
            "accept_mean", "mean_tree_depth")},
        "device": torch.cuda.get_device_name(0),
    }
    log(json.dumps(out))
    log(f"# wide path, bf16 design: warmup {out['warmup_s']:.1f} s, draws "
        f"{t_draw:.1f} s, ESS/s {out['effective_samples_per_s_per_chip']:.1f}"
        f" (phase 9, float32 design: warmup {wide_out['warmup_s']:.1f} s, "
        f"draws {wide_out['draws_s']:.1f} s, ESS/s "
        f"{wide_out['effective_samples_per_s_per_chip']:.1f}); sd(log w) "
        f"{sd_logw:.4f}, reweighting ESS fraction {ess_frac:.4f}; K1 bf16 "
        f"calls {out['k1_bf16_calls']}, launches {out['k1_bf16_launches']}")
    ref, ref_accept = wide_reference()
    gates = {
        f"sd(log w) <= {BF16_MAX_SD_LOGW} (bench.py's bf16 gate)":
            sd_logw <= BF16_MAX_SD_LOGW,
        f"reweighting ESS fraction >= {BF16_MIN_ESS_FRAC} (bench.py)":
            ess_frac >= BF16_MIN_ESS_FRAC,
        f"draws finite, shape {(WIDE_DRAWS, WIDE_CHAINS, WIDE_DIM)}":
            tuple(th.shape) == (WIDE_DRAWS, WIDE_CHAINS, WIDE_DIM)
            and bool(torch.isfinite(th).all()),
        "divergence_rate <= 1e-3": out["divergence_rate"] <= 1e-3,
        f"|accept - JAX's {ref_accept:.4f}| <= {WIDE_TOL_ACCEPT}":
            abs(out["accept_mean"] - ref_accept) <= WIDE_TOL_ACCEPT,
        "k1 bf16 launched": out["k1_bf16_launches"] > 0,
        "k1 bf16 calls = value+grad calls = all K1 calls":
            out["k1_bf16_calls"] == calls == launches[K1_CALLS],
        "k1 bf16 launches = 2 a call": out["k1_bf16_launches"]
        == 2 * out["k1_bf16_calls"],
    }
    for name in WIDE_MOMENTS:
        r = ref[name]
        floor = WIDE_K_RUNS * r["sd_between_runs"]
        tol = WIDE_K_MCSE * math.hypot(r["mcse"], mcse[name]) + floor
        gates[f"|{name} - JAX's {r['mean']:.4f}| <= {tol:.4f} (phase 9's "
              "band)"] = abs(moments[name] - r["mean"]) <= tol
    for name, ok in gates.items():
        log(f"# gate {name}: {'ok' if ok else 'FAIL'}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"bf16 wide-path gates failed: {failed}")
    return out


# ----------------------------------------------------------------- phase 12
# The new options of sample() at the 100-D model's full width, short runs
# (draws cut: 50 per-chain fused draws in (a), 32 in (b), 16 coupled steps
# in (c); (b) and (c) halved to leave room for phase 17; then (a) to 20
# with phase 8 and (c) to 8 steps, to bring the script under its 1200 s
# clock), each gated on
# divergence, acceptance and BENCH_r05's moments:
# (a) the per-chain fused warmup (phase 8's settings, 4096 chains) and
#     fused draws thinned by 2;
# (b) phase 3's configuration with the three-phase depth cap and ε
#     re-anchor, two chain chunks, bfloat16 U-turn stacks and online
#     collection (its summary's moments gated like stored draws);
# (c) coupled chains on the step path, from (a)'s warmed state.
OPT_FUSE, OPT_THIN = 10, 2
OPT_CAP, OPT_CAP_FRAC, OPT_CAP_FRAC2, OPT_DRAWS_B = 4, 0.25, 0.5, 32
OPT_COUPLED_STEPS = 8


def _fused_iterations(stats):
    """Leaf-loop iterations per transition of a fused single-leaf phase
    from its stats (T, C): the loop runs until its slowest chain has done
    all its leaves, Σ_t n_steps of that chain (to within the loop's check
    interval)."""
    return float(stats["n_steps"].double().sum(0).max()) / \
        stats["n_steps"].shape[0]


def _online_moment_gates(online):
    """Phase 4's moment gates on an online summary (per-chain means and
    variances): the pooled moments of every draw it folded in."""
    n = float(online["n"])
    mean, var = online["mean"].double(), online["var"].double()
    ls_mean = float(mean[:, 0].mean())
    # pooled variance of log σ over chains and draws
    ls_var = float((var[:, 0] * (n - 1) / n).mean()
                   + ((mean[:, 0] - ls_mean) ** 2).mean())
    return _gate_moments({"mean_logsigma": ls_mean,
                          "sd_logsigma": math.sqrt(ls_var),
                          "mean_beta_norm": float(mean[:, 1:].mean(0).norm())})


def _option_gates(name, out, moment_gates, delta, tol_accept):
    gates = {
        "divergence_rate <= 1e-3": out["divergence_rate"] <= 1e-3,
        f"|accept - {delta}| <= {tol_accept}":
            abs(out["accept_mean"] - delta) <= tol_accept,
        **moment_gates,
    }
    for g, ok in gates.items():
        log(f"# gate {name} {g}: {'ok' if ok else 'FAIL'}")
    failed = [g for g, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"phase 12 {name} gates failed: {failed}")


def phase_options(seed, defaults):
    """Phase 12: the three runs; returns their results."""
    import numpy as np

    import advancedhmc_torch as ah

    target, kernel, main_adaptor = main_path_spec()
    target, by_chains = count_by_chains(target)
    results = {}

    # (a) per-chain fused warmup, then fused draws thinned
    adaptor = ah.AdaptorConfig(
        kind="stan", da=ah.DualAveragingConfig(delta=DEF_DELTA),
        init_buffer=DEF_BUFFERS[0], term_buffer=DEF_BUFFERS[1],
        window_size=DEF_BUFFERS[2])
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(size=(DEF_CHAINS, DIM)),
        dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    metric = ah.make_metric("diagonal", DIM, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    by_chains.clear()
    t0 = time.perf_counter()
    res = ah.sample(gen, target, kernel, metric, theta0, DEF_SAMPLES,
                    n_adapts=DEF_ADAPTS, adaptor=adaptor,
                    init_mass_matrix="gradient", fuse_warmup=True,
                    fuse_draws=OPT_FUSE, thin=OPT_THIN, drop_warmup=True,
                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, ws = res.stats, res.warmup_stats
    n_kept = (DEF_SAMPLES - DEF_ADAPTS) // OPT_THIN
    a = {
        "run": "a: per-chain fused warmup, fused draws, thin 2",
        "chains": DEF_CHAINS, "adapts": DEF_ADAPTS,
        "draws": DEF_SAMPLES - DEF_ADAPTS, "fuse": OPT_FUSE,
        "thin": OPT_THIN, "kept": n_kept,
        "init_s": res.timings["init_s"], "warmup_s": res.timings["warmup_s"],
        "draws_s": res.timings["draws_s"], "wall_s": wall,
        "warmup_leaf_iterations_per_transition": _fused_iterations(ws),
        "warmup_mean_tree_depth": float(ws["tree_depth"].double().mean()),
        # the thinned rows' n_steps sum their block's, so this is the
        # slowest chain's leaves over all the draws' transitions
        "draws_leaf_iterations_per_transition":
            float(st["n_steps"].double().sum(0).max())
            / (DEF_SAMPLES - DEF_ADAPTS),
        "accept_mean": float(st["acceptance_rate"].double().mean()),
        "divergence_rate": float(st["numerical_error"].double().mean()),
        "k1_launches": read_launches()["fused_logistic_value_grad"],
        "value_grad_calls": sum(by_chains.values()),
        "phase8_warmup_s": defaults["warmup_s"],
        "phase8_leaf_iterations_per_transition":
            defaults["leaf_iterations_per_transition"],
        "step_size_median": float(res.final_state.adapt.da.eps.median()),
    }
    moments, gates = _moment_gates(res.thetas)
    a.update(moments)
    log(json.dumps(a))
    log(f"# phase 12a, per-chain fused warmup: warmup {a['warmup_s']:.1f} s,"
        f" {a['warmup_leaf_iterations_per_transition']:.1f} leaf iterations "
        f"a transition (phase 8, step by step: warmup "
        f"{defaults['warmup_s']:.1f} s, "
        f"{defaults['leaf_iterations_per_transition']:.1f} a transition); "
        f"fused draws {a['draws_s']:.1f} s "
        f"({a['draws_leaf_iterations_per_transition']:.1f} a transition), "
        f"{n_kept} kept of {a['draws']}")
    gates["thinned draws finite, shape"] = tuple(res.thetas.shape) == (
        n_kept, DEF_CHAINS, DIM) and bool(torch.isfinite(res.thetas).all())
    gates[f"final eps ({DEF_CHAINS},) and M^-1 ({DEF_CHAINS}, {DIM})"] = (
        tuple(res.final_state.adapt.da.eps.shape) == (DEF_CHAINS,)
        and tuple(res.final_state.metric.m_inv.shape) == (DEF_CHAINS, DIM))
    gates["k1 launches = value+grad calls"] = \
        a["k1_launches"] == a["value_grad_calls"] > 0
    _option_gates("12a", a, gates, DEF_DELTA, DEF_TOL_ACCEPT)
    results["a"] = a
    warmed = res.final_state
    del res

    # (b) phase 3's configuration with the depth cap, chunks, bf16 stacks
    # and online collection
    kernel_b = ah.HMCKernel(ah.Trajectory(
        kernel.trajectory.integrator, kernel.trajectory.criterion,
        stack_dtype="bfloat16"))
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(size=(N_CHAINS, DIM)),
        dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    metric = ah.make_metric("diagonal", DIM, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    by_chains.clear()
    t0 = time.perf_counter()
    res = ah.sample(
        gen, target, kernel_b, metric, theta0, N_WARMUP + OPT_DRAWS_B,
        n_adapts=N_WARMUP, adaptor=main_adaptor, init_mass_matrix="gradient",
        cross_chain=True, fuse_draws=FUSE, fuse_warmup=True,
        fuse_warmup_block=WARMUP_BLOCK, drop_warmup=True,
        warmup_chains=WARMUP_CHAINS, fanout_decorrelate=N_DECOR,
        fuse_pair=PAIR, fuse_chain_chunks=2, warmup_depth_cap=OPT_CAP,
        warmup_cap_frac=OPT_CAP_FRAC, warmup_eps_research=True,
        warmup_cap_frac2=OPT_CAP_FRAC2, collect="online", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, ws = res.stats, res.warmup_stats
    n_cap, n_cap2 = ah.depth_cap_schedule(
        N_WARMUP, OPT_CAP_FRAC, OPT_CAP_FRAC2, WARMUP_BLOCK, True)
    b = {
        "run": "b: phase 3 with the 3-phase depth cap, 2 chain chunks, "
               "bf16 stacks, online",
        "chains": N_CHAINS, "warmup_chains": WARMUP_CHAINS,
        "warmup": N_WARMUP, "draws": OPT_DRAWS_B, "depth_cap": OPT_CAP,
        "n_cap": n_cap, "n_cap2": n_cap2,
        "init_s": res.timings["init_s"], "warmup_s": res.timings["warmup_s"],
        "draws_s": res.timings["draws_s"], "wall_s": wall,
        "warmup_mean_tree_depth_capped":
            float(ws["tree_depth"][:n_cap2].double().mean()),
        "warmup_max_tree_depth_capped": int(ws["tree_depth"][:n_cap2].max()),
        "warmup_mean_tree_depth_full":
            float(ws["tree_depth"][n_cap2:].double().mean()),
        "draws_slowest_chain_leaves_per_transition": _fused_iterations(st),
        # every pair-body iteration of a chunk (half the chains) is two K1
        # calls; the chunks run one after the other
        "leaf_iterations_per_transition_per_chunk":
            by_chains[N_CHAINS // 2] / (2 if PAIR else 1) / 2
            / (N_DECOR + OPT_DRAWS_B),
        "accept_mean": float(st["acceptance_rate"].double().mean()),
        "divergence_rate": float(st["numerical_error"].double().mean()),
        "online_n": int(res.online["n"]),
        "online_min_ess": float(res.online["ess"].min()),
        "step_size": float(res.final_state.adapt.da.eps),
        "k1_launches": read_launches()["fused_logistic_value_grad"],
    }
    moments, gates = _online_moment_gates(res.online)
    b.update(moments)
    log(json.dumps(b))
    log(f"# phase 12b, depth-capped warmup (cap {OPT_CAP} to {n_cap2}, "
        f"re-anchor at {n_cap}), 2 chunks, bf16 stacks, online: warmup "
        f"{b['warmup_s']:.1f} s, draws {b['draws_s']:.1f} s "
        f"({b['leaf_iterations_per_transition_per_chunk']:.2f} leaf-loop "
        "iterations a transition in each of the two chunks, decorrelation "
        "and draws)")
    gates["no draws stored"] = res.thetas is None and b["online_n"] == \
        OPT_DRAWS_B
    gates[f"capped warmup trees <= {OPT_CAP}"] = \
        b["warmup_max_tree_depth_capped"] <= OPT_CAP
    _option_gates("12b", b, gates, DELTA, 0.1)
    results["b"] = b
    del res

    # (c) coupled chains, step by step, from (a)'s warmed state
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ah.sample(gen, target, kernel, warmed.metric, warmed.z.theta,
                    OPT_COUPLED_STEPS, init_eps=warmed.adapt.da.eps,
                    coupled=True, fuse_draws=FUSE, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = res.stats
    c = {
        "run": "c: coupled, step by step",
        "chains": DEF_CHAINS, "steps": OPT_COUPLED_STEPS,
        "draws_s": res.timings["draws_s"], "wall_s": wall,
        "leaf_iterations_per_transition":
            float(st["n_steps"].amax(1).double().mean()),
        "mean_tree_depth": float(st["tree_depth"].double().mean()),
        "accept_mean": float(st["acceptance_rate"].double().mean()),
        "divergence_rate": float(st["numerical_error"].double().mean()),
    }
    moments, gates = _moment_gates(res.thetas)
    c.update(moments)
    log(json.dumps(c))
    log(f"# phase 12c, coupled: {OPT_COUPLED_STEPS} steps in "
        f"{c['draws_s']:.1f} s, {c['leaf_iterations_per_transition']:.1f} "
        "leaf iterations a transition")
    gates["draws finite"] = bool(torch.isfinite(res.thetas).all())
    _option_gates("12c", c, gates, DEF_DELTA, DEF_TOL_ACCEPT)
    results["c"] = c
    return results

# ----------------------------------------------------------------- phase 13
# ChEES-HMC at the JAX bench's configuration (bench.py:915-1090 at its
# defaults), full width: the main path's target and 32768 chains, δ 0.75,
# T0 4, Stan windows 75/50/25, 256 warmup iterations (T averaged from 128),
# 256 draws, max_steps 64 (2^max_depth), host chunks of 256 iterations
# (bench.py's chunk), the gradient-seeded M⁻¹, ε0 from the search on chain
# 0. bench.py's untimed program-load runs have nothing to load here.
CHEES_DELTA, CHEES_T0, CHEES_MAX_STEPS, CHEES_CHUNK = 0.75, 4.0, 64, 256
CHEES_WARMUP, CHEES_DRAWS, CHEES_PROFILE = 256, 256, 16
# What the JAX package computed in this run on a TPU v5e (BENCH_r05's
# chees_* keys): the reference's figures, printed beside the port's; its
# moments are the centres of the moment gates, with phase 4's bands.
CHEES_REF = {"accept": 0.745, "mean_traj_len": 2.1217, "eps": 0.47245,
             "mean_logsigma": -0.70992, "sd_logsigma": 0.1083,
             "mean_beta_norm": 4.71332, "ess_per_s": 7763841.01,
             "min_ess_per_s": 2074553.41, "leapfrog_steps_per_s": 47890504.1,
             "warmup_s": 1.92, "draws_s": 0.87}
CHEES_TOL_ACCEPT = 0.1


def phase_chees(seed):
    """Phase 13: bench.py's ChEES measurement through `make_chees_step` and
    `make_chees_draw_step`, every kernel's count set to 0 just before and
    read just after; gated, then one draw chunk of CHEES_PROFILE
    iterations profiled. Returns the results."""
    import numpy as np

    import advancedhmc_torch as ah
    from advancedhmc_torch.chees import draw_carry
    from advancedhmc_torch.diagnostics import effective_sample_size

    target, _, _ = main_path_spec()
    target, by_chains = count_by_chains(target)
    cfg = ah.AdaptorConfig(kind="stan", mm_kind="welford_var",
                           da=ah.DualAveragingConfig(delta=CHEES_DELTA),
                           init_buffer=75, term_buffer=50, window_size=25)
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(size=(N_CHAINS, DIM)),
        dtype=torch.float32, device="cuda")
    n_total = CHEES_WARMUP + CHEES_DRAWS
    flags = ah.adapt_flags(cfg, CHEES_WARMUP, n_total)
    u_all = torch.as_tensor(ah.halton_sequence(n_total), dtype=torch.float32,
                            device="cuda")
    step = ah.make_chees_step(
        target, cfg, ah.CheesConfig(avg_start=CHEES_WARMUP // 2),
        CHEES_MAX_STEPS)
    dstep = ah.make_chees_draw_step(target, CHEES_MAX_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(3 + seed)
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    _, grads0 = target.logdensity_and_grad(theta0)
    m_inv0 = 1.0 / torch.clamp(grads0.abs().mean(0), 1e-3, 1e6)
    metric = ah.DiagEuclideanMetric.create(m_inv0)
    eps0 = ah.find_good_stepsize(gen, ah.Hamiltonian(metric=metric,
                                                     target=target),
                                 theta0[0])
    lp0, grad0 = target.logdensity_and_grad(theta0)
    lp0 = torch.where(torch.isfinite(lp0), lp0, float("-inf"))
    carry = (theta0, lp0, grad0, metric,
             ah.AdaptState.init(cfg, DIM, eps0, torch.float32),
             ah.CheesState.init(CHEES_T0, torch.float32, device="cuda"))
    uniform = torch.ones((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in range(0, CHEES_WARMUP, CHEES_CHUNK):
        for i in range(lo, min(lo + CHEES_CHUNK, CHEES_WARMUP)):
            carry, (_, st) = step(gen, carry,
                                  {k: bool(v[i]) for k, v in flags.items()},
                                  u_all[i])
            uniform &= (st["n_steps"] == st["n_steps"][0]).all()
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    dcarry = draw_carry(carry)
    th = torch.empty((CHEES_DRAWS, N_CHAINS, DIM), device="cuda")
    sums = torch.zeros(5, dtype=torch.float64, device="cuda")
    t0 = time.perf_counter()
    for lo in range(CHEES_WARMUP, n_total, CHEES_CHUNK):
        for i in range(lo, min(lo + CHEES_CHUNK, n_total)):
            dcarry, (th[i - CHEES_WARMUP], st) = dstep(gen, dcarry, u_all[i])
            uniform &= (st["n_steps"] == st["n_steps"][0]).all()
            sums += torch.stack([st[k].double().sum() for k in (
                "n_steps", "numerical_error", "acceptance_rate",
                "trajectory_length", "step_size")])
        torch.cuda.synchronize()
    draws_s = time.perf_counter() - t0
    counts = read_launches()
    by_chains = dict(sorted(by_chains.items(), reverse=True))

    lfs, divs, acc, tau, eps = sums.tolist()
    n_draws = CHEES_DRAWS * N_CHAINS
    ess_512 = effective_sample_size(th[:, :ESS_CHAINS])
    ess = ess_512 * (N_CHAINS / ESS_CHAINS)
    cs = carry[5]
    t_final = float(torch.exp(cs.log_t_avg))
    chees_cfg = ah.CheesConfig()
    moments, moment_gates = _moment_gates(th, (
        CHEES_REF["mean_logsigma"], CHEES_REF["sd_logsigma"],
        CHEES_REF["mean_beta_norm"]))
    out = {
        "phase": "13: ChEES, bench.py's configuration",
        "chains": N_CHAINS, "warmup": CHEES_WARMUP, "draws": CHEES_DRAWS,
        "delta": CHEES_DELTA, "t0": CHEES_T0, "max_steps": CHEES_MAX_STEPS,
        "init_s": init_s, "warmup_s": warmup_s, "draws_s": draws_s,
        "chees_ess_per_s": float(ess.quantile(0.5)) / draws_s,
        "chees_min_ess_per_s": float(ess.min()) / draws_s,
        "chees_median_pooled_ess": float(ess_512.quantile(0.5)),
        "chees_leapfrog_steps_per_s": lfs / draws_s,
        "leapfrog_steps_per_draw": lfs / n_draws,
        "chees_accept": acc / n_draws,
        "chees_divergence_rate": divs / n_draws,
        "chees_mean_traj_len": tau / n_draws,
        "chees_eps": eps / n_draws,
        "t_final": t_final, "eps_final": float(carry[4].da.eps),
        **moments,
        "k1_calls": counts[K1_CALLS],
        "k1_launches": counts["fused_logistic_value_grad"],
        "value_grad_calls": sum(by_chains.values()),
        "calls_by_chains": by_chains,
        "reference_tpu_v5e_bench_r05": CHEES_REF,
        "device": torch.cuda.get_device_name(0),
    }
    log(json.dumps(out))
    log(f"# phase 13, ChEES: warmup {warmup_s:.2f} s, draws {draws_s:.2f} s "
        f"(the JAX package on a TPU v5e, BENCH_r05: "
        f"{CHEES_REF['warmup_s']} / {CHEES_REF['draws_s']} s); ESS/s "
        f"{out['chees_ess_per_s']:.0f}, min {out['chees_min_ess_per_s']:.0f}"
        f" (reference {CHEES_REF['ess_per_s']:.0f}, "
        f"{CHEES_REF['min_ess_per_s']:.0f}); leapfrog steps/s "
        f"{out['chees_leapfrog_steps_per_s']:.0f} (reference "
        f"{CHEES_REF['leapfrog_steps_per_s']:.0f}); accept "
        f"{out['chees_accept']:.4f}, T {out['chees_mean_traj_len']:.4f}, ε "
        f"{out['chees_eps']:.5f} (reference {CHEES_REF['accept']}, "
        f"{CHEES_REF['mean_traj_len']}, {CHEES_REF['eps']}); "
        f"{out['leapfrog_steps_per_draw']:.2f} steps a draw; K1 calls "
        f"by chain count {by_chains}")
    gates = {
        f"draws finite, shape ({CHEES_DRAWS}, {N_CHAINS}, {DIM})":
            tuple(th.shape) == (CHEES_DRAWS, N_CHAINS, DIM)
            and bool(torch.isfinite(th).all()),
        "numerical-error rate <= 1e-3": out["chees_divergence_rate"] <= 1e-3,
        f"|accept - {CHEES_DELTA}| <= {CHEES_TOL_ACCEPT}":
            abs(out["chees_accept"] - CHEES_DELTA) <= CHEES_TOL_ACCEPT,
        "n_steps equal across chains at every iteration": bool(uniform),
        "finalized T finite, inside CheesConfig's bounds":
            math.isfinite(t_final)
            and chees_cfg.min_trajectory_length * (1 - 1e-6) <= t_final
            <= chees_cfg.max_trajectory_length * (1 + 1e-6),
        **moment_gates,
        "k1 calls = value+grad calls":
            out["k1_calls"] == out["value_grad_calls"] > 0,
        "k1 launches = calls": out["k1_launches"] == out["k1_calls"],
        "ESS finite": math.isfinite(out["chees_ess_per_s"])
        and out["chees_ess_per_s"] > 0,
    }
    for name, ok in gates.items():
        log(f"# gate 13 {name}: {'ok' if ok else 'FAIL'}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(f"phase 13 gates failed: {failed}")
    del th

    def chunk():
        c = dcarry
        for i in range(CHEES_PROFILE):
            c, _ = dstep(gen, c, u_all[CHEES_WARMUP + i])

    out["profile"] = profile_call(
        f"one ChEES draw chunk of {CHEES_PROFILE} iterations", chunk)
    return out


# ----------------------------------------------------------------- phase 14
# The static path through the constructors, from phase 3's warmed state: its
# ε and M⁻¹ and STATIC_CHAINS of its final positions.
# (HMCDA's draws cut from 100 to 50 and the jittered NUTS's from 64 to 32
# to bring the script under its 1200 s clock)
STATIC_CHAINS, STATIC_ITERS, STATIC_DA_ITERS, STATIC_DA_ADAPTS = \
    4096, 64, 150, 100
STATIC_FUSE, STATIC_NUTS_DRAWS, STATIC_DA_DELTA = 8, 32, 0.8
# HMC's acceptance floors, set before the first run: ε is phase 3's, tuned
# for NUTS's tree-mean acceptance 0.55 at δ 0.55; an endpoint of εL ≈ 1
# carries an energy error of the same order as the tree's leaves, so its
# acceptance should be near 0.55, and 0.4 leaves room for the spread of
# one endpoint against a tree's mean. The multinomial statistic averages
# min(1, exp(H0 − H)) over the trajectory with the origin at 1, so it lies
# above the endpoint's: 0.5.
STATIC_ACCEPT_FLOOR = {"endpoint": 0.4, "multinomial": 0.5}


def phase_static(seed, warmed):
    """Phase 14: (a) HMC(ε, L) endpoint, (b) HMC multinomial, (c) HMCDA(0.8,
    1) with phase 3's M⁻¹, (d) jittered NUTS on the fused loop, each from
    `warmed` = (ε, M⁻¹, θ) of phase 3, its counts set to 0 just before and
    read just after; returns the runs' results."""
    import advancedhmc_torch as ah

    eps, m_inv, theta = warmed
    eps_f = float(eps)
    n_leap = max(1, round(1.0 / eps_f))
    target, _, _ = main_path_spec()
    target, by_chains = count_by_chains(target)
    runs = {
        "a": (f"HMC({eps_f:.4f}, {n_leap}) endpoint", ah.HMC(eps_f, n_leap),
              dict(n_samples=STATIC_ITERS, init_eps=eps)),
        "b": (f"HMC({eps_f:.4f}, {n_leap}) multinomial",
              ah.HMC(eps_f, n_leap, ts_kind="multinomial"),
              dict(n_samples=STATIC_ITERS, init_eps=eps)),
        "c": (f"HMCDA({STATIC_DA_DELTA}, 1.0)", ah.HMCDA(STATIC_DA_DELTA, 1.0),
              dict(n_samples=STATIC_DA_ITERS, n_adapts=STATIC_DA_ADAPTS)),
        "d": ("NUTS(0.55, max_depth=6, jittered leapfrog), fused",
              ah.NUTS(DELTA, max_depth=MAX_DEPTH,
                      integrator="jitteredleapfrog"),
              dict(n_samples=STATIC_NUTS_DRAWS, n_adapts=0, init_eps=eps,
                   fuse_draws=STATIC_FUSE)),
    }
    results, failed = {}, []
    for i, (key, (name, cfg, kw)) in enumerate(runs.items()):
        gen = torch.Generator(device="cuda").manual_seed(40 + seed + i)
        metric = ah.DiagEuclideanMetric.create(m_inv)
        by_chains.clear()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = cfg.sample(gen, target, theta, metric=metric, device="cuda",
                         **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        n_adapts = kw.get("n_adapts", 0)
        th = res.thetas[n_adapts:]
        st = {k: v[n_adapts:] for k, v in res.stats.items()}
        out = {
            "run": f"14{key}: {name}", "chains": STATIC_CHAINS,
            "iterations": kw["n_samples"], "adapts": n_adapts,
            "warmup_s": res.timings["warmup_s"],
            "draws_s": res.timings["draws_s"], "wall_s": wall,
            "accept_mean": float(st["acceptance_rate"].double().mean()),
            "divergence_rate": float(st["numerical_error"].double().mean()),
            "mean_n_steps": float(st["n_steps"].double().mean()),
            "step_size_mean": float(st["step_size"].double().mean()),
            "k1_calls": counts[K1_CALLS],
            "k1_launches": counts["fused_logistic_value_grad"],
            "value_grad_calls": sum(by_chains.values()),
        }
        moments, gates = _moment_gates(th)
        out.update(moments)
        gates["draws finite"] = bool(torch.isfinite(th).all())
        gates["divergence_rate <= 1e-3"] = out["divergence_rate"] <= 1e-3
        if key in ("a", "b"):
            kind = cfg.kernel.trajectory.ts_kind
            floor = STATIC_ACCEPT_FLOOR[kind]
            gates[f"accept >= {floor} ({kind})"] = out["accept_mean"] >= floor
        else:
            delta = STATIC_DA_DELTA if key == "c" else DELTA
            gates[f"|accept - {delta}| <= 0.1"] = \
                abs(out["accept_mean"] - delta) <= 0.1
        if key == "d":
            e = st["step_size"]
            gates["jittered eps inside eps(1 +- 0.1), nominal eps"] = bool(
                ((e >= 0.9 * eps_f * (1 - 1e-6))
                 & (e <= 1.1 * eps_f * (1 + 1e-6))).all()
                and (st["nom_step_size"] == eps).all())
            out["mean_tree_depth"] = float(st["tree_depth"].double().mean())
        gates["k1 calls = value+grad calls"] = \
            out["k1_calls"] == out["value_grad_calls"] > 0
        gates["k1 launches = calls"] = out["k1_launches"] == out["k1_calls"]
        log(json.dumps(out))
        log(f"# phase 14{key}, {name}: warmup {out['warmup_s']:.1f} s, draws "
            f"{out['draws_s']:.1f} s, accept {out['accept_mean']:.4f}, "
            f"{out['mean_n_steps']:.2f} steps a transition, K1 launches "
            f"{out['k1_launches']}")
        for g, ok in gates.items():
            log(f"# gate 14{key} {g}: {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"14{key}: {g}")
        results[key] = out
        del res, th, st
    if failed:
        raise RuntimeError(f"phase 14 gates failed: {failed}")
    return results



# ----------------------------------------------------------------- phase 15
# The dense and rank-update metrics and the Welford-cov, low-rank and nutpie
# estimators at the 100-D model's width. Stan's 75/50/25 windows end at
# iterations 100 and 206 of 256 and at 100 of 150; at 128 there is none.
# To leave room for phase 17, (a)-(c) warm 150 iterations, not 256 (one
# window, then the same 50 iterations of dual averaging after its reset),
# (b) draws 128, not 256, and (d) runs 512 chains, not 1024, and 16
# draws, not 64. To leave room for phase 18, (a) draws 64, not 256, (b)
# 64, not 128, and (d) warms 100 iterations, not 150, its buffers cut
# from 75/50/25 to 50/25/25 (still one window, then 25 iterations of
# dual averaging after its reset). To bring the script under its 1200 s
# clock, (a)-(c) warm as (d) does, 100 iterations with buffers 50/25/25,
# not 150 with 75/50/25, and (d) draws 8, not 16. To make room for phase
# 19, (a)-(d) warm 70 iterations with buffers 35/20/15 (one window of 15,
# then 20 of dual averaging after its reset, 10 updates in blocks of 2)
MM_WARMUP, MM_CHAINS_C, MM_CHAINS_D = 70, 1024, 512
MM_DRAWS_A, MM_DRAWS_B, MM_DRAWS_C, MM_DRAWS_D = 64, 64, 64, 8
MM_BUFFERS = (35, 20, 15)
# The fused cross-chain warmup updates dual averaging once a block: blocks
# of 8 leave 6 updates between the last window's reset (206 of 256, 100 of
# 150) and the end, and the re-anchored ε overshoots (×75 in one block)
# before they settle; blocks of 4 left 12 after the reset at 100 of 150,
# and blocks of 2 leave 12 after the reset at 75 of 100 (15b, 15c).
MM_WARMUP_BLOCK = 2
# Stan's dual averaging ends at ε = exp(x̄), below its last iterates, so
# the draws accept above δ: in 15a's configuration the JAX package leaves
# δ + 0.09 (`scripts/accept_reference.py`), at the edge of a ±0.1 band;
# 15a–c are gated on this band, above δ by 0.2 and below by 0.1
MM_ACCEPT_BAND = (round(DELTA - 0.1, 2), round(DELTA + 0.2, 2))
# The draws' M⁻¹ ratio band (15a), the dense estimate's distance to the
# draws' covariance (15b: JAX `tests/test_fused_warmup_cc.py:66`'s rtol),
# and the momentum draws' covariance (15b, 15c)
NUTPIE_RATIO = (0.7, 1.4)
DENSE_COV_RTOL, MOMENTUM_DRAWS, MOMENTUM_RTOL = 0.25, 1 << 18, 0.03
SYM_RTOL, CHOL_RTOL = 1e-6, 1e-4


def _rel_fro(a, b):
    """‖a − b‖_F / ‖b‖_F in float64 (over the last two axes, the largest
    over any leading ones)."""
    a, b = a.double(), b.double()
    return float((torch.linalg.matrix_norm(a - b)
                  / torch.linalg.matrix_norm(b)).max())


def _momentum_cov_err(metric, seed):
    """Relative Frobenius distance between the covariance of
    MOMENTUM_DRAWS `rand_momentum` draws and the float64 inverse of M⁻¹."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = metric.rand_momentum(gen, MOMENTUM_DRAWS).double()
    emp = torch.cov(r.T)
    return _rel_fro(emp, torch.linalg.inv(metric.m_inv_matrix().double()))


def _chol_err(metric):
    """How far UᵀU is from M⁻¹ (relative Frobenius, every chain)."""
    u = metric.chol_u.double()
    return _rel_fro(u.mT @ u, metric.m_inv.double())


def _timed_run(by_chains, fn):
    """Runs `fn()` with every kernel's count set to 0 just before and read
    just after, and the value+grad tally cleared; (result, wall, tally,
    counts)."""
    by_chains.clear()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, dict(by_chains), read_launches())


def _mm_run(name, res, wall, by_chains, counts, chains, n_warmup, n_draws,
            pair, transitions_at, extra):
    """Phase 15's common report of one run: walls, ESS/s (bench.py's
    estimator), accept, final ε, leaf-loop iterations a transition at the
    chain count `transitions_at` = (C, transitions run there), K1's calls
    by chain count, the moments."""
    from advancedhmc_torch.diagnostics import effective_sample_size

    th, st = res.thetas, res.stats
    n_ess = min(ESS_CHAINS, chains)
    ess = effective_sample_size(th[:, :n_ess]) * (chains / n_ess)
    t_draw = res.timings["draws_s"]
    c_it, n_it = transitions_at
    eps = res.final_state.adapt.da.eps
    out = {
        "run": name, "chains": chains, "warmup": n_warmup, "draws": n_draws,
        "init_s": res.timings["init_s"], "warmup_s": res.timings["warmup_s"],
        "draws_s": t_draw, "wall_s": wall,
        "effective_samples_per_s_per_chip": float(ess.quantile(0.5))
        / t_draw,
        "min_ess_per_s": float(ess.min()) / t_draw,
        "accept_mean": float(st["acceptance_rate"].double().mean()),
        "divergence_rate": float(st["numerical_error"].double().mean()),
        "mean_tree_depth": float(st["tree_depth"].double().mean()),
        "step_size": float(eps.median()) if eps.dim() else float(eps),
        "leaf_iterations_per_transition":
            by_chains.get(c_it, 0) / (2 if pair else 1) / n_it,
        "k1_calls": counts[K1_CALLS],
        "k1_launches": counts["fused_logistic_value_grad"],
        "value_grad_calls": sum(by_chains.values()),
        "k1_calls_by_chains": dict(sorted(by_chains.items(), reverse=True)),
        **extra,
    }
    moments, gates = _moment_gates(th)
    out.update(moments)
    gates["draws finite, shape"] = tuple(th.shape) == (
        n_draws, chains, DIM) and bool(torch.isfinite(th).all())
    gates["k1 calls = value+grad calls"] = \
        out["k1_calls"] == out["value_grad_calls"] > 0
    gates["k1 launches = calls"] = out["k1_launches"] == out["k1_calls"]
    gates["divergence_rate <= 1e-3"] = out["divergence_rate"] <= 1e-3
    return out, gates


def _mm_finish(key, out, gates, failed):
    log(json.dumps(out))
    log(f"# phase {key}, {out['run']}: warmup {out['warmup_s']:.1f} s, "
        f"draws {out['draws_s']:.1f} s, ESS/s "
        f"{out['effective_samples_per_s_per_chip']:.0f} (min "
        f"{out['min_ess_per_s']:.0f}), accept {out['accept_mean']:.4f}, "
        f"eps {out['step_size']:.5f}, "
        f"{out['leaf_iterations_per_transition']:.2f} leaf-loop iterations "
        f"a transition, K1 calls by chain count {out['k1_calls_by_chains']}")
    for g, ok in gates.items():
        log(f"# gate {key} {g}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{key}: {g}")


def phase_metrics(seed, main_out):
    """Phase 15: (a) the JAX bench's nutpie run, (b) the main path with a
    dense metric, (c) the rank-update metric through `NUTS`, (d) the
    per-chain fused warmup with nutpie and with a per-chain dense metric;
    every kernel's count set to 0 just before each run and read just after.
    Returns the runs' results."""
    import numpy as np

    import advancedhmc_torch as ah

    target, kernel, main_adaptor = main_path_spec()
    target, by_chains = count_by_chains(target)
    results, failed = {}, []
    buffers = dict(zip(("init_buffer", "term_buffer", "window_size"),
                       MM_BUFFERS))
    main_adaptor = dataclasses.replace(main_adaptor, **buffers)

    def theta0(c, s=seed):
        return torch.as_tensor(
            0.1 * np.random.default_rng(s).normal(size=(c, DIM)),
            dtype=torch.float32, device="cuda")

    def run(gen, fn):
        return _timed_run(by_chains, lambda: fn(gen))

    # (a) bench.py with AHMC_BENCH_MM_KIND=nutpie AHMC_BENCH_WARMUP=256,
    # its warmup cut to MM_WARMUP: the cross-chain warmup runs step by step
    # (its fused form records no gradients), then phase 3's fan-out,
    # decorrelation and fused draws
    adaptor = dataclasses.replace(main_adaptor, mm_kind="nutpie")
    th0 = theta0(N_CHAINS)
    _, g = target.logdensity_and_grad(th0[:WARMUP_CHAINS])
    seed_m_inv = 1.0 / torch.clamp(g.abs().mean(0), 1e-3, 1e6)
    res, wall, calls, counts = run(
        torch.Generator(device="cuda").manual_seed(seed + 50),
        lambda gen: ah.sample(
            gen, target, kernel, ah.make_metric("diagonal", DIM,
                                                device="cuda"),
            th0, MM_WARMUP + MM_DRAWS_A, n_adapts=MM_WARMUP,
            adaptor=adaptor,
            init_mass_matrix="gradient", cross_chain=True,
            fuse_draws=FUSE, fuse_warmup=True, fuse_warmup_block=WARMUP_BLOCK,
            drop_warmup=True, warmup_chains=WARMUP_CHAINS,
            fanout_decorrelate=N_DECOR, fuse_pair=PAIR, device="cuda"))
    m_inv = res.final_state.metric.m_inv
    ratio = m_inv.double() / res.thetas.var((0, 1)).double()
    out, gates = _mm_run(
        "15a: nutpie, bench.py's configuration", res, wall, calls, counts,
        N_CHAINS, MM_WARMUP, MM_DRAWS_A, PAIR,
        (N_CHAINS, N_DECOR + MM_DRAWS_A),
        {"warmup_chains": WARMUP_CHAINS,
         "warmup_leaf_iterations_per_transition":
             calls.get(WARMUP_CHAINS, 0) / MM_WARMUP,
         "m_inv_over_draws_var_median": float(ratio.median()),
         "m_inv_rel_change_from_seed": float(
             (m_inv - seed_m_inv).norm() / seed_m_inv.norm()),
         "estimator": type(res.final_state.adapt.mm).__name__})
    gates[f"accept in {MM_ACCEPT_BAND}"] = \
        MM_ACCEPT_BAND[0] <= out["accept_mean"] <= MM_ACCEPT_BAND[1]
    gates["M^-1 moved from the gradient seed (> 1e-3 relative)"] = \
        out["m_inv_rel_change_from_seed"] > 1e-3
    lo, hi = NUTPIE_RATIO
    gates[f"median M^-1 / var(draws) in [{lo}, {hi}]"] = \
        lo <= out["m_inv_over_draws_var_median"] <= hi
    _mm_finish("15a", out, gates, failed)
    results["a"] = out
    del res, th0

    # (b) phase 3 with a dense metric and the Welford covariance, from the
    # identity, MM_WARMUP warmup iterations
    adaptor = dataclasses.replace(main_adaptor, mm_kind="welford_cov")
    res, wall, calls, counts = run(
        torch.Generator(device="cuda").manual_seed(seed + 51),
        lambda gen: ah.sample(
            gen, target, kernel, ah.make_metric("dense", DIM, device="cuda"),
            theta0(N_CHAINS), MM_WARMUP + MM_DRAWS_B, n_adapts=MM_WARMUP,
            adaptor=adaptor, cross_chain=True, fuse_draws=FUSE,
            fuse_warmup=True, fuse_warmup_block=MM_WARMUP_BLOCK,
            drop_warmup=True, warmup_chains=WARMUP_CHAINS,
            fanout_decorrelate=N_DECOR, fuse_pair=PAIR, device="cuda"))
    metric = res.final_state.metric
    m_inv = metric.m_inv
    draws_cov = torch.cov(res.thetas.reshape(-1, DIM).T).double()
    out, gates = _mm_run(
        "15b: main path, dense metric, Welford covariance", res, wall, calls,
        counts, N_CHAINS, MM_WARMUP, MM_DRAWS_B, PAIR,
        (N_CHAINS, N_DECOR + MM_DRAWS_B),
        {"warmup_chains": WARMUP_CHAINS,
         "phase3_ess_per_s": main_out["effective_samples_per_s_per_chip"],
         "phase3_draws_s": main_out["draws_s"],
         "m_inv_asymmetry": _rel_fro(m_inv, m_inv.mT),
         "chol_err": _chol_err(metric),
         "m_inv_vs_draws_cov": _rel_fro(m_inv, draws_cov),
         "momentum_cov_err": _momentum_cov_err(metric, seed + 52)})
    gates[f"accept in {MM_ACCEPT_BAND}"] = \
        MM_ACCEPT_BAND[0] <= out["accept_mean"] <= MM_ACCEPT_BAND[1]
    gates[f"M^-1 symmetric to {SYM_RTOL}"] = \
        out["m_inv_asymmetry"] <= SYM_RTOL
    gates[f"U^T U = M^-1 to {CHOL_RTOL}"] = out["chol_err"] <= CHOL_RTOL
    gates[f"|M^-1 - cov(draws)| <= {DENSE_COV_RTOL} |cov(draws)|"] = \
        out["m_inv_vs_draws_cov"] <= DENSE_COV_RTOL
    gates[f"momentum covariance within {MOMENTUM_RTOL} of M"] = \
        out["momentum_cov_err"] <= MOMENTUM_RTOL
    _mm_finish("15b", out, gates, failed)
    log(f"# phase 15b against phase 3 (diagonal) in this run: ESS/s "
        f"{out['effective_samples_per_s_per_chip']:.0f} against "
        f"{main_out['effective_samples_per_s_per_chip']:.0f}, draws "
        f"{out['draws_s']:.1f} s against {main_out['draws_s']:.1f} s")
    results["b"] = out
    del res, metric, m_inv, draws_cov

    # (c) NUTS(0.55, max_depth=6, metric="rank_update"): the low-rank
    # estimator at rank 8, cross-chain fused warmup on 1024 chains
    cfg = ah.NUTS(DELTA, max_depth=MAX_DEPTH, metric="rank_update")
    cfg = dataclasses.replace(
        cfg, adaptor=dataclasses.replace(cfg.adaptor, **buffers))
    res, wall, calls, counts = run(
        torch.Generator(device="cuda").manual_seed(seed + 53),
        lambda gen: cfg.sample(
            gen, target, theta0(MM_CHAINS_C), MM_WARMUP + MM_DRAWS_C,
            n_adapts=MM_WARMUP, cross_chain=True, fuse_warmup=True,
            fuse_warmup_block=MM_WARMUP_BLOCK, fuse_draws=FUSE,
            fuse_pair=PAIR, drop_warmup=True, device="cuda"))
    metric = res.final_state.metric
    out, gates = _mm_run(
        "15c: NUTS(metric='rank_update'), low-rank estimator", res, wall,
        calls, counts, MM_CHAINS_C, MM_WARMUP, MM_DRAWS_C, PAIR,
        (MM_CHAINS_C, MM_WARMUP + MM_DRAWS_C),
        {"rank": metric.rank,
         "d": [float(v) for v in metric.d.diagonal()],
         "m_inv_min_eig": float(torch.linalg.eigvalsh(
             metric.m_inv_matrix().double()).min()),
         "momentum_cov_err": _momentum_cov_err(metric, seed + 54)})
    gates[f"accept in {MM_ACCEPT_BAND}"] = \
        MM_ACCEPT_BAND[0] <= out["accept_mean"] <= MM_ACCEPT_BAND[1]
    gates["m_inv_matrix() positive definite"] = out["m_inv_min_eig"] > 0
    gates[f"momentum covariance within {MOMENTUM_RTOL} of M"] = \
        out["momentum_cov_err"] <= MOMENTUM_RTOL
    _mm_finish("15c", out, gates, failed)
    results["c"] = out
    del res, metric

    # (d) phase 12a's per-chain fused warmup at MM_CHAINS_D chains, one
    # Stan window: nutpie on the diagonal metric, then a per-chain dense
    # metric
    for key, kind, mm_kind, init in (("d1", "diagonal", "nutpie", "gradient"),
                                     ("d2", "dense", "welford_cov",
                                      "identity")):
        adaptor = ah.AdaptorConfig(
            kind="stan", mm_kind=mm_kind,
            da=ah.DualAveragingConfig(delta=DEF_DELTA), **buffers)
        res, wall, calls, counts = run(
            torch.Generator(device="cuda").manual_seed(seed + 55),
            lambda gen: ah.sample(
                gen, target, kernel, ah.make_metric(kind, DIM,
                                                    device="cuda"),
                theta0(MM_CHAINS_D), MM_WARMUP + MM_DRAWS_D,
                n_adapts=MM_WARMUP, adaptor=adaptor,
                init_mass_matrix=init, fuse_warmup=True, fuse_draws=FUSE,
                drop_warmup=True, device="cuda"))
        metric = res.final_state.metric
        extra = {"metric": type(metric).__name__,
                 "estimator": type(res.final_state.adapt.mm).__name__,
                 "m_inv_shape": list(metric.m_inv.shape),
                 "warmup_leaf_iterations_per_transition":
                     _fused_iterations(res.warmup_stats)}
        if kind == "dense":
            extra["chol_err"] = _chol_err(metric)
        out, gates = _mm_run(
            f"15{key}: per-chain fused warmup, {kind} metric, {mm_kind}",
            res, wall, calls, counts, MM_CHAINS_D, MM_WARMUP,
            MM_DRAWS_D, False, (MM_CHAINS_D, MM_WARMUP + MM_DRAWS_D),
            extra)
        gates[f"|accept - {DEF_DELTA}| <= {DEF_TOL_ACCEPT}"] = \
            abs(out["accept_mean"] - DEF_DELTA) <= DEF_TOL_ACCEPT
        gates["every chain's M^-1 finite"] = \
            bool(torch.isfinite(metric.m_inv).all())
        gates[f"per-chain M^-1 {tuple(metric.m_inv.shape)}"] = \
            metric.m_inv.shape[0] == MM_CHAINS_D
        if kind == "dense":
            gates[f"U^T U = M^-1 to {CHOL_RTOL}, every chain"] = \
                out["chol_err"] <= CHOL_RTOL
        _mm_finish(f"15{key}", out, gates, failed)
        results[key] = out
        del res, metric
    if failed:
        raise RuntimeError(f"phase 15 gates failed: {failed}")
    return results

# ----------------------------------------------------------------- phase 16
# (a) bench.py's AHMC_BENCH_MODEL=logistic_nc at its defaults: the
# non-centred hierarchy at phase 3's width, NUTS and schedule, with the
# reference-faithful 256 warmup iterations (bench.py's default for every
# model but the centred one), its draws mapped to (log σ, σ·β̃); cut to
# 150 warmup iterations (Stan's one window, ending at 100, then 50 of dual
# averaging after its reset, as phase 15 ran in PR 16) and 128 draws, not
# 256, to bring the script under its 1200 s clock; then, to make room for
# phase 19, to 100 warmup iterations with buffers 50/25/25 (one window,
# then 25 of dual averaging after its reset, as phase 15 ran at 100) and
# 64 draws
NC_WARMUP, NC_DRAWS = 100, 64
NC_BUFFERS = (50, 25, 25)
# the nc value+grad through K1 against its float64 analytic route, at the
# chain counts of its path: each within this share of the largest magnitude
# (K1's own gate, check_k1); the float32 analytic route is held to it too
NC_TOL = 1e-4
# (b) the new (criterion, sampler) pairs on phase 3's warmed state, draws
# cut from phase 3's 256 to 64 to leave room for phase 17, then to 32 to
# bring the script under its 1200 s clock
CRITERIA_DRAWS = 32
CRITERIA_PAIRS = (("ClassicNoUTurn", "multinomial"),
                  ("StrictGeneralisedNoUTurn", "multinomial"),
                  ("GeneralisedNoUTurn", "slice"))
# (c) phase 3's configuration with the strict criterion and slice sampling
# in the warmup blocks too, draws cut from 256 to 64, then to 32 (the clock)
STRICT_SLICE_DRAWS = 32
# (d) the zoo: value+grad of each new model at ZOO_CHECK_CHAINS chains on
# the card against the port's float64 CPU path (each within ZOO_TOL of the
# largest magnitude), then NUTS(0.8, max_depth=4) step by step on
# ZOO_CHAINS chains, ZOO_WARMUP + ZOO_DRAWS iterations, per-chain Stan
# adaptation: the sizes a short run of a user's takes (depth 4: these
# trees average depth 2-3 and the deepest of the 256 sets each step's
# loop; at 5 the five runs took 62 s of phase 16's 150 on an H100)
ZOO_CHECK_CHAINS, ZOO_TOL = 4096, 1e-4
# (draws cut from 40 to 20 to leave room for phase 17)
ZOO_CHAINS, ZOO_WARMUP, ZOO_DRAWS, ZOO_DEPTH, ZOO_DELTA = 256, 40, 20, 4, 0.8
# a mixture whose components overlap (chains cross between them): means,
# standard deviations, weights
ZOO_MIXTURE = (((-1.0, 0.0), (1.0, 0.5)), (1.0, 0.8), (0.4, 0.6))
# the German-credit posterior from the JAX package in float64 on the CPU,
# this configuration at 256 chains, one run a seed:
#   JAX_PLATFORMS=cpu python scripts/zoo_reference.py --seeds 0 1 2 3
# each run's (mean log σ, MCSE), (sd log σ, MCSE), (|mean β|, MCSE) and
# acceptance rate
GERMAN_REF_RUNS = (    # seeds 0-3, in WIDE_REF_RUNS' form; none diverged
    ((-0.6038272249857124, 0.0022281746598503023),
     (0.15899286900146478, 0.0015755574116481776),
     (2.556164427719271, 0.000867299923726647), 0.8727204689540684),
    ((-0.6039528130927025, 0.002071626235228472),
     (0.15907463414476516, 0.0014648609590140107),
     (2.5554226311569685, 0.0008922994706888054), 0.8764340189584887),
    ((-0.6086387745505479, 0.0020971075977200765),
     (0.15938359345970643, 0.0014828790032256965),
     (2.5544520466192475, 0.0009023598703573746), 0.8777552401903007),
    ((-0.6076544518643692, 0.002229255769231219),
     (0.16000367712721678, 0.0015763218714226282),
     (2.554442065629652, 0.0008799594957433248), 0.8752060177094171),
)
# Gates of analytic moments: within ZOO_MCSE_GATE Monte Carlo standard
# errors (sd / √ESS, the run's own bulk ESS) of the exact value; German
# credit within ZOO_MCSE_GATE combined MCSEs plus WIDE_K_RUNS standard
# deviations between the JAX runs, phase 9's form
ZOO_MCSE_GATE = 5.0


def nc_to_centred_(th):
    """Draws (…, dim) of the non-centred model mapped in place to the
    centred coordinates (log σ, β = σ·β̃), as bench.py maps them."""
    th[..., 1:] *= torch.exp(th[..., :1])
    return th


def check_nc_k1():
    """The non-centred model's value+grad on the card (its route through
    K1) against its analytic route in float64 and in float32 (the route's
    plain version), at the chain counts of the path; one K1 launch a call.
    Returns (rows, largest error of the K1 route)."""
    from unittest import mock

    import advancedhmc_torch as ah
    from advancedhmc_torch.models import logistic as lg

    t32 = ah.hierarchical_logistic_nc(n=N_ROWS, p=DIM - 1, device="cuda")
    t64 = ah.hierarchical_logistic_nc(n=N_ROWS, p=DIM - 1,
                                      dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows, worst, failed = [], 0.0, []
    for c in (N_CHAINS, WARMUP_CHAINS, 1):
        theta = torch.randn(c, DIM, generator=gen, device="cuda")
        theta[:, 0] = -0.7 + 0.1 * theta[:, 0]
        before = read_launches()["fused_logistic_value_grad"]
        lp, g = t32.logdensity_and_grad(theta)
        launched = read_launches()["fused_logistic_value_grad"] - before
        lp_r, g_r = t64.logdensity_and_grad(theta.double())
        with mock.patch.object(lg, "kernel_route", lambda t: False):
            lp_p, g_p = t32.logdensity_and_grad(theta)
            plain_ms = device_ms(lambda: t32.logdensity_and_grad(theta), 20)
        route_ms = device_ms(lambda: t32.logdensity_and_grad(theta), 20)
        tol_g = NC_TOL * float(g_r.abs().max())
        tol_lp = NC_TOL * max(1.0, float(lp_r.abs().max()))

        def err(gg, ll):
            return (float((gg.double() - g_r).abs().max()),
                    float((ll.double() - lp_r).abs().max()))

        (eg, el), (pg, pl) = err(g, lp), err(g_p, lp_p)
        ok = (bool(torch.isfinite(g).all() and torch.isfinite(lp).all())
              and eg <= tol_g and el <= tol_lp and pg <= tol_g
              and pl <= tol_lp and launched == 1)
        worst = max(worst, eg, el)
        rows.append(dict(chains=c, max_abs_err_grad=eg, max_abs_err_lp=el,
                         tol_grad=tol_g, tol_lp=tol_lp,
                         plain_f32_err_grad=pg, plain_f32_err_lp=pl,
                         launches=launched, route_ms=route_ms,
                         plain_route_ms=plain_ms))
        log(f"# 16a nc value+grad through K1, C={c}: vs float64 max|Δgrad| "
            f"{eg:.3e} (tol {tol_g:.3e}), max|Δlp| {el:.3e} (tol "
            f"{tol_lp:.3e}); the float32 analytic route {pg:.3e} / "
            f"{pl:.3e}; {launched} K1 launch a call; route {route_ms:.4f} "
            f"ms, analytic float32 {plain_ms:.4f} ms on the device: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(c)
    if failed:
        raise RuntimeError(f"16a: the nc route through K1 disagrees at C = "
                           f"{failed}")
    return rows, worst


def phase_nc(seed):
    """16a: bench.py's nc configuration through `sample` (cut to NC_WARMUP
    + NC_DRAWS), its draws in the centred coordinates, phase 3's gates (the
    accept band of phase 15's runs). Returns its results."""
    import numpy as np

    import advancedhmc_torch as ah

    check_rows, check_err = check_nc_k1()
    _, kernel, adaptor = main_path_spec()
    adaptor = dataclasses.replace(
        adaptor, init_buffer=NC_BUFFERS[0], term_buffer=NC_BUFFERS[1],
        window_size=NC_BUFFERS[2])
    target, by_chains = count_by_chains(
        ah.hierarchical_logistic_nc(n=N_ROWS, p=DIM - 1, device="cuda"))
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(size=(N_CHAINS, DIM)),
        dtype=torch.float32, device="cuda")
    res, wall, calls, counts = _timed_run(by_chains, lambda: ah.sample(
        torch.Generator(device="cuda").manual_seed(seed + 160), target,
        kernel, ah.make_metric("diagonal", DIM, device="cuda"), theta0,
        NC_WARMUP + NC_DRAWS, n_adapts=NC_WARMUP, adaptor=adaptor,
        init_mass_matrix="gradient", cross_chain=True, fuse_draws=FUSE,
        fuse_warmup=True, fuse_warmup_block=WARMUP_BLOCK, drop_warmup=True,
        warmup_chains=WARMUP_CHAINS, fanout_decorrelate=N_DECOR,
        fuse_pair=PAIR, device="cuda"))
    nc_to_centred_(res.thetas)
    out, gates = _mm_run(
        "16a: bench.py's logistic_nc", res, wall, calls, counts, N_CHAINS,
        NC_WARMUP, NC_DRAWS, PAIR, (N_CHAINS, N_DECOR + NC_DRAWS),
        {"warmup_chains": WARMUP_CHAINS, "k1_check": check_rows,
         "k1_check_max_abs_err": check_err})
    gates[f"accept in {MM_ACCEPT_BAND}"] = \
        MM_ACCEPT_BAND[0] <= out["accept_mean"] <= MM_ACCEPT_BAND[1]
    failed = []
    _mm_finish("16a", out, gates, failed)
    if failed:
        raise RuntimeError(f"phase 16a gates failed: {failed}")
    return out


def phase_criteria(main_state, main_out, turns):
    """16b: phase 3's draw phase (pair body, CRITERIA_DRAWS fused FUSE)
    from its final ε, M⁻¹ and positions with each new (criterion, sampler)
    pair,
    every kernel's count set to 0 just before each run and read just
    after; phase 3's gates. Printed beside: phase 3's draws (`main_out`)
    and phase 3b's pair-body runs from the same state (`turns`), per
    transition. Returns the rows."""
    import advancedhmc_torch as ah
    from advancedhmc_torch.diagnostics import effective_sample_size

    target, kernel, adaptor = main_path_spec()
    target, by_chains = count_by_chains(target)
    rows, failed = {}, []
    for k, (crit, ts) in enumerate(CRITERIA_PAIRS):
        spec = ah.SampleSpec(
            target=target, adaptor=adaptor, cross_chain=True,
            kernel=ah.HMCKernel(ah.Trajectory(
                kernel.trajectory.integrator,
                getattr(ah, crit)(max_depth=MAX_DEPTH), ts)))
        gen = torch.Generator(device="cuda").manual_seed(161 + k)
        (_, th, st), wall, calls, counts = _timed_run(
            by_chains, lambda: ah.fused_draw_phase(
                gen, spec, main_state, CRITERIA_DRAWS, FUSE, pair=True))
        ess = effective_sample_size(th[:, :ESS_CHAINS]) * (
            N_CHAINS / ESS_CHAINS)
        moments, gates = _moment_gates(th)
        row = {
            "criterion": crit, "ts_kind": ts, "draws_s": wall,
            "leaf_iterations_per_transition":
                calls.get(N_CHAINS, 0) / 2 / CRITERIA_DRAWS,
            "effective_samples_per_s_per_chip":
                float(ess.quantile(0.5)) / wall,
            "accept_mean": float(st["acceptance_rate"].double().mean()),
            "divergence_rate": float(st["numerical_error"].double().mean()),
            "mean_tree_depth": float(st["tree_depth"].double().mean()),
            "k1_launches": counts["fused_logistic_value_grad"],
            "value_grad_calls": sum(calls.values()), **moments}
        gates = {"draws finite": bool(torch.isfinite(th).all()),
                 "k1 launches = value+grad calls":
                     row["k1_launches"] == row["value_grad_calls"] > 0,
                 **_draw_gates(row, gates)}
        del th, st
        log(f"# 16b {crit} + {ts}: draws {wall:.2f} s, "
            f"{row['leaf_iterations_per_transition']:.2f} leaf-loop "
            f"iterations a transition, depth {row['mean_tree_depth']:.3f}, "
            f"ESS/s {row['effective_samples_per_s_per_chip']:.0f}, accept "
            f"{row['accept_mean']:.4f}, K1 launches {row['k1_launches']}")
        for g, ok in gates.items():
            log(f"# gate 16b {crit} + {ts} {g}: {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{crit} + {ts}: {g}")
        rows[f"{crit} + {ts}"] = row
    beside = [("phase 3", main_out["draws_s"] / N_DRAWS, main_out)] + [
        ("phase 3b", r["wall_s"] / PAIR_TURN_DRAWS, r) for r in turns
        if r["pair"]]
    for name, per, r in beside:
        log(f"# 16b beside {name}'s generalised + multinomial (pair body): "
            f"{1e3 * per:.2f} ms a transition, "
            f"{r['leaf_iterations_per_transition']:.2f} leaf-loop "
            f"iterations a transition, depth {r['mean_tree_depth']:.3f}")
    for row in rows.values():
        row["ms_per_transition"] = 1e3 * row["draws_s"] / CRITERIA_DRAWS
    log(json.dumps({"criteria": rows}))
    if failed:
        raise RuntimeError(f"phase 16b gates failed: {failed}")
    return rows


def phase_strict_slice(seed):
    """16c: `sample` at phase 3's configuration with the strict criterion
    and slice sampling, so both run in the warmup blocks too; draws cut to
    STRICT_SLICE_DRAWS; phase 3's gates."""
    import numpy as np

    import advancedhmc_torch as ah

    target, kernel, adaptor = main_path_spec()
    target, by_chains = count_by_chains(target)
    kernel = ah.HMCKernel(ah.Trajectory(
        kernel.trajectory.integrator,
        ah.StrictGeneralisedNoUTurn(max_depth=MAX_DEPTH), "slice"))
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(size=(N_CHAINS, DIM)),
        dtype=torch.float32, device="cuda")
    res, wall, calls, counts = _timed_run(by_chains, lambda: ah.sample(
        torch.Generator(device="cuda").manual_seed(seed + 165), target,
        kernel, ah.make_metric("diagonal", DIM, device="cuda"), theta0,
        N_WARMUP + STRICT_SLICE_DRAWS, n_adapts=N_WARMUP, adaptor=adaptor,
        init_mass_matrix="gradient", cross_chain=True, fuse_draws=FUSE,
        fuse_warmup=True, fuse_warmup_block=WARMUP_BLOCK, drop_warmup=True,
        warmup_chains=WARMUP_CHAINS, fanout_decorrelate=N_DECOR,
        fuse_pair=PAIR, device="cuda"))
    out, gates = _mm_run(
        "16c: strict + slice, phase 3's configuration", res, wall, calls,
        counts, N_CHAINS, N_WARMUP, STRICT_SLICE_DRAWS, PAIR,
        (N_CHAINS, N_DECOR + STRICT_SLICE_DRAWS),
        {"warmup_leaf_iterations_per_transition":
             calls.get(WARMUP_CHAINS, 0) / 2 / N_WARMUP})
    gates[f"|accept - {DELTA}| <= 0.1"] = abs(out["accept_mean"] - DELTA) \
        <= 0.1
    failed = []
    _mm_finish("16c", out, gates, failed)
    if failed:
        raise RuntimeError(f"phase 16c gates failed: {failed}")
    return out


def _zoo_models(dtype, device):
    """The new models of the port's zoo, by name: (target, dim, the scale
    of the check's points)."""
    import advancedhmc_torch as ah
    from advancedhmc_torch.models import dists

    means, sds, weights = ZOO_MIXTURE
    return {
        "banana": (ah.banana(device=device), 2, 5.0),
        "eight_schools": (ah.eight_schools(dtype, device), 10, 1.0),
        "gdemo": (ah.gdemo(device), 2, 0.7),
        "gaussian_mixture": (ah.gaussian_mixture(
            means, sds, weights, dtype, device), 2, 1.5),
        "two_gaussian_mixtures_2d": (ah.two_gaussian_mixtures_2d(
            dtype=dtype, device=device), 2, 1.5),
        "spiral": (ah.spiral(device=device), 2, 1.5),
        "german_credit_logistic": (ah.german_credit_logistic(
            dtype, device), 25, 0.2),
        "hierarchical_logistic_nc": (ah.hierarchical_logistic_nc(
            n=N_ROWS, p=DIM - 1, dtype=dtype, device=device), DIM, 0.3),
        "gdemo_declarative": (dists.gdemo_declarative(), 2, 0.7),
        "target_of(Gamma(2, 3), 5)": (dists.target_of(
            dists.Gamma(2.0, 3.0), 5), 5, 1.0),
    }


def _zoo_check(seed):
    """Each new model's value+grad on the card (float32) against the
    port's float64 CPU path at the same points. Returns the rows."""
    import numpy as np

    rng = np.random.default_rng(seed + 166)
    card, cpu = _zoo_models(torch.float32, "cuda"), \
        _zoo_models(torch.float64, "cpu")
    rows, failed = {}, []
    for name, (tgt, dim, scale) in card.items():
        th = torch.as_tensor(scale * rng.normal(size=(ZOO_CHECK_CHAINS, dim)),
                             dtype=torch.float32, device="cuda")
        lp, g = tgt.logdensity_and_grad(th)
        lp_r, g_r = cpu[name][0].logdensity_and_grad(th.cpu().double())
        eg = float((g.cpu().double() - g_r).abs().max())
        el = float((lp.cpu().double() - lp_r).abs().max())
        tol_g = ZOO_TOL * max(1.0, float(g_r.abs().max()))
        tol_lp = ZOO_TOL * max(1.0, float(lp_r.abs().max()))
        ok = eg <= tol_g and el <= tol_lp and lp.shape == (ZOO_CHECK_CHAINS,)
        rows[name] = dict(max_abs_err_grad=eg, max_abs_err_lp=el,
                          tol_grad=tol_g, tol_lp=tol_lp)
        log(f"# 16d {name} value+grad at C={ZOO_CHECK_CHAINS} on the card "
            f"vs the float64 CPU path: max|Δgrad| {eg:.3e} (tol "
            f"{tol_g:.3e}), max|Δlp| {el:.3e} (tol {tol_lp:.3e}): "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    return rows, failed


def _mcse_gate(x, exact):
    """(mean, MCSE, ok): the draws' mean of each coordinate of `x` (n, C,
    k) within ZOO_MCSE_GATE MCSEs (sd/√ESS) of `exact`."""
    from advancedhmc_torch.diagnostics import effective_sample_size

    x = x.double()
    ess = effective_sample_size(x)
    mean = x.mean((0, 1))
    mcse = x.std((0, 1)) / torch.sqrt(ess)
    exact = torch.as_tensor(exact, dtype=torch.float64, device=x.device)
    ok = bool(((mean - exact).abs() <= ZOO_MCSE_GATE * mcse).all())
    return mean.tolist(), mcse.tolist(), ok


def phase_zoo(seed):
    """16d: the zoo's value+grad check, then short `NUTS(...).sample` runs
    on the step path, every kernel's count set to 0 just before each run
    and read just after: gdemo against GDEMO_MEAN, the mixture's mean, the
    eight schools and banana finite (divergence reported), German credit
    (K1 narrow, p = 24) against the JAX package's posterior."""
    import numpy as np

    import advancedhmc_torch as ah
    from advancedhmc_torch.models.gdemo import constrain

    check, failed = _zoo_check(seed)
    cfg = ah.NUTS(ZOO_DELTA, max_depth=ZOO_DEPTH)
    means, sds, weights = ZOO_MIXTURE
    mu = np.asarray(means)
    runs = {
        "gdemo": (ah.gdemo("cuda"), 2),
        "gaussian_mixture": (ah.gaussian_mixture(means, sds, weights,
                                                 device="cuda"), 2),
        "eight_schools": (ah.eight_schools(device="cuda"), 10),
        "banana": (ah.banana(device="cuda"), 2),
        "german_credit_logistic": (ah.german_credit_logistic(
            device="cuda"), 25),
    }
    out = {}
    for k, (name, (tgt, dim)) in enumerate(runs.items()):
        tgt, by_chains = count_by_chains(tgt)
        th0 = torch.as_tensor(0.1 * np.random.default_rng(seed + k).normal(
            size=(ZOO_CHAINS, dim)), dtype=torch.float32, device="cuda")
        res, wall, calls, counts = _timed_run(by_chains, lambda: cfg.sample(
            torch.Generator(device="cuda").manual_seed(seed + 170 + k), tgt,
            th0, ZOO_WARMUP + ZOO_DRAWS, n_adapts=ZOO_WARMUP,
            drop_warmup=True, device="cuda"))
        th, st = res.thetas, res.stats
        row = {"wall_s": wall, "warmup_s": res.timings["warmup_s"],
               "draws_s": res.timings["draws_s"],
               "accept_mean": float(st["acceptance_rate"].double().mean()),
               "divergence_rate": float(
                   st["numerical_error"].double().mean()),
               "mean_tree_depth": float(st["tree_depth"].double().mean()),
               "value_grad_calls": sum(calls.values()),
               "k1_launches": counts["fused_logistic_value_grad"]}
        gates = {"draws finite, shape": tuple(th.shape) == (
            ZOO_DRAWS, ZOO_CHAINS, dim) and bool(torch.isfinite(th).all())}
        if name == "gdemo":
            row["mean"], row["mcse"], ok = _mcse_gate(constrain(th),
                                                      ah.GDEMO_MEAN)
            gates[f"mean (s, m) within {ZOO_MCSE_GATE} MCSE of GDEMO_MEAN"] \
                = ok
        elif name == "gaussian_mixture":
            exact = (np.asarray(weights)[:, None] * mu).sum(0)
            row["mean"], row["mcse"], ok = _mcse_gate(th, exact)
            gates[f"mean within {ZOO_MCSE_GATE} MCSE of {exact.tolist()}"] \
                = ok
        elif name == "german_credit_logistic":
            moments, mcse, _ = _wide_moments(th)
            row.update(moments, mcse=mcse)
            ref, _ = wide_reference(GERMAN_REF_RUNS)
            for m in WIDE_MOMENTS:
                r = ref[m]
                tol = ZOO_MCSE_GATE * math.hypot(r["mcse"], mcse[m]) \
                    + WIDE_K_RUNS * r["sd_between_runs"]
                gates[f"|{m} - JAX's {r['mean']:.5f}| <= {tol:.5f}"] = \
                    abs(moments[m] - r["mean"]) <= tol
            gates["k1 launches = value+grad calls"] = \
                row["k1_launches"] == row["value_grad_calls"] > 0
        else:
            gates["k1 not launched"] = row["k1_launches"] == 0
        log(f"# 16d {name}: {ZOO_CHAINS} chains, warmup "
            f"{row['warmup_s']:.1f} s, draws {row['draws_s']:.1f} s, accept "
            f"{row['accept_mean']:.4f}, divergence share "
            f"{row['divergence_rate']:.5f}, depth "
            f"{row['mean_tree_depth']:.3f}" + (
                f", mean {row['mean']} (MCSE {row['mcse']})"
                if "mean" in row else ""))
        for g, ok in gates.items():
            log(f"# gate 16d {name} {g}: {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{name}: {g}")
        out[name] = row
        del res, th, st
    log(json.dumps({"zoo": out, "zoo_check": check}))
    if failed:
        raise RuntimeError(f"phase 16d gates failed: {failed}")
    return out, check


# ----------------------------------------------------------------- phase 17
# (a) bench.py with AHMC_BENCH_TCAP=4 (TCAP_INIT and TCAP_POST at their
# defaults): phase 3's configuration uncut, driven as bench.py drives it
# (init_state on the warmup pool, fused_warmup_phase_crosschain with the
# schedule's depth caps, fanout_warmup_state, the decorrelation and the
# draws through fused_draw_phase, FUSE a call); at 128 iterations Stan's
# windows leave no reset, so the first TCAP_INIT iterations are capped;
# its draws cut from 256 to TCAP_DRAWS to bring the script under its
# 1200 s clock (128, then 64 to make room for phase 19)
TCAP, TCAP_INIT, TCAP_POST, TCAP_DRAWS = 4, 40, 16, 64
# (b) bench.py with AHMC_BENCH_RAGGED=1.5: one ragged call from phase 3's
# final state, t_min RAGGED_T_MIN (bench.py's chunk is 256, the draw count;
# cut to 128 to bring the script under its 1200 s clock) and t_max
# round(t_min · 1.5), on the single-leaf body (as the JAX ragged loop);
# the ragged ESS over the first ESS_CHAINS chains on the card against the
# port's float64 CPU ESS of the same buffer, within this share
RAGGED_FACTOR, RAGGED_T_MIN = 1.5, 128
RAGGED_ESS_RTOL = 1e-3


def _main_theta0(seed):
    """Phase 3's starting points (from numpy, as the tests make theirs)."""
    import numpy as np

    return torch.as_tensor(
        0.1 * np.random.default_rng(seed).normal(size=(N_CHAINS, DIM)),
        dtype=torch.float32, device="cuda")


def _drive_main(gen, spec, theta0, n_draws, caps=None):
    """Phase 3's configuration driven as bench.py drives it: `init_state`
    on the warmup pool, `fused_warmup_phase_crosschain` (with the depth
    caps `caps`, if given), `fanout_warmup_state`, the decorrelation and
    `n_draws` draws through `fused_draw_phase`, FUSE a call; a
    `SampleResult` with the phases' walls."""
    import advancedhmc_torch as ah

    timings, t0 = {}, time.perf_counter()
    state = ah.init_state(
        gen, spec, ah.make_metric("diagonal", DIM, device="cuda"),
        theta0[:WARMUP_CHAINS], init_mass_matrix="gradient", device="cuda")
    torch.cuda.synchronize()
    timings["init_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    state, _, warm = ah.fused_warmup_phase_crosschain(
        gen, spec, state, N_WARMUP, WARMUP_BLOCK, depth_caps=caps, pair=PAIR)
    state = ah.fanout_warmup_state(spec, state, N_CHAINS)
    state, _, _ = ah.fused_draw_phase(gen, spec, state, N_DECOR, FUSE,
                                      pair=PAIR)
    torch.cuda.synchronize()
    timings["warmup_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    state, th, st = ah.fused_draw_phase(gen, spec, state, n_draws, FUSE,
                                        pair=PAIR)
    torch.cuda.synchronize()
    timings["draws_s"] = time.perf_counter() - t0
    return ah.SampleResult(thetas=th, stats=st, warmup_stats=warm,
                           final_state=state, timings=timings,
                           target=spec.target)


def phase_tcap(seed, main_out):
    """17a: bench.py's transient depth caps at phase 3's configuration,
    every kernel's count set to 0 just before and read just after; phase
    4's gates, and no capped warmup iteration deeper than TCAP. Printed
    beside phase 3's walls (`main_out`)."""
    import advancedhmc_torch as ah

    target, kernel, adaptor = main_path_spec()
    target, by_chains = count_by_chains(target)
    spec = ah.SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                         cross_chain=True)
    caps = ah.transient_depth_caps(
        N_WARMUP, MAX_DEPTH, TCAP, TCAP_INIT, TCAP_POST, adaptor.init_buffer,
        adaptor.term_buffer, adaptor.window_size)
    gen = torch.Generator(device="cuda").manual_seed(seed + 170)
    res, wall, calls, counts = _timed_run(by_chains, lambda: _drive_main(
        gen, spec, _main_theta0(seed), TCAP_DRAWS, caps))
    capped = torch.as_tensor(caps < MAX_DEPTH, device="cuda")
    depth = res.warmup_stats["tree_depth"].double()
    out, gates = _mm_run(
        f"17a: bench.py's TCAP={TCAP}", res, wall, calls, counts, N_CHAINS,
        N_WARMUP, TCAP_DRAWS, PAIR, (N_CHAINS, N_DECOR + TCAP_DRAWS), {
            "tcap": TCAP, "tcap_init": TCAP_INIT, "tcap_post": TCAP_POST,
            "capped_iterations": int(capped.sum()),
            "warmup_depth_capped_mean": float(depth[capped].mean()),
            "warmup_depth_capped_max": int(depth[capped].max()),
            "warmup_depth_uncapped_mean": float(depth[~capped].mean()),
            "warmup_depth_uncapped_max": int(depth[~capped].max()),
            "warmup_leaf_iterations_per_transition":
                calls.get(WARMUP_CHAINS, 0) / 2 / N_WARMUP,
            "phase3_warmup_s": main_out["warmup_s"],
            "phase3_draws_s": main_out["draws_s"]})
    gates[f"|accept - {DELTA}| <= 0.1"] = \
        abs(out["accept_mean"] - DELTA) <= 0.1
    gates[f"no capped warmup iteration deeper than {TCAP}"] = \
        out["warmup_depth_capped_max"] <= TCAP
    log(f"# 17a: {out['capped_iterations']}/{N_WARMUP} warmup iterations "
        f"capped at depth {TCAP}: tree depth "
        f"{out['warmup_depth_capped_mean']:.3f} mean, "
        f"{out['warmup_depth_capped_max']} largest (uncapped "
        f"iterations {out['warmup_depth_uncapped_mean']:.3f}, "
        f"{out['warmup_depth_uncapped_max']}); warmup {out['warmup_s']:.2f} "
        f"s and draws {out['draws_s']:.2f} s against phase 3's "
        f"{main_out['warmup_s']:.2f} and {main_out['draws_s']:.2f} s; final "
        f"eps {out['step_size']:.5f} (phase 3: {main_out['step_size']:.5f})")
    failed = []
    _mm_finish("17a", out, gates, failed)
    if failed:
        raise RuntimeError(f"phase 17a gates failed: {failed}")
    return out


def _count_weighted_moments(th, valid, chunk=4096):
    """Phase 4's moments of the draws `th (C, T, dim)` at the rows `valid
    (C, T)`, each draw weighing one (count-weighted over the chains), in
    float64, a chunk of chains at a time; and whether every draw is finite
    and every row past the counts zero."""
    n = float(valid.sum())
    s1 = s2 = 0.0
    beta = torch.zeros(th.shape[-1] - 1, dtype=torch.float64, device="cuda")
    finite, padded = True, True
    for lo in range(0, th.shape[0], chunk):
        x = th[lo:lo + chunk].double()
        v = valid[lo:lo + chunk]
        finite &= bool(torch.isfinite(x).all())
        padded &= not bool(x[~v].any())
        s1 += float(torch.where(v, x[..., 0], 0.0).sum())
        s2 += float(torch.where(v, x[..., 0] ** 2, 0.0).sum())
        beta += torch.where(v[..., None], x[..., 1:], 0.0).sum((0, 1))
        del x
    mean = s1 / n
    return {"mean_logsigma": mean,
            "sd_logsigma": math.sqrt(max(s2 / n - mean ** 2, 0.0)),
            "mean_beta_norm": float((beta / n).norm())}, finite, padded


def phase_ragged(seed, main_state, main_out, turns):
    """17b: bench.py's ragged configuration, one `fused_draw_phase_ragged`
    call from phase 3's final state, every kernel's count set to 0 just
    before and read just after; bench.py's figures and its ragged ESS/s,
    printed beside phase 3's ESS/s and phase 3b's rectangular single-body
    draws; gated on the counts, `is_accept` past them, the count-weighted
    moments, divergence, acceptance and the ragged ESS on the card against
    the CPU's."""
    import advancedhmc_torch as ah
    from advancedhmc_torch.diagnostics import effective_sample_size_ragged
    from advancedhmc_torch.experimental import fused_draw_phase_ragged

    target, kernel, adaptor = main_path_spec()
    target, by_chains = count_by_chains(target)
    spec = ah.SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                         cross_chain=True)
    t_min = RAGGED_T_MIN
    t_max = int(round(t_min * RAGGED_FACTOR))
    gen = torch.Generator(device="cuda").manual_seed(seed + 171)
    (_, th, cnt, st), wall, calls, counts = _timed_run(
        by_chains, lambda: fused_draw_phase_ragged(gen, spec, main_state,
                                                   t_max, t_min))
    rows = torch.arange(t_max, device="cuda")[None]
    valid = rows < cnt[:, None].long()
    n_total = int(cnt.sum())
    sub = cnt[:ESS_CHAINS].long()
    x_sub = th[:ESS_CHAINS, :int(sub.max())]
    ess = effective_sample_size_ragged(x_sub, sub)
    ess_cpu = effective_sample_size_ragged(x_sub.cpu(), sub.cpu())
    ess_rel = float(((ess.cpu() - ess_cpu).abs() / ess_cpu.abs()).max())
    median_ess = float(ess.quantile(0.5)) * (N_CHAINS / ESS_CHAINS)
    rect = [r for r in turns if not r["pair"]]
    out = {
        "run": f"17b: bench.py's RAGGED={RAGGED_FACTOR}", "chains": N_CHAINS,
        "t_min": t_min, "t_max": t_max, "draws_s": wall,
        "draws_per_chain_mean": n_total / N_CHAINS,
        "draws_per_chain_min": int(cnt.min()),
        "draws_per_chain_max": int(cnt.max()),
        "collected_vs_rect": n_total / (t_min * N_CHAINS),
        "effective_samples_per_s_per_chip": median_ess / wall,
        "median_ess": median_ess,
        "min_ess_per_s": float(ess.min()) * (N_CHAINS / ESS_CHAINS) / wall,
        "ess_card_vs_cpu_max_rel": ess_rel,
        "accept_mean": float((st["acceptance_rate"].double() * valid).sum())
        / n_total,
        "divergence_rate": float((st["numerical_error"] & valid).sum())
        / n_total,
        "leaf_iterations_per_transition":
            calls.get(N_CHAINS, 0) / t_min,
        "k1_calls": counts[K1_CALLS],
        "k1_launches": counts["fused_logistic_value_grad"],
        "value_grad_calls": sum(calls.values()),
        "k1_calls_by_chains": dict(sorted(calls.items(), reverse=True)),
        "phase3_effective_samples_per_s_per_chip":
            main_out["effective_samples_per_s_per_chip"],
        "phase3b_single_body_ms_per_transition":
            [1e3 * r["wall_s"] / PAIR_TURN_DRAWS for r in rect],
    }
    moments, finite, padded = _count_weighted_moments(th, valid)
    moments, moment_gates = _gate_moments(moments)
    out.update(moments)
    gates = {
        f"counts in [{t_min}, {t_max}]":
            out["draws_per_chain_min"] >= t_min
            and out["draws_per_chain_max"] <= t_max,
        f"the slowest chain stopped at t_min = {t_min}":
            out["draws_per_chain_min"] == t_min,
        "is_accept true before each count, false past it":
            bool(torch.equal(st["is_accept"], valid)),
        "draws finite, zero past each count": finite and padded,
        "k1 calls = value+grad calls":
            out["k1_calls"] == out["value_grad_calls"] > 0,
        "k1 launches = calls": out["k1_launches"] == out["k1_calls"],
        f"ragged ESS on the card within {RAGGED_ESS_RTOL} of the CPU's":
            ess_rel <= RAGGED_ESS_RTOL,
        **_draw_gates(out, moment_gates),
    }
    del th, st, valid
    log(json.dumps(out))
    log(f"# 17b: ragged draws {wall:.2f} s for t_min {t_min} (t_max "
        f"{t_max}): {out['draws_per_chain_mean']:.2f} draws a chain (min "
        f"{out['draws_per_chain_min']}, max {out['draws_per_chain_max']}), "
        f"collected_vs_rect {out['collected_vs_rect']:.4f}, ESS/s "
        f"{out['effective_samples_per_s_per_chip']:.0f} (phase 3: "
        f"{main_out['effective_samples_per_s_per_chip']:.0f}); "
        f"{1e3 * wall / t_min:.2f} ms a t_min transition against phase 3b's "
        f"rectangular single-body "
        + ", ".join(f"{v:.2f}" for v in
                    out["phase3b_single_body_ms_per_transition"])
        + f" ms; {out['leaf_iterations_per_transition']:.2f} leaf-loop "
        f"iterations a t_min transition; accept {out['accept_mean']:.4f}")
    failed = []
    for g, ok in gates.items():
        log(f"# gate 17b {g}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"17b: {g}")
    if failed:
        raise RuntimeError(f"phase 17b gates failed: {failed}")
    return out


# ----------------------------------------------------------------- phase 18
# (a) the relativistic kinetic energy at phase 3's width: its configuration
# with `SampleSpec(kinetic=RelativisticKinetic(m, c))` (the JAX test's m and
# c), driven as 17a drives it; the draws cut from 256 to REL_DRAWS. Stan's
# finalised ε = exp(x̄) leaves the draws' acceptance above δ here too: the
# JAX package 0.6241 / 0.6841 and the port 0.6374 / 0.6681 on this
# configuration at 64 chains (`scripts/accept_reference.py --config
# relativistic`), so it is gated on phase 15's band, MM_ACCEPT_BAND; the
# draws then cut from 128 to 64 to bring the script under its 1200 s clock
REL_M, REL_C, REL_DRAWS = 1.0, 2.0, 64
# (b) SoftAbs RMHMC (α 20, `sample_rmhmc`'s default map) on Neal's funnel
# at its own width (dim 10, σ_v 3) in float64, RM_CHAINS chains started at
# exact draws of the funnel (so every iteration's v has the exact
# marginal N(0, σ_v²)); static RMHMC (RM_LEAPFROG steps, RM_FP fixed-point
# iterations) and Riemannian NUTS (generalised, max_depth RM_DEPTH), each
# with RM_ADAPT iterations of dual averaging (δ 0.8) and then its draws,
# gated on E[v] = 0 and sd(v) = σ_v within RM_MCSE MCSEs of the pooled
# bulk ESS (dual averaging cut from 5 to 4 iterations and the static draws
# from 8 to 6 to bring the script under its 1200 s clock; 4 draws is the
# fewest whose split halves give the ESS a variance)
RM_DIM, RM_SIGMA_V, RM_CHAINS = 10, 3.0, 4096
RM_LEAPFROG, RM_FP, RM_DEPTH, RM_EPS0 = 8, 6, 5, 0.1
RM_ADAPT, RM_DRAWS_STATIC, RM_DRAWS_NUTS, RM_MCSE = 4, 6, 4, 5.0
# 18b's chains start at exact draws, so v's moments hold for chains that
# never move: these gates fail a sampler that rejects or stays put
RM_ACCEPT_MIN, RM_MOVED_MIN, RM_CORR_V_MAX = 0.5, 0.9, 0.9
# (c) SoftAbs RMHMC on the 100-D logistic in float32 (K1 computes ℓπ and
# ∇ℓπ in every ∂H∂θ): RMC_CHAINS of phase 3's final positions, RMC_T static
# transitions of RMC_LEAPFROG steps at ε RMC_EPS, ∂G in chunks of
# RMC_CHUNK chains; ∂H∂θ through K1 against the float64 route at the
# first RMC_CHECK chains, within K1's gate (one transition, not two, to
# bring the script under its 1200 s clock: a step takes ≈ 5.5 s here)
RMC_CHAINS, RMC_T, RMC_LEAPFROG, RMC_EPS, RMC_CHUNK = 256, 1, 2, 0.2, 64
RMC_CHECK, RMC_TOL = 32, 1e-4
# (d) a checkpoint of phase 3's final state and generator, CKPT_DRAWS fused
# draws from the state as saved and as loaded, bitwise; throughput_report
# against phase 4's leapfrog steps/s
CKPT_DRAWS, THROUGHPUT_RTOL = 16, 1e-9


def _zeros_like(tree):
    """A state of the same structure as `tree`, every leaf zero (the
    like-structured state a checkpoint loads into)."""
    from advancedhmc_torch import checkpoint

    pairs, rebuild = checkpoint._flatten(tree)
    return rebuild([torch.zeros_like(x) if isinstance(x, torch.Tensor)
                    else type(x)(0) for _, x in pairs])


def _same_leaves(a, b):
    """Whether two states hold the same bits in every leaf."""
    from advancedhmc_torch import checkpoint

    la, lb = checkpoint._flatten(a)[0], checkpoint._flatten(b)[0]
    return len(la) == len(lb) and all(
        (torch.equal(x, y) and x.dtype == y.dtype)
        if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(la, lb))


def phase_checkpoint(res, main_out, gen):
    """18d (run after phase 5, while phase 3's result is held): phase 3's
    final state and its generator saved, loaded into a zeroed state and a
    new generator; CKPT_DRAWS fused draws from each, bitwise equal; then
    `profiling.throughput_report` on phase 3's result with its draw wall
    against phase 4's leapfrog steps/s."""
    import os
    import tempfile

    import advancedhmc_torch as ah
    from advancedhmc_torch import checkpoint, profiling

    target, kernel, adaptor = main_path_spec()
    spec = ah.SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                         cross_chain=True)
    state = res.final_state
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        t0 = time.perf_counter()
        checkpoint.save_state(path, state, generator=gen)
        save_s = time.perf_counter() - t0
        gen2 = torch.Generator(device="cuda").manual_seed(12345)
        t0 = time.perf_counter()
        loaded = checkpoint.load_state(path, _zeros_like(state),
                                       generator=gen2)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    _, th1, st1 = ah.fused_draw_phase(gen, spec, state, CKPT_DRAWS,
                                      CKPT_DRAWS, pair=PAIR)
    _, th2, st2 = ah.fused_draw_phase(gen2, spec, loaded, CKPT_DRAWS,
                                      CKPT_DRAWS, pair=PAIR)
    report = profiling.throughput_report(
        ah.SampleResult(thetas=res.thetas[:, :ESS_CHAINS], stats=res.stats,
                        warmup_stats=None, final_state=None),
        main_out["draws_s"])
    rel = abs(report["leapfrog_steps_per_s_per_chip"]
              / main_out["leapfrog_steps_per_s"] - 1)
    out = {"checkpoint_bytes": size, "save_s": save_s, "load_s": load_s,
           "leapfrog_steps_per_s_report":
               report["leapfrog_steps_per_s_per_chip"],
           "leapfrog_steps_per_s_phase4": main_out["leapfrog_steps_per_s"],
           "throughput_rel_diff": rel,
           "median_ess_512_report": report["median_ess"]}
    gates = {
        "loaded state bitwise the saved one": _same_leaves(loaded, state),
        f"{CKPT_DRAWS} fused draws from both bitwise equal":
            torch.equal(th1, th2)
            and all(torch.equal(st1[k], st2[k]) for k in st1),
        f"throughput_report = phase 4's leapfrog steps/s to "
        f"{THROUGHPUT_RTOL}": rel <= THROUGHPUT_RTOL,
    }
    log(json.dumps({"phase_18d": out}))
    _finish_gates("18d", gates)
    return out


def _finish_gates(key, gates):
    failed = []
    for name, ok in gates.items():
        log(f"# gate {key} {name}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{key}: {name}")
    if failed:
        raise RuntimeError(f"phase {key} gates failed: {failed}")


def phase_relativistic(seed, main_out):
    """18a: the relativistic kinetic energy on phase 3's configuration,
    every kernel's count set to 0 just before and read just after; phase
    4's gates; printed beside phase 3's walls, ESS/s, leaf-loop iterations
    and K1 launches."""
    import advancedhmc_torch as ah

    target, kernel, adaptor = main_path_spec()
    target, by_chains = count_by_chains(target)
    spec = ah.SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                         cross_chain=True,
                         kinetic=ah.RelativisticKinetic(m=REL_M, c=REL_C))
    gen = torch.Generator(device="cuda").manual_seed(seed + 180)
    res, wall, calls, counts = _timed_run(by_chains, lambda: _drive_main(
        gen, spec, _main_theta0(seed), REL_DRAWS))
    out, gates = _mm_run(
        f"18a: RelativisticKinetic(m={REL_M}, c={REL_C}), phase 3's "
        "configuration", res, wall, calls, counts, N_CHAINS, N_WARMUP,
        REL_DRAWS, PAIR, (N_CHAINS, N_DECOR + REL_DRAWS), {
            "warmup_leaf_iterations_per_transition":
                calls.get(WARMUP_CHAINS, 0) / 2 / N_WARMUP,
            **{f"phase3_{k}": main_out[k] for k in (
                "warmup_s", "draws_s", "effective_samples_per_s_per_chip",
                "leaf_iterations_per_transition", "k1_launches",
                "step_size")}})
    gates[f"accept in {MM_ACCEPT_BAND}"] = \
        MM_ACCEPT_BAND[0] <= out["accept_mean"] <= MM_ACCEPT_BAND[1]
    log(f"# 18a beside phase 3: warmup {out['warmup_s']:.2f} / "
        f"{main_out['warmup_s']:.2f} s, draws ({REL_DRAWS} / {N_DRAWS}) "
        f"{out['draws_s']:.2f} / {main_out['draws_s']:.2f} s, ESS/s "
        f"{out['effective_samples_per_s_per_chip']:.0f} / "
        f"{main_out['effective_samples_per_s_per_chip']:.0f}, leaf-loop "
        f"iterations a transition "
        f"{out['leaf_iterations_per_transition']:.2f} / "
        f"{main_out['leaf_iterations_per_transition']:.2f}, K1 launches "
        f"{out['k1_launches']} / {main_out['k1_launches']}, eps "
        f"{out['step_size']:.5f} / {main_out['step_size']:.5f}")
    failed = []
    _mm_finish("18a", out, gates, failed)
    if failed:
        raise RuntimeError(f"phase 18a gates failed: {failed}")
    return out


def _funnel_draws(seed):
    """RM_CHAINS exact draws of Neal's funnel (v ~ N(0, σ_v²), x_i | v ~
    N(0, e^v)), float64, from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v = RM_SIGMA_V * rng.normal(size=(RM_CHAINS, 1))
    x = np.exp(0.5 * v) * rng.normal(size=(RM_CHAINS, RM_DIM - 1))
    return torch.as_tensor(np.concatenate([v, x], 1), dtype=torch.float64,
                           device="cuda")


def _v_moments(draws):
    """Mean and sd of v over the draws (n, C, dim), each with its MCSE from
    the pooled bulk ESS (of v, and of (v − mean)² for the sd)."""
    from advancedhmc_torch.diagnostics import effective_sample_size

    v = draws[..., 0].double()
    mean = float(v.mean())
    sq = (v - mean) ** 2
    var = float(sq.mean())
    sd = math.sqrt(var)
    ess_v = float(effective_sample_size(v[..., None])[0])
    ess_sq = float(effective_sample_size(sq[..., None])[0])
    mcse_mean = sd / math.sqrt(ess_v)
    mcse_sd = float(sq.std()) / math.sqrt(ess_sq) / (2 * sd)
    return {"mean_v": mean, "sd_v": sd, "ess_v": ess_v, "ess_v_sq": ess_sq,
            "mcse_mean_v": mcse_mean, "mcse_sd_v": mcse_sd}


def phase_rmhmc_funnel(seed):
    """18b: `sample_rmhmc` on Neal's funnel, static and Riemannian NUTS,
    each gated on v's exact marginal, and on the chains moving (mean
    acceptance, the share of chains whose θ changed, the correlation of v
    between the start and the last draw); the NUTS run's result saved with
    `SampleResult.save` and read back with `load_result` bitwise."""
    import os
    import tempfile

    import advancedhmc_torch as ah
    from advancedhmc_torch import checkpoint
    from advancedhmc_torch import riemannian as rm

    target = ah.neal_funnel(dim=RM_DIM, sigma_v=RM_SIGMA_V, device="cuda")
    theta0 = _funnel_draws(seed + 181)
    runs, gates = {}, {}
    for name, crit, n_draws in (
            ("static", None, RM_DRAWS_STATIC),
            ("nuts", ah.GeneralisedNoUTurn(max_depth=RM_DEPTH),
             RM_DRAWS_NUTS)):
        gen = torch.Generator(device="cuda").manual_seed(seed + 182)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        thetas, stats, final = rm.sample_rmhmc(
            gen, target, theta0, RM_ADAPT + n_draws,
            n_leapfrog=RM_LEAPFROG, step_size=RM_EPS0, n_fp=RM_FP,
            n_adapts=RM_ADAPT, criterion=crit, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        draws = thetas[RM_ADAPT:]
        st = {k: v[RM_ADAPT:] for k, v in stats.items()}
        out = {"chains": RM_CHAINS, "adapt": RM_ADAPT, "draws": n_draws,
               "wall_s": wall,
               "s_per_iteration": wall / (RM_ADAPT + n_draws),
               "accept_mean": float(st["acceptance_rate"].double().mean()),
               "divergence_rate":
                   float(st["numerical_error"].double().mean()),
               "n_steps_mean": float(st["n_steps"].double().mean()),
               "step_size": float(final[1].eps),
               "moved_share": float((draws[-1] != theta0).any(-1)
                                    .double().mean()),
               "corr_v_start_last": float(torch.corrcoef(torch.stack(
                   [theta0[:, 0], draws[-1, :, 0]]))[0, 1]),
               **_v_moments(draws)}
        if crit is not None:
            out["mean_tree_depth"] = float(
                st["tree_depth"].double().mean())
        out["ms_per_generalized_leapfrog_step"] = 1e3 * wall / float(
            stats["n_steps"].double().mean(1).sum())
        runs[name] = out
        log(json.dumps({f"phase_18b_{name}": out}))
        gates[f"{name}: draws finite"] = bool(torch.isfinite(draws).all())
        gates[f"{name}: |E[v]| <= {RM_MCSE} MCSE"] = \
            abs(out["mean_v"]) <= RM_MCSE * out["mcse_mean_v"]
        gates[f"{name}: |sd(v) - {RM_SIGMA_V}| <= {RM_MCSE} MCSE"] = \
            abs(out["sd_v"] - RM_SIGMA_V) <= RM_MCSE * out["mcse_sd_v"]
        gates[f"{name}: accept >= {RM_ACCEPT_MIN}"] = \
            out["accept_mean"] >= RM_ACCEPT_MIN
        gates[f"{name}: share of chains moved >= {RM_MOVED_MIN}"] = \
            out["moved_share"] >= RM_MOVED_MIN
        gates[f"{name}: corr(v start, v last) <= {RM_CORR_V_MAX}"] = \
            out["corr_v_start_last"] <= RM_CORR_V_MAX
    result = ah.SampleResult(thetas=thetas, stats=stats, warmup_stats=None,
                             final_state=final)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "result.npz")
        result.save(path)
        back = checkpoint.load_result(path, like_state=_zeros_like(final),
                                      device="cuda")
    gates["SampleResult.save / load_result round trip bitwise"] = (
        torch.equal(back.thetas, thetas)
        and set(back.stats) == set(stats)
        and all(torch.equal(back.stats[k], v) for k, v in stats.items())
        and _same_leaves(back.final_state, final))
    log(f"# 18b: static {runs['static']['wall_s']:.1f} s, NUTS "
        f"{runs['nuts']['wall_s']:.1f} s; divergence "
        f"{runs['static']['divergence_rate']:.4f} / "
        f"{runs['nuts']['divergence_rate']:.4f}")
    _finish_gates("18b", gates)
    return runs


def _ms(fn, reps=3, warm=True):
    """Host wall of one call of `fn`, ending in a synchronise (the mean of
    `reps`, after one warm-up call if `warm`)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_rmhmc_logistic(seed, main_state):
    """18c: SoftAbs RMHMC on the 100-D logistic in float32 from phase 3's
    final positions, every kernel's count set to 0 just before and read
    just after: K1's calls against the target's value+grad calls, one
    ∂H∂θ through K1 against the float64 route, finite energies; the time
    of one generalised leapfrog step beside its parts (the Hessian, ∂G,
    the batched eigh, K1) and the peak device memory."""
    import advancedhmc_torch as ah
    from advancedhmc_torch import riemannian as rm

    def model(dtype):
        return ah.hierarchical_logistic(n=N_ROWS, p=DIM - 1, dtype=dtype,
                                        device="cuda")

    t32, by_chains = count_by_chains(model(torch.float32))
    t64 = model(torch.float64)
    h32 = rm.RiemannianHamiltonian(
        metric=rm.DenseRiemannianMetric.from_hessian(
            t32, rm.SoftAbsMap(20.0), chunk_size=RMC_CHUNK), target=t32)
    h64 = rm.RiemannianHamiltonian(
        metric=rm.DenseRiemannianMetric.from_hessian(
            t64, rm.SoftAbsMap(20.0), chunk_size=RMC_CHUNK), target=t64)
    theta = main_state.z.theta[:RMC_CHAINS].clone()
    gen = torch.Generator(device="cuda").manual_seed(seed + 183)
    r = torch.randn(theta.shape, generator=gen, device="cuda")

    # ∂H∂θ at float32 through K1 against the float64 route (no kernel)
    th_c, r_c = theta[:RMC_CHECK], r[:RMC_CHECK]
    lp32, g32 = h32.dH_dtheta(th_c, r_c)
    lp64, g64 = h64.dH_dtheta(th_c.double(), r_c.double())
    err_g = float((g32.double() - g64).abs().max())
    err_lp = float((lp32.double() - lp64).abs().max())
    scale_g, scale_lp = float(g64.abs().max()), float(lp64.abs().max())

    # the step and its parts at RMC_CHAINS
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    z = h32.phasepoint(theta, r)
    integ = rm.GeneralizedLeapfrog(
        step_size=torch.tensor(RMC_EPS, device="cuda"), n_fp=RM_FP)
    g = h32.metric.g_fn(theta)
    parts = {
        "hessian_ms": _ms(lambda: h32.metric.g_fn(theta)),
        "dg_ms": _ms(lambda: h32.metric.dg_fn(theta), reps=1),
        "eigh_ms": _ms(lambda: rm.metric.eigh(g)),
        "k1_ms": _ms(lambda: t32.logdensity_and_grad(theta)),
        # its parts are warm: one step, not warmed up
        "step_ms": _ms(lambda: rm.generalized_leapfrog_step(
            integ, h32, z, RMC_EPS), reps=1, warm=False),
    }
    del g, z

    res, wall, calls, counts = _timed_run(by_chains, lambda: (
        rm.sample_rmhmc(gen, t32, theta, RMC_T, n_leapfrog=RMC_LEAPFROG,
                        step_size=RMC_EPS, n_fp=RM_FP, metric=h32.metric,
                        device="cuda")))
    thetas, stats, _ = res
    peak = torch.cuda.max_memory_allocated()
    out = {
        "chains": RMC_CHAINS, "transitions": RMC_T,
        "n_leapfrog": RMC_LEAPFROG, "n_fp": RM_FP, "step_size": RMC_EPS,
        "dg_chunk": RMC_CHUNK, "wall_s": wall,
        "accept_mean": float(stats["acceptance_rate"].double().mean()),
        "k1_calls": counts[K1_CALLS],
        "k1_launches": counts["fused_logistic_value_grad"],
        "value_grad_calls": sum(calls.values()),
        "k1_calls_by_chains": dict(sorted(calls.items(), reverse=True)),
        "dH_dtheta_max_abs_err": err_g, "dH_dtheta_scale": scale_g,
        "lp_max_abs_err": err_lp, "peak_memory_gb": peak / 2 ** 30,
        "memory_before_gb": base_mem / 2 ** 30,
        **parts}
    log(json.dumps({"phase_18c": out}))
    log(f"# 18c: one generalised leapfrog step at {RMC_CHAINS} chains "
        f"{parts['step_ms']:.1f} ms; Hessian {parts['hessian_ms']:.1f} ms, "
        f"∂G {parts['dg_ms']:.1f} ms, eigh {parts['eigh_ms']:.2f} ms, K1 "
        f"{parts['k1_ms']:.3f} ms a call; peak memory "
        f"{out['peak_memory_gb']:.2f} GiB")
    gates = {
        "k1 calls = value+grad calls": out["k1_calls"]
        == out["value_grad_calls"] > 0,
        "k1 launches = calls": out["k1_launches"] == out["k1_calls"],
        f"dH/dtheta through K1 within {RMC_TOL} of the float64 route":
            err_g <= RMC_TOL * scale_g
            and err_lp <= RMC_TOL * max(1.0, scale_lp),
        "energies and draws finite":
            bool(torch.isfinite(stats["hamiltonian_energy"]).all())
            and bool(torch.isfinite(thetas).all()),
    }
    _finish_gates("18c", gates)
    return out


# ----------------------------------------------------------------- phase 19
# Chain parallelism and the program cache. (a) right after phase 4 (at the
# end of the script, after 800 s of other phases, the same run took 35 s
# against phase 3's 28), phase 3 exactly through
# `sample(mesh=mesh_of_all_devices())` in a one-rank NCCL group: its draws,
# stats, ε and M⁻¹ must be phase 3's bit for bit, and K1's launches as
# many. (b) two ranks under gloo sharing the card (this script started
# twice with --mesh-worker), phase 3's configuration at MESH_CHAINS chains
# with a short warmup, against the same run in this process; K1 is first
# held at C and at C/2 on the same rows, which says whether the sharded
# run can be bitwise the unsharded one (each rank computes its chains'
# value+grad at C/2). (c) `aot_program` on a fused cross-chain warmup
# block, the program bench.py's AHMC_BENCH_AOT path wraps. (c) and (d)
# run in this process while (b)'s ranks run (their start takes most of
# their wall): phase 19 took 60.7 and 63.2 s run one after the other.
MESH_WORLD = 2
MESH_CHAINS, MESH_WARMUP_CHAINS = 4096, 1024
# 64 warmup iterations in blocks of 4 (16 dual-averaging updates): 32 in
# blocks of 8 left ε so large that nothing was accepted
MESH_WARMUP, MESH_WARMUP_BLOCK, MESH_DECOR, MESH_DRAWS = 64, 4, 4, 16
MESH_ACCEPT_BAND = (0.3, 0.9)
# (b)'s gates where K1's bits depend on the chain count: the two runs'
# final ε within this ratio, and their acceptance and mean log σ within
# these differences
MESH_EPS_RATIO, MESH_TOL_ACCEPT, MESH_TOL_LOGSIGMA = 1.25, 0.05, 0.05
# (c) on 1024 of phase 3's starting points (phase 19's clock: 4096 took
# 6.8 s), one block of phase 3's length
AOT_CHAINS, AOT_BLOCK = 1024, WARMUP_BLOCK


def bits_digest(x):
    """A digest of the bits of `x`, one int64 for each index of its first
    axis: the bytes of the row times odd weights, summed with wrap-around.
    Rows of equal bits give equal digests; a row that differs gives another
    one but for a collision."""
    out, w = [], None
    for row in x:
        b = row.contiguous().view(torch.uint8).reshape(-1).to(torch.int64)
        if w is None or w.numel() != b.numel():
            w = torch.arange(b.numel(), device=b.device,
                             dtype=torch.int64) * 5308871522 + 1
        out.append((b * w).sum())
    return torch.stack(out).cpu()


def result_digest(res):
    """What 19a compares: the draws' and every stat's digests, the final ε
    and the M⁻¹."""
    return {"thetas": bits_digest(res.thetas),
            "stats": {k: bits_digest(v) for k, v in res.stats.items()},
            "eps": res.final_state.adapt.da.eps.clone(),
            "m_inv": res.final_state.metric.m_inv.clone()}


def _same_digest(a, b):
    return (torch.equal(a["thetas"], b["thetas"])
            and a["stats"].keys() == b["stats"].keys()
            and all(torch.equal(a["stats"][k], b["stats"][k])
                    for k in a["stats"])
            and torch.equal(a["eps"], b["eps"])
            and torch.equal(a["m_inv"], b["m_inv"]))


def phase_mesh_full(seed, main):
    """19a: phase 3 on a one-rank NCCL mesh; `main` holds phase 3's
    digest, K1 launches, K1 calls by chain count and wall."""
    import torch.distributed as dist

    import advancedhmc_torch as ah

    mesh = ah.parallel.mesh_of_all_devices()
    backend, world = dist.get_backend(), dist.get_world_size()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res, launches, wall, by_chains, _ = phase_main(seed, gen, mesh)
    digest = result_digest(res)
    del res
    dist.destroy_process_group()
    out = {"phase": "19a", "backend": backend, "world": world,
           "chains": N_CHAINS, "wall_s": wall, "phase3_wall_s": main["wall"],
           "k1_launches": launches, "phase3_k1_launches": main["launches"],
           "k1_calls_by_chains": by_chains}
    log(json.dumps(out))
    log(f"# phase 19a: phase 3 on a one-rank {backend} mesh in {wall:.1f} s "
        f"(phase 3: {main['wall']:.1f} s), K1 launches {launches} "
        f"(phase 3: {main['launches']})")
    gates = {
        "one-rank NCCL group": backend == "nccl" and world == 1,
        "draws, stats, eps and M^-1 bitwise phase 3's":
            _same_digest(digest, main["digest"]),
        "K1 launches = phase 3's": launches == main["launches"],
        "K1 calls by chain count = phase 3's":
            by_chains == main["by_chains"],
    }
    _finish_gates("19a", gates)
    return out


def _mesh_run(seed, mesh=None):
    """(b)'s configuration: phase 3's at MESH_CHAINS chains, warming
    MESH_WARMUP_CHAINS, on `mesh` if given. Returns (result, K1
    launches, wall)."""
    import advancedhmc_torch as ah

    target, kernel, adaptor = main_path_spec()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    metric = ah.make_metric("diagonal", DIM, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = ah.sample(
        gen, target, kernel, metric, _main_theta0(seed)[:MESH_CHAINS],
        MESH_WARMUP + MESH_DRAWS, n_adapts=MESH_WARMUP, adaptor=adaptor,
        init_mass_matrix="gradient", cross_chain=True, fuse_draws=FUSE,
        fuse_warmup=True, fuse_warmup_block=MESH_WARMUP_BLOCK,
        drop_warmup=True, warmup_chains=MESH_WARMUP_CHAINS,
        fanout_decorrelate=MESH_DECOR,
        fuse_pair=PAIR, mesh=mesh, device="cuda")
    torch.cuda.synchronize()
    return (res, read_launches()["fused_logistic_value_grad"],
            time.perf_counter() - t0)


def mesh_worker(rank, world, store, out, seed):
    """One rank of 19b (`--mesh-worker`): a gloo group over a file store,
    the configuration of `_mesh_run` on the mesh, this rank's results to
    `out` (an npz)."""
    import numpy as np

    require_cuda()
    import advancedhmc_torch as ah

    ah.parallel.distributed_init(backend="gloo",
                                 init_method=f"file://{store}",
                                 world_size=world, rank=rank)
    res, launches, wall = _mesh_run(seed, ah.parallel.mesh_of_all_devices())
    st = res.final_state
    np.savez(out, thetas=res.thetas.cpu().numpy(),
             accept=res.stats["acceptance_rate"].cpu().numpy(),
             eps=st.adapt.da.eps.cpu().numpy(),
             m_inv=st.metric.m_inv.cpu().numpy(),
             z=st.z.theta.cpu().numpy(), launches=launches, wall=wall)
    import torch.distributed as dist

    dist.destroy_process_group()


def _k1_bitwise_at_half(theta):
    """Whether K1 gives each chain the same bits at C and at C/2 (the
    rows split in two calls), and the largest difference."""
    target = main_path_spec()[0]
    lp, g = target.logdensity_and_grad(theta)
    h = theta.shape[0] // 2
    parts = [target.logdensity_and_grad(theta[i:i + h]) for i in (0, h)]
    lp2 = torch.cat([p[0] for p in parts])
    g2 = torch.cat([p[1] for p in parts])
    same = torch.equal(lp, lp2) and torch.equal(g, g2)
    err = max(float((lp - lp2).abs().max()), float((g - g2).abs().max()))
    return same, err


def phase_mesh_gloo(seed, meanwhile):
    """19b: two ranks sharing the card under gloo against one process.
    `meanwhile()` runs here after the one-process run, while the ranks
    still run (their start takes most of their wall); returns (19b's
    results, what `meanwhile` returned)."""
    import shutil
    from pathlib import Path

    import numpy as np

    from advancedhmc_torch.ops import _build

    work = _build.BUILD_DIR / "mesh19b"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
         "--mesh-worker", str(r), str(MESH_WORLD), str(work / "store"),
         str(work / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_WORLD)]
    try:
        res, launches, wall = _mesh_run(seed)
        extra = meanwhile()
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"19b rank {r} failed:\n{text[-4000:]}")
    ranks = [dict(np.load(work / f"rank{r}.npz"))
             for r in range(MESH_WORLD)]
    shutil.rmtree(work, ignore_errors=True)
    one = {"thetas": res.thetas.cpu().numpy(),
           "accept": res.stats["acceptance_rate"].cpu().numpy(),
           "eps": res.final_state.adapt.da.eps.cpu().numpy(),
           "m_inv": res.final_state.metric.m_inv.cpu().numpy(),
           "z": res.final_state.z.theta.cpu().numpy()}
    k1_same, k1_err = _k1_bitwise_at_half(res.final_state.z.theta)
    del res
    two = ranks[0]
    z2 = np.concatenate([r["z"] for r in ranks])
    bitwise = (np.array_equal(two["thetas"], one["thetas"])
               and np.array_equal(two["eps"], one["eps"])
               and np.array_equal(two["m_inv"], one["m_inv"])
               and np.array_equal(z2, one["z"]))
    agree = float(np.mean(np.all(two["thetas"] == one["thetas"], -1)))
    ls1 = float(one["thetas"][..., 0].astype(np.float64).mean())
    ls2 = float(two["thetas"][..., 0].astype(np.float64).mean())
    acc1, acc2 = float(one["accept"].mean()), float(two["accept"].mean())
    eps_ratio = float(two["eps"]) / float(one["eps"])
    out = {"phase": "19b", "world": MESH_WORLD, "backend": "gloo",
           "chains": MESH_CHAINS, "warmup_chains": MESH_WARMUP_CHAINS,
           "warmup": MESH_WARMUP, "draws": MESH_DRAWS,
           "k1_bitwise_at_half": k1_same, "k1_half_max_abs_diff": k1_err,
           "bitwise": bitwise, "draws_agreeing_share": agree,
           "eps_ratio": eps_ratio, "accept": [acc1, acc2],
           "mean_logsigma": [ls1, ls2],
           "wall_s": wall, "rank_walls_s": [float(r["wall"]) for r in ranks],
           "k1_launches": launches,
           "rank_k1_launches": [int(r["launches"]) for r in ranks]}
    log(json.dumps(out))
    log(f"# phase 19b: K1 bitwise at C/2: {k1_same} (max diff {k1_err:.3g});"
        f" 2 ranks bitwise the one process: {bitwise}, {agree:.4f} of the "
        f"draws agree; eps ratio {eps_ratio:.4f}, accept {acc2:.4f} against "
        f"{acc1:.4f}; walls {out['rank_walls_s']} s against {wall:.1f} s")
    gates = {
        "ranks hold the same draws": all(
            np.array_equal(r["thetas"], two["thetas"]) for r in ranks),
        "draws finite, shape": two["thetas"].shape == (
            MESH_DRAWS, MESH_CHAINS, DIM)
        and bool(np.isfinite(two["thetas"]).all()),
        "K1 launched on every rank": min(out["rank_k1_launches"]) > 0,
        f"accept in {MESH_ACCEPT_BAND} (the chains move)":
            MESH_ACCEPT_BAND[0] <= min(acc1, acc2)
            and max(acc1, acc2) <= MESH_ACCEPT_BAND[1],
    }
    if k1_same:
        gates["2 ranks bitwise the one process (K1 bitwise at C/2)"] = bitwise
    else:
        gates[f"eps ratio within 1/{MESH_EPS_RATIO}..{MESH_EPS_RATIO}"] = \
            1 / MESH_EPS_RATIO <= eps_ratio <= MESH_EPS_RATIO
        gates[f"|accept diff| <= {MESH_TOL_ACCEPT}"] = \
            abs(acc1 - acc2) <= MESH_TOL_ACCEPT
        gates[f"|mean log sigma diff| <= {MESH_TOL_LOGSIGMA}"] = \
            abs(ls1 - ls2) <= MESH_TOL_LOGSIGMA
    _finish_gates("19b", gates)
    return out, extra


def phase_aot(seed):
    """19c: `aot_program` on one fused cross-chain warmup block of phase
    3's configuration at AOT_CHAINS chains: the first lookup reports
    "trace" and its call writes the manifest, a second reports "cache",
    both calls bitwise the block's."""
    import shutil

    import advancedhmc_torch as ah
    from advancedhmc_torch.ops import _build
    from advancedhmc_torch.sampler import fused_warmup_phase_crosschain

    target, kernel, adaptor = main_path_spec()
    spec = ah.SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                         cross_chain=True)
    st0 = ah.init_state(torch.Generator(device="cuda").manual_seed(seed),
                        spec, ah.make_metric("diagonal", DIM, device="cuda"),
                        _main_theta0(seed)[:AOT_CHAINS],
                        init_mass_matrix="gradient", device="cuda")

    def block(st):
        return fused_warmup_phase_crosschain(
            torch.Generator(device="cuda").manual_seed(seed + 19), spec, st,
            AOT_BLOCK, AOT_BLOCK, pair=PAIR)

    cache = _build.BUILD_DIR / "aot19c"
    shutil.rmtree(cache, ignore_errors=True)
    ref = block(st0)
    t0 = time.perf_counter()
    call1, src1 = ah.aot_program(block, (st0,), program_id="warm_block",
                                 cache_dir=cache)
    out1 = call1(st0)
    t1 = time.perf_counter()
    call2, src2 = ah.aot_program(block, (st0,), program_id="warm_block",
                                 cache_dir=cache)
    t2 = time.perf_counter()
    out2 = call2(st0)
    manifest = json.loads(next(cache.glob("*.json")).read_text())
    shutil.rmtree(cache, ignore_errors=True)

    def same(a, b):
        return (_same_leaves(a[0], b[0]) and torch.equal(a[1], b[1])
                and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))

    out = {"phase": "19c", "sources": [src1, src2],
           "libraries": manifest["libraries"],
           "trace_call_s": t1 - t0, "cache_lookup_s": t2 - t1}
    log(json.dumps(out))
    gates = {
        'first lookup "trace", second "cache"': [src1, src2] == [
            "trace", "cache"],
        "calls bitwise the block's": same(out1, ref) and same(out2, ref),
        "manifest lists K1's library": "fused_logistic" in out["libraries"],
    }
    _finish_gates("19c", gates)
    return out


# (d) the fused loop's last options: one fused draw call of OPT19_T
# transitions from phase 3's ε, M⁻¹ and positions on the 100-D model with
# its design in float16 (K1's float16 mode at every leaf), the draw buffer
# in bfloat16, `stage_slots=OPT19_STAGE` (taken, a no-op in the port) and
# `unroll` 2; then the same call at the defaults but the bfloat16 buffer,
# which must give the same bits
OPT19_CHAINS, OPT19_T, OPT19_STAGE = 4096, 16, 4


def phase_last_options(warmed):
    import advancedhmc_torch as ah
    from advancedhmc_torch.experimental import Experimental
    from advancedhmc_torch.sampler import fused_draw_phase

    eps, m_inv, theta = warmed
    _, kernel, adaptor = main_path_spec()
    target = ah.hierarchical_logistic(n=N_ROWS, p=DIM - 1,
                                      dtype=torch.float32,
                                      x_dtype="float16", device="cuda")
    target, by_chains = count_by_chains(target)
    spec = ah.SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                         cross_chain=True)
    state = ah.init_state(
        torch.Generator(device="cuda").manual_seed(19), spec,
        ah.DiagEuclideanMetric.create(m_inv), theta[:OPT19_CHAINS],
        init_eps=eps, device="cuda")

    def call(**options):
        gen = torch.Generator(device="cuda").manual_seed(190)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, th, st = fused_draw_phase(gen, spec, state, OPT19_T, OPT19_T,
                                     pair=PAIR, **options)
        torch.cuda.synchronize()
        return th, st, time.perf_counter() - t0

    calls0 = sum(by_chains.values())     # init_state's value+grad
    reset_launches()
    th, st, wall = call(unroll=2, experimental=Experimental(
        out_dtype=torch.bfloat16, stage_slots=OPT19_STAGE))
    counts = read_launches()
    calls = sum(by_chains.values()) - calls0
    th_ref, st_ref, wall_ref = call(
        experimental=Experimental(out_dtype=torch.bfloat16))
    out = {"phase": "19d", "chains": OPT19_CHAINS, "transitions": OPT19_T,
           "x_dtype": "float16", "out_dtype": "bfloat16",
           "stage_slots": OPT19_STAGE, "unroll": 2,
           "wall_s": wall, "defaults_wall_s": wall_ref,
           "accept_mean": float(st["acceptance_rate"].double().mean()),
           "divergence_rate": float(st["numerical_error"].double().mean()),
           "k1_f16_launches": counts[K1_F16],
           "k1_f16_calls": counts[K1_F16_CALLS], "value_grad_calls": calls}
    log(json.dumps(out))
    gates = {
        "draws finite, shape": tuple(th.shape) == (
            OPT19_T, OPT19_CHAINS, DIM) and bool(torch.isfinite(th).all()),
        "draws held in bfloat16": torch.equal(
            th, th.to(torch.bfloat16).to(th.dtype)),
        "the layout options change no bit": torch.equal(th, th_ref) and all(
            torch.equal(st[k], st_ref[k]) for k in st),
        "divergence_rate <= 1e-3": out["divergence_rate"] <= 1e-3,
        f"accept in {MM_ACCEPT_BAND}":
            MM_ACCEPT_BAND[0] <= out["accept_mean"] <= MM_ACCEPT_BAND[1],
        "k1 float16 launched": out["k1_f16_launches"] > 0,
        "k1 float16 calls = value+grad calls = all K1 calls":
            out["k1_f16_calls"] == calls == counts[K1_CALLS],
        "k1 float16 launches = 1 a call":
            out["k1_f16_launches"] == out["k1_f16_calls"],
    }
    _finish_gates("19d", gates)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the starting points and the sampler")
    ap.add_argument("--mesh-worker", nargs=4,
                    metavar=("RANK", "WORLD", "STORE", "OUT"),
                    help="run one rank of phase 19b and exit (the script "
                    "starts its ranks itself)")
    args = ap.parse_args(argv)
    if args.mesh_worker:
        rank, world, store, out = args.mesh_worker
        mesh_worker(int(rank), int(world), store, out, args.seed)
        return
    require_cuda()
    import advancedhmc_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()

    def clock(done):
        log(f"# clock: {done} done at {time.perf_counter() - t_start:.1f} s")

    gpu = gpu_line()
    log(f"# card: {gpu}")
    phase_build()
    clock("phase 1 (build)")
    from advancedhmc_torch.ops.fused_logistic import MODE_BF16, MODE_F16, \
        MODE_F32
    k1_rows, k1_err, _ = phase_k1(MODE_F32)
    k1_report()
    k1_bf16_rows, k1_bf16_err, _ = phase_k1(MODE_BF16)
    k1_f16_rows, k1_f16_err, _ = phase_k1(MODE_F16)
    clock("phase 2")
    k3_rows, k3_err, k3_launches = phase_k3()
    clock("phase 2b")
    gen_main = torch.Generator(device="cuda").manual_seed(args.seed)
    res, launches, wall, k1_by_chains, iters = phase_main(args.seed,
                                                          gen_main)
    out = phase_results(res, launches, wall, args.seed, iters)
    log(f"# main path: warmup {out['warmup_s']:.1f} s, draws "
        f"{out['draws_s']:.1f} s, K1 launches {launches}")
    clock("phases 3-4")
    # phase 19a here, beside phase 3 (the allocator and the card as phase
    # 3 had them): phase 3 again on a one-rank NCCL mesh
    t19a = time.perf_counter()
    mesh_full = phase_mesh_full(args.seed, {
        "digest": result_digest(res), "launches": launches,
        "by_chains": k1_by_chains, "wall": wall})
    t19a = time.perf_counter() - t19a
    clock("phase 19a")
    turns = phase_pair_turns(res)
    clock("phase 3b")
    phase_profile(res)
    clock("phase 5")
    ckpt = phase_checkpoint(res, out, gen_main)
    clock("phase 18d (checkpoint, throughput_report)")
    mega = phase_megakernel(res, out)
    clock("phase 6")
    k2_rows = [dict(case=f"logistic C={N_CHAINS} T={MEGA_T} "
                    f"max_depth={MAX_DEPTH} (megakernel call 1)",
                    **mega["first_call_agreement"],
                    mean_depth=mega["mean_tree_depth"],
                    ms=mega["call_ms_mean"],
                    plain_ms=mega["first_call_plain_ms"],
                    bound_ms=mega["bound_ms_mean"]),
               *phase_k2_parity(res)]
    clock("phase 7")
    # phase 14 starts from phase 3's ε, M⁻¹ and a slice of its positions
    fs = res.final_state
    warmed = (fs.adapt.da.eps.clone(), fs.metric.m_inv.clone(),
              fs.z.theta[:STATIC_CHAINS].clone())
    # phase 16b: its final ε, M⁻¹ and all 32768 positions
    main_state = fs
    del res, fs
    defaults, k1_by_chains_defaults = phase_defaults(args.seed)
    clock("phase 8")
    wide_rows, wide_err, wide_launched = phase_wide_k1(MODE_F32)
    wide_shape = k1_wide_report(wide_launched)
    wide_bf16_rows, wide_bf16_err, _ = phase_wide_k1(MODE_BF16)
    wide_f16_rows, wide_f16_err, _ = phase_wide_k1(MODE_F16)
    cox_rows, cox_err = phase_cox_k1((MODE_F32, MODE_BF16))
    clock("phase 9c")
    wide, res = phase_wide(args.seed)
    clock("phase 9")
    wide_k2 = phase_wide_megakernel(res, wide)
    del res
    clock("phase 10")
    wide_bf16 = phase_wide_bf16(args.seed, wide)
    clock("phase 11")
    options = phase_options(args.seed, defaults)
    clock("phase 12")
    log("# phase 12: " + json.dumps(
        {k: {f: v[f] for f in ("warmup_s", "draws_s") if f in v}
         for k, v in options.items()}))
    chees = phase_chees(args.seed)
    clock("phase 13")
    static = phase_static(args.seed, warmed)
    clock("phase 14")
    log("# phase 14: " + json.dumps(
        {k: {f: v[f] for f in ("warmup_s", "draws_s", "accept_mean")}
         for k, v in static.items()}))
    mm = phase_metrics(args.seed, out)
    log("# phase 15: " + json.dumps(
        {k: {f: v[f] for f in ("warmup_s", "draws_s", "accept_mean",
                               "k1_launches")}
         for k, v in mm.items()}))
    clock("phase 15")
    t16 = time.perf_counter()
    nc = phase_nc(args.seed)
    criteria = phase_criteria(main_state, out, turns)
    strict_slice = phase_strict_slice(args.seed)
    zoo, _ = phase_zoo(args.seed)
    log(f"# phase 16 took {time.perf_counter() - t16:.1f} s: " + json.dumps(
        {"16a": {f: nc[f] for f in ("warmup_s", "draws_s",
                                     "effective_samples_per_s_per_chip")},
         "16b": {k: v["draws_s"] for k, v in criteria.items()},
         "16c": {f: strict_slice[f] for f in ("warmup_s", "draws_s")},
         "16d": {k: v["wall_s"] for k, v in zoo.items()}}))
    clock("phase 16")
    t17 = time.perf_counter()
    tcap = phase_tcap(args.seed, out)
    ragged = phase_ragged(args.seed, main_state, out, turns)
    log(f"# phase 17 took {time.perf_counter() - t17:.1f} s: " + json.dumps(
        {"17a": {f: tcap[f] for f in (
            "warmup_s", "draws_s", "effective_samples_per_s_per_chip",
            "step_size")},
         "17b": {f: ragged[f] for f in (
             "draws_s", "draws_per_chain_mean", "collected_vs_rect",
             "effective_samples_per_s_per_chip")}}))
    clock("phase 17")
    t18 = time.perf_counter()
    rel = phase_relativistic(args.seed, out)
    clock("phase 18a")
    funnel = phase_rmhmc_funnel(args.seed)
    clock("phase 18b")
    rmc = phase_rmhmc_logistic(args.seed, main_state)
    del main_state
    log(f"# phase 18 took {time.perf_counter() - t18:.1f} s (18d "
        "above, after phase 5): " + json.dumps(
            {"18a": {f: rel[f] for f in (
                "warmup_s", "draws_s", "effective_samples_per_s_per_chip",
                "leaf_iterations_per_transition", "k1_launches")},
             "18b": {k: v["wall_s"] for k, v in funnel.items()},
             "18c": {f: rmc[f] for f in ("wall_s", "step_ms",
                                         "peak_memory_gb")},
             "18d": {f: ckpt[f] for f in ("save_s", "load_s")}}))
    clock("phase 18")
    t19 = time.perf_counter() - t19a     # phase 19's clock, 19a included
    # 19c and 19d run while 19b's ranks run
    mesh_gloo, (aot, last) = phase_mesh_gloo(
        args.seed, lambda: (phase_aot(args.seed), phase_last_options(warmed)))
    log(f"# phase 19 took {time.perf_counter() - t19:.1f} s (19a after "
        "phase 3): " + json.dumps(
        {"19a": {f: mesh_full[f] for f in ("wall_s", "phase3_wall_s")},
         "19b": {f: mesh_gloo[f] for f in ("wall_s", "rank_walls_s",
                                            "bitwise",
                                            "k1_bitwise_at_half")},
         "19c": {f: aot[f] for f in ("sources", "trace_call_s",
                                     "cache_lookup_s")},
         "19d": {f: last[f] for f in ("wall_s", "defaults_wall_s",
                                      "accept_mean")}}))
    clock("phase 19")

    k1_row, k3_row = k1_rows[0], k3_rows[2]
    wide_row = next(r for r in wide_rows if r["chains"] == WIDE_CHAINS)
    bf16_row = next(r for r in wide_bf16_rows if r["chains"] == WIDE_CHAINS)
    f16_row = next(r for r in wide_f16_rows if r["chains"] == WIDE_CHAINS)
    f16_narrow = k1_f16_rows[0]
    kernels = {"kernels": [{
        "name": "fused_logistic_value_grad",
        "route": "cuda",
        "source": "advancedhmc_torch/csrc/fused_logistic.cu",
        "replaces": "advancedhmc_tpu/ops/fused_logistic.py:53",
        "launches": launches,
        "launches_by_chains": k1_by_chains,
        "launches_default_path": defaults["k1_launches"],
        "launches_default_path_by_chains": k1_by_chains_defaults,
        "launches_chees": chees["k1_launches"],
        "calls_chees_by_chains": chees["calls_by_chains"],
        "launches_static_path": {k: v["k1_launches"]
                                 for k, v in static.items()},
        "launches_metric_paths": {k: v["k1_launches"]
                                  for k, v in mm.items()},
        "calls_metric_paths_by_chains": {k: v["k1_calls_by_chains"]
                                         for k, v in mm.items()},
        "launches_nc": nc["k1_launches"],
        "calls_nc_by_chains": nc["k1_calls_by_chains"],
        "nc_max_abs_err": nc["k1_check_max_abs_err"],
        "launches_criteria_paths": {
            **{k: v["k1_launches"] for k, v in criteria.items()},
            "16c strict + slice": strict_slice["k1_launches"],
            "16d german_credit_logistic":
                zoo["german_credit_logistic"]["k1_launches"]},
        "launches_tcap": tcap["k1_launches"],
        "calls_tcap_by_chains": tcap["k1_calls_by_chains"],
        "launches_ragged": ragged["k1_launches"],
        "calls_ragged_by_chains": ragged["k1_calls_by_chains"],
        "launches_relativistic": rel["k1_launches"],
        "calls_relativistic_by_chains": rel["k1_calls_by_chains"],
        "launches_rmhmc_logistic": rmc["k1_launches"],
        "calls_rmhmc_logistic_by_chains": rmc["k1_calls_by_chains"],
        "rmhmc_dH_dtheta_max_abs_err": rmc["dH_dtheta_max_abs_err"],
        "launches_mesh_19a": mesh_full["k1_launches"],
        "launches_mesh_19b_by_rank": mesh_gloo["rank_k1_launches"],
        "max_abs_err": k1_err,
        "max_err": k1_err,
        "ms": k1_row["ms"],
        "kernel_ms": k1_row["ms"],
        "plain_ms": k1_row["plain_ms"],
        "bound_ms": k1_row["bound_ms"],
        "bound_by": k1_row["bound_by"],
        "bound_ms_f32_cuda_cores": k1_row["bound_ms_f32_cuda_cores"],
        "library_ms": None,
        "cublas_ms": k1_row["cublas_ms"],
        "wrapper_ms": k1_row["wrapper_ms"],
        "shapes": k1_rows,
    }, {
        "name": "fused_logistic_value_grad (wide, p > 128)",
        "route": "cuda",
        "source": "advancedhmc_torch/csrc/fused_logistic.cu",
        "replaces": "advancedhmc_tpu/ops/fused_logistic.py:53",
        "launches": wide["k1_launches"],
        "calls": wide["k1_calls"],
        "calls_by_chains": wide["k1_calls_by_chains"],
        "max_abs_err": wide_err,
        "max_err": wide_err,
        "ms": wide_row["ms"],
        "kernel_ms": wide_row["ms"],
        "plain_ms": wide_row["plain_ms"],
        "bound_ms": wide_row["bound_ms"],
        "bound_by": wide_row["bound_by"],
        "bound_ms_f32_cuda_cores": wide_row["bound_ms_f32_cuda_cores"],
        "library_ms": None,
        "cublas_ms": wide_row["cublas_ms"],
        "wrapper_ms": wide_row["wrapper_ms"],
        **wide_shape,
        "shapes": wide_rows,
    }, {
        "name": K1_BF16,
        "route": "cuda",
        "source": "advancedhmc_torch/csrc/fused_logistic.cu",
        "replaces": "advancedhmc_tpu/ops/fused_logistic.py:53",
        "launches": wide_bf16["k1_bf16_launches"],
        "calls": wide_bf16["k1_bf16_calls"],
        "max_abs_err": max(k1_bf16_err, wide_bf16_err),
        "max_err": max(k1_bf16_err, wide_bf16_err),
        "ms": bf16_row["ms"],
        "kernel_ms": bf16_row["ms"],
        "plain_ms": bf16_row["plain_ms"],
        "bound_ms": bf16_row["bound_ms"],
        "bound_by": bf16_row["bound_by"],
        "bound_ms_one_tf32_pass": bf16_row["bound_ms_one_tf32_pass"],
        "library_ms": None,
        "cublas_bf16_ms": bf16_row["cublas_ms"],
        "wrapper_ms": bf16_row["wrapper_ms"],
        "shapes": k1_bf16_rows + wide_bf16_rows,
    }, {
        "name": K1_F16,
        "route": "cuda",
        "source": "advancedhmc_torch/csrc/fused_logistic.cu",
        "replaces": "advancedhmc_tpu/ops/fused_logistic.py:53",
        # its path: phase 19d's fused call on the float16 design (narrow)
        "launches": last["k1_f16_launches"],
        "calls": last["k1_f16_calls"],
        "max_abs_err": max(k1_f16_err, wide_f16_err),
        "max_err": max(k1_f16_err, wide_f16_err),
        "ms": f16_narrow["ms"],
        "kernel_ms": f16_narrow["ms"],
        "plain_ms": f16_narrow["plain_ms"],
        "bound_ms": f16_narrow["bound_ms"],
        "bound_by": f16_narrow["bound_by"],
        "bound_ms_one_tf32_pass": f16_narrow["bound_ms_one_tf32_pass"],
        "library_ms": None,
        "cublas_f16_ms": f16_narrow["cublas_ms"],
        "wrapper_ms": f16_narrow["wrapper_ms"],
        "wide_ms": f16_row["ms"],
        "wide_plain_ms": f16_row["plain_ms"],
        "wide_bound_ms": f16_row["bound_ms"],
        "shapes": k1_f16_rows + wide_f16_rows,
    }, {
        "name": "fused_logistic_value_grad (Poisson link)",
        "route": "cuda",
        "source": "advancedhmc_torch/csrc/fused_logistic.cu",
        "replaces": None,
        "launches": cox_rows[0]["launches"],
        "max_abs_err": cox_err,
        "max_err": cox_err,
        "ms": cox_rows[0]["ms"],
        "kernel_ms": cox_rows[0]["ms"],
        "plain_ms": cox_rows[0]["plain_ms"],
        "bound_ms": cox_rows[0]["bound_ms"],
        "bound_by": cox_rows[0]["bound_by"],
        "library_ms": None,
        "wrapper_ms": cox_rows[0]["wrapper_ms"],
        "shapes": cox_rows,
    }, {
        "name": "fused_nuts",
        "route": "cuda",
        "source": "advancedhmc_torch/csrc/fused_nuts.cu",
        "replaces": "advancedhmc_tpu/ops/fused_nuts_kernel.py:417",
        "launches": mega["k2_launches"],
        # over every chain of every comparison, with the least share of
        # chains that agreed (a chain that drew another candidate counts)
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "max_err": max(r["max_abs_err"] for r in k2_rows),
        "agree_share": min(r["share_theta"] for r in k2_rows),
        "max_abs_err_agreeing":
            max(r["max_abs_err_agreeing"] for r in k2_rows),
        "ms": mega["call_ms_mean"],
        "kernel_ms": mega["call_ms_mean"],
        "plain_ms": mega["first_call_plain_ms"],
        "bound_ms": mega["bound_ms_mean"],
        "bound_by": mega["bound_by"],
        "bound_ms_f32_cuda_cores": mega["bound_ms_f32_cuda_cores_mean"],
        "library_ms": None,
        "chains_per_block": mega["chains_per_block"],
        "smem_bytes_per_block": mega["smem_bytes_per_block"],
        "blocks_per_sm": mega["blocks_per_sm"],
        "lockstep_share": mega["tile_lockstep_share"],
        "shapes": k2_rows,
    }, {
        "name": "fused_nuts (wide, p > 128)",
        "route": "cuda",
        "source": "advancedhmc_torch/csrc/fused_nuts.cu",
        "replaces": "advancedhmc_tpu/ops/fused_nuts_kernel.py:417",
        "launches": wide_k2["k2_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in wide_k2["shapes"]),
        "max_err": max(r["max_abs_err"] for r in wide_k2["shapes"]),
        "agree_share": min(r["share_theta"] for r in wide_k2["shapes"]),
        "agree_share_integers": min(r["share"] for r in wide_k2["shapes"]),
        "theta_transitions": WIDE_K2_THETA_T,
        "max_abs_err_agreeing":
            max(r["max_abs_err_agreeing"] for r in wide_k2["shapes"]),
        "ms": wide_k2["call_ms_mean"],
        "kernel_ms": wide_k2["call_ms_mean"],
        "plain_ms": wide_k2["shapes"][0]["plain_ms"],
        "bound_ms": wide_k2["bound_ms_mean"],
        "bound_by": wide_k2["bound_by"],
        "library_ms": None,
        "ms_per_leaf_iteration": wide_k2["ms_per_leaf_iteration"],
        **{k: wide_k2[k] for k in (
            "registers", "spill_store_bytes", "chains_per_block",
            "smem_bytes_per_block", "blocks_per_sm", "ranks_per_cluster",
            "groups", "blocks", "resident_clusters", "sms", "sms_used",
            "lockstep_share")},
        "shapes": wide_k2["shapes"],
    }, {
        "name": "fused_gaussian_leapfrog",
        "route": "cuda",
        "source": "advancedhmc_torch/csrc/fused_leapfrog.cu",
        "replaces": "advancedhmc_tpu/ops/fused_leapfrog.py:60",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "max_err": k3_err,
        "ms": k3_row["ms"],
        "kernel_ms": k3_row["ms"],
        "plain_ms": k3_row["plain_ms"],
        "bound_ms": k3_row["bound_ms"],
        "bound_by": k3_row["bound_by"],
        "library_ms": None,
        "wrapper_ms": k3_row["wrapper_ms"],
        "shapes": k3_rows,
    }]}
    log(json.dumps(kernels))
    log(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""The ChEES job: bench.py's ChEES measurement.

In the window: the initial M⁻¹ from the gradient at the initial points and
ε from the search on the first chain, `n_warmup` iterations of
`make_chees_step` (Stan's windows with the Welford variance, ChEES's
trajectory length adapted, Halton jitter), then `make_chees_draw_step`
iterations in chunks of `chunk`, each chunk ending in a host synchronise,
until `--seconds` have passed since the window opened (at least
`MIN_CHUNKS`). Set-up runs the step once for each distinct set of the
warmup's adaptation flags, and the draw step once, on throwaway state.

The warmup is the same in every run: its initial points and its random
stream come from `WARMUP_SEED`, so every run adapts to the same ε, M⁻¹
and trajectory length and its draws do the same work (the number of
leapfrog steps a draw takes follows the adapted T / ε). `--seed` seeds the
stream of the draws.

After the window it reads the peak memory, runs the traced stretches
(`--trace 1`), then one more draw iteration from the window's final state
through the same entry, whose value+grad keeps what it saw for a sample of
chains drawn from the seed (`check_step`), for the reference to follow.

Traffic keys: chains, n_warmup, chunk, delta, t0, max_steps, init_buffer,
term_buffer, window_size, ess_chains.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

INIT_SCALE = 0.1         # sd of the initial points
WARMUP_SEED = 0          # the warmup's initial points and random stream
MIN_CHUNKS = 1           # draw chunks the window holds at least
MAX_DRAWS = 262144       # Halton points made for the draws
STRETCH_ITERATIONS = 16  # draw iterations of a traced stretch
CHECK_CHAINS = 1024      # chains whose followed draw step is kept


def halton(lo: int, hi: int) -> np.ndarray:
    """Points lo..hi-1 of the base-2 van der Corput sequence, the program's
    `halton_sequence` (point i is the radical inverse of i + 1)."""
    idx = np.arange(lo + 1, hi + 1, dtype=np.int64)
    out, f = np.zeros(hi - lo), 1.0
    while idx.any():
        f /= 2.0
        out += f * (idx % 2)
        idx //= 2
    return out


def _stat_sums(st):
    """(Σ n_steps, Σ divergent, Σ acceptance, Σ T, Σ ε) of an iteration."""
    return torch.stack([st[k].to(torch.float64).sum() for k in (
        "n_steps", "numerical_error", "acceptance_rate", "trajectory_length",
        "step_size")])


def _keeping(target, rows, seen):
    """`target` whose value+grad also keeps (θ, ℓ, ∇) of the chains `rows`
    at each call, in `seen`."""
    value_and_grad = target.logdensity_and_grad

    def kept(theta):
        lp, grad = value_and_grad(theta)
        seen.append((theta[rows].clone(), lp[rows].clone(),
                     grad[rows].clone()))
        return lp, grad

    return dataclasses.replace(target, logdensity_and_grad=kept)


def check_step(ah, env, gen, dcarry, u) -> dict:
    """One draw iteration from `dcarry` at jitter `u` through
    `make_chees_draw_step`, with a value+grad that keeps what it saw for
    `CHECK_CHAINS` chains drawn from the seed: the start and every position
    of the trajectory, the state kept, ε, M⁻¹ and the step's statistics."""
    theta, lp, grad, metric, eps, _ = dcarry
    rows = torch.randperm(theta.shape[0], generator=torch.Generator()
                          .manual_seed(env.seed))[:CHECK_CHAINS]
    rows = rows.to(theta.device)
    seen = [(theta[rows].clone(), lp[rows].clone(), grad[rows].clone())]
    step = ah.make_chees_draw_step(_keeping(env.target, rows, seen),
                                   env.traffic["max_steps"])
    new, (_, st) = step(gen, dcarry, u)
    return {"theta": torch.stack([s[0] for s in seen]),
            "lp": torch.stack([s[1] for s in seen]),
            "grad": torch.stack([s[2] for s in seen]),
            "kept": tuple(a[rows] for a in new[:3]), "eps": float(eps),
            "m_inv": metric.m_inv.clone(),
            "accept": st["is_accept"][rows],
            "alpha": st["acceptance_rate"][rows],
            "energy": st["hamiltonian_energy"][rows]}


def run(env) -> dict:
    ah, t, dev, tracer = env.ah, env.traffic, env.device, env.tracer
    target, dim = env.target, env.dim
    c, m, n_warm, chunk = t["chains"], t["ess_chains"], t["n_warmup"], \
        t["chunk"]
    cfg = ah.AdaptorConfig(kind="stan", mm_kind="welford_var",
                           da=ah.DualAveragingConfig(delta=t["delta"]),
                           init_buffer=t["init_buffer"],
                           term_buffer=t["term_buffer"],
                           window_size=t["window_size"])
    flags = ah.adapt_flags(cfg, n_warm, n_warm)
    flag_rows = [{k: bool(v[i]) for k, v in flags.items()}
                 for i in range(n_warm)]
    u_warm = torch.as_tensor(halton(0, n_warm), dtype=torch.float32,
                             device=dev)
    step = ah.make_chees_step(target, cfg,
                              ah.CheesConfig(avg_start=n_warm // 2),
                              t["max_steps"])
    dstep = ah.make_chees_draw_step(target, t["max_steps"])
    theta0 = torch.as_tensor(
        INIT_SCALE * np.random.default_rng(WARMUP_SEED).normal(
            size=(c, dim)), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)

    def start():
        lp0, grad0 = target.logdensity_and_grad(theta0)
        metric = ah.DiagEuclideanMetric.create(
            1.0 / torch.clamp(grad0.abs().mean(0), 1e-3, 1e6))
        eps0 = ah.find_good_stepsize(
            gen, ah.Hamiltonian(metric=metric, target=target), theta0[0])
        lp0 = torch.where(torch.isfinite(lp0), lp0, float("-inf"))
        return (theta0, lp0, grad0, metric,
                ah.AdaptState.init(cfg, dim, eps0, torch.float32),
                ah.CheesState.init(t["t0"], torch.float32, device=dev))

    def draw(dcarry, i, buf, sums):
        with tracer.span("draw_iteration"):
            dcarry, (th, st) = dstep(gen, dcarry, u_draws[i])
        buf.copy_(th[:m])
        sums += _stat_sums(st)
        return dcarry

    # set-up: each distinct warmup step and the draw step once, on
    # throwaway state; the Halton points of the draws
    u_draws = torch.as_tensor(halton(n_warm, n_warm + MAX_DRAWS),
                              dtype=torch.float32, device=dev)
    gen.manual_seed(env.seed + 1)
    carry = start()
    seen = set()
    for i, row in enumerate(flag_rows):
        key = tuple(sorted(row.items()))
        if key not in seen:
            seen.add(key)
            carry, (_, st) = step(gen, carry, row, u_warm[i])
    scratch = torch.zeros(5, dtype=torch.float64, device=dev)
    draw(ah.chees.draw_carry(carry), 0,
         torch.empty((m, dim), device=dev), scratch)
    del carry, scratch, st

    gen.manual_seed(WARMUP_SEED)
    t0 = env.open_window()
    wsum = torch.zeros((), dtype=torch.float64, device=dev)
    with tracer.span("warmup"):
        carry = start()
        for i in range(n_warm):
            carry, (_, st) = step(gen, carry, flag_rows[i], u_warm[i])
            wsum += st["n_steps"].to(torch.float64).sum()
        env.sync()
    t_draws = time.perf_counter()
    gen.manual_seed(env.seed)
    dcarry = ah.chees.draw_carry(carry)
    t_final = float(torch.exp(carry[5].log_t_avg))
    del carry, st
    blocks, sums, i = [], torch.zeros(5, dtype=torch.float64,
                                      device=dev), 0
    while True:
        if i + chunk > MAX_DRAWS:
            raise RuntimeError(f"more than {MAX_DRAWS} "
                               "draw iterations in the window")
        buf = torch.empty((chunk, m, dim), device=dev)
        for j in range(chunk):
            dcarry = draw(dcarry, i + j, buf[j], sums)
        blocks.append(buf)
        i += chunk
        env.sync()
        if (len(blocks) >= MIN_CHUNKS
                and time.perf_counter() - t0 >= env.seconds):
            break
    t1 = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated() if dev != "cpu" else 0)
    final = dcarry[:3]

    holder = [dcarry, i]
    scratch = torch.zeros(5, dtype=torch.float64, device=dev)
    row = torch.empty((m, dim), device=dev)

    def stretch():
        for _ in range(STRETCH_ITERATIONS):
            holder[0] = draw(holder[0], holder[1], row, scratch)
            holder[1] += 1
        env.sync()

    tracer.stretches(stretch)
    eps = float(dcarry[4])
    # the next draw iteration whose jitter is at least ½, so that the
    # followed trajectory has several steps
    k = holder[1]
    while float(u_draws[k]) < 0.5:
        k += 1
    step_rec = check_step(ah, env, gen, holder[0], u_draws[k])
    del holder, dcarry

    n_draws = i * c
    steps, divs, acc, tau, _ = sums.tolist()
    return {
        "setup_s": env.setup_s, "window_s": t1 - t0,
        "warmup_s": t_draws - t0, "draws": n_draws, "calls": len(blocks),
        "ess_blocks": blocks, "ess_scale": c / m, "final": final,
        "check_step": step_rec, "memory_peak_bytes": peak,
        "useful_steps": float(wsum) + steps,
        "stretch_unprofiled_s": (t1 - t_draws) / i
        * STRETCH_ITERATIONS,
        "info": {"eps": eps, "t_final": t_final,
                 "warmup_steps": float(wsum), "accept": acc / n_draws,
                 "divergence_rate": divs / n_draws,
                 "mean_traj_len": tau / n_draws,
                 "steps_per_draw": steps / n_draws},
    }

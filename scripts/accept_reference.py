#!/usr/bin/env python3
"""The draws' acceptance rate that Stan's dual averaging leaves in
`chip_smoke.py` phase 15a's configuration, from the JAX package and from
the port, both on the CPU.

Phase 15a is the JAX bench's nutpie run (`AHMC_BENCH_MM_KIND=nutpie
AHMC_BENCH_WARMUP=256`): the 100-D hierarchical logistic (n = 1000, p =
99, float32), NUTS (multinomial, generalised no-U-turn, max_depth 6,
diagonal metric), cross-chain Stan adaptation with the nutpie estimator
step by step (δ 0.55, κ 0.8, buffers 75/50/25, gradient-seeded M⁻¹, 256
iterations: windows end at 100 and 206), then draws. Here a small pool
(`--chains`, 64 by default) warms and draws, from 0.1·N(0, 1) starting
points made with numpy; the finalised ε = exp(x̄) of dual averaging is
what sets the draws' acceptance, and it sits above δ. The JAX run takes
about 40 s a seed on 8 CPU cores, the port's about 100 s.

    JAX_PLATFORMS=cpu python scripts/accept_reference.py [--chains 64]
        [--draws 32] [--seeds 1 2] [--config nutpie|relativistic]

`--config relativistic` runs `chip_smoke.py` phase 18a's configuration
instead: phase 3's (the Welford variance, 128 warmup iterations in fused
cross-chain blocks of 8 on the leaf-pair body, then fused draws) with
`SampleSpec(kinetic=RelativisticKinetic(m=1, c=2))`, driven through
`init_state`, `fused_warmup_phase_crosschain` and `fused_draw_phase` in
both packages, on the whole pool (no fan-out).

Prints one line a run (package, seed, acceptance, final ε) and last one
JSON object with all of them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DELTA, KAPPA, WARMUP, DIM = 0.55, 0.8, 256, 100


def run_jax(chains, draws, seed, th0):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import advancedhmc_tpu as aj
    from advancedhmc_tpu.adaptation import DualAveragingConfig
    from advancedhmc_tpu.models.logistic import hierarchical_logistic

    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.05, jnp.float32)),
        aj.GeneralisedNoUTurn(max_depth=6), "multinomial"))
    adaptor = aj.AdaptorConfig(
        kind="stan", mm_kind="nutpie",
        da=DualAveragingConfig(delta=DELTA, kappa=KAPPA))
    res = aj.sample(
        jax.random.PRNGKey(seed), hierarchical_logistic(n=1000, p=DIM - 1),
        kernel, aj.make_metric("diagonal", DIM), jnp.asarray(th0, jnp.float32),
        WARMUP + draws, n_adapts=WARMUP, adaptor=adaptor,
        init_mass_matrix="gradient", cross_chain=True, drop_warmup=True)
    return (float(np.asarray(res.stats["acceptance_rate"]).mean()),
            float(np.asarray(res.final_state.adapt.da.eps)))


def run_port(chains, draws, seed, th0):
    import torch

    import advancedhmc_torch as ah

    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.05)),
        ah.GeneralisedNoUTurn(max_depth=6)))
    adaptor = ah.AdaptorConfig(
        kind="stan", mm_kind="nutpie",
        da=ah.DualAveragingConfig(delta=DELTA, kappa=KAPPA))
    res = ah.sample(
        torch.Generator().manual_seed(seed),
        ah.hierarchical_logistic(n=1000, p=DIM - 1, device="cpu"), kernel,
        ah.make_metric("diagonal", DIM, device="cpu"),
        torch.as_tensor(th0, dtype=torch.float32), WARMUP + draws,
        n_adapts=WARMUP, adaptor=adaptor, init_mass_matrix="gradient",
        cross_chain=True, drop_warmup=True, device="cpu")
    return (float(res.stats["acceptance_rate"].mean()),
            float(res.final_state.adapt.da.eps))


REL_WARMUP, REL_BLOCK = 128, 8


def run_jax_relativistic(chains, draws, seed, th0):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import advancedhmc_tpu as aj
    from advancedhmc_tpu.adaptation import DualAveragingConfig
    from advancedhmc_tpu.kinetic import RelativisticKinetic
    from advancedhmc_tpu.models.logistic import hierarchical_logistic
    from advancedhmc_tpu.riemannian.relativistic import _magnitude_table
    from advancedhmc_tpu.sampler import SampleSpec, fused_draw_phase, \
        fused_warmup_phase_crosschain

    # the JAX package caches the magnitude table on its first use; built
    # first inside a traced function (init_state's step-size search), the
    # cached arrays would be that trace's tracers, so build it eagerly
    _magnitude_table(1.0, 2.0, DIM)

    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.05, jnp.float32)),
        aj.GeneralisedNoUTurn(max_depth=6), "multinomial"))
    spec = SampleSpec(
        target=hierarchical_logistic(n=1000, p=DIM - 1), kernel=kernel,
        adaptor=aj.AdaptorConfig(kind="stan", da=DualAveragingConfig(
            delta=DELTA, kappa=KAPPA)),
        cross_chain=True, kinetic=RelativisticKinetic(m=1.0, c=2.0))
    state = aj.init_state(jax.random.PRNGKey(seed), spec,
                          aj.make_metric("diagonal", DIM),
                          jnp.asarray(th0, jnp.float32),
                          init_mass_matrix="gradient")
    state, _, _ = fused_warmup_phase_crosschain(spec, state, REL_WARMUP,
                                                REL_BLOCK, pair=True)
    state, _, stats = fused_draw_phase(spec, state, draws, REL_BLOCK,
                                       pair=True)
    return (float(np.asarray(stats["acceptance_rate"]).mean()),
            float(np.asarray(state.adapt.da.eps)))


def run_port_relativistic(chains, draws, seed, th0):
    import torch

    import advancedhmc_torch as ah

    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.05)),
        ah.GeneralisedNoUTurn(max_depth=6)))
    spec = ah.SampleSpec(
        target=ah.hierarchical_logistic(n=1000, p=DIM - 1, device="cpu"),
        kernel=kernel, adaptor=ah.AdaptorConfig(
            kind="stan", da=ah.DualAveragingConfig(delta=DELTA,
                                                   kappa=KAPPA)),
        cross_chain=True, kinetic=ah.RelativisticKinetic(m=1.0, c=2.0))
    gen = torch.Generator().manual_seed(seed)
    state = ah.init_state(gen, spec, ah.make_metric("diagonal", DIM,
                                                    device="cpu"),
                          torch.as_tensor(th0, dtype=torch.float32),
                          init_mass_matrix="gradient", device="cpu")
    state, _, _ = ah.fused_warmup_phase_crosschain(gen, spec, state,
                                                   REL_WARMUP, REL_BLOCK,
                                                   pair=True)
    state, _, stats = ah.fused_draw_phase(gen, spec, state, draws,
                                          REL_BLOCK, pair=True)
    return (float(stats["acceptance_rate"].mean()),
            float(state.adapt.da.eps))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--draws", type=int, default=32)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--config", choices=("nutpie", "relativistic"),
                    default="nutpie")
    args = ap.parse_args()
    runs = []
    fns = ((("jax", run_jax), ("port", run_port)) if args.config == "nutpie"
           else (("jax", run_jax_relativistic),
                 ("port", run_port_relativistic)))
    for package, fn in fns:
        for seed in args.seeds:
            th0 = 0.1 * np.random.default_rng(seed).normal(
                size=(args.chains, DIM))
            t0 = time.perf_counter()
            accept, eps = fn(args.chains, args.draws, seed, th0)
            runs.append({"package": package, "seed": seed, "accept": accept,
                         "eps": eps, "s": time.perf_counter() - t0})
            print(f"{package} seed {seed}: accept {accept:.4f} (δ {DELTA}), "
                  f"final eps {eps:.5f}", flush=True)
    print(json.dumps({"config": args.config, "chains": args.chains,
                      "draws": args.draws,
                      "delta": DELTA, "runs": runs}))


if __name__ == "__main__":
    main()

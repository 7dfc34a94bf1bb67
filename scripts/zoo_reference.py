#!/usr/bin/env python3
"""The posterior moments that `chip_smoke.py` phase 16d holds the port's
German-credit run to, from the JAX package on the CPU.

Phase 16d runs `NUTS(0.8, max_depth=4).sample(...)` on
`german_credit_logistic()` (the hierarchical logistic at 1000 rows × 24
features, 25 parameters) step by step on 256 chains: per-chain Stan
adaptation (the window schedule of a 40-iteration warmup), 40 warmup
iterations and 40 draws, from 0.1·N(0, 1) starting points made with
numpy. This script runs the same configuration through JAX
`NUTS(...).sample` in float64, one run a seed, and prints each run's mean
log σ, sd log σ and |mean β| with their Monte Carlo standard errors (from
the bulk ESS), then one JSON object with all of them. Under a minute a
seed on 8 CPU cores.

    JAX_PLATFORMS=cpu python scripts/zoo_reference.py [--chains 256]
        [--seeds 0 1 2 3]
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

WARMUP, DRAWS, DELTA, MAX_DEPTH, DIM = 40, 40, 0.8, 4, 25


def moments(th, ess):
    """(mean log σ, sd log σ, |mean β|) of draws (n, C, dim) and their
    MCSEs: sd/√ESS for the mean, the delta method for the sd (the ESS of
    log σ), and the norm's through its gradient at the mean."""
    ls = th[:, :, 0].ravel()
    beta = th[:, :, 1:].reshape(-1, DIM - 1)
    mean_b = beta.mean(0)
    norm = float(np.linalg.norm(mean_b))
    se_b = beta.std(0) / np.sqrt(ess[1:])
    return {
        "mean_logsigma": float(ls.mean()),
        "mean_logsigma_mcse": float(ls.std() / np.sqrt(ess[0])),
        "sd_logsigma": float(ls.std()),
        "sd_logsigma_mcse": float(ls.std() / np.sqrt(2 * ess[0])),
        "mean_beta_norm": norm,
        "mean_beta_norm_mcse": float(np.sqrt(np.sum((mean_b / norm * se_b)
                                                    ** 2))),
    }


def run(chains, seed):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import advancedhmc_tpu as aj
    from advancedhmc_tpu.diagnostics import effective_sample_size
    from advancedhmc_tpu.models import german_credit_logistic

    th0 = 0.1 * np.random.default_rng(seed).normal(size=(chains, DIM))
    t0 = time.time()
    res = aj.NUTS(DELTA, max_depth=MAX_DEPTH).sample(
        jax.random.PRNGKey(seed), german_credit_logistic(jnp.float64),
        jnp.asarray(th0), WARMUP + DRAWS, n_adapts=WARMUP,
        dtype=jnp.float64, drop_warmup=True)
    th = np.asarray(res.thetas)
    ess = np.asarray(effective_sample_size(jnp.asarray(th)))
    out = moments(th, ess)
    out.update(seed=seed, chains=chains, seconds=round(time.time() - t0, 1),
               accept=float(np.mean(np.asarray(
                   res.stats["acceptance_rate"]))),
               divergence=float(np.mean(np.asarray(
                   res.stats["numerical_error"]))))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    runs = []
    for seed in args.seeds:
        runs.append(run(args.chains, seed))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"german_credit_reference": runs}))


if __name__ == "__main__":
    main()

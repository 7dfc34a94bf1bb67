#!/usr/bin/env python3
"""The JAX package's posterior of the 1000-D hierarchical logistic, the
reference that `chip_smoke.py` phase 9 holds the port's card run against.

Runs JAX `sample` on the CPU with phase 9's settings: `hierarchical_logistic
(n=1000, p=999)` in float64, NUTS (multinomial, generalised no-U-turn,
max_depth 6, diagonal metric, single-leaf loop), Stan cross-chain warmup
(δ 0.55, κ 0.8, buffers 75/50/25, gradient-seeded M⁻¹, 128 iterations fused
in blocks of 8, the whole batch warmed), then draws fused 16 a call, from
0.1·N(0, 1) starting points made with numpy. The chains and draws default
to phase 9's 1024 and 64 (one seed takes about 16 minutes on 8 CPU
cores); under cross-chain adaptation the pool's size changes the warmup,
so the reference is taken at phase 9's own chain count.

    JAX_PLATFORMS=cpu python scripts/wide_reference.py [--chains 1024]
        [--draws 64] [--seeds 0 1 2 3]

At this configuration the draws do not reach stationarity: log σ's
autocorrelation time is longer than the draw phase (its pooled ESS is
~600 over 1024 chains × 64 draws), and |mean β| moves between the first
and the second half of the draws by far more than its MCSE. The moments of a run
then depend on where the warmup left it, and every chain of a run shares
that warmup's ε and M⁻¹ (cross-chain adaptation), so runs with different
seeds differ by more than their MCSEs. The script therefore runs each seed
and reports, per run and over the runs: the three moments phase 9 gates on
(mean log σ, sd log σ, |mean β| over all draws and chains), each with its
MCSE from the pooled bulk ESS (mean: sd/√ESS; sd: sd/√(2·ESS); |mean β|:
the delta method over the β means); the same moments over the first and
the second half of the draws; the acceptance and divergence rates, the mean
tree depth and the final ε. Over the runs: the mean of each moment, its
MCSE (the runs' MCSEs combined, over √runs) and the standard deviation
between runs. Last, one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def moments(th, ess_fn):
    """(mean log σ, sd log σ, |mean β|) of draws `th` (n, C, dim), and their
    Monte Carlo standard errors from the pooled bulk ESS `ess_fn(th)`."""
    ess = np.asarray(ess_fn(th))
    ls = th[:, :, 0]
    beta_mean = th[:, :, 1:].mean((0, 1))
    beta_sd = th[:, :, 1:].std((0, 1))
    norm = float(np.linalg.norm(beta_mean))
    out = {"mean_logsigma": float(ls.mean()),
           "sd_logsigma": float(ls.std()),
           "mean_beta_norm": norm}
    se_mean_b = beta_sd / np.sqrt(ess[1:])
    mcse = {"mean_logsigma": float(ls.std() / np.sqrt(ess[0])),
            "sd_logsigma": float(ls.std() / np.sqrt(2 * ess[0])),
            # d|m|/dm_i = m_i/|m|
            "mean_beta_norm": float(np.sqrt(np.sum(
                (beta_mean / norm) ** 2 * se_mean_b ** 2)))}
    return out, mcse, float(ess[0]), float(np.median(ess))


def run(seed, chains, draws):
    """One JAX run at `seed`: its moments, MCSEs and statistics."""
    import jax
    import jax.numpy as jnp

    import advancedhmc_tpu as aj
    from advancedhmc_tpu.adaptation import AdaptorConfig, DualAveragingConfig
    from advancedhmc_tpu.diagnostics import effective_sample_size
    from advancedhmc_tpu.models.logistic import hierarchical_logistic

    n_rows, p, warmup, block, fuse, max_depth = 1000, 999, 128, 8, 16, 6
    dim = p + 1
    target = hierarchical_logistic(n=n_rows, p=p, dtype=jnp.float64)
    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.05)),
        aj.GeneralisedNoUTurn(max_depth=max_depth), "multinomial"))
    adaptor = AdaptorConfig(kind="stan", da=DualAveragingConfig(
        delta=0.55, kappa=0.8), init_buffer=75, term_buffer=50,
        window_size=25)
    theta0 = 0.1 * np.random.default_rng(seed).normal(size=(chains, dim))
    t0 = time.perf_counter()
    res = aj.sample(
        jax.random.PRNGKey(seed), target, kernel,
        aj.make_metric("diagonal", dim, dtype=jnp.float64),
        jnp.asarray(theta0), warmup + draws, n_adapts=warmup,
        adaptor=adaptor, init_mass_matrix="gradient", cross_chain=True,
        fuse_draws=fuse, fuse_warmup=True, fuse_warmup_block=block,
        drop_warmup=True)
    th = np.asarray(res.thetas)
    wall = time.perf_counter() - t0
    st = {k: np.asarray(v) for k, v in res.stats.items()}

    def ess_fn(x):
        return effective_sample_size(jnp.asarray(x))

    out, mcse, ess_ls, ess_median = moments(th, ess_fn)
    half = draws // 2
    first, _, _, _ = moments(th[:half], ess_fn)
    second, _, _, _ = moments(th[half:], ess_fn)
    result = {
        "seed": seed, **out, "mcse": mcse,
        "first_half": first, "second_half": second,
        "ess_logsigma": ess_ls, "ess_median": ess_median,
        "accept_mean": float(st["acceptance_rate"].mean()),
        "divergence_rate": float(st["numerical_error"].mean()),
        "mean_tree_depth": float(st["tree_depth"].mean()),
        "step_size": float(res.final_state.adapt.da.eps),
        "wall_s": wall,
    }
    for k in KEYS:
        print(f"# seed {seed} {k}: {out[k]:.6f} ± {mcse[k]:.6f} (MCSE); "
              f"halves {first[k]:.6f}, {second[k]:.6f}", flush=True)
    print(f"# seed {seed}: accept {result['accept_mean']:.4f}, divergence "
          f"{result['divergence_rate']:.5f}, mean depth "
          f"{result['mean_tree_depth']:.3f}, eps {result['step_size']:.5f}, "
          f"ESS log σ {ess_ls:.0f}, median ESS {ess_median:.0f}, wall "
          f"{wall:.1f} s", flush=True)
    return result


KEYS = ("mean_logsigma", "sd_logsigma", "mean_beta_norm")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--draws", type=int, default=64)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    runs = [run(seed, args.chains, args.draws) for seed in args.seeds]
    over = {}
    for k in KEYS:
        vals = np.array([r[k] for r in runs])
        ses = np.array([r["mcse"][k] for r in runs])
        over[k] = {"mean": float(vals.mean()),
                   "mcse": float(np.sqrt(np.mean(ses ** 2) / len(runs))),
                   "sd_between_runs": float(vals.std(ddof=1))
                   if len(runs) > 1 else None}
        print(f"# over {len(runs)} runs {k}: {over[k]['mean']:.6f} ± "
              f"{over[k]['mcse']:.6f} (MCSE), sd between runs "
              f"{over[k]['sd_between_runs']}")
    accept = float(np.mean([r["accept_mean"] for r in runs]))
    print(f"# over {len(runs)} runs: accept {accept:.4f}")
    print(json.dumps({
        "command": f"JAX_PLATFORMS=cpu python scripts/wide_reference.py "
                   f"--chains {args.chains} --draws {args.draws} --seeds "
                   + " ".join(str(s) for s in args.seeds),
        "chains": args.chains, "draws": args.draws, "over_runs": over,
        "accept_mean": accept, "runs": runs,
        "device": jax.devices()[0].device_kind}))


if __name__ == "__main__":
    main()

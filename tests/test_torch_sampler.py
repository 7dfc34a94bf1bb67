"""The slice as a whole: the port's `sample()` against the JAX package's.

Both packages run the main path's configuration at a small size: cross-chain
Stan warmup with gradient-seeded M⁻¹ on a 64-chain pool fanned out to 128
chains, fused warmup blocks and fused draws, NUTS (multinomial, generalised
no-U-turn) on a 10-D hierarchical logistic over 200 rows. Their random
streams differ, so they are compared in distribution. The last test starts
the port from the JAX package's final state, carried over by `convert`.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu.adaptation import AdaptorConfig as AdaptorConfigJ
from advancedhmc_tpu.adaptation import DualAveragingConfig as DAConfigJ
from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)

import advancedhmc_torch as ah
from advancedhmc_torch import convert
from advancedhmc_torch.diagnostics import effective_sample_size

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
N, P = 200, 9
DIM = P + 1
CHAINS, POOL, WARMUP, DRAWS, FUSE = 128, 64, 64, 64, 8
BLOCK, DECOR = 4, 16
# δ 0.8 rather than the bench's 0.55: at this size and warmup length the
# δ 0.55 dual averaging of both packages overshoots into ε that accept
# nothing. Warmup blocks of 4 and the term buffer leave eight dual-averaging
# updates after the one Stan window, so the final ε is settled enough to
# compare.
DELTA = 0.8
BUFFERS = dict(init_buffer=16, term_buffer=32, window_size=16)
# Two independent runs: a difference of means (sds) within this many
# combined Monte Carlo standard errors, over ten dimensions. The MCSE comes
# from the pooled ESS of 64 draws per chain of a fanned-out pool, which
# overstates the independence of cloned chains, so the bound is wide.
K_MCSE = 5.0


def _theta0():
    return 0.1 * np.random.default_rng(0).normal(size=(CHAINS, DIM))


def _jax_sample():
    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.05)),
        aj.GeneralisedNoUTurn(max_depth=6), "multinomial"))
    adaptor = AdaptorConfigJ(kind="stan", da=DAConfigJ(delta=DELTA,
                                                       kappa=0.8), **BUFFERS)
    res = aj.sample(
        jax.random.PRNGKey(0), jax_logistic(n=N, p=P, dtype=jnp.float64),
        kernel, aj.make_metric("diagonal", DIM, dtype=jnp.float64),
        jnp.asarray(_theta0()), WARMUP + DRAWS, n_adapts=WARMUP,
        adaptor=adaptor, init_mass_matrix="gradient", cross_chain=True,
        fuse_draws=FUSE, fuse_warmup=True, fuse_warmup_block=BLOCK,
        drop_warmup=True, warmup_chains=POOL, fanout_decorrelate=DECOR)
    return res


@pytest.fixture(scope="module")
def jax_run():
    return _jax_sample()


def _port_spec():
    target = ah.hierarchical_logistic(n=N, p=P, dtype=torch.float64,
                                      device="cpu")
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.05, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=6)))
    adaptor = ah.AdaptorConfig(kind="stan", da=ah.DualAveragingConfig(
        delta=DELTA, kappa=0.8), **BUFFERS)
    return target, kernel, adaptor


def _assert_same_law(th_t, th_j, what):
    """Per-dimension mean and sd agree within K_MCSE combined MCSEs."""
    th_t, th_j = np.asarray(th_t), np.asarray(th_j)
    mcse = []
    for th in (th_t, th_j):
        ess = effective_sample_size(torch.as_tensor(np.array(th))).numpy()
        sd = th.std((0, 1))
        mcse.append((sd / np.sqrt(ess), sd / np.sqrt(2 * ess)))
    se_mean = np.hypot(mcse[0][0], mcse[1][0])
    se_sd = np.hypot(mcse[0][1], mcse[1][1])
    d_mean = np.abs(th_t.mean((0, 1)) - th_j.mean((0, 1)))
    d_sd = np.abs(th_t.std((0, 1)) - th_j.std((0, 1)))
    assert np.all(d_mean <= K_MCSE * se_mean), (what, d_mean / se_mean)
    assert np.all(d_sd <= K_MCSE * se_sd), (what, d_sd / se_sd)


def test_sample_matches_jax_in_distribution(jax_run):
    target, kernel, adaptor = _port_spec()
    res = ah.sample(
        torch.Generator().manual_seed(0), target, kernel,
        ah.make_metric("diagonal", DIM, dtype=torch.float64, device="cpu"),
        _theta0(), WARMUP + DRAWS, n_adapts=WARMUP, adaptor=adaptor,
        init_mass_matrix="gradient", cross_chain=True, fuse_draws=FUSE,
        fuse_warmup=True, fuse_warmup_block=BLOCK, drop_warmup=True,
        warmup_chains=POOL, fanout_decorrelate=DECOR, device="cpu")
    assert res.thetas.shape == (DRAWS, CHAINS, DIM)
    assert torch.isfinite(res.thetas).all()
    for k in ("acceptance_rate", "n_steps", "tree_depth", "numerical_error"):
        assert res.stats[k].shape == (DRAWS, CHAINS)
    _assert_same_law(res.thetas.numpy(), jax_run.thetas, "sample")
    acc_t = float(res.stats["acceptance_rate"].mean())
    acc_j = float(np.mean(jax_run.stats["acceptance_rate"]))
    assert abs(acc_t - acc_j) <= 0.05, (acc_t, acc_j)
    eps_t = float(res.final_state.adapt.da.eps)
    eps_j = float(jax_run.final_state.adapt.da.eps)
    assert abs(eps_t / eps_j - 1) <= 0.25, (eps_t, eps_j)
    assert not bool(res.stats["numerical_error"].any())
    assert not bool(np.any(jax_run.stats["numerical_error"]))
    assert set(res.timings) == {"init_s", "warmup_s", "draws_s"}


def test_draws_from_a_jax_warmed_state(jax_run):
    """`convert.hmc_state` carries the JAX package's final state (positions
    with their caches, ε, M⁻¹, dual-averaging and Welford state) into the
    port, whose draws from it follow the JAX draws' law at the same ε."""
    state = convert.hmc_state(jax_run.final_state, device="cpu")
    fs = jax_run.final_state
    assert torch.equal(state.z.theta, torch.as_tensor(np.array(fs.z.theta)))
    assert float(state.adapt.da.eps) == float(fs.adapt.da.eps)
    assert torch.equal(state.metric.m_inv,
                       torch.as_tensor(np.array(fs.metric.m_inv)))
    assert int(state.adapt.mm.n) == int(fs.adapt.mm.n)
    target, kernel, adaptor = _port_spec()
    spec = ah.SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                         cross_chain=True)
    out, thetas, stats = ah.fused_draw_phase(
        torch.Generator().manual_seed(1), spec, state, DRAWS, FUSE)
    assert thetas.shape == (DRAWS, CHAINS, DIM)
    assert out.iteration == state.iteration + DRAWS
    _assert_same_law(thetas.numpy(), jax_run.thetas, "from JAX state")
    acc_t = float(stats["acceptance_rate"].mean())
    acc_j = float(np.mean(jax_run.stats["acceptance_rate"]))
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)
    depth_t = float(stats["tree_depth"].double().mean())
    depth_j = float(np.mean(jax_run.stats["tree_depth"]))
    assert abs(depth_t - depth_j) <= 0.15, (depth_t, depth_j)


def test_import_leaves_jax_out():
    code = ("import sys, advancedhmc_torch; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'advancedhmc_tpu')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_jax_import_in_port_sources():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|advancedhmc_tpu)\b", re.M)
    files = sorted((ROOT / "advancedhmc_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        assert not pattern.search(f.read_text()), f

"""The classic and strict no-U-turn criteria and the slice sampler through
`sample()`, the port's and the JAX package's, on a 5-D correlated Gaussian
(256 chains, 100 warmup iterations and 100 draws) against the analytic
moments: on the fused path (cross-chain warmup in blocks, fused draws on
the pair body), on the step path and with bfloat16 stacks; and the
per-chain fused warmup and the depth-capped warmup run them.
`test_torch_criteria.py` holds the transitions themselves.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu.models import correlated_gaussian as correlated_gaussian_j

import advancedhmc_torch as ah

torch.set_num_threads(2)

CRITERIA = {"classic": ah.ClassicNoUTurn,
            "generalised": ah.GeneralisedNoUTurn,
            "strict": ah.StrictGeneralisedNoUTurn}
CRITERIA_J = {"classic": aj.ClassicNoUTurn,
              "generalised": aj.GeneralisedNoUTurn,
              "strict": aj.StrictGeneralisedNoUTurn}

DG, CG, N_ADAPT, N_DRAW = 5, 256, 100, 100
RHO = 0.8
# analytic: mean 0, variances 1, covariances ρ. Over 256 × 100 draws the
# Monte Carlo error of a mean is ≲ 0.015 and of a covariance ≲ 0.02, so
# these bounds are 4–5 of them; the two packages' mean acceptances must
# agree within 0.06 (0.8 ± the dual averaging's spread over 100 warmup
# iterations)
TOL_MEAN, TOL_COV, TOL_ACCEPT = 0.06, 0.1, 0.06
STEP_N = 60
FUSED = dict(cross_chain=True, fuse_warmup=True, fuse_warmup_block=4,
             fuse_draws=20, fuse_pair=True)


def _adaptor(pkg):
    return pkg.AdaptorConfig(kind="stan", init_buffer=30, term_buffer=20,
                             window_size=10)


def _theta0():
    return 0.3 * np.random.default_rng(1).normal(size=(CG, DG))


def _port_sample(crit, ts, stack_dtype=None, n=N_ADAPT, **kw):
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.3, dtype=torch.float64)),
        CRITERIA[crit](max_depth=6), ts, stack_dtype=stack_dtype))
    res = ah.sample(torch.Generator().manual_seed(0),
                    ah.correlated_gaussian(DG, RHO, torch.float64, "cpu"),
                    kernel, ah.make_metric("diagonal", DG, torch.float64,
                                           device="cpu"),
                    _theta0(), 2 * n, n_adapts=n, adaptor=_adaptor(ah),
                    init_eps=0.3, drop_warmup=True, device="cpu", **kw)
    return res.thetas.numpy(), float(res.stats["acceptance_rate"].mean())


def _jax_sample(crit, ts, n=N_ADAPT, **kw):
    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.3, jnp.float64)),
        CRITERIA_J[crit](max_depth=6), ts))
    res = aj.sample(jax.random.PRNGKey(0), correlated_gaussian_j(DG, RHO),
                    kernel, aj.make_metric("diagonal", DG,
                                           dtype=jnp.float64),
                    jnp.asarray(_theta0()), 2 * n, n_adapts=n,
                    adaptor=_adaptor(aj), init_eps=0.3, drop_warmup=True,
                    **kw)
    return (np.asarray(res.thetas),
            float(np.mean(np.asarray(res.stats["acceptance_rate"]))))


def _check_law(th, n=N_DRAW):
    x = th.reshape(-1, DG)
    assert x.shape == (n * CG, DG) and np.isfinite(x).all()
    cov = (1 - RHO) * np.eye(DG) + RHO * np.ones((DG, DG))
    np.testing.assert_allclose(x.mean(0), 0.0, atol=TOL_MEAN)
    np.testing.assert_allclose(np.cov(x.T), cov, atol=TOL_COV)


@pytest.mark.parametrize("crit,ts,path", [
    ("strict", "slice", "fused"),
    ("classic", "multinomial", "fused"),
    ("classic", "slice", "step"),
])
def test_sample_matches_jax_in_distribution(crit, ts, path):
    """Fused: the cross-chain warmup in blocks of 4 and the fused draws on
    the pair body; step: per-chain adaptation, one transition a step, 60
    warmup iterations and 60 draws (the port's step loop costs 2-3 ms a
    leaf on the CPU, the slowest of the 256 trees setting each step)."""
    kw = FUSED if path == "fused" else dict(n=STEP_N)
    (th_t, acc_t), (th_j, acc_j) = (_port_sample(crit, ts, **kw),
                                    _jax_sample(crit, ts, **kw))
    _check_law(th_t, kw.get("n", N_DRAW))
    _check_law(th_j, kw.get("n", N_DRAW))
    assert abs(acc_t - acc_j) <= TOL_ACCEPT, (acc_t, acc_j)


@pytest.mark.parametrize("crit", ["classic", "strict"])
def test_bfloat16_stacks_keep_the_law(crit):
    """Every stack the criterion carries in bfloat16 (θ for classic, the
    odd-leaf r and the cumulative sums for strict): the U-turn decisions
    move, the invariant law does not."""
    th, acc = _port_sample(crit, "multinomial", stack_dtype="bfloat16",
                           **FUSED)
    _check_law(th)
    assert abs(acc - 0.8) <= 0.1


@pytest.mark.parametrize("crit,ts", [("strict", "slice"),
                                     ("classic", "multinomial")])
def test_per_chain_fused_and_capped_warmups_run(crit, ts):
    """The per-chain fused warmup (adaptation inside the loop, the level
    redrawn at each boundary) and the cross-chain depth-capped warmup run
    the new criteria: finite draws, per-chain ε, acceptance near δ."""
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.3, dtype=torch.float64)),
        CRITERIA[crit](max_depth=5), ts))
    common = dict(n_adapts=60, adaptor=_adaptor(ah), init_eps=0.3,
                  drop_warmup=True, device="cpu")
    target = ah.correlated_gaussian(DG, RHO, torch.float64, "cpu")
    metric = ah.make_metric("diagonal", DG, torch.float64, device="cpu")
    per_chain = ah.sample(torch.Generator().manual_seed(2), target, kernel,
                          metric, _theta0()[:32], 100, fuse_warmup=True,
                          fuse_draws=20, **common)
    capped = ah.sample(torch.Generator().manual_seed(3), target, kernel,
                       metric, _theta0()[:32], 100, cross_chain=True,
                       fuse_warmup=True, fuse_warmup_block=4, fuse_draws=20,
                       warmup_depth_cap=3, **common)
    assert per_chain.final_state.adapt.da.eps.shape == (32,)
    for res in (per_chain, capped):
        assert res.thetas.shape == (40, 32, DG)
        assert bool(torch.isfinite(res.thetas).all())
        assert abs(float(res.stats["acceptance_rate"].mean()) - 0.8) <= 0.15



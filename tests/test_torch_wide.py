"""The 1000-D slice on the CPU: K1's plain version at p = 999 against the
JAX package, and `sample()` past the narrow kernel's width.

K1's wide path (p > 128) runs only on the card; its prepared layout and its
order of work are modelled in tests/test_torch_k1_wgmma.py. Here:

* the plain version at p = 999 against the JAX model in float64 and the
  Pallas kernel in interpret mode;
* the slice as a whole: the port's `sample()` on a 151-D hierarchical
  logistic against the JAX package's, in distribution.
"""

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
from advancedhmc_tpu.ops.fused_logistic import (
    fused_logistic_value_grad as jax_fused,
)

import advancedhmc_torch as ah
from advancedhmc_torch.diagnostics import effective_sample_size
from advancedhmc_torch.models.logistic import _prior, _synthetic_data
from advancedhmc_torch.ops import fused_logistic as k1

torch.set_num_threads(2)

# --- the plain version at p = 999 against the JAX package --------------
N_WIDE, P_WIDE = 1000, 999


@pytest.fixture(scope="module")
def wide_inputs():
    x, y = _synthetic_data(N_WIDE, P_WIDE)
    th = 0.05 * np.random.default_rng(9).normal(size=(12, P_WIDE + 1))
    return x, y, th


def test_plain_k1_at_p999_matches_jax_model_float64(wide_inputs):
    """The plain K1 plus the model's prior, in float64, against the JAX
    model's float64 value and gradient, to 1e-10 of the largest magnitude."""
    x, y, th = wide_inputs
    tj = jax_logistic(n=N_WIDE, p=P_WIDE, dtype=jnp.float64)
    lp_j, g_j = jax.vmap(tj.logdensity_and_grad)(jnp.asarray(th))
    tt = torch.as_tensor(th)
    lp_l, g_l = k1.plain_logistic_value_grad(tt, torch.as_tensor(x),
                                             torch.as_tensor(y))
    lp_p, g_p = _prior(tt, P_WIDE)
    lp_t, g_t = (lp_l + lp_p).numpy(), (g_l + g_p).numpy()
    lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    assert np.abs(lp_t - lp_j).max() <= 1e-10 * np.abs(lp_j).max()
    assert np.abs(g_t - g_j).max() <= 1e-10 * np.abs(g_j).max()


def test_plain_k1_at_p999_matches_pallas_interpret(wide_inputs):
    """The plain version in float32 against the Pallas kernel in interpret
    mode at p = 999, at the JAX test's bf16-input tolerance
    (tests/test_pallas_ops.py): lp to 3e-3 relative, the gradient to 1 % of
    its largest magnitude; component 0 is 0 in both."""
    x, y, th = wide_inputs
    th = th.astype(np.float32)
    apply = jax_fused(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                      block_chains=8, interpret=True)
    lp_j, g_j = apply(jnp.asarray(th))
    lp_t, g_t = k1.logistic_value_grad(
        torch.as_tensor(th), torch.as_tensor(x, dtype=torch.float32),
        torch.as_tensor(y, dtype=torch.float32))
    assert lp_t.shape == (12,) and g_t.shape == (12, P_WIDE + 1)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=3e-3)
    scale = float(np.abs(np.asarray(g_j)).max())
    assert float(np.abs(g_t.numpy() - np.asarray(g_j)).max()) < 0.01 * scale
    assert np.all(g_t[:, 0].numpy() == 0.0)
    assert np.all(np.asarray(g_j)[:, 0] == 0.0)


# --- the slice as a whole ---------------------------------------------
# sample() on a 151-D hierarchical logistic over 200 rows, cross-chain fused
# warmup and fused draws, 16 chains; δ 0.8 and short Stan buffers as in
# tests/test_torch_sampler.py (at this size the δ 0.55 dual averaging of
# both packages overshoots).
N_S, P_S, CHAINS_S = 200, 150, 16
WARMUP_S, DRAWS_S, FUSE_S, BLOCK_S = 64, 48, 4, 4
DELTA_S = 0.8
BUFFERS_S = dict(init_buffer=16, term_buffer=32, window_size=16)
# two independent runs: a difference of means (sds) within this many
# combined Monte Carlo standard errors, over 151 dimensions (as
# tests/test_torch_sampler.py)
K_MCSE = 5.0


def _ess(th):
    return effective_sample_size(torch.as_tensor(np.array(th))).numpy()


def _mcse_mean_sd(th):
    """Per-dimension MCSE of the mean (sd/√ESS) and of the sd: the MCSE of
    the variance from the ESS of the squared deviations, over 2·sd. The
    β's marginals here are far from normal (they scale with σ), so the
    normal-theory sd/√(2·ESS) understates the sd's error: with it, two runs
    of the port with different seeds differ by up to 10 MCSEs."""
    sd = th.std((0, 1))
    dev2 = (th - th.mean((0, 1))) ** 2
    se_var = dev2.std((0, 1)) / np.sqrt(_ess(dev2))
    return sd / np.sqrt(_ess(th)), se_var / (2 * sd)


def _theta0_s():
    return 0.1 * np.random.default_rng(4).normal(size=(CHAINS_S, P_S + 1))


def _jax_slice():
    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.05)),
        aj.GeneralisedNoUTurn(max_depth=6), "multinomial"))
    adaptor = AdaptorConfigJ(kind="stan", da=DAConfigJ(delta=DELTA_S,
                                                       kappa=0.8), **BUFFERS_S)
    return aj.sample(
        jax.random.PRNGKey(0), jax_logistic(n=N_S, p=P_S, dtype=jnp.float64),
        kernel, aj.make_metric("diagonal", P_S + 1, dtype=jnp.float64),
        jnp.asarray(_theta0_s()), WARMUP_S + DRAWS_S, n_adapts=WARMUP_S,
        adaptor=adaptor, init_mass_matrix="gradient", cross_chain=True,
        fuse_draws=FUSE_S, fuse_warmup=True, fuse_warmup_block=BLOCK_S,
        drop_warmup=True)


@pytest.fixture(scope="module")
def jax_slice():
    return _jax_slice()


def _port_slice():
    target = ah.hierarchical_logistic(n=N_S, p=P_S, dtype=torch.float64,
                                      device="cpu")
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.05, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=6)))
    adaptor = ah.AdaptorConfig(kind="stan", da=ah.DualAveragingConfig(
        delta=DELTA_S, kappa=0.8), **BUFFERS_S)
    return ah.sample(
        torch.Generator().manual_seed(0), target, kernel,
        ah.make_metric("diagonal", P_S + 1, dtype=torch.float64,
                       device="cpu"),
        _theta0_s(), WARMUP_S + DRAWS_S, n_adapts=WARMUP_S, adaptor=adaptor,
        init_mass_matrix="gradient", cross_chain=True, fuse_draws=FUSE_S,
        fuse_warmup=True, fuse_warmup_block=BLOCK_S, drop_warmup=True,
        device="cpu")


def test_wide_slice_matches_jax_in_distribution(jax_slice):
    """The port's `sample()` at p = 150 (beyond the narrow kernel's width)
    on the CPU against the JAX package's: per-dimension mean and sd within
    K_MCSE combined MCSEs, acceptance within 0.05, no divergence."""
    res = _port_slice()
    th_t = res.thetas.numpy()
    th_j = np.asarray(jax_slice.thetas)
    assert th_t.shape == th_j.shape == (DRAWS_S, CHAINS_S, P_S + 1)
    assert np.all(np.isfinite(th_t))
    mcse = []
    for th in (th_t, th_j):
        mcse.append(_mcse_mean_sd(th))
    se_mean = np.hypot(mcse[0][0], mcse[1][0])
    se_sd = np.hypot(mcse[0][1], mcse[1][1])
    d_mean = np.abs(th_t.mean((0, 1)) - th_j.mean((0, 1)))
    d_sd = np.abs(th_t.std((0, 1)) - th_j.std((0, 1)))
    assert np.all(d_mean <= K_MCSE * se_mean), (d_mean / se_mean).max()
    assert np.all(d_sd <= K_MCSE * se_sd), (d_sd / se_sd).max()
    acc_t = float(res.stats["acceptance_rate"].mean())
    acc_j = float(np.mean(jax_slice.stats["acceptance_rate"]))
    assert abs(acc_t - acc_j) <= 0.05, (acc_t, acc_j)
    assert not bool(res.stats["numerical_error"].any())
    assert not bool(np.any(jax_slice.stats["numerical_error"]))

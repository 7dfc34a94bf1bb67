"""`sample()` at its defaults: per-chain Stan adaptation, step by step.

The deterministic pieces get the same numpy inputs on both sides, float64,
and agree to 1e-12: the batched per-chain step-size search against the JAX
search vmapped over chains, and 200 iterations of a Stan schedule through
the per-chain `adapt_step` and the cross-chain `adapt_step_batch`. Whole
runs of both packages' `sample()` at their defaults (and cross-chain, step
by step) are compared in distribution, as are the port's per-chain fused
draws started from the JAX package's per-chain warmed state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu.adaptation import stan as stan_j
from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)
from advancedhmc_tpu.stepsize_search import find_good_stepsize as fgs_j

import advancedhmc_torch as ah
from advancedhmc_torch import convert
from advancedhmc_torch.stepsize_search import _search
from test_torch_sampler import _assert_same_law

torch.set_num_threads(2)

N, P = 200, 9
DIM = P + 1
CHAINS, SAMPLES, ADAPTS = 16, 300, 150
# the cross-chain comparison runs shorter, to keep the file's time down;
# its one Stan window ends at iteration 70
SAMPLES_CC, ADAPTS_CC = 200, 100
BUFFERS = dict(init_buffer=30, term_buffer=30, window_size=15)
DELTA, MAX_DEPTH = 0.8, 6
EXACT = dict(rtol=1e-12, atol=1e-12)


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **EXACT)


def _theta0():
    return 0.1 * np.random.default_rng(0).normal(size=(CHAINS, DIM))


def _jax_kernel():
    return aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.05)),
        aj.GeneralisedNoUTurn(max_depth=MAX_DEPTH), "multinomial"))


def _port_kernel():
    return ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.05, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=MAX_DEPTH)))


def _jax_sample(cross_chain, n=SAMPLES, n_adapts=ADAPTS):
    adaptor = stan_j.AdaptorConfig(
        kind="stan", da=aj.DualAveragingConfig(delta=DELTA), **BUFFERS)
    return aj.sample(
        jax.random.PRNGKey(0), jax_logistic(n=N, p=P, dtype=jnp.float64),
        _jax_kernel(), aj.make_metric("diagonal", DIM, dtype=jnp.float64),
        jnp.asarray(_theta0()), n, n_adapts=n_adapts, adaptor=adaptor,
        cross_chain=cross_chain)


def _port_sample(cross_chain, n=SAMPLES, n_adapts=ADAPTS):
    adaptor = ah.AdaptorConfig(
        kind="stan", da=ah.DualAveragingConfig(delta=DELTA), **BUFFERS)
    return ah.sample(
        torch.Generator().manual_seed(0),
        ah.hierarchical_logistic(n=N, p=P, dtype=torch.float64,
                                 device="cpu"),
        _port_kernel(),
        ah.make_metric("diagonal", DIM, dtype=torch.float64, device="cpu"),
        _theta0(), n, n_adapts=n_adapts, adaptor=adaptor,
        cross_chain=cross_chain, device="cpu")


@pytest.fixture(scope="module")
def jax_default_run():
    return _jax_sample(cross_chain=False)


def _hamiltonians(m_inv):
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(
        jnp.asarray(m_inv)), target=jax_logistic(n=N, p=P, dtype=jnp.float64))
    ht = ah.Hamiltonian(
        metric=convert.diag_metric(m_inv, "cpu"),
        target=ah.hierarchical_logistic(n=N, p=P, dtype=torch.float64,
                                        device="cpu"))
    return hj, ht


def test_per_chain_stepsize_search_matches_jax_vmap():
    """Chains from 0.02 to 3 times a unit spread need from one to several
    doublings or halvings and bisections, so the chains' loops end at
    different trial steps."""
    c = 16
    hj, ht = _hamiltonians(np.linspace(0.5, 2.0, DIM))
    rng = np.random.default_rng(4)
    theta = np.geomspace(0.02, 3.0, c)[:, None] * rng.normal(size=(c, DIM))
    keys = jax.random.split(jax.random.PRNGKey(5), c)
    eps_j = jax.jit(jax.vmap(lambda k, t: fgs_j(k, hj, t)))(
        keys, jnp.asarray(theta))
    zj = jax.jit(jax.vmap(hj.init_phasepoint))(keys, jnp.asarray(theta))
    eps_t = _search(ht, convert.phasepoint(zj, "cpu"), 0.1, 100)
    assert eps_t.shape == (c,)
    assert len(np.unique(np.asarray(eps_j))) > 8
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=1e-12)
    eps_g = ah.find_good_stepsizes(torch.Generator().manual_seed(0), ht,
                                   torch.as_tensor(theta))
    assert eps_g.shape == (c,) and bool((eps_g > 0).all())


def test_per_chain_metric_broadcasts_like_jax_vmap():
    """A (C, dim) M⁻¹: velocity, -K and the momentum's scale per chain."""
    c = 6
    rng = np.random.default_rng(2)
    m_inv = rng.uniform(0.2, 3.0, size=(c, DIM))
    r = rng.normal(size=(c, DIM))
    mj = jax.vmap(aj.DiagEuclideanMetric.create)(jnp.asarray(m_inv))
    mt = convert.diag_metric(m_inv, "cpu")
    rt = torch.as_tensor(r)
    _close(mt.velocity(rt), jax.vmap(lambda m, x: m.velocity(x))(mj, r))
    _close(mt.neg_kinetic_energy(rt),
           jax.vmap(lambda m, x: m.neg_kinetic_energy(x))(mj, r))
    draws = torch.stack([mt.rand_momentum(torch.Generator().manual_seed(s),
                                          c) for s in range(400)])
    ratio = draws.var(0) * torch.as_tensor(m_inv)       # Var r = 1 / M⁻¹
    assert float((ratio - 1).abs().max()) < 0.35
    shared = ah.make_metric("diagonal", DIM, torch.float64, device="cpu")
    assert shared.per_chain(c).m_inv.shape == (c, DIM)


@pytest.mark.parametrize("cross_chain", [False, True])
def test_adaptation_steps_match_jax(cross_chain):
    """200 iterations of a Stan schedule (windows ending at 45, 75 and 170,
    finalize at 199) on given θ, ∇ and α; 8 chains, per chain or pooled.
    Every dual-averaging and Welford field agrees at every iteration."""
    c, n = 8, 200
    rng = np.random.default_rng(7)
    thetas = rng.normal(size=(n, c, DIM)) * np.linspace(0.2, 3.0, DIM) + 1.0
    grads = rng.normal(size=(n, c, DIM))
    alphas = rng.uniform(0.0, 1.3, size=(n, c))
    cfg_j = stan_j.AdaptorConfig(kind="stan", **BUFFERS)
    cfg_t = ah.AdaptorConfig(kind="stan", **BUFFERS)
    flags_j = stan_j.adapt_flags(cfg_j, n, n)
    flags_t = ah.adapt_flags(cfg_t, n, n)
    assert list(np.nonzero(flags_t["window_end"])[0]) == [44, 74, 169]
    if cross_chain:
        eps0 = 0.3
        st_j = stan_j.AdaptState.init(cfg_j, DIM, eps0, jnp.float64)
        step_j = jax.jit(lambda st, th, g, a, fl: stan_j.adapt_step_batch(
            cfg_j, st, th, g, a, fl))
        step_t = ah.adapt_step_batch
    else:
        eps0 = np.geomspace(0.05, 1.0, c)
        st_j = jax.vmap(lambda e: stan_j.AdaptState.init(
            cfg_j, DIM, e, jnp.float64))(jnp.asarray(eps0))
        step_j = jax.jit(jax.vmap(
            lambda st, th, g, a, fl: stan_j.adapt_step(cfg_j, st, th, g, a,
                                                       fl),
            in_axes=(0, 0, 0, 0, None)))
        step_t = ah.adapt_step
    st_t = ah.AdaptState.init(
        cfg_t, DIM, torch.as_tensor(eps0, dtype=torch.float64), torch.float64)
    assert st_t.da.eps.shape == st_t.mm.n.shape == (() if cross_chain
                                                   else (c,))
    for t in range(n):
        st_j = step_j(st_j, thetas[t], grads[t], alphas[t],
                      {k: v[t] for k, v in flags_j.items()})
        st_t = step_t(cfg_t, st_t, torch.as_tensor(thetas[t]),
                      torch.as_tensor(grads[t]), torch.as_tensor(alphas[t]),
                      {k: bool(v[t]) for k, v in flags_t.items()})
        for f in ("eps", "mu", "x_bar", "h_bar"):
            _close(getattr(st_t.da, f), getattr(st_j.da, f))
        for f in ("mean", "m2", "var"):
            _close(getattr(st_t.mm, f), getattr(st_j.mm, f))
        assert np.array_equal(st_t.da.m.numpy(), np.asarray(st_j.da.m))
        assert np.array_equal(st_t.mm.n.numpy(), np.asarray(st_j.mm.n))
    assert st_t.mm.var.shape == ((DIM,) if cross_chain else (c, DIM))


def _compare_runs(res, jax_res, cross_chain, n=SAMPLES, n_adapts=ADAPTS):
    """Draws after warmup in law, acceptance, the final ε and the state's
    and stats' layout, as in the JAX package."""
    assert res.thetas.shape == (n, CHAINS, DIM)
    assert torch.isfinite(res.thetas).all()
    assert res.warmup_stats is None and jax_res.warmup_stats is None
    assert set(res.stats) == set(jax_res.stats)
    assert "is_adapt" in res.stats
    assert bool(res.stats["is_adapt"][:n_adapts].all())
    assert not bool(res.stats["is_adapt"][n_adapts:].any())
    for k, v in res.stats.items():
        assert v.shape == (n, CHAINS), k
    fs, fj = res.final_state, jax_res.final_state
    assert fs.adapt.da.eps.shape == np.shape(fj.adapt.da.eps)
    assert fs.metric.m_inv.shape == np.shape(fj.metric.m_inv)
    assert fs.adapt.mm.n.shape == np.shape(fj.adapt.mm.n)
    if not cross_chain:
        assert fs.adapt.da.eps.shape == (CHAINS,)
        assert fs.metric.m_inv.shape == (CHAINS, DIM)
        # the draws run at each chain's own final ε
        assert torch.equal(res.stats["step_size"][-1], fs.adapt.da.eps)
    _assert_same_law(res.thetas[n_adapts:].numpy(),
                     np.asarray(jax_res.thetas[n_adapts:]), "draws")
    acc_t = float(res.stats["acceptance_rate"][n_adapts:].mean())
    acc_j = float(np.mean(jax_res.stats["acceptance_rate"][n_adapts:]))
    assert abs(acc_t - acc_j) <= 0.05, (acc_t, acc_j)
    eps_t = float(fs.adapt.da.eps.median())
    eps_j = float(np.median(np.asarray(fj.adapt.da.eps)))
    assert abs(eps_t / eps_j - 1) <= 0.25, (eps_t, eps_j)
    assert not bool(res.stats["numerical_error"][n_adapts:].any())


def test_sample_defaults_match_jax(jax_default_run):
    """Every argument but the adaptor and n_adapts at its default: per-chain
    adaptation, every iteration one `sample_step`."""
    _compare_runs(_port_sample(cross_chain=False), jax_default_run, False)


def test_cross_chain_step_by_step_matches_jax():
    run = dict(n=SAMPLES_CC, n_adapts=ADAPTS_CC)
    _compare_runs(_port_sample(True, **run), _jax_sample(True, **run), True,
                  **run)


def test_per_chain_adaptation_learns_the_variances():
    """Each chain's adapted M⁻¹ is near the variances of a scaled 5-D
    Gaussian (the JAX package's tests/test_sampler.py check, at rtol 0.35
    on the mean over 8 chains; the last Stan window holds 75 draws)."""
    scales = torch.tensor([0.5, 1.0, 2.0, 4.0, 0.25], dtype=torch.float64)

    def value_and_grad(x):
        return -0.5 * torch.sum(x * x / scales, -1), -x / scales

    target = ah.LogDensityTarget(lambda x: value_and_grad(x)[0], 5,
                                 value_and_grad)
    res = ah.sample(
        torch.Generator().manual_seed(11), target, _port_kernel(),
        ah.make_metric("diagonal", 5, dtype=torch.float64, device="cpu"),
        np.zeros(5), 150, n_adapts=150,
        adaptor=ah.AdaptorConfig(kind="stan", **BUFFERS), n_chains=8,
        device="cpu")
    m_inv = res.final_state.metric.m_inv
    assert m_inv.shape == (8, 5)
    np.testing.assert_allclose(m_inv.mean(0).numpy(), scales.numpy(),
                               rtol=0.35)


def test_per_chain_draws_from_a_jax_warmed_state(jax_default_run):
    """`convert.hmc_state` carries the JAX package's per-chain final state
    (ε (C,), M⁻¹ (C, dim), per-chain Welford moments) into the port, whose
    per-chain fused draws from it follow the JAX draws' law."""
    fj = jax_default_run.final_state
    state = convert.hmc_state(fj, device="cpu")
    assert torch.equal(state.adapt.da.eps,
                       torch.as_tensor(np.array(fj.adapt.da.eps)))
    assert torch.equal(state.metric.m_inv,
                       torch.as_tensor(np.array(fj.metric.m_inv)))
    assert state.adapt.mm.n.shape == (CHAINS,)
    assert state.adapt.mm.mean.shape == (CHAINS, DIM)
    spec = ah.SampleSpec(
        target=ah.hierarchical_logistic(n=N, p=P, dtype=torch.float64,
                                        device="cpu"),
        kernel=_port_kernel(), adaptor=ah.AdaptorConfig(**BUFFERS))
    n_draws = SAMPLES - ADAPTS
    out, thetas, stats = ah.fused_draw_phase(
        torch.Generator().manual_seed(1), spec, state, n_draws, 10)
    assert thetas.shape == (n_draws, CHAINS, DIM)
    assert torch.equal(stats["step_size"],
                       state.adapt.da.eps.expand(n_draws, -1))
    th_j = np.asarray(jax_default_run.thetas[ADAPTS:])
    _assert_same_law(thetas.numpy(), th_j, "from JAX per-chain state")
    acc_t = float(stats["acceptance_rate"].mean())
    acc_j = float(np.mean(jax_default_run.stats["acceptance_rate"][ADAPTS:]))
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)
    depth_t = float(stats["tree_depth"].double().mean())
    depth_j = float(np.mean(jax_default_run.stats["tree_depth"][ADAPTS:]))
    assert abs(depth_t - depth_j) <= 0.15, (depth_t, depth_j)

"""The port's deterministic building blocks against the JAX package.

Bit tricks, energies and the −Inf clamp, leapfrog, the step-size search,
dual averaging, the Welford estimator and the Stan schedule, each fed the
same numpy inputs on both sides: float64 on both, held to 1e-10 (the flags
exactly).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import utils as uj
from advancedhmc_tpu.adaptation import stan as stan_j
from advancedhmc_tpu.adaptation.massmatrix import WelfordVarState as WelfordJ
from advancedhmc_tpu.adaptation.stepsize import (
    DualAveragingConfig as DAConfigJ,
    DualAveragingState as DAStateJ,
    da_update as da_update_j,
)
from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)
from advancedhmc_tpu.stepsize_search import find_good_stepsize as fgs_j
from advancedhmc_tpu.trajectory import mh_accept_ratio as mh_j

import advancedhmc_torch as ah
from advancedhmc_torch import convert, utils as ut
from advancedhmc_torch.stepsize_search import _search

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-12)
N, P = 200, 9
DIM = P + 1


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def _models():
    hj = aj.Hamiltonian(
        metric=aj.DiagEuclideanMetric.create(
            jnp.linspace(0.5, 2.0, DIM, dtype=jnp.float64)),
        target=jax_logistic(n=N, p=P, dtype=jnp.float64))
    ht = ah.Hamiltonian(
        metric=convert.diag_metric(np.linspace(0.5, 2.0, DIM), "cpu"),
        target=ah.hierarchical_logistic(n=N, p=P, dtype=torch.float64,
                                        device="cpu"))
    return hj, ht


def _phase_points(hj, c, seed):
    rng = np.random.default_rng(seed)
    th = 0.3 * rng.normal(size=(c, DIM))
    r = rng.normal(size=(c, DIM))
    return jax.vmap(hj.phasepoint)(jnp.asarray(th), jnp.asarray(r))


def test_bit_tricks_match():
    i = np.concatenate([np.arange(0, 300), [1023, 1024, 4095, 2**30 - 1,
                                           2**30, 2**31 - 1]]).astype(np.int32)
    it = torch.as_tensor(i)
    assert np.array_equal(ut.trailing_ones(it).numpy(),
                          np.asarray(uj.trailing_ones(jnp.asarray(i))))
    assert np.array_equal(ut.trailing_zeros(it).numpy(),
                          np.asarray(uj.trailing_zeros(jnp.asarray(i))))


def test_elementwise_helpers_match():
    rng = np.random.default_rng(3)
    a = rng.normal(size=50)
    b = rng.normal(size=50)
    a[:3] = [-np.inf, np.nan, np.inf]
    b[:3] = [-np.inf, 1.0, -np.inf]
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    _close(ut.maxabs(at[3:], bt[3:]), uj.maxabs(a[3:], b[3:]))
    _close(ut.logaddexp(at, bt), uj.logaddexp(jnp.asarray(a), jnp.asarray(b)))
    _close(ut.clamp_nonfinite(at), uj.clamp_nonfinite(jnp.asarray(a)))


def test_random_helpers_have_the_right_law():
    g = torch.Generator().manual_seed(0)
    e = ut.rand_exponential(g, (20000,), torch.float64, "cpu")
    s = ut.rand_sign(g, (20000,), "cpu")
    assert abs(float(e.mean()) - 1.0) < 0.03 and float(e.min()) >= 0
    assert set(s.unique().tolist()) == {-1, 1}
    assert abs(float(s.double().mean())) < 0.03 and s.dtype == torch.int32


def test_energies_and_velocity_match():
    hj, ht = _models()
    zj = _phase_points(hj, 16, 0)
    zt = convert.phasepoint(zj, "cpu")
    zt2 = ht.phasepoint(zt.theta, zt.r)
    for f in ("logdensity", "grad", "neg_k"):
        _close(getattr(zt2, f), getattr(zj, f))
    _close(zt2.energy(), jax.vmap(lambda z: z.energy())(zj))
    _close(ht.velocity(zt.r), jax.vmap(hj.velocity)(zj.r))
    unit_j = aj.UnitEuclideanMetric(size=DIM, _dtype=jnp.float64)
    unit_t = ah.make_metric("unit", DIM, dtype=torch.float64, device="cpu")
    _close(unit_t.neg_kinetic_energy(zt.r),
           jax.vmap(unit_j.neg_kinetic_energy)(zj.r))


def test_nonfinite_energies_clamp_to_minus_inf():
    def lp_j(x):
        return jnp.where(x[0] > 0, jnp.inf, jnp.where(x[1] > 0, jnp.nan,
                                                        -0.5 * x @ x))

    def lp_t(x):
        out = -0.5 * (x * x).sum(-1)
        out = torch.where(x[:, 1] > 0, torch.nan, out)
        return torch.where(x[:, 0] > 0, torch.inf, out)

    th = np.array([[1.0, -1.0, 0.2], [-1.0, 1.0, 0.2], [-1.0, -1.0, 0.2]])
    r = np.array([[0.1, 0.2, 0.3], [np.inf, 0.0, 0.0], [0.3, 0.2, 0.1]])
    hj = aj.Hamiltonian(metric=aj.UnitEuclideanMetric(size=3,
                                                      _dtype=jnp.float64),
                        target=aj.LogDensityTarget(lp_j, 3))
    ht = ah.Hamiltonian(metric=ah.make_metric("unit", 3, torch.float64,
                                              device="cpu"),
                        target=ah.LogDensityTarget(lp_t, 3))
    zj = jax.vmap(hj.phasepoint)(jnp.asarray(th), jnp.asarray(r))
    zt = ht.phasepoint(torch.as_tensor(th), torch.as_tensor(r))
    assert np.array_equal(zt.logdensity.numpy(), np.asarray(zj.logdensity))
    assert np.array_equal(zt.neg_k.numpy(), np.asarray(zj.neg_k))
    assert zt.logdensity[0] == zt.logdensity[1] == -np.inf
    assert zt.neg_k[1] == -np.inf
    assert np.array_equal(zt.is_finite().numpy(),
                          np.asarray(jax.vmap(lambda z: z.is_finite())(zj)))


@pytest.mark.parametrize("eps", [0.05, -0.1, 0.3])
def test_leapfrog_matches(eps):
    hj, ht = _models()
    zj = _phase_points(hj, 12, 1)
    zt = convert.phasepoint(zj, "cpu")
    integ = aj.Leapfrog(step_size=jnp.asarray(abs(eps)))
    z1j, z1t = zj, zt
    for _ in range(3):
        z1j = jax.vmap(lambda z: aj.leapfrog_step(integ, hj, z, eps))(z1j)
        z1t = ah.leapfrog_step(ht, z1t, eps)
    for f in ("theta", "r", "logdensity", "grad", "neg_k"):
        _close(getattr(z1t, f), getattr(z1j, f))
    # per-chain signed step sizes
    eps_c = np.where(np.arange(12) % 2 == 0, eps, -eps)
    z2j = jax.vmap(lambda z, e: aj.leapfrog_step(integ, hj, z, e))(
        zj, jnp.asarray(eps_c))
    z2t = ah.leapfrog_step(ht, zt, torch.as_tensor(eps_c))
    _close(z2t.theta, z2j.theta)
    _close(z2t.r, z2j.r)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_good_stepsize_matches(seed):
    """Both searches from the same phase point (the JAX search draws its
    momentum from the key; the port's `_search` takes that phase point)."""
    hj, ht = _models()
    key = jax.random.PRNGKey(seed)
    theta = jnp.asarray(0.3 * np.random.default_rng(seed).normal(size=DIM))
    eps_j = float(fgs_j(key, hj, theta))
    zj = hj.init_phasepoint(key, theta)
    zt = convert.phasepoint(jax.tree_util.tree_map(lambda a: a[None], zj),
                            "cpu")
    eps_t = float(_search(ht, zt, 0.1, 100))
    np.testing.assert_allclose(eps_t, eps_j, rtol=1e-12)


def test_dual_averaging_matches():
    cfg_j = DAConfigJ(delta=0.55, kappa=0.8)
    cfg_t = ah.DualAveragingConfig(delta=0.55, kappa=0.8)
    sj = DAStateJ.init(jnp.asarray(0.37))
    st = ah.DualAveragingState.init(torch.tensor(0.37, dtype=torch.float64))
    alphas = np.random.default_rng(0).uniform(0, 1.2, size=40)
    alphas[7] = 1.0
    for k, a in enumerate(alphas):
        sj = da_update_j(cfg_j, sj, jnp.asarray(a))
        st = ah.da_update(cfg_t, st, a)
        if k == 20:
            sj, st = sj.reset(), st.reset()
    sj, st = sj.finalize(), st.finalize()
    for f in ("eps", "mu", "x_bar", "h_bar"):
        _close(getattr(st, f), getattr(sj, f))
    assert int(st.m) == int(sj.m)
    # a non-finite step size reverts the whole update
    huge = DAStateJ.init(jnp.asarray(1e300))
    st_h = convert.dual_averaging_state(huge, "cpu")
    out_t = ah.da_update(cfg_t, st_h, 0.0)
    out_j = da_update_j(cfg_j, huge, jnp.asarray(0.0))
    assert int(out_t.m) == int(out_j.m)
    _close(out_t.eps, out_j.eps)


def test_welford_matches():
    rng = np.random.default_rng(1)
    wj = WelfordJ.init(DIM, jnp.float64)
    wt = ah.WelfordVarState.init(DIM, torch.float64)
    for c in (64, 7, 128, 3):
        xs = rng.normal(size=(c, DIM)) * np.linspace(0.1, 3.0, DIM) + 1.5
        wj = wj.push_batch(jnp.asarray(xs))
        wt = wt.push_batch(torch.as_tensor(xs))
        wj, wt = wj.update_estimate(), wt.update_estimate()
        for f in ("mean", "m2", "var"):
            _close(getattr(wt, f), getattr(wj, f))
        assert int(wt.n) == int(wj.n)
    wj, wt = wj.reset(), wt.reset()
    _close(wt.m_inv, wj.m_inv)
    assert int(wt.n) == 0 and float(wt.m2.abs().sum()) == 0
    # below n_min the estimate is kept
    wt2 = ah.WelfordVarState.init(DIM, torch.float64).push_batch(
        torch.ones(5, DIM, dtype=torch.float64)).update_estimate()
    assert torch.equal(wt2.var, torch.ones(DIM, dtype=torch.float64))


@pytest.mark.parametrize("kind,n_adapts,n_total,buffers", [
    ("stan", 1000, 1200, (75, 50, 25)),
    ("stan", 128, 384, (75, 50, 25)),
    ("stan", 64, 128, (16, 16, 16)),
    ("stan", 300, 300, (30, 20, 10)),
    ("naive", 50, 80, (75, 50, 25)),
    ("stepsize", 50, 80, (75, 50, 25)),
])
def test_adapt_flags_exact(kind, n_adapts, n_total, buffers):
    ib, tb, ws = buffers
    fj = stan_j.adapt_flags(stan_j.AdaptorConfig(
        kind=kind, init_buffer=ib, term_buffer=tb, window_size=ws),
        n_adapts, n_total)
    ft = ah.adapt_flags(ah.AdaptorConfig(
        kind=kind, init_buffer=ib, term_buffer=tb, window_size=ws),
        n_adapts, n_total)
    for k in ("is_adapt", "in_window", "window_end", "is_last"):
        assert np.array_equal(ft[k], np.asarray(fj[k])), k
    if kind == "stan":
        for a, b in zip(ah.stan_schedule(n_adapts, ib, tb, ws),
                        stan_j.stan_schedule(n_adapts, ib, tb, ws)):
            assert np.array_equal(a, b)


def test_mh_accept_ratio_alpha_matches():
    g = torch.Generator().manual_seed(0)
    h0 = torch.tensor([1.0, 2.0, 3.0, 0.5], dtype=torch.float64)
    h1 = torch.tensor([0.5, 2.5, np.nan, np.inf], dtype=torch.float64)
    _, alpha_t = ah.mh_accept_ratio(g, h0, h1)
    _, alpha_j = jax.vmap(mh_j, in_axes=(None, 0, 0))(
        jax.random.PRNGKey(0), jnp.asarray(h0.numpy()),
        jnp.asarray(h1.numpy()))
    _close(alpha_t, alpha_j)


def test_unported_options_raise_not_implemented():
    tgt = ah.hierarchical_logistic(n=N, p=P, dtype=torch.float64,
                                   device="cpu")
    lf = ah.Leapfrog(step_size=torch.tensor(0.1, dtype=torch.float64))
    kernel = ah.HMCKernel(ah.Trajectory(lf, ah.GeneralisedNoUTurn()))
    metric = ah.make_metric("diagonal", DIM, torch.float64, device="cpu")
    th0 = np.zeros((4, DIM))
    gen = torch.Generator().manual_seed(0)
    h = ah.Hamiltonian(metric=metric, target=tgt)
    z = h.init_phasepoint(gen, torch.zeros(4, DIM, dtype=torch.float64))
    cases = [
        lambda: ah.make_metric("dense", DIM, device="cpu"),
        lambda: ah.Trajectory(lf, ah.GeneralisedNoUTurn(), ts_kind="slice"),
        lambda: ah.AdaptState.init(ah.AdaptorConfig(mm_kind="nutpie"), DIM,
                                   0.1),
        lambda: ah.SampleSpec(target=tgt, kernel=kernel,
                              adaptor=ah.AdaptorConfig(), cross_chain=False),
        lambda: ah.SampleSpec(target=tgt, kernel=kernel,
                              adaptor=ah.AdaptorConfig(), cross_chain=True,
                              coupled=True),
        lambda: ah.hierarchical_logistic(n=N, p=P, x_dtype="bfloat16",
                                         device="cpu"),
        lambda: ah.nuts_transition(gen, h, kernel.trajectory, z,
                                   coupled_key=1),
        lambda: ah.nuts_transitions_fused(gen, h, kernel.trajectory, z, 2,
                                          kernel.refreshment, pair=True),
        lambda: ah.sample(gen, tgt, kernel, metric, th0, 16, n_adapts=8,
                          adaptor=ah.AdaptorConfig(), cross_chain=True,
                          fuse_draws=4, fuse_warmup=True,
                          fuse_warmup_block=4, mesh=object(), device="cpu"),
        lambda: ah.sample(gen, tgt, kernel, metric, th0, 16, n_adapts=8,
                          adaptor=ah.AdaptorConfig(), cross_chain=True,
                          fuse_draws=0, device="cpu"),
    ]
    for case in cases:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            case()

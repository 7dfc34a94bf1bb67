"""ChEES-HMC in the port against the JAX package.

* `halton_sequence` and `chees_tau_sweep`: equal to JAX's.
* `chees_update`: against JAX's over random inputs with non-finite chains,
  zero weights and counts on both sides of `avg_start`, in float64 to
  1e-12 over a run of SGA steps (float32 to 2e-5 relative).
* The transition: `chees_transition_core` given JAX's momenta and MH
  uniforms (drawn from JAX's key as `chees_transition` draws them) against
  JAX `chees_transition`, in float64 to 1e-10, on a 2-D anisotropic
  Gaussian and the logistic at p = 9, with a step count at a `ceil`
  boundary and one at `max_steps`.
* The draws-only step equals the full step with `is_adapt` False, bit for
  bit (the property JAX pins in tests/test_chees.py).
* `sample_chees` in law against JAX `sample_chees` on the anisotropic
  target (64 chains, 400 iterations): finalized T in (2, 20) and within
  1.5× of JAX's, moments, acceptance, step size; the τ schedule applies
  in warmup only, `drop_warmup`, one step count for every chain; and the
  non-centered funnel gate of tests/test_chees.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import chees as chees_j
from advancedhmc_tpu.adaptation import chees as achees_j
from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)

import advancedhmc_torch as ah
from advancedhmc_torch import chees as chees_t
from advancedhmc_torch import convert

torch.set_num_threads(2)

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-12)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def test_halton_and_tau_sweep_match():
    for n in (1, 7, 256, 1000):
        for base in (2, 3):
            np.testing.assert_array_equal(
                ah.halton_sequence(n, base),
                achees_j.halton_sequence(n, base))
    for args in ((100, 50), (512, 256, 4.0, 0.25), (10, 0), (64, 64, 8.0,
                                                                1.0)):
        np.testing.assert_array_equal(ah.chees_tau_sweep(*args),
                                      chees_j.chees_tau_sweep(*args))


def _update_inputs(rng, c, d, step, dtype):
    th = rng.normal(size=(c, d))
    thp = th + rng.normal(size=(c, d)) * (0.5 + 0.1 * step)
    vp = rng.normal(size=(c, d))
    alpha = rng.uniform(-0.2, 1.3, size=c)     # clipped to [0, 1]
    if step % 3 == 1:      # non-finite chains weigh nothing
        thp[2] = np.nan
        vp[5, 1] = np.inf
    if step % 4 == 2:      # zero weights
        alpha[:] = 0.0
    tau = rng.uniform(0.2, 3.0)
    return th.astype(dtype), thp.astype(dtype), vp.astype(dtype), \
        alpha.astype(dtype), np.asarray(tau, dtype)


@pytest.mark.parametrize("dtype,tol", [
    (np.float64, dict(rtol=1e-12, atol=1e-12)),
    # float32: the chains' sums run in another order on each side
    (np.float32, dict(rtol=2e-5, atol=2e-6)),
])
@pytest.mark.parametrize("avg_start", [None, 0, 5])
def test_chees_update_matches_jax(dtype, tol, avg_start):
    rng = np.random.default_rng(11)
    cfg_t = ah.CheesConfig(avg_start=avg_start)
    cfg_j = achees_j.CheesConfig(avg_start=avg_start)
    st_j = achees_j.CheesState.init(2.0, jnp.dtype(dtype))
    st_t = ah.CheesState.init(2.0, torch.from_numpy(np.zeros(0, dtype)).dtype,
                              device="cpu")
    for step in range(12):     # the count crosses avg_start = 5
        th, thp, vp, alpha, tau = _update_inputs(rng, 64, 6, step, dtype)
        st_j = achees_j.chees_update(cfg_j, st_j, jnp.asarray(th),
                                     jnp.asarray(thp), jnp.asarray(vp),
                                     jnp.asarray(alpha), jnp.asarray(tau))
        st_t = ah.chees_update(cfg_t, st_t, torch.from_numpy(th),
                               torch.from_numpy(thp), torch.from_numpy(vp),
                               torch.from_numpy(alpha),
                               torch.from_numpy(tau))
        for f in ("log_t", "log_t_avg", "m", "v"):
            np.testing.assert_allclose(_np(getattr(st_t, f)),
                                       np.asarray(getattr(st_j, f)), **tol,
                                       err_msg=f"{f} at step {step}")
        assert int(st_t.count) == int(st_j.count) == step + 1
    # the state carried across is the same state
    again = convert.chees_state(st_j, "cpu")
    np.testing.assert_allclose(_np(again.log_t), _np(st_t.log_t), **tol)
    np.testing.assert_allclose(_np(st_t.finalize().log_t),
                               _np(st_t.log_t_avg), rtol=0, atol=0)


def _gauss_pair(scales):
    s2 = np.asarray(scales, np.float64) ** 2
    target_j = aj.LogDensityTarget(
        lambda x: -0.5 * jnp.sum(x * x / jnp.asarray(s2)), len(scales))
    return target_j, ah.mvn_diag(s2, dtype=F64, device="cpu")


def _logistic_pair():
    return (jax_logistic(n=200, p=9, dtype=jnp.float64),
            ah.hierarchical_logistic(n=200, p=9, dtype=F64, device="cpu"))


# (target, chains, ε, τ, max_steps): τ/ε = 4 exactly (the ceil boundary),
# a generic quotient, and one clipped at max_steps
CORE_CASES = [
    ("gauss", 32, 0.25, 1.0, 64),
    ("gauss", 32, 0.3, 1.37, 64),
    ("gauss", 16, 0.05, 2.0, 7),
    ("logistic", 24, 0.125, 0.5, 64),
    ("logistic", 24, 0.07, 0.31, 64),
]


@pytest.mark.parametrize("kind,c,eps,tau,max_steps", CORE_CASES)
def test_chees_transition_core_matches_jax(kind, c, eps, tau, max_steps):
    tj, tt = (_gauss_pair((1.0, 3.0)) if kind == "gauss"
              else _logistic_pair())
    dim = tt.dim
    rng = np.random.default_rng(3)
    theta = 0.3 * rng.normal(size=(c, dim))
    m_inv = np.linspace(0.5, 1.5, dim)
    metric_j = aj.DiagEuclideanMetric.create(jnp.asarray(m_inv))
    metric_t = convert.diag_metric(m_inv, "cpu")
    lp_j, grad_j = jax.vmap(tj.logdensity_and_grad)(jnp.asarray(theta))
    key = jax.random.PRNGKey(7)
    out_j = chees_j.chees_transition(
        key, tj, metric_j, jnp.asarray(eps), jnp.asarray(tau), max_steps,
        jnp.asarray(theta), lp_j, grad_j)
    # JAX's draws, from its key as its transition draws them
    k_mom, k_mh = jax.random.split(key)
    r0 = jax.vmap(metric_j.rand_momentum)(jax.random.split(k_mom, c))
    u = jax.random.uniform(k_mh, (c,), jnp.float64)
    th_t = torch.from_numpy(theta)
    lp_t, grad_t = tt.logdensity_and_grad(th_t)
    out_t = chees_t.chees_transition_core(
        tt, metric_t, torch.tensor(eps, dtype=F64),
        torch.tensor(tau, dtype=F64), max_steps, th_t, lp_t, grad_t,
        torch.from_numpy(np.asarray(r0)), torch.from_numpy(np.asarray(u)))
    n = min(max(int(np.ceil(tau / eps)), 1), max_steps)
    assert int(out_t[2]["n_steps"][0]) == int(out_j[2]["n_steps"][0]) == n
    for a, b in zip(out_t[0] + out_t[1], out_j[0] + out_j[1]):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    for k, v in out_j[2].items():
        np.testing.assert_allclose(_np(out_t[2][k]).astype(np.float64),
                                   np.asarray(v).astype(np.float64), **TOL,
                                   err_msg=k)


def _chees_start(c=16, dim=4, seed=0):
    target = ah.std_gaussian(dim, device="cpu")
    theta = torch.from_numpy(0.4 * np.random.default_rng(seed).normal(
        size=(c, dim)))
    lp, grad = target.logdensity_and_grad(theta)
    cfg = ah.AdaptorConfig(kind="stan", mm_kind="welford_var")
    metric = ah.make_metric("diagonal", dim, F64, device="cpu")
    adapt = ah.AdaptState.init(cfg, dim, torch.tensor(0.5, dtype=F64), F64)
    cs = ah.CheesState.init(1.5, F64, device="cpu")
    return target, cfg, (theta, lp, grad, metric, adapt, cs)


def test_draw_step_is_bitwise_the_full_step():
    n = 12
    target, cfg, carry = _chees_start()
    u = torch.from_numpy(ah.halton_sequence(n))
    flags = ah.adapt_flags(cfg, 0, n)          # every iteration draws
    full = ah.make_chees_step(target, cfg, ah.CheesConfig(avg_start=0), 64)
    draw = ah.make_chees_draw_step(target, 64)
    dcarry = chees_t.draw_carry(carry)
    g_full = torch.Generator().manual_seed(7)
    g_draw = torch.Generator().manual_seed(7)
    for i in range(n):
        carry, (th_f, st_f) = full(g_full, carry,
                                   {k: bool(v[i]) for k, v in flags.items()},
                                   u[i])
        dcarry, (th_d, st_d) = draw(g_draw, dcarry, u[i])
        assert torch.equal(th_f, th_d)
        for k in st_f:
            assert torch.equal(st_f[k], st_d[k]), k


def _anisotropic_runs(seed, n_samples=400, n_adapts=200, **kw):
    s2 = np.asarray([1.0, 9.0])
    theta0 = 0.1 * np.random.default_rng(9).normal(size=(64, 2))
    res_t = ah.sample_chees(torch.Generator().manual_seed(seed),
                            ah.mvn_diag(s2, dtype=F64, device="cpu"),
                            torch.from_numpy(theta0), n_samples, n_adapts,
                            device="cpu", **kw)
    tj = aj.LogDensityTarget(
        lambda x: -0.5 * jnp.sum(x * x / jnp.asarray(s2)), 2)
    res_j = aj.sample_chees(jax.random.PRNGKey(seed), tj,
                            jnp.asarray(theta0), n_samples=n_samples,
                            n_adapts=n_adapts, **kw)
    return res_t, res_j


def test_sample_chees_matches_jax_in_law():
    res_t, res_j = _anisotropic_runs(1)
    u_last = ah.halton_sequence(400)[-1]
    t_t = float(res_t.stats["trajectory_length"][-1, 0]) / u_last
    t_j = float(np.asarray(res_j.stats["trajectory_length"])[-1, 0]) / u_last
    assert 2.0 < t_t < 20.0, t_t
    assert 1 / 1.5 < t_t / t_j < 1.5, (t_t, t_j)
    post = _np(res_t.thetas[200:]).reshape(-1, 2)
    np.testing.assert_allclose(post.mean(0), [0.0, 0.0], atol=0.25)
    np.testing.assert_allclose(post.std(0), [1.0, 3.0], rtol=0.2)
    post_j = np.asarray(res_j.thetas[200:]).reshape(-1, 2)
    np.testing.assert_allclose(post.std(0), post_j.std(0), rtol=0.2)
    accept = float(res_t.stats["acceptance_rate"][200:].mean())
    accept_j = float(np.asarray(res_j.stats["acceptance_rate"])[200:].mean())
    assert 0.4 < accept <= 1.0 and abs(accept - accept_j) < 0.15
    eps = float(res_t.stats["step_size"][-1, 0])
    assert 0.05 < eps < 5.0
    assert res_t.final_state[5].count == 200


def test_tau_schedule_applies_in_warmup_only():
    n_samples, n_adapts = 120, 60
    sched = np.ones(n_samples)
    sched[n_adapts:] = 100.0    # would 100× the draws' trajectories
    res, _ = _anisotropic_runs(5, n_samples, n_adapts, t_schedule=sched)
    t_final = float(torch.exp(res.final_state[5].log_t_avg))
    tl_post = _np(res.stats["trajectory_length"][n_adapts:])
    assert tl_post.max() <= t_final * 1.0001, (tl_post.max(), t_final)
    # and the warmup's τ is the schedule's multiple of u·T
    assert float(res.stats["trajectory_length"][:n_adapts].max()) > \
        tl_post.max()


def test_drop_warmup_and_one_step_count_for_all_chains():
    s2 = np.asarray([1.0, 9.0])
    theta0 = torch.from_numpy(
        0.1 * np.random.default_rng(9).normal(size=(64, 2)))
    res = ah.sample_chees(torch.Generator().manual_seed(4),
                          ah.mvn_diag(s2, dtype=F64, device="cpu"), theta0,
                          60, 30, drop_warmup=True, t_schedule="sweep",
                          device="cpu")
    assert res.thetas.shape == (30, 64, 2)
    assert res.warmup_stats is not None
    assert res.warmup_stats["is_adapt"].all()
    assert not res.stats["is_adapt"].any()
    for st in (res.stats, res.warmup_stats):
        ns = st["n_steps"]
        assert torch.equal(ns, ns[:, :1].expand_as(ns))
    with pytest.raises(ValueError):
        ah.sample_chees(torch.Generator(), ah.mvn_diag(s2, dtype=F64,
                                                       device="cpu"),
                        theta0[0], 10, 5, device="cpu")


def test_chees_noncentered_funnel():
    """tests/test_chees.py's non-centered funnel gate: ChEES at its
    defaults on `neal_funnel_nc`, draws mapped back to the centered
    funnel."""
    theta0 = torch.from_numpy(
        0.1 * np.random.default_rng(1).normal(size=(512, 10)))
    res = ah.sample_chees(torch.Generator().manual_seed(0),
                          ah.neal_funnel_nc(10, device="cpu"), theta0, 768,
                          512, init_t=4.0, drop_warmup=True, device="cpu")
    cen = _np(ah.funnel_nc_to_centered(res.thetas))
    v = cen[:, :, 0].ravel()
    assert abs(v.mean()) < 0.2, v.mean()
    assert abs(v.std() - 3.0) < 0.3, v.std()
    assert np.abs(cen[:, :, 1:].mean((0, 1))).max() < 0.3

"""The static-HMC family of the port against the JAX package.

* `_num_static_steps` against JAX's, scalar and per-chain ε.
* Each integrator's `step` against JAX's on the same (z, ε, step index,
  n_steps) in float64 to 1e-10: plain, jittered (given JAX's uniform),
  tempered at every index (and per-chain indices and counts), `yoshida4`
  and a `SolverIntegrator` stepper; `PartialMomentumRefreshment` given G.
* `transition_static` with endpoint sampling against JAX's given the
  momenta and the Exp(1) draws, fixed steps and fixed integration time
  (per-chain counts), to 1e-10.
* Static multinomial selection frequencies ∝ exp(−H) over the random
  splits, as tests/test_trajectory_dist.py checks JAX's; a coupled split.
* The constructors equal to JAX's field by field; `SamplerConfig.sample`
  bitwise `sample`; `HMC` and `HMCDA` in law against JAX on a 5-D Gaussian;
  the jittered ε per chain on NUTS's step and fused paths; `as_target`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import trajectory as traj_j
from advancedhmc_tpu import utils as uj
from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)

import advancedhmc_torch as ah
from advancedhmc_torch import convert
from advancedhmc_torch import trajectory as traj_t

torch.set_num_threads(2)

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-12)
N, P = 200, 9
DIM = P + 1
C = 12


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _models():
    m_inv = np.linspace(0.5, 2.0, DIM)
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(
        jnp.asarray(m_inv)), target=jax_logistic(n=N, p=P, dtype=jnp.float64))
    ht = ah.Hamiltonian(metric=convert.diag_metric(m_inv, "cpu"),
                        target=ah.hierarchical_logistic(n=N, p=P, dtype=F64,
                                                        device="cpu"))
    return hj, ht


def _points(hj, seed=0, c=C):
    rng = np.random.default_rng(seed)
    zj = jax.vmap(hj.phasepoint)(jnp.asarray(0.3 * rng.normal(size=(c, DIM))),
                                 jnp.asarray(rng.normal(size=(c, DIM))))
    return zj, convert.phasepoint(zj, "cpu")


def _close_z(zt, zj):
    for f in ("theta", "r", "logdensity", "grad", "neg_k"):
        np.testing.assert_allclose(_np(getattr(zt, f)),
                                   np.asarray(getattr(zj, f)), **TOL,
                                   err_msg=f)


def test_num_static_steps_matches_jax():
    eps = np.asarray([0.3, 0.25, 1e-9, 7.0, 0.1, np.float64(1.3) / 4])
    for crit_j in (aj.FixedNSteps(7), aj.FixedIntegrationTime(1.0, 64),
                   aj.FixedIntegrationTime(1.3, 5)):
        crit_t = convert.criterion(crit_j)
        for e in (eps, eps[0]):
            tj = aj.Trajectory(aj.Leapfrog(step_size=jnp.asarray(0.1)),
                               crit_j, ts_kind="endpoint")
            n_j = jax.vmap(lambda x: traj_j._num_static_steps(
                tj.with_nom_step_size(x))[1])(jnp.atleast_1d(e))
            tt = ah.Trajectory(ah.Leapfrog(step_size=torch.tensor(e)),
                               crit_t, ts_kind="endpoint")
            bound_t, n_t = traj_t._num_static_steps(tt)
            assert bound_t == traj_j._num_static_steps(tj)[0]
            assert n_t.dtype == torch.int32
            np.testing.assert_array_equal(
                np.broadcast_to(_np(n_t), np.shape(n_j)), np.asarray(n_j))


def _position_verlet(q, p, eps, grad_fn, velocity_fn):
    """A symmetric stepper written once for both packages: position Verlet
    (drift, kick, drift)."""
    q = q + 0.5 * eps * velocity_fn(p)
    p = p + eps * grad_fn(q)
    q = q + 0.5 * eps * velocity_fn(p)
    return q, p


def _integrators():
    """(name, JAX integrator, port integrator) at template step size 0.2."""
    e = 0.2
    return [
        ("leapfrog", aj.Leapfrog(step_size=jnp.asarray(e)),
         ah.Leapfrog(step_size=torch.tensor(e, dtype=F64))),
        ("tempered", aj.TemperedLeapfrog(step_size=jnp.asarray(e),
                                         alpha=1.21),
         ah.TemperedLeapfrog(step_size=torch.tensor(e, dtype=F64),
                             alpha=1.21)),
        ("yoshida4", aj.ComposedLeapfrog.yoshida4(e),
         ah.ComposedLeapfrog.yoshida4(torch.tensor(e, dtype=F64))),
        ("solver", aj.SolverIntegrator(step_size=jnp.asarray(e),
                                       stepper=_position_verlet),
         ah.SolverIntegrator(step_size=torch.tensor(e, dtype=F64),
                             stepper=_position_verlet)),
    ]


@pytest.mark.parametrize("which", range(4))
def test_integrator_steps_match_jax(which):
    name, ij, it = _integrators()[which]
    hj, ht = _models()
    zj, zt = _points(hj, 1)
    eps = np.linspace(-0.3, 0.25, C)          # signed, per chain
    n_steps = 3
    for i in range(n_steps):
        sj = jax.vmap(lambda z, e: ij.step(hj, z, e, step_index=i,
                                           n_steps=n_steps))(
            zj, jnp.asarray(eps))
        st = it.step(ht, zt, torch.from_numpy(eps), step_index=i,
                     n_steps=n_steps)
        _close_z(st, sj)
        zj, zt = sj, st
    if name == "tempered":
        # per-chain step indices and counts, as a multinomial split gives
        idx = np.arange(C) % 4
        cnt = 1 + np.arange(C) % 5
        sj = jax.vmap(lambda z, e, i, n: ij.step(hj, z, e, step_index=i,
                                                 n_steps=n))(
            zj, jnp.asarray(eps), jnp.asarray(idx), jnp.asarray(cnt))
        st = it.step(ht, zt, torch.from_numpy(eps),
                     step_index=torch.from_numpy(idx),
                     n_steps=torch.from_numpy(cnt))
        _close_z(st, sj)
        for k in range(4):
            for half in (True, False):
                np.testing.assert_array_equal(
                    _np(it.temper_scale(k, half, 3)),
                    np.asarray(ij.temper_scale(k, half, 3)))


def test_jitter_matches_jax_given_u():
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    eps0 = np.linspace(0.1, 0.5, C)
    jj = jax.vmap(lambda k, e: aj.JitteredLeapfrog.create(e, 0.2).jitter(
        k).current_step_size)(keys, jnp.asarray(eps0))
    u = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float64))(keys)
    it = ah.JitteredLeapfrog.create(torch.from_numpy(eps0), 0.2)
    jt = it.with_jitter(torch.from_numpy(np.asarray(u)))
    np.testing.assert_allclose(_np(jt.current_step_size), np.asarray(jj),
                               **TOL)
    np.testing.assert_array_equal(_np(jt.nom_step_size), eps0)
    # the step at the jittered size is plain leapfrog's at that size
    hj, ht = _models()
    zj, zt = _points(hj, 2)
    sj = jax.vmap(lambda z, e: aj.leapfrog_step(
        aj.Leapfrog(step_size=e), hj, z, e))(zj, jj)
    _close_z(jt.step(ht, zt, jt.current_step_size), sj)
    # drawn from a generator: inside the bounds, one per chain
    g = torch.Generator().manual_seed(0)
    e = it.jitter(g).current_step_size
    assert e.shape == (C,)
    assert bool(((e >= 0.8 * it.step_size0) & (e <= 1.2 * it.step_size0))
                .all())
    shared = ah.JitteredLeapfrog.create(torch.tensor(0.5, dtype=F64), 0.2)
    assert shared.jitter(g, 64).current_step_size.unique().numel() == 64


def test_partial_refreshment_matches_jax_given_g():
    hj, ht = _models()
    zj, zt = _points(hj, 3)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    ref = aj.PartialMomentumRefreshment(alpha=0.7)
    out_j = jax.vmap(lambda k, z: ref.refresh(k, hj, z))(keys, zj)
    g = jax.vmap(hj.rand_momentum)(keys)
    out_t = convert.refreshment(ref).mix(ht, zt,
                                         torch.from_numpy(np.asarray(g)))
    _close_z(out_t, out_j)
    # drawn from a generator it keeps the chains' positions and caches
    r = ah.PartialMomentumRefreshment(0.7).refresh(torch.Generator(), ht, zt)
    assert torch.equal(r.theta, zt.theta) and torch.equal(r.grad, zt.grad)


@pytest.mark.parametrize("crit", ["fixed_n", "fixed_time"])
@pytest.mark.parametrize("which", [0, 1])
def test_endpoint_transition_matches_jax(crit, which, monkeypatch):
    name, ij, it = _integrators()[which]
    hj, ht = _models()
    zj, zt = _points(hj, 4)
    crit_j = (aj.FixedNSteps(5) if crit == "fixed_n"
              else aj.FixedIntegrationTime(1.3, 64))
    eps = np.linspace(0.08, 0.6, C)       # per chain: per-chain counts
    keys = jax.random.split(jax.random.PRNGKey(6), C)
    tj = aj.Trajectory(ij, crit_j, ts_kind="endpoint")

    def one(k, e, z):
        return traj_j.transition_static(k, hj, tj.with_nom_step_size(e), z)

    z_j, st_j = jax.vmap(one)(keys, jnp.asarray(eps), zj)
    e = jax.vmap(lambda k: uj.rand_exponential(
        jax.random.split(k)[1], dtype=jnp.float64))(keys)
    monkeypatch.setattr(traj_t, "rand_exponential",
                        lambda *a: torch.from_numpy(np.asarray(e)))
    tt = ah.Trajectory(it, convert.criterion(crit_j), ts_kind="endpoint")
    z_t, st_t = ah.transition_static(
        torch.Generator(), ht, tt.with_nom_step_size(torch.from_numpy(eps)),
        zt)
    _close_z(z_t, z_j)
    for k, v in st_j.items():
        np.testing.assert_allclose(_np(st_t[k]).astype(np.float64),
                                   np.asarray(v).astype(np.float64), **TOL,
                                   err_msg=k)
    acc = _np(st_t["is_accept"])
    assert 0 < acc.sum() < C, acc      # both branches of the MH step


def _fan(ht, z0, eps, n):
    """Energies and θ of the points n steps backward and forward of z0."""
    pts = {0: z0}
    for sign in (1, -1):
        z = z0
        for k in range(1, n + 1):
            z = ah.leapfrog_step(ht, z, sign * eps)
            pts[sign * k] = z
    return {k: (float(z.theta[0, 0]), float(z.energy()[0]))
            for k, z in pts.items()}


def _leaves(z):
    return [getattr(z, f) for f in ("theta", "r", "logdensity", "grad",
                                    "neg_k")]


def _first(z, c):
    return ah.PhasePoint(*(v[:c] for v in _leaves(z)))


def test_static_multinomial_selection_is_weight_proportional():
    tgt = ah.std_gaussian(1, device="cpu")
    ht = ah.Hamiltonian(metric=ah.make_metric("unit", 1, F64, device="cpu"),
                        target=tgt)
    n_chains, n_steps, eps = 40000, 3, 0.9
    z0 = ht.phasepoint(torch.ones(1, 1, dtype=F64),
                       torch.full((1, 1), 0.5, dtype=F64))
    fan = _fan(ht, z0, eps, n_steps)
    h0 = fan[0][1]
    # exact law: a split n_fwd uniform on 0..L, then ∝ exp(−H) on its points
    probs, alphas = {k: 0.0 for k in fan}, []
    for n_fwd in range(n_steps + 1):
        span = range(-(n_steps - n_fwd), n_fwd + 1)
        w = {k: np.exp(-fan[k][1]) for k in span}
        for k in span:
            probs[k] += w[k] / sum(w.values()) / (n_steps + 1)
        alphas.append(np.mean([min(1.0, np.exp(h0 - fan[k][1]))
                               for k in span]))
    zs = ah.PhasePoint(*(v.expand(n_chains, *v.shape[1:])
                         for v in _leaves(z0)))
    traj = ah.Trajectory(ah.Leapfrog(step_size=torch.tensor(eps, dtype=F64)),
                         ah.FixedNSteps(n_steps), ts_kind="multinomial")
    z1, st = ah.transition_static(torch.Generator().manual_seed(2), ht, traj,
                                  zs)
    th = _np(z1.theta[:, 0])
    total = 0.0
    for k, (theta_k, _) in fan.items():
        freq = np.mean(np.abs(th - theta_k) < 1e-12)
        total += freq
        assert abs(freq - probs[k]) < 0.01, (k, freq, probs[k])
    assert total > 0.9999      # every candidate is a point of the fan
    # α is the trajectory mean of min(1, exp(H0 − H)) over the chain's split
    a = _np(st["acceptance_rate"])
    assert np.min(np.abs(a[:, None] - np.asarray(alphas)[None]), 1).max() \
        < 1e-12
    # a coupled split: every chain's candidate lies in one split's points
    zc, _ = ah.transition_static(torch.Generator().manual_seed(3), ht, traj,
                                 _first(zs, 4096),
                                 coupled_key=torch.Generator().manual_seed(9))
    ks = {k for k, (theta_k, _) in fan.items()
          if bool((zc.theta[:, 0] - theta_k).abs().lt(1e-12).any())}
    assert max(ks) - min(ks) <= n_steps, ks


def _fields(obj):
    """The fields of a (JAX or port) dataclass as plain values, nested."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _fields(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, (torch.Tensor, jax.Array)):
        return float(_np(obj))
    return obj


@pytest.mark.parametrize("make", [
    lambda m: m.NUTS(),
    lambda m: m.NUTS(0.65, max_depth=7, delta_max=500.0,
                     integrator="jitteredleapfrog", metric="unit",
                     init_eps=0.3),
    lambda m: m.NUTS(integrator="temperedleapfrog", metric="dense"),
    lambda m: m.NUTS(integrator="yoshida4", metric="nutpie"),
    lambda m: m.HMC(),
    lambda m: m.HMC(0.05, 25, ts_kind="multinomial", metric="unit"),
    lambda m: m.HMCDA(),
    lambda m: m.HMCDA(0.65, 2.5, integrator="jittered", max_steps=64,
                      init_eps=0.02),
])
def test_constructors_match_jax_field_by_field(make):
    assert _fields(make(ah)) == _fields(make(aj))


def _gauss4(c=8, seed=5):
    tgt = ah.std_gaussian(4, device="cpu")
    th0 = torch.from_numpy(0.3 * np.random.default_rng(seed).normal(
        size=(c, 4)))
    return tgt, th0


@pytest.mark.parametrize("cfg", [ah.NUTS(0.8, max_depth=5),
                                 ah.HMCDA(0.8, 1.0)])
def test_sampler_config_sample_is_sample_bitwise(cfg):
    tgt, th0 = _gauss4()
    kw = dict(n_adapts=15, drop_warmup=True, device="cpu")
    a = cfg.sample(torch.Generator().manual_seed(3), tgt, th0, 30,
                   dtype=F64, **kw)
    b = ah.sample(torch.Generator().manual_seed(3), tgt, cfg.kernel,
                  ah.make_metric("diagonal", 4, F64, device="cpu"), th0, 30,
                  adaptor=cfg.adaptor, **kw)
    assert torch.equal(a.thetas, b.thetas)
    assert a.stats.keys() == b.stats.keys()
    for k in a.stats:
        assert torch.equal(a.stats[k], b.stats[k]), k
    # a bare batched callable through as_target, and the queued estimators
    c = cfg.sample(torch.Generator().manual_seed(3),
                   lambda x: -0.5 * torch.sum(x * x, -1), th0, 30, dim=4,
                   dtype=F64, **kw)
    assert c.thetas.shape == a.thetas.shape
    assert ah.as_target(tgt) is tgt
    with pytest.raises(ValueError):
        ah.as_target(lambda x: x)
    with pytest.raises(TypeError):
        ah.as_target(3)


VARS5 = np.asarray([1.0, 0.5, 2.0, 1.5, 0.8])


def _law_runs(cfg_t, cfg_j, n_samples, n_adapts, init_eps):
    th0 = 0.3 * np.random.default_rng(1).normal(size=(64, 5))
    rt = cfg_t.sample(torch.Generator().manual_seed(0),
                      ah.mvn_diag(VARS5, dtype=F64, device="cpu"),
                      torch.from_numpy(th0), n_samples, n_adapts=n_adapts,
                      init_eps=init_eps, dtype=F64, device="cpu")
    rj = cfg_j.sample(jax.random.PRNGKey(0), aj.models.mvn_diag(VARS5),
                      jnp.asarray(th0), n_samples, n_adapts=n_adapts,
                      init_eps=init_eps, dtype=jnp.float64)
    return rt, rj


@pytest.mark.parametrize("which", ["hmc", "hmcda"])
def test_hmc_and_hmcda_match_jax_in_law(which):
    if which == "hmc":
        rt, rj = _law_runs(ah.HMC(0.4, 6), aj.HMC(0.4, 6), 300, 0, 0.4)
        keep = slice(50, None)
    else:
        rt, rj = _law_runs(ah.HMCDA(0.8, 1.5), aj.HMCDA(0.8, 1.5), 300, 150,
                           None)
        keep = slice(150, None)
    for res, th, st in ((rt, _np(rt.thetas), rt.stats),
                        (rj, np.asarray(rj.thetas), rj.stats)):
        draws = th[keep].reshape(-1, 5)
        np.testing.assert_allclose(draws.mean(0), 0.0, atol=0.2)
        np.testing.assert_allclose(draws.std(0), np.sqrt(VARS5), rtol=0.15)
        assert float(np.mean(_np(st["numerical_error"]))) == 0.0
    acc_t = float(_np(rt.stats["acceptance_rate"])[keep].mean())
    acc_j = float(np.asarray(rj.stats["acceptance_rate"])[keep].mean())
    assert abs(acc_t - acc_j) < 0.1, (acc_t, acc_j)
    if which == "hmcda":
        assert abs(acc_t - 0.8) < 0.1 and abs(acc_j - 0.8) < 0.1
        eps_t = float(np.median(_np(rt.final_state.adapt.da.eps)))
        eps_j = float(np.median(np.asarray(rj.final_state.adapt.da.eps)))
        assert 0.7 < eps_t / eps_j < 1.4, (eps_t, eps_j)
        ns = _np(rt.stats["n_steps"])[keep]
        e = _np(rt.stats["step_size"])[keep]
        np.testing.assert_array_equal(ns, np.maximum(
            1, np.floor(1.5 / e)).astype(np.int32))


def test_jittered_nuts_step_and_fused_paths():
    """A jittered ε per chain on both NUTS paths: inside ε0(1 ± 0.1), one
    per chain and transition; the fused loop redraws it at every
    transition boundary, its first transition at the nominal ε as in
    JAX; the nominal ε is reported apart."""
    tgt, th0 = _gauss4(c=16)
    cfg = ah.NUTS(0.8, max_depth=5, integrator="jitteredleapfrog")
    for fuse in (0, 8):
        res = cfg.sample(torch.Generator().manual_seed(1), tgt, th0, 24,
                         n_adapts=0, init_eps=0.4, cross_chain=True,
                         fuse_draws=fuse, dtype=F64, device="cpu")
        e = _np(res.stats["step_size"])
        assert (_np(res.stats["nom_step_size"]) == 0.4).all()
        if fuse:
            first = np.arange(24) % fuse == 0
            assert (e[first] == 0.4).all()
            e = e[~first]
        assert ((e >= 0.4 * 0.9) & (e <= 0.4 * 1.1)).all()
        assert len(np.unique(e)) == e.size
        assert bool(torch.isfinite(res.thetas).all())
    # partial refreshment runs on both paths too
    kernel = ah.HMCKernel(cfg.kernel.trajectory,
                          ah.PartialMomentumRefreshment(0.5))
    for fuse in (0, 4):
        res = ah.sample(torch.Generator().manual_seed(2), tgt, kernel,
                        ah.make_metric("diagonal", 4, F64, device="cpu"),
                        th0, 16, init_eps=0.4, fuse_draws=fuse,
                        device="cpu")
        assert bool(torch.isfinite(res.thetas).all())


@pytest.mark.parametrize("which", [1, 2])
def test_nuts_with_other_integrators_matches_jax_forced(which):
    """NUTS with the tempered and the composed integrator (each leaf one
    `integrator.step`, as in JAX) under forced directions: the tree's
    deterministic statistics equal JAX's in float64."""
    name, ij, it = _integrators()[which]
    hj, ht = _models()
    zj, zt = _points(hj, 7, c=6)
    dirs = np.asarray([1, -1, 1, 1, -1])
    crit = dict(max_depth=5, delta_max=1000.0)
    tj = aj.Trajectory(ij.with_nom_step_size(jnp.asarray(0.15)),
                       aj.GeneralisedNoUTurn(**crit))
    tt = ah.Trajectory(it.with_nom_step_size(torch.tensor(0.15, dtype=F64)),
                       ah.GeneralisedNoUTurn(**crit))
    keys = jax.random.split(jax.random.PRNGKey(8), 6)
    _, st_j = jax.vmap(lambda k, z: aj.nuts_transition(
        k, hj, tj, z, force_directions=dirs))(keys, zj)
    _, st_t = ah.nuts_transition(torch.Generator(), ht, tt, zt,
                                 force_directions=dirs)
    for k in ("n_steps", "tree_depth", "numerical_error"):
        np.testing.assert_array_equal(_np(st_t[k]), np.asarray(st_j[k]),
                                      err_msg=k)
    for k in ("acceptance_rate", "max_hamiltonian_energy_error"):
        np.testing.assert_allclose(_np(st_t[k]), np.asarray(st_j[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)

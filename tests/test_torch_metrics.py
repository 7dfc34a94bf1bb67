"""The dense and rank-update metrics, the mass-matrix estimators and the
adaptation steps against the JAX package.

Deterministic pieces get the same numpy inputs on both sides in float64:
the metrics' velocity, kinetic energy, momenta (from the JAX package's own
normals, with its factors carried by `convert`), `renew` and
`m_inv_matrix` to 1e-12; every estimator's push, push_batch,
update_estimate and reset (dense estimates to 1e-10, the low-rank estimate
by `m_inv_matrix()`, which does not see the eigenvectors' signs, to 1e-8);
and `adapt_step`, `adapt_step_batch` and `adapt_step_masked` over a short
Stan schedule for every estimator. The momentum draws are held to M by
their covariance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import metrics as metrics_j
from advancedhmc_tpu.adaptation import massmatrix as mm_j
from advancedhmc_tpu.adaptation import stan as stan_j
from advancedhmc_tpu.models import std_gaussian as std_gaussian_j

import advancedhmc_torch as ah
from advancedhmc_torch import convert

torch.set_num_threads(2)

DIM, C = 6, 5
EXACT = dict(rtol=1e-12, atol=1e-12)


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               **(tol or EXACT))


def _spd(rng, dim=DIM):
    a = rng.normal(size=(dim, dim))
    return a @ a.T / dim + np.diag(np.linspace(0.5, 2.0, dim))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_metrics(rng):
    """(name, JAX metric, per chain) of every new metric kind."""
    dense = metrics_j.DenseEuclideanMetric.create(jnp.asarray(_spd(rng)))
    mats = np.stack([_spd(rng) for _ in range(C)])
    per_chain = jax.vmap(metrics_j.DenseEuclideanMetric.create)(
        jnp.asarray(mats))
    a = np.exp(rng.normal(size=DIM))
    out = [("dense", dense, False), ("dense per chain", per_chain, True)]
    for k in (0, 2, DIM):
        b = rng.normal(size=(DIM, k))
        dm = np.diag(rng.uniform(0.3, 2.0, size=k))
        out.append((f"rank_update k={k}",
                    metrics_j.RankUpdateEuclideanMetric.create(
                        jnp.asarray(a), jnp.asarray(b), jnp.asarray(dm)),
                    False))
    return out


@pytest.mark.parametrize("case", range(5))
def test_metric_matches_jax(case):
    rng = np.random.default_rng(case)
    name, mj, per_chain = _jax_metrics(rng)[case]
    mt = convert.metric(mj, "cpu")
    r = rng.normal(size=(C, DIM))
    keys = jax.random.split(jax.random.PRNGKey(case), C)
    z = jax.vmap(lambda k: jax.random.normal(k, (DIM,), jnp.float64))(keys)
    if per_chain:
        vel = jax.vmap(lambda m, x: m.velocity(x))(mj, jnp.asarray(r))
        nk = jax.vmap(lambda m, x: m.neg_kinetic_energy(x))(mj, jnp.asarray(r))
        mom = jax.vmap(lambda m, k: m.rand_momentum(k))(mj, keys)
    else:
        vel = jax.vmap(mj.velocity)(jnp.asarray(r))
        nk = jax.vmap(mj.neg_kinetic_energy)(jnp.asarray(r))
        mom = jax.vmap(mj.rand_momentum)(keys)
    _close(mt.velocity(_t(r)), vel)
    _close(mt.neg_kinetic_energy(_t(r)), nk)
    _close(mt.momentum_from_normals(_t(z)), mom)
    mat_j = (jax.vmap(lambda m: m.m_inv_matrix())(mj) if per_chain
             else mj.m_inv_matrix())
    _close(mt.m_inv_matrix(), mat_j)
    # a metric built by the port from M⁻¹ alone: the same M⁻¹ and, for the
    # dense metric, the same factor (the rank update's Q is signed by its
    # QR, so it is held by what it computes)
    if name.startswith("dense"):
        built = ah.DenseEuclideanMetric.create(_t(mj.m_inv))
        _close(built.chol_u, mj.chol_u, rtol=1e-12, atol=1e-13)
        _close(built.momentum_from_normals(_t(z)), mom)
    else:
        built = ah.RankUpdateEuclideanMetric.create(
            _t(mj.a_diag), _t(mj.b), _t(mj.d))
        r_b = built.momentum_from_normals(_t(z))
        # Q's columns are signed by the QR, so the momenta agree with JAX's
        # in law only; hold the factors: Q orthogonal, VᵀV = I + R D Rᵀ
        q, v = built.q_full.numpy(), built.v_upper.numpy()
        _close(q @ q.T, np.eye(DIM), rtol=0, atol=1e-12)
        k = mj.b.shape[-1]
        if k:
            rr = np.linalg.qr(np.asarray(mj.b) / np.sqrt(
                np.asarray(mj.a_diag))[:, None], mode="complete")[1][:k]
            _close(v.T @ v, np.eye(k) + rr @ np.asarray(mj.d) @ rr.T,
                   rtol=1e-12, atol=1e-12)
        assert torch.isfinite(r_b).all()


@pytest.mark.parametrize("case", range(5))
def test_metric_renew_matches_jax(case):
    rng = np.random.default_rng(10 + case)
    name, mj, per_chain = _jax_metrics(rng)[case]
    mt = convert.metric(mj, "cpu")
    if name.startswith("dense"):
        new = (np.stack([_spd(rng) for _ in range(C)]) if per_chain
               else _spd(rng))
        rj = (jax.vmap(lambda m, x: m.renew(x))(mj, jnp.asarray(new))
              if per_chain else mj.renew(jnp.asarray(new)))
        rt = mt.renew(_t(new))
        assert isinstance(rt, ah.DenseEuclideanMetric)
        _close(rt.m_inv, rj.m_inv)
        _close(rt.chol_u, rj.chol_u, rtol=1e-12, atol=1e-13)
        return
    k = mt.rank
    a = np.exp(rng.normal(size=DIM))
    b = rng.normal(size=(DIM, k))
    d = rng.uniform(-0.5, 2.0, size=k)
    for new_j, new_t in (
            # the low-rank estimator's triple, d as a vector and a matrix
            ((jnp.asarray(a), jnp.asarray(b), jnp.asarray(d)),
             (_t(a), _t(b), _t(d))),
            ((jnp.asarray(a), jnp.asarray(b), jnp.diag(jnp.asarray(d))),
             (_t(a), _t(b), torch.diag(_t(d)))),
            # a plain diagonal keeps the rank with B = 0
            (jnp.asarray(a), _t(a))):
        rj, rt = mj.renew(new_j), mt.renew(new_t)
        assert isinstance(rt, ah.RankUpdateEuclideanMetric)
        assert rt.rank == rj.rank == k
        _close(rt.m_inv_matrix(), rj.m_inv_matrix())
        r = rng.normal(size=(C, DIM))
        _close(rt.velocity(_t(r)), jax.vmap(rj.velocity)(jnp.asarray(r)))


@pytest.mark.parametrize("make", [
    lambda: ah.DenseEuclideanMetric.create(torch.from_numpy(
        np.eye(4) * 1.5 + 0.3 * np.ones((4, 4)))),
    lambda: ah.RankUpdateEuclideanMetric.create(
        torch.tensor([0.5, 1.0, 2.0, 1.5], dtype=torch.float64),
        torch.from_numpy(np.random.default_rng(1).normal(size=(4, 2))),
        torch.diag(torch.tensor([2.0, 0.4], dtype=torch.float64))),
])
def test_momentum_covariance_is_the_mass_matrix(make):
    """r ~ N(0, M): the covariance of 2¹⁶ draws within 3 % (Frobenius,
    relative) of the inverse of M⁻¹."""
    metric = make()
    r = metric.rand_momentum(torch.Generator().manual_seed(0), 1 << 16)
    emp = np.cov(r.numpy().T)
    m = np.linalg.inv(metric.m_inv_matrix().numpy())
    assert np.linalg.norm(emp - m) / np.linalg.norm(m) < 0.03


def test_cholesky_failure_gives_nan_without_raising():
    """As `jnp.linalg.cholesky`: a matrix that is not positive definite
    gives a factor of NaNs (on and above U's diagonal); a batch fails only
    where it must."""
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    good = torch.eye(2, dtype=torch.float64)
    m = ah.DenseEuclideanMetric.create(torch.stack([bad, good]))
    uj = metrics_j.DenseEuclideanMetric.create(jnp.asarray(bad.numpy())).chol_u
    _close(m.chol_u[0], uj, rtol=0, atol=0, equal_nan=True)
    _close(m.chol_u[1], np.eye(2))


# --------------------------------------------------------------- estimators
def _estimators(rng):
    """(name, JAX init, port init, per chain, takes gradients)."""
    return [
        ("welford_cov", lambda: mm_j.WelfordCovState.init(DIM, jnp.float64),
         lambda n=None: ah.WelfordCovState.init(DIM, torch.float64, "cpu",
                                                n_chains=n), True, False),
        ("lowrank", lambda: mm_j.LowRankCovState.init(DIM, jnp.float64,
                                                      rank=3),
         lambda n=None: ah.LowRankCovState.init(DIM, torch.float64, "cpu",
                                                rank=3), False, False),
        ("nutpie", lambda: mm_j.NutpieVarState.init(DIM, jnp.float64),
         lambda n=None: ah.NutpieVarState.init(DIM, torch.float64, "cpu",
                                               n_chains=n), True, True),
    ]


def _estimate(st):
    """The estimate as a matrix (a low-rank one, shared or per chain, as
    diag(A) + B·D·Bᵀ, which does not see the eigenvectors' signs)."""
    if isinstance(st, (mm_j.LowRankCovState, ah.LowRankCovState)):
        a, b, d = (np.asarray(x) for x in st.m_inv)
        return a[..., :, None] * np.eye(a.shape[-1]) \
            + (b * d[..., None, :]) @ np.swapaxes(b, -1, -2)
    return np.asarray(st.m_inv)


def _sym(a):
    """½(A + Aᵀ) of a matrix estimate; a diagonal one as it is."""
    a = np.asarray(a)
    return (a + np.swapaxes(a, -1, -2)) / 2 if a.ndim >= 2 and \
        a.shape[-1] == a.shape[-2] == DIM else a


@pytest.mark.parametrize("which", range(3))
def test_estimator_matches_jax(which):
    rng = np.random.default_rng(20 + which)
    name, init_j, init_t, per_chain, grads = _estimators(rng)[which]
    cov = _spd(rng)
    xs = rng.multivariate_normal(np.zeros(DIM), cov, size=60)
    gs = -xs @ np.linalg.inv(cov)
    args_j = (lambda i, j: (jnp.asarray(xs[i:j]), jnp.asarray(gs[i:j]))
              if grads else (jnp.asarray(xs[i:j]),))
    args_t = (lambda i, j: (_t(xs[i:j]), _t(gs[i:j])) if grads
              else (_t(xs[i:j]),))
    tol = dict(rtol=1e-8, atol=1e-10) if name == "lowrank" \
        else dict(rtol=1e-10, atol=1e-12)
    # shared: two batches, the estimate, a reset, a single-sample push
    sj = init_j().push_batch(*args_j(0, 25)).push_batch(*args_j(25, 60))
    st = init_t().push_batch(*args_t(0, 25)).push_batch(*args_t(25, 60))
    assert int(st.n) == int(sj.n) == 60
    sj, st = sj.update_estimate(), st.update_estimate()
    _close(_sym(_estimate(st)), _sym(_estimate(sj)), **tol)
    sj, st = sj.reset(), st.reset()
    assert int(st.n) == 0
    _close(_sym(_estimate(st)), _sym(_estimate(sj)), **tol)
    sj = sj.push(*(a[0] for a in args_j(0, 1)))
    st = st.push(*(a[0] for a in args_t(0, 1)))
    for f in ("mean", "m2"):
        obj_t = st.position if grads else st
        obj_j = sj.position if grads else sj
        _close(getattr(obj_t, f), getattr(obj_j, f))
    if not per_chain:
        return
    # per chain: each chain pushes its own row, C chains, 12 samples each
    pj = jax.vmap(lambda _: init_j())(jnp.arange(C))
    pt = init_t(C)
    for s in range(12):
        lo = s * C
        pj = jax.vmap(lambda m, *a: m.push(*a))(pj, *args_j(lo, lo + C))
        pt = pt.push(*args_t(lo, lo + C))
    pj = jax.vmap(lambda m: m.update_estimate())(pj)
    pt = pt.update_estimate()
    assert tuple(pt.n.shape) == (C,)
    _close(_sym(pt.m_inv), _sym(pj.m_inv), **tol)


def test_dense_shrinkage_goes_on_the_diagonal():
    """Stan's 1e-3·5/(n+5) is added to the diagonal of a covariance
    estimate only (a scalar broadcast would add it to every entry)."""
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(400, 3)) @ rng.normal(size=(3, 3)).T
    st = ah.WelfordCovState.init(3, torch.float64, "cpu")
    for x in xs:
        st = st.push(_t(x))
    st = st.update_estimate()
    n = len(xs)
    want = n / ((n + 5) * (n - 1)) * np.cov(xs.T, ddof=0) * n \
        + 1e-3 * (5 / (n + 5)) * np.eye(3)
    _close(st.cov, want, rtol=1e-8, atol=0)


def test_naive_oracles_agree_with_welford():
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(50, 4)) @ rng.normal(size=(4, 4))
    nv, nc = ah.NaiveVar(), ah.NaiveCov()
    wv = ah.WelfordVarState.init(4, torch.float64, "cpu")
    wc = ah.WelfordCovState.init(4, torch.float64, "cpu")
    for x in xs:
        nv.push(_t(x))
        nc.push(_t(x))
        wv, wc = wv.push(_t(x)), wc.push(_t(x))
    _close(wv.m2.numpy() / 49, nv.estimate)
    _close(_sym(wc.m2.numpy()) / 49, nc.estimate)
    jv, jc = mm_j.NaiveVar(), mm_j.NaiveCov()
    for x in xs:
        jv.push(x)
        jc.push(x)
    _close(nv.estimate, jv.estimate)
    _close(nc.estimate, jc.estimate)
    nv.reset()
    assert nv.samples == []


def test_nutpie_estimate_is_the_variance_of_a_gaussian():
    """sqrt(var θ / var ∇) = σ² for a Gaussian (∇ = −θ/σ²)."""
    rng = np.random.default_rng(3)
    sigma2 = np.asarray([0.5, 2.0, 4.0])
    th = rng.normal(size=(2000, 3)) * np.sqrt(sigma2)
    st = ah.NutpieVarState.init(3, torch.float64, "cpu")
    st = st.push_batch(_t(th), _t(-th / sigma2)).update_estimate()
    _close(st.var, sigma2, rtol=0.1, atol=0)


# -------------------------------------------------------------- adaptation
SCHEDULE = dict(init_buffer=5, term_buffer=5, window_size=5)
N_ADAPTS = 30       # windows end at iterations 10 and 25


def _flags_t(flags, t):
    return {k: bool(v[t]) for k, v in flags.items()}


@pytest.mark.parametrize("mm_kind",
                         ["welford_var", "welford_cov", "nutpie", "lowrank",
                          "unit"])
@pytest.mark.parametrize("cross_chain", [True, False])
def test_adapt_steps_match_jax(mm_kind, cross_chain):
    """`adapt_step_batch` (shared) or `adapt_step` (per chain, JAX's vmap)
    over a Stan schedule with two window ends, on the same positions,
    gradients and acceptances; then `adapt_step_masked` with each chain at
    its own iteration, for the per-chain estimators."""
    rng = np.random.default_rng(7)
    cfg_j = aj.AdaptorConfig(kind="stan", mm_kind=mm_kind, mm_rank=3,
                             **SCHEDULE)
    cfg_t = ah.AdaptorConfig(kind="stan", mm_kind=mm_kind, mm_rank=3,
                             **SCHEDULE)
    flags_j = stan_j.adapt_flags(cfg_j, N_ADAPTS, N_ADAPTS + 2)
    flags_t = ah.adapt_flags(cfg_t, N_ADAPTS, N_ADAPTS + 2)
    eps0 = 0.3 if cross_chain else np.linspace(0.2, 0.4, C)
    sj = (stan_j.AdaptState.init(cfg_j, DIM, eps0, jnp.float64)
          if cross_chain else jax.vmap(
              lambda e: stan_j.AdaptState.init(cfg_j, DIM, e, jnp.float64))(
                  jnp.asarray(eps0)))
    st = ah.AdaptState.init(cfg_t, DIM, _t(eps0), torch.float64)
    cov = _spd(rng)
    if cross_chain:
        step_j = jax.jit(lambda s, th, g, a, f: stan_j.adapt_step_batch(
            cfg_j, s, th, g, a, f))
    else:
        step_j = jax.jit(jax.vmap(
            lambda s, th, g, a, f: stan_j.adapt_step(cfg_j, s, th, g, a, f),
            in_axes=(0, 0, 0, 0, None)))
    step_t = ah.adapt_step_batch if cross_chain else ah.adapt_step
    for t in range(N_ADAPTS + 2):
        th = rng.multivariate_normal(np.zeros(DIM), cov, size=C)
        g = -th @ np.linalg.inv(cov)
        a = rng.uniform(0.3, 1.2, size=C)
        sj = step_j(sj, jnp.asarray(th), jnp.asarray(g), jnp.asarray(a),
                    {k: v[t] for k, v in flags_j.items()})
        st = step_t(cfg_t, st, _t(th), _t(g), _t(a), _flags_t(flags_t, t))
        _close(st.da.eps, sj.da.eps)
    if mm_kind != "unit":
        tol = dict(rtol=1e-8, atol=1e-10) if mm_kind == "lowrank" \
            else dict(rtol=1e-10, atol=1e-12)
        _close(_sym(_estimate(st.mm)), _sym(_estimate(sj.mm)), **tol)
        assert np.array_equal(np.asarray(st.mm.n), np.asarray(sj.mm.n))
    if cross_chain or mm_kind == "unit":
        return
    # each chain at its own iteration, only the chains in `where` stepping
    step_jm = jax.jit(jax.vmap(
        lambda s, th, g, a, f: stan_j.adapt_step(cfg_j, s, th, g, a, f)))
    for rep in range(8):
        idx = rng.integers(0, N_ADAPTS, size=C)
        idx[0] = [9, 24][rep % 2]       # a chain at a window end
        where = rng.uniform(size=C) < 0.7
        th = rng.multivariate_normal(np.zeros(DIM), cov, size=C)
        g = -th @ np.linalg.inv(cov)
        a = rng.uniform(0.3, 1.2, size=C)
        new = step_jm(sj, jnp.asarray(th), jnp.asarray(g), jnp.asarray(a),
                      {k: v[idx] for k, v in flags_j.items()})
        sj = jax.tree_util.tree_map(
            lambda n, o: jnp.where(jnp.asarray(where).reshape(
                (C,) + (1,) * (n.ndim - 1)), n, o), new, sj)
        st = ah.adapt_step_masked(
            cfg_t, st, _t(th), _t(g), _t(a),
            {k: torch.from_numpy(v[idx]) for k, v in flags_t.items()},
            torch.from_numpy(where))
        _close(st.da.eps, sj.da.eps)
        _close(_sym(_estimate(st.mm)), _sym(_estimate(sj.mm)), **tol)
    assert np.array_equal(np.asarray(st.mm.n), np.asarray(sj.mm.n))


def test_state_conversion_keeps_every_leaf():
    """`convert.hmc_state` on a per-chain dense nutpie-free state and a
    shared rank-update one: each leaf keeps its shape and bits."""
    rng = np.random.default_rng(8)
    mats = jnp.asarray(np.stack([_spd(rng) for _ in range(C)]))
    cfg = aj.AdaptorConfig(mm_kind="welford_cov")
    ad = jax.vmap(lambda e: stan_j.AdaptState.init(cfg, DIM, e, jnp.float64))(
        jnp.full((C,), 0.3))
    m = jax.vmap(metrics_j.DenseEuclideanMetric.create)(mats)
    st = convert.adapt_state(ad, "cpu")
    assert isinstance(st.mm, ah.WelfordCovState)
    assert tuple(st.mm.m2.shape) == (C, DIM, DIM)
    mt = convert.metric(m, "cpu")
    assert np.array_equal(mt.chol_u.numpy(), np.asarray(m.chol_u))
    lr = convert.mm_state(mm_j.LowRankCovState.init(DIM, jnp.float64, rank=2),
                          "cpu")
    assert isinstance(lr, ah.LowRankCovState) and lr.rank == 2
    nut = convert.mm_state(mm_j.NutpieVarState.init(DIM, jnp.float64), "cpu")
    assert isinstance(nut.gradient, ah.WelfordVarState)
    unit = convert.mm_state(mm_j.UnitMassMatrixState.init(DIM), "cpu")
    assert unit.m_inv is None and dataclasses.is_dataclass(unit)


# -------------------------------------------------- make_metric, init_state
def test_make_metric_kinds_match_jax():
    for kind, rank in (("dense", 0), ("rank_update", 0), ("rankupdate", 3)):
        mt = ah.make_metric(kind, DIM, torch.float64, device="cpu",
                            rank=rank)
        mj = aj.make_metric(kind, DIM, dtype=jnp.float64, rank=rank)
        assert type(mt).__name__ == type(mj).__name__
        _close(mt.m_inv_matrix(), mj.m_inv_matrix())
        if kind != "dense":
            assert mt.rank == mj.rank == rank
    for make in (lambda: ah.make_metric("nutpie", DIM, device="cpu"),
                 lambda: aj.make_metric("nutpie", DIM)):
        with pytest.raises(ValueError, match="unknown metric kind: 'nutpie'"):
            make()


def test_nutpie_metric_kind_is_an_estimator_as_in_jax():
    """The reference's quirk, kept: `NUTS(metric="nutpie")` adapts with the
    nutpie estimator, but `SamplerConfig.sample` then asks `make_metric`
    for a "nutpie" metric, which both packages reject with the same
    ValueError; with a diagonal metric passed, both sample."""
    tgt_t = ah.std_gaussian(3, device="cpu")
    tgt_j = std_gaussian_j(3)
    cfg_t, cfg_j = ah.NUTS(0.8, max_depth=4, metric="nutpie"), \
        aj.NUTS(0.8, max_depth=4, metric="nutpie")
    assert cfg_t.adaptor.mm_kind == cfg_j.adaptor.mm_kind == "nutpie"
    with pytest.raises(ValueError, match="unknown metric kind: 'nutpie'"):
        cfg_t.sample(torch.Generator(), tgt_t, np.zeros((4, 3)), 8,
                     device="cpu")
    with pytest.raises(ValueError, match="unknown metric kind: 'nutpie'"):
        cfg_j.sample(jax.random.PRNGKey(0), tgt_j, np.zeros((4, 3)), 8)
    res = cfg_t.sample(
        torch.Generator().manual_seed(0), tgt_t,
        torch.zeros(4, 3, dtype=torch.float64), 40, n_adapts=30,
        metric=ah.make_metric("diagonal", 3, torch.float64, device="cpu"),
        cross_chain=True, device="cpu")
    assert torch.isfinite(res.thetas).all()
    assert isinstance(res.final_state.adapt.mm, ah.NutpieVarState)


def test_init_state_sizes_the_rank_update_metric():
    """A rank-0 rank-update metric is upgraded to the adaptor's mm_rank
    (at most dim); another rank or another metric class raises, as in
    JAX."""
    tgt = ah.std_gaussian(4, device="cpu")
    kernel = ah.NUTS(max_depth=3).kernel
    gen = torch.Generator().manual_seed(0)
    th = torch.zeros(3, 4, dtype=torch.float64)

    def spec(rank):
        return ah.SampleSpec(tgt, kernel, ah.AdaptorConfig(
            mm_kind="lowrank", mm_rank=rank), cross_chain=True)

    m0 = ah.make_metric("rank_update", 4, torch.float64, device="cpu")
    st = ah.init_state(gen, spec(2), m0, th, init_eps=0.3, device="cpu")
    assert st.metric.rank == 2 and st.adapt.mm.rank == 2
    st = ah.init_state(gen, spec(9), m0, th, init_eps=0.3, device="cpu")
    assert st.metric.rank == 4
    with pytest.raises(ValueError, match="metric rank 3 != adaptor mm_rank 2"):
        ah.init_state(gen, spec(2), ah.make_metric(
            "rank_update", 4, torch.float64, device="cpu", rank=3), th,
            init_eps=0.3, device="cpu")
    with pytest.raises(ValueError, match="adapts a RankUpdateEuclideanMetric"):
        ah.init_state(gen, spec(2), ah.make_metric(
            "dense", 4, torch.float64, device="cpu"), th, init_eps=0.3,
            device="cpu")
    with pytest.raises(ValueError, match="requires a diagonal metric"):
        ah.init_state(gen, spec(2), m0, th, init_eps=0.3,
                      init_mass_matrix="gradient", device="cpu")

"""The tree walk, the fused loop and `sample()` with the dense and
rank-update metrics and the Welford-cov, low-rank and nutpie estimators.

1. `nuts_transition` under `force_directions` with a dense metric (shared
   and per chain) and a rank-update metric, from fed momenta, against the
   recursion oracle run on the JAX package's metric, to 1e-10 in float64,
   as `test_torch_nuts_oracle.py` does for the diagonal; the leaf-pair body
   bitwise the single-leaf one with these metrics.
2. Statistical gates at a small size, mirroring the JAX package's tests
   (`test_fused_warmup_cc.py`, `test_sampler.py`, `test_adaptation.py`):
   the per-chain dense fused warmup, the cross-chain low-rank warmup, nutpie
   on the step path and in the per-chain fused warmup, and the
   constructors' `metric="dense"` and `"rank_update"` end to end.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import metrics as metrics_j

import advancedhmc_torch as ah
from advancedhmc_torch import convert, nuts

from nuts_oracle import nuts_oracle
from test_torch_pair import _mismatches

torch.set_num_threads(2)

N_SEEDS = 3


def _corr_target(dim, rho):
    cov = (1 - rho) * np.eye(dim) + rho * np.ones((dim, dim))
    prec = np.linalg.inv(cov)
    pj, pt = jnp.asarray(prec), torch.as_tensor(prec)
    return (cov, lambda x: -0.5 * x @ pj @ x,
            lambda x: -0.5 * torch.sum((x @ pt) * x, -1))


def _metrics_j(kind, dim, cov, rng):
    """The JAX metric (per chain: a batch of N_SEEDS) of a case."""
    if kind == "dense":
        return metrics_j.DenseEuclideanMetric.create(jnp.asarray(cov))
    if kind == "dense per chain":
        mats = np.stack([cov * s for s in np.linspace(0.7, 1.3, N_SEEDS)])
        return jax.vmap(metrics_j.DenseEuclideanMetric.create)(
            jnp.asarray(mats))
    b = rng.normal(size=(dim, 2))
    return metrics_j.RankUpdateEuclideanMetric.create(
        jnp.asarray(np.linspace(0.5, 1.5, dim)), jnp.asarray(b),
        jnp.asarray(np.diag([0.8, 0.3])))


CASES = [("dense", 4, 0.5, 6, 0), ("dense", 4, 3.5, 6, 1),
         ("dense per chain", 5, 0.4, 7, 2), ("rank_update", 5, 0.3, 6, 3)]


@pytest.mark.parametrize("kind,dim,eps,max_depth,seed", CASES)
def test_dense_transition_matches_recursion(kind, dim, eps, max_depth, seed):
    rng = np.random.default_rng(seed)
    cov, lp_j, lp_t = _corr_target(dim, 0.6)
    mj = _metrics_j(kind, dim, cov, rng)
    per_chain = kind == "dense per chain"
    ht = ah.Hamiltonian(metric=convert.metric(mj, "cpu"),
                        target=ah.LogDensityTarget(lp_t, dim))
    crit_j = aj.GeneralisedNoUTurn(max_depth=max_depth, delta_max=1000.0)
    integ = aj.Leapfrog(step_size=jnp.asarray(eps, jnp.float64))
    traj_t = ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(eps, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=max_depth, delta_max=1000.0))
    directions = rng.choice([-1, 1], size=max_depth)
    theta0 = rng.normal(size=(N_SEEDS, dim))
    r0 = rng.normal(size=(N_SEEDS, dim))

    def h_j(c):
        m = jax.tree_util.tree_map(lambda a: a[c], mj) if per_chain else mj
        return aj.Hamiltonian(metric=m, target=aj.LogDensityTarget(lp_j, dim))

    zs = [h_j(c).phasepoint(jnp.asarray(theta0[c]), jnp.asarray(r0[c]))
          for c in range(N_SEEDS)]
    zj = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *zs)
    zt = convert.phasepoint(zj, "cpu")
    _, stats, dbg = ah.nuts_transition(torch.Generator().manual_seed(seed),
                                       ht, traj_t, zt,
                                       force_directions=directions,
                                       return_debug=True)
    for c in range(N_SEEDS):
        o = nuts_oracle(h_j(c), integ, crit_j, "multinomial", zs[c],
                        directions)
        assert int(stats["n_steps"][c]) == o["n_steps"]
        assert int(stats["tree_depth"][c]) == o["depth"]
        assert bool(stats["numerical_error"][c]) == o["diverged"]
        np.testing.assert_allclose(float(stats["acceptance_rate"][c]),
                                   o["sum_alpha"] / max(o["n_steps"], 1),
                                   rtol=1e-10)
        for got, want in ((dbg["t_rho"][c], o["rho"]),
                          (dbg["t_zleft"].theta[c], o["zleft_theta"]),
                          (dbg["t_zright"].theta[c], o["zright_theta"])):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                       atol=1e-12)
        if np.isfinite(o["logw"]):
            np.testing.assert_allclose(float(dbg["t_w"][c]), o["logw"],
                                       rtol=1e-10, atol=1e-12)
    if eps > 2:
        assert bool(stats["numerical_error"].any())


@pytest.mark.parametrize("kind", ["dense", "dense per chain", "rank_update"])
def test_pair_transition_is_bitwise_the_single_one_dense(kind):
    rng = np.random.default_rng(4)
    dim, c = 5, 16
    cov, _, lp_t = _corr_target(dim, 0.6)
    m = convert.metric(_metrics_j(kind, dim, cov, rng), "cpu")
    if kind == "dense per chain":
        m = ah.DenseEuclideanMetric.create(
            m.m_inv[torch.arange(c) % N_SEEDS])
    h = ah.Hamiltonian(metric=m, target=ah.LogDensityTarget(lp_t, dim))
    traj = ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.35, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=6))
    gen = torch.Generator().manual_seed(1)
    z0 = h.init_phasepoint(gen, torch.randn(c, dim, generator=gen,
                                            dtype=torch.float64))
    (z1, s1, d1), (z2, s2, d2) = [
        nuts.nuts_transition(torch.Generator().manual_seed(5), h, traj, z0,
                             return_debug=True, _pair=pair)
        for pair in (False, True)]
    assert not _mismatches(d1, d2, d1["ck_r"].shape[1] - 1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert torch.equal(z1.theta, z2.theta)
    assert int(s1["tree_depth"].max()) >= 2


# ---------------------------------------------------------- whole runs
def _kernel(eps, max_depth):
    return ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(eps, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=max_depth)))


def _theta0(c, dim, seed):
    return torch.from_numpy(
        0.2 * np.random.default_rng(seed).normal(size=(c, dim)))


def test_fused_warmup_dense_per_chain():
    """Per-chain dense adaptation inside the fused warmup (in-loop Welford
    covariance, the Cholesky factor refreshed at window ends): the mean of
    the chains' M⁻¹ near the true covariance (rtol 0.25, atol 0.12, JAX
    `test_fused_warmup_cc.py:66`), every chain's factor consistent with its
    M⁻¹, the draws calibrated."""
    dim, c = 4, 16
    target = ah.correlated_gaussian(dim, rho=0.7, dtype=torch.float64,
                                    device="cpu")
    res = ah.sample(
        torch.Generator().manual_seed(3), target, _kernel(0.3, 6),
        ah.make_metric("dense", dim, torch.float64, device="cpu"),
        _theta0(c, dim, 2), 260, n_adapts=200,
        adaptor=ah.AdaptorConfig(mm_kind="welford_cov", init_buffer=50,
                                 term_buffer=30, window_size=20),
        init_eps=0.3, fuse_warmup=True, fuse_draws=20, drop_warmup=True,
        device="cpu")
    m = res.final_state.metric
    assert isinstance(m, ah.DenseEuclideanMetric)
    assert tuple(m.m_inv.shape) == (c, dim, dim)
    assert isinstance(res.final_state.adapt.mm, ah.WelfordCovState)
    m_inv, u = m.m_inv.numpy(), m.chol_u.numpy()
    np.testing.assert_allclose(np.swapaxes(u, 1, 2) @ u,
                               (m_inv + np.swapaxes(m_inv, 1, 2)) / 2,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(m_inv.mean(0), target.cov, rtol=0.25,
                               atol=0.12)
    draws = res.thetas.reshape(-1, dim).numpy()
    np.testing.assert_allclose(draws.mean(0), 0.0, atol=0.25)
    np.testing.assert_allclose(np.cov(draws.T), target.cov, atol=0.35)
    assert 0.6 < float(res.stats["acceptance_rate"].mean()) <= 1.0


def test_fused_cc_rank_update_lowrank():
    """The rank-update metric with the low-rank estimator on the fused
    cross-chain warmup (JAX `test_fused_warmup_cc.py:333`): the metric
    keeps rank k, D is adapted, the draws match the covariance."""
    dim, k, c = 8, 3, 32
    target = ah.correlated_gaussian(dim, rho=0.7, dtype=torch.float64,
                                    device="cpu")
    res = ah.sample(
        torch.Generator().manual_seed(0), target, _kernel(0.25, 5),
        ah.make_metric("rank_update", dim, torch.float64, device="cpu"),
        _theta0(c, dim, 2), 192, n_adapts=160,
        adaptor=ah.AdaptorConfig(mm_kind="lowrank", mm_rank=k,
                                 init_buffer=40, term_buffer=30,
                                 window_size=20),
        cross_chain=True, init_eps=0.25, fuse_warmup=True,
        fuse_warmup_block=4, fuse_draws=8, drop_warmup=True, device="cpu")
    m = res.final_state.metric
    assert m.rank == k
    assert float(m.d.abs().max()) > 0.1
    assert np.linalg.eigvalsh(m.m_inv_matrix().numpy()).min() > 0
    draws = res.thetas.reshape(-1, dim).numpy()
    np.testing.assert_allclose(draws.mean(0), 0.0, atol=0.25)
    np.testing.assert_allclose(np.cov(draws.T), target.cov, atol=0.3)


@pytest.mark.parametrize("fused", [False, True])
def test_nutpie_warmup(fused):
    """Nutpie's estimator on a Gaussian with scales 0.5..2: cross-chain on
    the step path (the JAX bench's route: its fused cross-chain warmup
    records no gradients) and per chain in the fused warmup; the adapted
    diagonal lies near the variances (sqrt(var θ / var ∇) = σ²)."""
    dim, c = 4, 16
    scales = np.linspace(0.5, 2.0, dim) ** 2
    target = ah.mvn_diag(scales, dtype=torch.float64, device="cpu")
    kw = dict(fuse_warmup=True, fuse_pair=True) if fused \
        else dict(cross_chain=True, fuse_warmup=True)
    res = ah.sample(
        torch.Generator().manual_seed(1), target, _kernel(0.3, 6),
        ah.make_metric("diagonal", dim, torch.float64, device="cpu"),
        _theta0(c, dim, 3), 150, n_adapts=120,
        adaptor=ah.AdaptorConfig(mm_kind="nutpie", init_buffer=40,
                                 term_buffer=30, window_size=20),
        init_eps=0.3, fuse_draws=10, drop_warmup=True, device="cpu", **kw)
    st = res.final_state
    assert isinstance(st.adapt.mm, ah.NutpieVarState)
    m_inv = st.metric.m_inv.numpy()
    assert m_inv.shape == ((c, dim) if fused else (dim,))
    est = m_inv.mean(0) if fused else m_inv
    np.testing.assert_allclose(est, scales, rtol=0.35)
    draws = res.thetas.reshape(-1, dim).numpy()
    np.testing.assert_allclose(draws.var(0), scales, rtol=0.35)


@pytest.mark.parametrize("metric", ["dense", "rank_update"])
def test_constructor_metric_runs_end_to_end(metric):
    """`NUTS(metric=...)` builds the JAX configuration (dense: Welford
    covariance; rank update: the low-rank estimator, the metric's rank
    sized by `init_state`) and samples a correlated Gaussian."""
    dim, c = 4, 16
    cfg_t, cfg_j = ah.NUTS(0.8, max_depth=5, metric=metric), \
        aj.NUTS(0.8, max_depth=5, metric=metric)
    assert cfg_t.adaptor.mm_kind == cfg_j.adaptor.mm_kind
    target = ah.correlated_gaussian(dim, rho=0.6, dtype=torch.float64,
                                    device="cpu")
    res = cfg_t.sample(torch.Generator().manual_seed(2), target,
                       _theta0(c, dim, 4), 180, n_adapts=150,
                       cross_chain=True, init_eps=0.3, fuse_draws=10,
                       dtype=torch.float64, device="cpu")
    fm = res.final_state.metric
    assert type(fm).__name__ == {"dense": "DenseEuclideanMetric",
                                 "rank_update": "RankUpdateEuclideanMetric"
                                 }[metric]
    if metric == "rank_update":
        assert fm.rank == min(cfg_t.adaptor.mm_rank, dim)
    draws = res.thetas[150:].reshape(-1, dim).numpy()
    np.testing.assert_allclose(np.cov(draws.T), target.cov, atol=0.35)
    # M⁻¹ adapted from the identity towards the covariance
    assert abs(float(fm.m_inv_matrix()[0, 1])) > 0.2

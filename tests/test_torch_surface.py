"""`SampleResult`'s exports, the small API pieces and the per-chain
rank-update metric and low-rank estimator, against the JAX package.

Every comparison feeds both packages the same numpy inputs in float64:
`summary` to 1e-12 (relative); `to_inference_dict` by names, shapes and
values (bitwise, the constrained blocks to 1e-12) for a flat, a pytree and
a transformed target; `with_position`'s ℓπ and ∇ℓπ and
`leapfrog_trajectory` to 1e-12; the per-chain rank-update metric's
velocity, kinetic energy and momenta (from JAX's normals, with its
factors carried by `convert`) and the per-chain low-rank estimate to 1e-10
of JAX vmapped. Runs of `sample()` per chain with the rank-update metric
are held to the target's moments.
"""

import collections
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import metrics as metrics_j
from advancedhmc_tpu import transforms as tr_j
from advancedhmc_tpu.adaptation import FixedStepSize as FixedJ
from advancedhmc_tpu.adaptation import massmatrix as mm_j
from advancedhmc_tpu.integrators import leapfrog_trajectory as traj_j
from advancedhmc_tpu.models import hierarchical_logistic as logistic_j
from advancedhmc_tpu.sampler import SampleResult as ResultJ
from advancedhmc_tpu.sampler import SampleSpec as SpecJ

import advancedhmc_torch as ah
from advancedhmc_torch import convert
from advancedhmc_torch import transforms as tr_t
from advancedhmc_torch.adaptation import FixedStepSize, ManualSSAdaptor

torch.set_num_threads(2)

REL = dict(rtol=1e-12, atol=0)
N, C, DIM = 64, 4, 6


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               **(tol or REL))


def _ar1(n, m, dim, phi, seed, slow=None):
    """AR(1) chains with per-chain offsets; coordinate `slow` mixes at
    0.995 (one parameter far slower than the rest)."""
    rng = np.random.default_rng(seed)
    phis = np.full(dim, phi)
    if slow is not None:
        phis[slow] = 0.995
    x = np.empty((n, m, dim))
    x[0] = rng.normal(size=(m, dim))
    for t in range(1, n):
        x[t] = phis * x[t - 1] + np.sqrt(1 - phis ** 2) * rng.normal(
            size=(m, dim))
    return x + 0.1 * rng.normal(size=(1, m, dim))


def _stats(rng, n, m):
    """A run's stats in float64 (ints and booleans as the samplers give
    them); each chain's divergence count a power of two over n = 2^k draws,
    so JAX's float32 mean of it is exact."""
    div = np.zeros((n, m), bool)
    for c, k in enumerate((0, 8, 16, 32, 1, 2)[:m]):
        div[rng.choice(n, size=k, replace=False), c] = True
    return {
        "log_density": rng.normal(size=(n, m)),
        "numerical_error": div,
        "acceptance_rate": rng.uniform(0.2, 1.0, size=(n, m)),
        "hamiltonian_energy": np.cumsum(rng.normal(size=(n, m)), 0),
        "tree_depth": rng.integers(1, 6, size=(n, m)).astype(np.int32),
        "n_steps": rng.integers(1, 40, size=(n, m)).astype(np.int32),
        "step_size": np.full((n, m), 0.3),
        "is_accept": np.ones((n, m), bool),
    }


# ------------------------------------------------------ SampleResult
Pair = collections.namedtuple("Pair", ["loc", "scale"])


def _targets():
    """(name, JAX target, port target) of each kind of naming: flat, a
    pytree (dict keys, a namedtuple's fields, sequence positions) and a
    transformed target with names."""
    def lp_j(x):
        return -0.5 * jnp.sum(x ** 2)

    example_j = {"b": jnp.zeros((2, 2)), "a": jnp.zeros(()),
                 "pair": Pair(jnp.zeros(1), jnp.zeros(2)),
                 "coefs": [jnp.zeros(3), (jnp.zeros(()),)]}
    example_t = {"b": torch.zeros(2, 2), "a": torch.zeros(()),
                 "pair": Pair(torch.zeros(1), torch.zeros(2)),
                 "coefs": [torch.zeros(3), (torch.zeros(()),)]}
    blocks_j = [tr_j.Positive(1), tr_j.Interval(2, -1.0, 3.0),
                tr_j.Simplex(2), tr_j.Identity(2)]
    blocks_t = [tr_t.Positive(1), tr_t.Interval(2, -1.0, 3.0),
                tr_t.Simplex(2), tr_t.Identity(2)]
    names = ["sigma", "bounded", "weights", "mu"]
    return [
        ("flat", aj.LogDensityTarget(lp_j, 5),
         ah.LogDensityTarget(lambda x: -0.5 * (x ** 2).sum(-1), 5)),
        ("pytree", aj.target_from_pytree(lambda t: 0.0, example_j),
         ah.target_from_pytree(lambda t: 0.0, example_t)),
        ("transformed",
         tr_j.transformed_target(lambda *b: 0.0, blocks_j, names=names),
         tr_t.transformed_target(lambda *b: 0.0, blocks_t, names=names)),
    ]


def _results(target_j, target_t, x, stats):
    res_j = ResultJ(thetas=jnp.asarray(x),
                    stats={k: jnp.asarray(v) for k, v in stats.items()},
                    warmup_stats=None, final_state=None, target=target_j)
    res_t = ah.SampleResult(
        thetas=torch.from_numpy(x),
        stats={k: torch.from_numpy(v) for k, v in stats.items()},
        warmup_stats=None, final_state=None, target=target_t)
    return res_j, res_t


@pytest.mark.parametrize("which", range(3))
def test_exports_match_jax(which):
    """`to_inference_dict` (plain and, for the transformed target,
    constrained), `summary` (but for the pytree target) and `n_chains`
    against the JAX result's on the same draws and stats; `to_arviz` raises JAX's ImportError (arviz is
    not installed)."""
    name, target_j, target_t = _targets()[which]
    rng = np.random.default_rng(which)
    x = _ar1(N, C, target_j.dim, 0.4, seed=which)
    res_j, res_t = _results(target_j, target_t, x, _stats(rng, N, C))
    assert res_t.n_chains == res_j.n_chains == C
    for constrained in ((False, True) if name == "transformed"
                        else (False,)):
        dj_, dt_ = (r.to_inference_dict(constrained=constrained)
                    for r in (res_j, res_t))
        assert list(dt_["posterior"]) == list(dj_["posterior"])
        assert list(dt_["sample_stats"]) == list(dj_["sample_stats"])
        for part in ("posterior", "sample_stats"):
            for k, v in dj_[part].items():
                got = dt_[part][k]
                assert isinstance(got, np.ndarray)
                assert got.shape == np.shape(v), (k, got.shape)
                if constrained:
                    _close(got, v)
                else:
                    np.testing.assert_array_equal(got, np.asarray(v))
        if name == "pytree":
            continue    # its variables are to_inference_dict's, each
                        # summarised as the other targets' are
        sj = res_j.summary(constrained=constrained, verbose=False)
        st = res_t.summary(constrained=constrained, verbose=False)
        assert list(st) == list(sj)
        for var, row in sj.items():
            assert list(st[var]) == list(row)
            for k, v in row.items():
                assert np.shape(st[var][k]) == np.shape(v)
                _close(st[var][k], v)
    for r in (res_j, res_t):
        with pytest.raises(ImportError, match="to_inference_dict"):
            r.to_arviz()


def test_summary_warns_on_a_slow_parameter_and_prints_the_table(capsys):
    """Both packages warn when one parameter's bulk ESS is under 0.2 of the
    median, and print the same table."""
    _, target_j, target_t = _targets()[0]
    x = _ar1(400, C, 5, 0.0, seed=3, slow=2)
    res_j, res_t = _results(target_j, target_t, x,
                            _stats(np.random.default_rng(3), 400, C))
    tables = []
    for r in (res_j, res_t):
        with pytest.warns(UserWarning, match="min/median bulk-ESS ratio"):
            r.summary(verbose=True)
        tables.append(capsys.readouterr().out)
    assert tables[0] == tables[1]
    assert "theta[2]" in tables[1]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _results(target_j, target_t, _ar1(400, C, 5, 0.0, seed=3),
                 _stats(np.random.default_rng(3), 400, C))[1].summary(
                     verbose=False)


def test_sample_sets_the_target_and_online_results_refuse_exports():
    tgt = ah.target_from_pytree(
        lambda t: -0.5 * ((t["mu"] ** 2).sum(-1) + t["tau"] ** 2),
        {"mu": torch.zeros(2), "tau": torch.zeros(())})
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.5, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=4)))
    metric = ah.make_metric("diagonal", 3, torch.float64, device="cpu")
    res = ah.sample(torch.Generator().manual_seed(0), tgt, kernel, metric,
                    torch.zeros(4, 3, dtype=torch.float64), 24, n_adapts=8,
                    adaptor=ah.AdaptorConfig(), init_eps=0.5, device="cpu")
    assert res.target is tgt
    post = res.to_inference_dict()["posterior"]
    assert {k: v.shape for k, v in post.items()} == {
        "mu": (4, 24, 2), "tau": (4, 24)}
    np.testing.assert_array_equal(post["mu"], np.moveaxis(
        res.thetas[..., :2].numpy(), 0, 1))
    online = ah.sample(torch.Generator().manual_seed(0), tgt, kernel, metric,
                       torch.zeros(4, 3, dtype=torch.float64), 24,
                       n_adapts=8, adaptor=ah.AdaptorConfig(), init_eps=0.5,
                       collect="online", drop_warmup=True, device="cpu")
    assert online.n_chains == 4
    with pytest.raises(ValueError, match="online"):
        online.to_inference_dict()
    with pytest.raises(ValueError, match="transformed_target"):
        res.to_inference_dict(constrained=True)


# ---------------------------------------------------- small API pieces
def test_fixed_and_manual_step_size():
    """As JAX `tests/test_adaptation.py:194`: FixedStepSize is inert,
    ManualSSAdaptor holds the ϵ last set; `convert` carries the former."""
    fss = FixedStepSize.init(0.3)
    assert fss.update(0.1) is fss and fss.reset() is fss
    np.testing.assert_allclose(float(fss.finalize().eps), 0.3, rtol=1e-7)
    mssa = ManualSSAdaptor(0.1)
    mssa.set(0.25)
    assert isinstance(mssa.state, FixedStepSize)
    np.testing.assert_allclose(float(mssa.state.eps), 0.25, rtol=1e-7)
    per_chain = FixedJ.init(jnp.asarray([0.1, 0.2]))
    np.testing.assert_array_equal(
        convert.fixed_step_size(per_chain, "cpu").eps.numpy(),
        np.asarray(per_chain.eps))


def _gauss_spec(cross_chain):
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.35, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=6)))
    return ah.SampleSpec(target=ah.std_gaussian(4, device="cpu"),
                         kernel=kernel, adaptor=ah.AdaptorConfig(),
                         cross_chain=cross_chain)


@pytest.mark.parametrize("cross_chain", [True, False])
def test_with_step_size(cross_chain):
    """As JAX `tests/test_api.py:578`: the set ε is the state's and the
    next transition's step size (shared, or each chain's own)."""
    spec = _gauss_spec(cross_chain)
    state = ah.init_state(
        torch.Generator().manual_seed(5), spec,
        ah.make_metric("diagonal", 4, torch.float64, device="cpu"),
        torch.zeros(3, 4, dtype=torch.float64), init_eps=0.3, device="cpu")
    eps = 0.123 if cross_chain else torch.tensor(
        [0.1, 0.123, 0.2], dtype=torch.float64)
    state = state.with_step_size(eps)
    want = np.broadcast_to(np.asarray(eps), (3,))
    _close(np.broadcast_to(state.adapt.da.eps.numpy(), (3,)), want)
    flags = dict(is_adapt=False, in_window=False, window_end=False,
                 is_last=False)
    _, stats = ah.sample_step(torch.Generator().manual_seed(1), spec, state,
                              flags)
    _close(stats["step_size"], want)


def test_with_position_matches_jax():
    """As JAX `tests/test_api.py:522` on the 100-D-shaped logistic (cut
    to 9-D): ℓπ and ∇ℓπ recomputed at the new positions as JAX's, the
    momenta kept, a non-finite ℓπ mapped to −Inf; a step runs from there."""
    tgt_t = ah.hierarchical_logistic(n=40, p=8, dtype=torch.float64,
                                     device="cpu")
    tgt_j = logistic_j(n=40, p=8, dtype=jnp.float64)
    spec_t = dataclasses.replace(_gauss_spec(True), target=tgt_t)
    metric = ah.make_metric("diagonal", 9, torch.float64, device="cpu")
    state = ah.init_state(torch.Generator().manual_seed(6), spec_t, metric,
                          torch.zeros(3, 9, dtype=torch.float64),
                          init_eps=0.3, device="cpu")
    theta = np.random.default_rng(6).normal(scale=0.3, size=(3, 9))
    theta[2, 0] = np.inf
    st2 = state.with_position(spec_t, theta)
    np.testing.assert_array_equal(st2.position.numpy(), theta)
    lp, grad = jax.vmap(tgt_j.logdensity_and_grad)(jnp.asarray(theta))
    _close(st2.z.logdensity[:2], lp[:2])
    _close(st2.z.grad[:2], grad[:2])
    assert st2.z.logdensity[2] == -np.inf and not np.isfinite(lp[2])
    assert torch.equal(st2.z.r, state.z.r)
    assert torch.equal(st2.z.neg_k, state.z.neg_k)
    st3, _ = ah.sample_step(
        torch.Generator().manual_seed(2), spec_t,
        st2.with_position(spec_t, np.where(np.isfinite(theta), theta, 0.0)),
        dict(is_adapt=False, in_window=False, window_end=False,
             is_last=False))
    assert torch.isfinite(st3.position).all()


def test_leapfrog_trajectory_matches_jax():
    """As JAX `tests/test_integrators.py:100`: a target that is NaN past
    |x| > 2; each chain's trajectory and taken mask equal JAX's (vmapped)
    to 1e-12: the first non-finite point taken, every later step untaken
    and at that point; `leapfrog_steps` ends there too."""
    tgt_t = ah.LogDensityTarget(
        lambda x: torch.where(x[:, 0].abs() > 2.0, float("nan"),
                              -0.5 * x[:, 0] ** 2), 1)
    tgt_j = aj.LogDensityTarget(
        lambda x: jnp.where(jnp.abs(x[0]) > 2.0, jnp.nan, -0.5 * x[0] ** 2),
        1)
    h_t = ah.Hamiltonian(metric=ah.make_metric("unit", 1, torch.float64,
                                               device="cpu"), target=tgt_t)
    h_j = aj.Hamiltonian(metric=aj.UnitEuclideanMetric(size=1,
                                                       _dtype=jnp.float64),
                         target=tgt_j)
    theta = np.array([[1.5], [0.0], [-1.0], [0.3]])
    r = np.array([[2.0], [0.1], [-1.8], [3.0]])
    for fwd in (True, False):
        integ_t = ah.Leapfrog(step_size=torch.tensor(0.6, dtype=torch.float64))
        integ_j = aj.Leapfrog(step_size=jnp.asarray(0.6, jnp.float64))
        zs, taken = ah.leapfrog_trajectory(
            integ_t, h_t, h_t.phasepoint(torch.from_numpy(theta),
                                         torch.from_numpy(r)), 10, fwd=fwd)
        zj, taken_j = jax.vmap(lambda q, p: traj_j(
            integ_j, h_j, h_j.phasepoint(q, p), 10, fwd=fwd))(
                jnp.asarray(theta), jnp.asarray(r))
        assert zs.theta.shape == (10, 4, 1) and taken.shape == (10, 4)
        np.testing.assert_array_equal(taken.numpy(),
                                      np.swapaxes(np.asarray(taken_j), 0, 1))
        for f in ("theta", "r", "logdensity", "grad"):
            _close(getattr(zs, f), np.swapaxes(np.asarray(getattr(zj, f)),
                                               0, 1), rtol=1e-12, atol=0)
        assert not taken.all() and taken[0].all()
        last = ah.leapfrog_steps(integ_t, h_t, h_t.phasepoint(
            torch.from_numpy(theta), torch.from_numpy(r)), 10, fwd=fwd)
        _close(last.theta, zs.theta[-1])


# --------------------------------- per-chain rank update and low rank
def _per_chain_rank_update(rng, k, c=C, dim=DIM):
    a = np.exp(rng.normal(size=(c, dim)))
    b = rng.normal(size=(c, dim, k))
    d = np.stack([np.diag(rng.uniform(0.3, 2.0, size=k)) for _ in range(c)])
    mj = jax.vmap(metrics_j.RankUpdateEuclideanMetric.create)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(d))
    return a, b, d, mj


@pytest.mark.parametrize("k", [0, 2, DIM])
def test_per_chain_rank_update_metric_matches_jax(k):
    """Velocity, −K and momenta from JAX's normals (its factors carried by
    `convert`) within 1e-10 of JAX's metric vmapped; the port's own
    per-chain factorisation is each chain's shared one, and `renew`,
    `per_chain` and `take` keep every chain's M⁻¹."""
    rng = np.random.default_rng(40 + k)
    a, b, d, mj = _per_chain_rank_update(rng, k)
    mt = convert.metric(mj, "cpu")
    r = rng.normal(size=(C, DIM))
    keys = jax.random.split(jax.random.PRNGKey(k), C)
    z = jax.vmap(lambda kk: jax.random.normal(kk, (DIM,), jnp.float64))(keys)
    tol = dict(rtol=1e-10, atol=1e-12)
    _close(mt.velocity(torch.from_numpy(r)),
           jax.vmap(lambda m, x: m.velocity(x))(mj, jnp.asarray(r)), **tol)
    _close(mt.neg_kinetic_energy(torch.from_numpy(r)),
           jax.vmap(lambda m, x: m.neg_kinetic_energy(x))(
               mj, jnp.asarray(r)), **tol)
    _close(mt.momentum_from_normals(torch.from_numpy(np.array(z))),
           jax.vmap(lambda m, kk: m.rand_momentum(kk))(mj, keys), **tol)
    _close(mt.m_inv_matrix(),
           jax.vmap(lambda m: m.m_inv_matrix())(mj), **tol)
    built = ah.RankUpdateEuclideanMetric.create(*(torch.from_numpy(v)
                                                  for v in (a, b, d)))
    for c in range(C):
        one = ah.RankUpdateEuclideanMetric.create(*(torch.from_numpy(v[c])
                                                    for v in (a, b, d)))
        for f in ("q_full", "v_upper"):
            _close(getattr(built, f)[c], getattr(one, f), rtol=1e-12,
                   atol=1e-14)
        _close(built.velocity(torch.from_numpy(r))[c],
               one.velocity(torch.from_numpy(r[c:c + 1]))[0], **tol)
    # the estimator's triple, d per chain as (C, k) or (C, k, k)
    d_vec = rng.uniform(-0.5, 2.0, size=(C, k))
    rj = jax.vmap(lambda m, x, y, w: m.renew((x, y, w)))(
        mj, jnp.asarray(a), jnp.asarray(b), jnp.asarray(d_vec))
    for dd in (torch.from_numpy(d_vec), torch.diag_embed(
            torch.from_numpy(d_vec))):
        rt = mt.renew((torch.from_numpy(a), torch.from_numpy(b), dd))
        _close(rt.m_inv_matrix(), jax.vmap(lambda m: m.m_inv_matrix())(rj),
               **tol)
    diag = mt.renew(torch.from_numpy(a))
    assert diag.b.shape == (C, DIM, k) and not diag.b.any()
    shared = ah.make_metric("rank_update", DIM, torch.float64, device="cpu",
                            rank=k)
    many = shared.per_chain(C)
    assert many.q_full.shape == (C, DIM, DIM)
    _close(many.take(slice(1, 3)).m_inv_matrix(),
           np.broadcast_to(np.eye(DIM), (2, DIM, DIM)))


def test_per_chain_low_rank_estimator_matches_jax():
    """Each chain's pushes and the estimate (refined 3 times) within 1e-10
    of JAX's vmapped estimator, as the estimate's matrix (which does not
    see the eigenvectors' signs), after a reset too; chains below n_min
    keep their old estimate."""
    rng = np.random.default_rng(12)
    k = 3
    init_j = jax.vmap(lambda _: mm_j.LowRankCovState.init(
        DIM, jnp.float64, rank=k))(jnp.arange(C))
    st = ah.LowRankCovState.init(DIM, torch.float64, "cpu", rank=k,
                                 n_chains=C)
    sj = init_j
    push_j = jax.jit(jax.vmap(lambda s, x: s.push(x)))
    est_j = jax.jit(jax.vmap(lambda s: s.update_estimate()))

    def matrix(s):
        a, b, d = (np.asarray(v) for v in s.m_inv)
        return a[..., :, None] * np.eye(DIM) \
            + (b * d[..., None, :]) @ np.swapaxes(b, -1, -2)

    covs = [np.diag(np.linspace(0.5, 3.0, DIM)) + 0.4 * np.outer(v, v)
            for v in rng.normal(size=(C, DIM))]
    for rnd in range(2):
        for t in range(40):
            x = np.stack([rng.multivariate_normal(np.zeros(DIM), cv)
                          for cv in covs])
            sj, st = push_j(sj, jnp.asarray(x)), st.push(torch.from_numpy(x))
            if rnd == 1 and t == 4:
                # chains 0-1 at n = 5 < n_min keep their estimate
                _close(matrix(st.update_estimate()), matrix(est_j(sj)),
                       rtol=1e-10, atol=1e-12)
        sj, st = est_j(sj), st.update_estimate()
        _close(matrix(st), matrix(sj), rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(st.n.numpy(), np.asarray(sj.n))
        sj = jax.vmap(lambda s: s.reset())(sj)
        st = st.reset()
    converted = convert.lowrank_state(sj, "cpu")
    assert converted.b.shape == (C, DIM, k)
    _close(matrix(converted), matrix(sj))


def _run_per_chain(adaptor, metric, n, n_adapts, seed=3):
    return ah.sample(
        torch.Generator().manual_seed(seed), ah.std_gaussian(4, device="cpu"),
        _gauss_spec(False).kernel, metric,
        torch.zeros(4, dtype=torch.float64), n, n_adapts=n_adapts,
        adaptor=adaptor, init_eps=0.35, n_chains=4, device="cpu")


@pytest.mark.parametrize("adapt", ["none", "lowrank"])
def test_sample_per_chain_rank_update(adapt):
    """`sample()` per chain with metric "rank_update": with no adaptation
    (JAX `tests/test_api.py:87`'s run, 200 iterations instead of 1000) and
    with per-chain Stan adaptation by the low-rank estimator; the draws'
    mean and variance near the standard Gaussian's, each chain's metric
    its own."""
    metric = ah.make_metric("rank_update", 4, torch.float64, device="cpu",
                            rank=0 if adapt == "none" else 2)
    adaptor = (ah.AdaptorConfig(kind="none") if adapt == "none" else
               ah.AdaptorConfig(mm_kind="lowrank", mm_rank=2, init_buffer=20,
                                term_buffer=20, window_size=20))
    res = _run_per_chain(adaptor, metric, 200, 100)
    m = res.final_state.metric
    assert isinstance(m, ah.RankUpdateEuclideanMetric)
    assert m.a_diag.shape == (4, 4) and m.b.shape == (4, 4, metric.rank)
    draws = res.thetas[100:].reshape(-1, 4).numpy()
    assert np.linalg.norm(draws.mean(0)) < 0.5
    np.testing.assert_allclose(draws.var(0), 1.0, atol=0.35)
    if adapt == "lowrank":
        assert isinstance(res.final_state.adapt.mm, ah.LowRankCovState)
        assert res.final_state.adapt.mm.n.shape == (4,)
        assert not torch.equal(m.a_diag[0], m.a_diag[1])


@pytest.mark.parametrize("criterion,sampler", [
    (crit, s) for crit in ("classic", "generalised", "strict")
    for s in ("slice", "multinomial")] + [
    (crit, s) for crit in ("fixed_n", "fixed_t")
    for s in ("endpoint", "multinomial")])
def test_per_chain_rank_update_lattice(criterion, sampler):
    """JAX `tests/test_compile_lattice.py:126-133`'s per-chain rank-update
    cases: one `sample_step` with the low-rank estimator at every
    criterion and sampler, D = 3, C = 2, from zeros at ε 0.3."""
    crit = {"fixed_n": lambda: ah.FixedNSteps(4),
            "fixed_t": lambda: ah.FixedIntegrationTime(0.8),
            "classic": lambda: ah.ClassicNoUTurn(max_depth=3),
            "generalised": lambda: ah.GeneralisedNoUTurn(max_depth=3),
            "strict": lambda: ah.StrictGeneralisedNoUTurn(max_depth=3)}
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.3, dtype=torch.float64)),
        crit[criterion](), sampler))
    spec = ah.SampleSpec(target=ah.std_gaussian(3, device="cpu"),
                         kernel=kernel,
                         adaptor=ah.AdaptorConfig(mm_kind="lowrank"))
    state = ah.init_state(
        torch.Generator().manual_seed(0), spec,
        ah.make_metric("rank_update", 3, torch.float64, device="cpu"),
        torch.zeros(2, 3, dtype=torch.float64), init_eps=0.3, device="cpu")
    flags = {k: bool(v[0]) for k, v in ah.adapt_flags(
        spec.adaptor, 10, 20).items()}
    new, stats = ah.sample_step(torch.Generator().manual_seed(1), spec,
                                state, flags)
    assert new.metric.b.shape == (2, 3, 3)
    assert torch.isfinite(new.position).all()
    assert stats["acceptance_rate"].shape == (2,)

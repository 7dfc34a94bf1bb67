"""The relativistic kinetic energy of the port against the JAX package, in
float64.

1. The magnitude table bitwise, `interp` against `jnp.interp`, the momenta
   from JAX's own uniforms and normals (unit, shared and per-chain
   diagonal metrics), the JAX test's distribution check, the energy and
   the velocity; dense and rank-update metrics raise in both packages.
2. `nuts_transition` with the relativistic kinetic energy under forced
   directions against JAX's (the tree's depth, length, edges and momentum
   sum), with a shared and a per-chain diagonal metric (the strict
   criterion's row velocities, `Hamiltonian.velocity_rows`), and a start where
   the reference's span check, which applies the velocity to a momentum
   sum (dot(velocity(ρ), r_a)), stops the tree where the recursion
   oracle's dot(ρ, velocity(r_a)) does not: the port follows JAX.
3. The cross-chain fused warmup and draws (phase 18a's path) on a small
   Gaussian, held to its moments.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu.kinetic import RelativisticKinetic as RKj
from advancedhmc_tpu.models import std_gaussian as std_gaussian_j
from advancedhmc_tpu.riemannian import relativistic as relj

import advancedhmc_torch as ah
from advancedhmc_torch import convert
from advancedhmc_torch.riemannian import relativistic as relt

from nuts_oracle import nuts_oracle

torch.set_num_threads(2)

D = 3
A = np.array([[2.0, 0.5, 0.0], [0.5, 1.5, 0.3], [0.0, 0.3, 1.0]])
M_INV = np.array([0.5, 2.0, 1.0])
TOL = dict(rtol=1e-12, atol=1e-12)


def _np(x):
    return x.detach().cpu().numpy()


def _metrics(kind, c=4, dim=D):
    """(JAX metric or per-chain list, port metric) of `kind`."""
    rng = np.random.default_rng(11)
    if kind == "unit":
        return (aj.UnitEuclideanMetric(size=dim, _dtype=jnp.float64),
                ah.make_metric("unit", dim, dtype=torch.float64,
                               device="cpu"))
    if kind == "diag":
        m = np.linspace(0.5, 2.0, dim)
        return (aj.DiagEuclideanMetric.create(jnp.asarray(m)),
                convert.diag_metric(m, device="cpu"))
    m = rng.uniform(0.3, 3.0, size=(c, dim))           # one M⁻¹ a chain
    return ([aj.DiagEuclideanMetric.create(jnp.asarray(row)) for row in m],
            convert.diag_metric(m, device="cpu"))


# ------------------------------------------------------------ 1. pieces
@pytest.mark.parametrize("m,c,dim", [(1.0, 2.0, 4), (1.0, 2.0, 100),
                                     (0.5, 1.0, 3), (2.0, 0.3, 10)])
def test_magnitude_table_is_jax_table_bitwise(m, c, dim):
    u_j, cdf_j = relj._magnitude_table(m, c, dim)
    u_t, cdf_t = relt.magnitude_table(m, c, dim)
    assert np.array_equal(np.asarray(u_j), u_t)
    assert np.array_equal(np.asarray(cdf_j), cdf_t)


def test_interp_matches_jnp_interp():
    """The table's inverse CDF at uniforms, at the grid points themselves
    (the right-sided search's ties), at its flat ends and past them."""
    u, cdf = relt.magnitude_table(1.0, 2.0, 4)
    x = np.concatenate([np.random.default_rng(0).uniform(size=2000),
                        cdf[[0, 1, 5, 100, 4000, -2, -1]], [-0.5, 1.5]])
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(cdf),
                                jnp.asarray(u)))
    out = _np(relt.interp(torch.as_tensor(x), torch.as_tensor(cdf),
                          torch.as_tensor(u)))
    np.testing.assert_allclose(out, ref, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("kind", ["unit", "diag", "per_chain"])
def test_momenta_from_jax_draws_match(kind):
    """r from JAX's uniform and normals (its key split as JAX splits it)
    against `rand_momentum_relativistic` to 1e-12."""
    c = 6
    kin_j, kin_t = RKj(m=1.0, c=2.0), ah.RelativisticKinetic(m=1.0, c=2.0)
    mj, mt = _metrics(kind, c)
    keys = jax.random.split(jax.random.PRNGKey(5), c)
    if kind == "per_chain":
        r_j = np.stack([np.asarray(relj.rand_momentum_relativistic(
            kin_j, mj[i], keys[i])) for i in range(c)])
    else:
        r_j = np.asarray(jax.vmap(
            lambda k: relj.rand_momentum_relativistic(kin_j, mj, k))(keys))

    def draws(k):
        k_u, k_dir = jax.random.split(k)
        return (jax.random.uniform(k_u, dtype=jnp.float64),
                jax.random.normal(k_dir, (D,), dtype=jnp.float64))

    p, n = jax.vmap(draws)(keys)
    r_t = relt.momentum_from_draws(kin_t, mt, torch.from_numpy(np.array(p)),
                                   torch.from_numpy(np.array(n)))
    np.testing.assert_allclose(_np(r_t), r_j, **TOL)
    # drawn through the Hamiltonian: one uniform, then one row of normals
    gen = torch.Generator().manual_seed(1)
    ht = ah.Hamiltonian(metric=mt, target=ah.std_gaussian(D, device="cpu"),
                        kinetic=kin_t)
    r = ht.rand_momentum(gen, c)
    gen.manual_seed(1)
    p2 = torch.rand(c, generator=gen, dtype=torch.float64)
    n2 = torch.randn((c, D), generator=gen, dtype=torch.float64)
    assert torch.equal(r, relt.momentum_from_draws(kin_t, mt, p2, n2))


def test_relativistic_momentum_distribution():
    """The JAX test: |r|'s moments against quadrature of the magnitude's
    density (unit metric, 20000 chains), and rᵀM⁻¹r = |w|² under a diagonal
    metric."""
    kin = ah.RelativisticKinetic(m=1.0, c=2.0)
    gen = torch.Generator().manual_seed(5)
    metric = ah.make_metric("unit", 4, dtype=torch.float64, device="cpu")
    rs = _np(relt.rand_momentum_relativistic(kin, metric, gen, 20000))
    u = np.linalg.norm(rs, axis=1)
    grid = np.linspace(1e-6, 60, 20000)
    logp = 3 * np.log(grid) - 1.0 * 4.0 * np.sqrt(grid ** 2 / 4.0 + 1)
    p = np.exp(logp - logp.max())
    p /= np.trapezoid(p, grid)
    mean_expected = np.trapezoid(grid * p, grid)
    var_expected = np.trapezoid(grid ** 2 * p, grid) - mean_expected ** 2
    assert abs(u.mean() - mean_expected) < 0.05 * mean_expected
    assert abs(u.var() - var_expected) < 0.15 * var_expected
    dm = convert.diag_metric(np.array([0.5, 2.0, 1.0, 4.0]), device="cpu")
    r2 = _np(relt.rand_momentum_relativistic(kin, dm, gen, 2000))
    u2 = np.sqrt(np.einsum("nd,d,nd->n", r2, _np(dm.m_inv), r2))
    assert abs(u2.mean() - mean_expected) < 0.1 * mean_expected


@pytest.mark.parametrize("kind", ["unit", "diag", "per_chain"])
def test_energy_and_velocity_match_jax(kind):
    c = 5
    kin_j, kin_t = RKj(m=1.3, c=0.7), ah.RelativisticKinetic(m=1.3, c=0.7)
    mj, mt = _metrics(kind, c)
    r = 2.0 * np.random.default_rng(2).normal(size=(c, D))
    tj = std_gaussian_j(D)
    ht = ah.Hamiltonian(metric=mt, target=ah.std_gaussian(D, device="cpu"),
                        kinetic=kin_t)

    def jax_h(i):
        return aj.Hamiltonian(metric=mj[i] if kind == "per_chain" else mj,
                              target=tj, kinetic=kin_j)

    k_j = np.array([float(jax_h(i).neg_kinetic_energy(jnp.asarray(r[i])))
                    for i in range(c)])
    v_j = np.stack([np.asarray(jax_h(i).velocity(jnp.asarray(r[i])))
                    for i in range(c)])
    rt_ = torch.as_tensor(r)
    np.testing.assert_allclose(_np(ht.neg_kinetic_energy(rt_)), k_j, **TOL)
    np.testing.assert_allclose(_np(ht.velocity(rt_)), v_j, **TOL)
    # the phase point caches −K of the relativistic energy
    z = ht.phasepoint(torch.zeros(c, D, dtype=torch.float64), rt_)
    np.testing.assert_allclose(_np(z.neg_k), k_j, **TOL)


@pytest.mark.parametrize("kind", ["dense", "rank_update"])
def test_other_metrics_raise_in_both_packages(kind):
    kin_t = ah.RelativisticKinetic(m=1.0, c=2.0)
    mj = aj.make_metric(kind, D, dtype=jnp.float64)
    mt = ah.make_metric(kind, D, dtype=torch.float64, device="cpu")
    hj = aj.Hamiltonian(metric=mj, target=std_gaussian_j(D),
                        kinetic=RKj(m=1.0, c=2.0))
    ht = ah.Hamiltonian(metric=mt, target=ah.std_gaussian(D, device="cpu"),
                        kinetic=kin_t)
    with pytest.raises(NotImplementedError):
        hj.neg_kinetic_energy(jnp.ones(D))
    with pytest.raises(NotImplementedError):
        hj.rand_momentum(jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="unit/diagonal"):
        ht.neg_kinetic_energy(torch.ones(2, D, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="unit/diagonal"):
        ht.velocity(torch.ones(2, D, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="unit/diagonal"):
        ht.rand_momentum(torch.Generator(), 2)


# ------------------------------------------------------ 2. the NUTS tree
CRITS = {"generalised": (aj.GeneralisedNoUTurn, ah.GeneralisedNoUTurn),
         "classic": (aj.ClassicNoUTurn, ah.ClassicNoUTurn),
         "strict": (aj.StrictGeneralisedNoUTurn, ah.StrictGeneralisedNoUTurn)}


def _targets():
    aj_, at = jnp.asarray(A), torch.as_tensor(A)
    return (aj.LogDensityTarget(lambda x: -0.5 * x @ aj_ @ x, D),
            ah.LogDensityTarget(
                lambda x: -0.5 * torch.einsum("ca,ab,cb->c", x, at, x), D))


def _jax_transitions(crit, kin, m_invs, th, r, dirs, eps, max_depth=6):
    """JAX's transition of each chain (its own diagonal M⁻¹), jitted once
    and vmapped: (n_steps, depth, debug state)."""
    tj, _ = _targets()

    def one(m_inv, t, p):
        h = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(m_inv),
                           target=tj, kinetic=kin)
        tr = aj.Trajectory(aj.Leapfrog(step_size=jnp.asarray(eps)),
                           CRITS[crit][0](max_depth=max_depth))
        _, st, dbg = aj.nuts_transition(
            jax.random.PRNGKey(0), h, tr, h.phasepoint(t, p),
            force_directions=jnp.asarray(dirs, jnp.int32),
            return_debug=True)
        return st["n_steps"], st["tree_depth"], dbg

    return jax.jit(jax.vmap(one))(jnp.asarray(m_invs), jnp.asarray(th),
                                  jnp.asarray(r))


def _port_transition(crit, kin, metric, th, r, dirs, eps, max_depth=6):
    _, tt = _targets()
    h = ah.Hamiltonian(metric=metric, target=tt, kinetic=kin)
    tr = ah.Trajectory(ah.Leapfrog(step_size=torch.tensor(
        eps, dtype=torch.float64)), CRITS[crit][1](max_depth=max_depth))
    z0 = h.phasepoint(torch.as_tensor(th), torch.as_tensor(r))
    return ah.nuts_transition(torch.Generator().manual_seed(0), h, tr, z0,
                              force_directions=np.asarray(dirs),
                              return_debug=True)


@pytest.mark.parametrize("crit,per_chain", [
    ("generalised", False), ("classic", False), ("strict", False),
    ("generalised", True), ("strict", True)])
def test_nuts_transition_matches_jax(crit, per_chain):
    """Five chains from JAX-sized starts (|r| ≈ 3, c = 0.5: the velocity
    far from linear), forced directions: n_steps, depth, the edges and ρ
    against JAX's to 1e-10, with one M⁻¹ shared or one a chain."""
    c, eps = 5, 0.2
    rng = np.random.default_rng(21)
    th, r = rng.normal(size=(c, D)), 3.0 * rng.normal(size=(c, D))
    dirs = [1, -1, 1, 1, -1, 1]
    m_invs = (rng.uniform(0.3, 3.0, size=(c, D)) if per_chain
              else np.broadcast_to(M_INV, (c, D)))
    n_j, d_j, dbg_j = _jax_transitions(crit, RKj(m=1.0, c=0.5), m_invs, th,
                                       r, dirs, eps)
    metric = convert.diag_metric(m_invs if per_chain else M_INV,
                                 device="cpu")
    _, st, dbg = _port_transition(crit, ah.RelativisticKinetic(1.0, 0.5),
                                  metric, th, r, dirs, eps)
    np.testing.assert_array_equal(_np(st["n_steps"]), np.asarray(n_j))
    np.testing.assert_array_equal(_np(st["tree_depth"]), np.asarray(d_j))
    for side in ("t_zleft", "t_zright"):
        np.testing.assert_allclose(_np(dbg[side].theta),
                                   np.asarray(dbg_j[side].theta),
                                   rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_np(dbg["t_rho"]), np.asarray(dbg_j["t_rho"]),
                               rtol=1e-10, atol=1e-10)
    assert int(_np(st["tree_depth"]).max()) >= 2


@pytest.mark.parametrize("crit", ["generalised", "classic"])
def test_velocity_of_sums_follows_the_reference(crit):
    """A start (found by a search over seeds) where the reference's span
    check, dot(velocity(ρ), r_a) (classic: dot(velocity(θ), r_a)), stops
    the tree at depth 2 after 7 (classic 5) leaves, while the recursion
    oracle's dot(ρ, velocity(r_a)) runs to 63: the velocity is not linear
    in r. The port computes what JAX computes (ROADMAP §3 logs this as a
    quirk of the reference)."""
    rng = np.random.default_rng(1)
    th, r = rng.normal(size=D), 3 * rng.normal(size=D)
    dirs = rng.choice([-1, 1], size=6).astype(np.int32)
    kin_j = RKj(m=1.0, c=0.5)
    n_j, d_j, _ = _jax_transitions(crit, kin_j, M_INV[None], th[None],
                                   r[None], dirs, 0.1)
    _, st, _ = _port_transition(crit, ah.RelativisticKinetic(1.0, 0.5),
                                convert.diag_metric(M_INV, device="cpu"),
                                th[None], r[None], dirs, 0.1)
    tj, _ = _targets()
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(
        jnp.asarray(M_INV)), target=tj, kinetic=kin_j)
    oracle = nuts_oracle(
        hj, aj.Leapfrog(step_size=jnp.asarray(0.1)),
        CRITS[crit][0](max_depth=6), "multinomial",
        hj.phasepoint(jnp.asarray(th), jnp.asarray(r)), list(dirs))
    assert int(st["n_steps"][0]) == int(n_j[0]) == (
        7 if crit == "generalised" else 5)
    assert int(st["tree_depth"][0]) == int(d_j[0]) == 2
    assert oracle["n_steps"] == 63 and oracle["depth"] == 6


# ------------------------------------------------ 3. the fused main path
def test_crosschain_fused_sample_holds_gaussian_moments():
    """Phase 18a's path at a small size: `init_state`, the cross-chain
    fused warmup in blocks on the leaf-pair body, fan-out, and the fused
    draws, with the relativistic kinetic energy on a diagonal metric, on a
    4-D Gaussian with variances 0.5..2 (128 warmup iterations in blocks of
    4 on 32 chains, 160 draws on 64): the draws' means and variances."""
    var = np.array([0.5, 1.0, 1.5, 2.0])
    target = ah.mvn_diag(var, dtype=torch.float64, device="cpu")
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.1, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=6)))
    spec = ah.SampleSpec(
        target=target, kernel=kernel,
        adaptor=ah.AdaptorConfig(kind="stan", da=ah.DualAveragingConfig(
            delta=0.8), init_buffer=30, term_buffer=20, window_size=20),
        cross_chain=True, kinetic=ah.RelativisticKinetic(m=1.0, c=2.0))
    gen = torch.Generator().manual_seed(3)
    theta0 = torch.as_tensor(0.1 * np.random.default_rng(3).normal(
        size=(64, 4)))
    state = ah.init_state(gen, spec, ah.make_metric(
        "diagonal", 4, dtype=torch.float64, device="cpu"), theta0[:32],
        device="cpu")
    state, _, _ = ah.fused_warmup_phase_crosschain(gen, spec, state, 128, 4,
                                                   pair=True)
    state = ah.fanout_warmup_state(spec, state, 64)
    _, th, st = ah.fused_draw_phase(gen, spec, state, 160, 16, pair=True)
    th = _np(th)
    assert th.shape == (160, 64, 4) and np.isfinite(th).all()
    np.testing.assert_allclose(th.mean((0, 1)), 0.0, atol=0.06)
    np.testing.assert_allclose(th.var((0, 1)) / var, 1.0, atol=0.1)
    assert float(st["numerical_error"].double().mean()) < 1e-2
    assert 0.6 < float(st["acceptance_rate"].mean()) <= 1.0

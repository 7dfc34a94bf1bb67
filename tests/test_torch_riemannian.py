"""The Riemannian tier of the port against the JAX package
(`tests/test_riemannian.py`'s counterparts), in float64 at D ≤ 3.

Both packages get the same numpy inputs: positions, momenta (the port's
from JAX's normals through `momentum_from_normals`) and the MH step's
Exp(1) draws (monkeypatched into the port's `trajectory`). Deterministic
pieces are held to 1e-10 (`softabs`, J, dsoftabs/dλ and the kinetic
energy to 1e-12). `test_torch_riemannian_sample.py` holds the sampling
loops by statistical gates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import riemannian as rj
from advancedhmc_tpu.riemannian import hamiltonian as rhj
from advancedhmc_tpu.riemannian.metric import apply_map as apply_map_j

import advancedhmc_torch as ah
from advancedhmc_torch import convert, trajectory as traj_t
from advancedhmc_torch import riemannian as rt
from advancedhmc_torch.riemannian import hamiltonian as rht

torch.set_num_threads(2)

D = 3
A = np.array([[2.0, 0.5, 0.0], [0.5, 1.5, 0.3], [0.0, 0.3, 1.0]])
TOL = dict(rtol=1e-10, atol=1e-10)


def _targets():
    """The JAX test's quartic-perturbed Gaussian in both packages."""
    aj_ = jnp.asarray(A)
    at = torch.as_tensor(A)
    tj = aj.LogDensityTarget(
        lambda x: -0.5 * x @ aj_ @ x - 0.1 * jnp.sum(x ** 4), D)
    tt = ah.LogDensityTarget(
        lambda x: (-0.5 * torch.einsum("ca,ab,cb->c", x, at, x)
                   - 0.1 * torch.sum(x ** 4, -1)), D)
    return tj, tt


def _convex_targets():
    """The JAX finite-difference test's convex target (identity map)."""
    tj = aj.LogDensityTarget(
        lambda x: -0.5 * jnp.sum(x ** 2) - 0.05 * jnp.sum(x ** 4), D)
    tt = ah.LogDensityTarget(
        lambda x: (-0.5 * torch.sum(x ** 2, -1)
                   - 0.05 * torch.sum(x ** 4, -1)), D)
    return tj, tt


def _hamiltonians(map_name, alpha=20.0):
    if map_name == "identity":
        tj, tt = _convex_targets()
        mj, mt = rj.IdentityMap(), rt.IdentityMap()
    else:
        tj, tt = _targets()
        mj, mt = rj.SoftAbsMap(alpha), rt.SoftAbsMap(alpha)
    hj = rj.RiemannianHamiltonian(
        metric=rj.DenseRiemannianMetric.from_hessian(tj, mj), target=tj)
    ht = rt.RiemannianHamiltonian(
        metric=rt.DenseRiemannianMetric.from_hessian(tt, mt), target=tt)
    assert convert.riemannian_map(hj.metric) == mt
    return hj, ht


def _np(x):
    return x.detach().cpu().numpy()


def _points(seed, c=4, scale=0.8):
    rng = np.random.default_rng(seed)
    return scale * rng.normal(size=(c, D)), rng.normal(size=(c, D))


def _close_z(zt, zj, **tol):
    for f in ("theta", "r", "logdensity", "dHdtheta", "neg_k"):
        np.testing.assert_allclose(_np(getattr(zt, f)),
                                   np.asarray(getattr(zj, f)),
                                   err_msg=f, **(tol or TOL))


# ---------------------------------------------------------------- softabs
def _sym(seed):
    x = np.random.default_rng(seed).normal(size=(D, D))
    return 0.5 * (x + x.T)


# symmetric matrices with generic, degenerate, near-zero and exactly zero
# eigenvalues: Q diag(λ) Qᵀ for a fixed rotation Q
_Q = np.linalg.qr(np.random.default_rng(7).normal(size=(D, D)))[0]
SPECTRA = {"generic": None, "degenerate": [1.5, 1.5, -0.7],
           "near_zero": [2e-6, -3e-7, 1.0], "zero": [0.0, 0.0, 2.0]}


def _matrix(name):
    lam = SPECTRA[name]
    return _sym(0) if lam is None else (_Q * np.asarray(lam)) @ _Q.T


@pytest.mark.parametrize("name", list(SPECTRA))
def test_softabs_matches_jax(name):
    """softabs(X) and softabs(λ) against JAX to 1e-12 (the Taylor branch
    at |αλ| < 1e-4 on the near-zero spectra), and the JAX test's
    properties: G = Q·diag(sλ)·Qᵀ, positive definite, sλ ≥ |λ|."""
    x = _matrix(name)
    gj, _, lamj, softj = rj.softabs(jnp.asarray(x), 20.0)
    gt, qt, lamt, softt = rt.softabs(torch.as_tensor(x), 20.0)
    np.testing.assert_allclose(_np(lamt), np.asarray(lamj), atol=1e-12)
    np.testing.assert_allclose(_np(softt), np.asarray(softj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_np(gt), np.asarray(gj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_np(gt), _np((qt * softt) @ qt.T),
                               rtol=1e-10, atol=1e-12)
    evals = np.linalg.eigvalsh(_np(gt))
    assert (evals > 0).all()
    assert (_np(softt) >= np.abs(_np(lamt)) - 1e-10).all()
    # a PD input at a large α is mapped to itself
    pd = x @ x.T + np.eye(D)
    np.testing.assert_allclose(_np(rt.softabs(torch.as_tensor(pd), 1e6)[0]),
                               pd, rtol=1e-6)


def test_softabs_nonfinite_matrix_gives_nan():
    """A matrix with a NaN entry gives NaN (JAX's result; torch's eigh
    would raise), and the other matrices of the batch are unaffected."""
    x = np.stack([_sym(1), np.full((D, D), np.nan)])
    g, _, lam, _ = rt.softabs(torch.as_tensor(x), 20.0)
    assert torch.isnan(g[1]).all() and torch.isnan(lam[1]).all()
    np.testing.assert_allclose(
        _np(g[0]), np.asarray(rj.softabs(jnp.asarray(x[0]), 20.0)[0]),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("lam", [
    [0.3, -1.2, 2.0],             # distinct
    [0.7, 0.7, -0.4],             # degenerate pair
    [1e-6, -2e-6, 0.5],           # |αλ| < 1e-4: the Taylor branches
    [0.0, 0.0, 0.0],              # all zero
    [1.0, 1.0 + 1e-12, 3.0],      # |λ_i − λ_j| below 1e-10
])
@pytest.mark.parametrize("alpha", [1.0, 20.0])
def test_make_j_and_dsoftabs_match_jax(lam, alpha):
    lj = jnp.asarray(lam, jnp.float64)
    lt = torch.as_tensor(lam, dtype=torch.float64)
    np.testing.assert_allclose(_np(rht._dsoftabs_dlam(alpha, lt)),
                               np.asarray(rhj._dsoftabs_dlam(alpha, lj)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(rht._make_j(lt, alpha)),
                               np.asarray(rhj._make_j(lj, alpha)),
                               rtol=1e-12, atol=1e-12)
    # batched: a chain axis in front gives each row's own J
    lb = torch.stack([lt, lt.flip(0)])
    np.testing.assert_allclose(_np(rht._make_j(lb, alpha)[1]),
                               np.asarray(rhj._make_j(lj[::-1], alpha)),
                               rtol=1e-12, atol=1e-12)


# --------------------------------------------------------- kinetic energy
def test_kinetic_energy_matches_jax_and_mvnormal_logpdf():
    """−K(θ, r) equals JAX's to 1e-12 and log N(r; 0, G(θ)) (the JAX
    test's check against scipy) at several chains at once."""
    from scipy.stats import multivariate_normal

    hj, ht = _hamiltonians("softabs")
    th, r = _points(1, c=5)
    kt = _np(ht.neg_kinetic_energy(torch.as_tensor(th), torch.as_tensor(r)))
    kj = np.asarray(jax.vmap(hj.neg_kinetic_energy)(jnp.asarray(th),
                                                    jnp.asarray(r)))
    np.testing.assert_allclose(kt, kj, rtol=1e-12, atol=1e-12)
    gs = np.asarray(jax.vmap(lambda t: apply_map_j(
        hj.metric.map, hj.metric.g_fn(t)))(jnp.asarray(th)))
    for c in range(len(th)):
        expected = multivariate_normal(np.zeros(D), gs[c]).logpdf(r[c])
        np.testing.assert_allclose(kt[c], expected, rtol=1e-8)
    vt = _np(ht.velocity(torch.as_tensor(th), torch.as_tensor(r)))
    vj = np.asarray(jax.vmap(hj.velocity)(jnp.asarray(th), jnp.asarray(r)))
    np.testing.assert_allclose(vt, vj, **TOL)


def test_momenta_from_jax_normals_match():
    """`rand_momentum`'s map r = U⁻¹z (UᵀU = G⁻¹) given JAX's normals."""
    hj, ht = _hamiltonians("softabs")
    th, _ = _points(2, c=6)
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    rj_ = jax.vmap(hj.rand_momentum)(keys, jnp.asarray(th))
    z = jax.vmap(lambda k: jax.random.normal(k, (D,), jnp.float64))(keys)
    r_t = ht.momentum_from_normals(torch.as_tensor(th),
                                   torch.from_numpy(np.asarray(z)))
    np.testing.assert_allclose(_np(r_t), np.asarray(rj_), **TOL)
    # drawn from a generator: N(0, G(θ)) at one θ over many chains
    gen = torch.Generator().manual_seed(0)
    theta = torch.as_tensor(np.repeat(th[:1], 20000, 0))
    draws = _np(ht.rand_momentum(gen, theta))
    g = _np(rt.metric.apply_map(ht.metric.map,
                                ht.metric.g_fn(theta[:1]))[0])
    np.testing.assert_allclose(np.cov(draws.T), g, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("dim", [3, 20])
def test_metric_from_hessian_matches_jax(dim):
    """G and ∂G against JAX's `from_hessian` (`jax.hessian` and `jacfwd`
    of it) to 1e-10, with ∂/∂θᵢ on the last axis, in chunks of chains or
    not."""
    rng = np.random.default_rng(12)
    a = rng.normal(size=(dim, dim)) / dim
    a = a @ a.T + np.eye(dim)
    aj_, at = jnp.asarray(a), torch.as_tensor(a)
    tj = aj.LogDensityTarget(
        lambda x: -0.5 * x @ aj_ @ x - 0.1 * jnp.sum(x ** 4), dim)
    tt = ah.LogDensityTarget(
        lambda x: (-0.5 * torch.einsum("ca,ab,cb->c", x, at, x)
                   - 0.1 * torch.sum(x ** 4, -1)), dim)
    th = rng.normal(size=(5, dim))
    mj = rj.DenseRiemannianMetric.from_hessian(tj, rj.SoftAbsMap())
    g_j = np.asarray(jax.vmap(mj.g_fn)(jnp.asarray(th)))
    dg_j = np.asarray(jax.vmap(mj.dg_fn)(jnp.asarray(th)))
    for chunk in (None, 2):
        mt = rt.DenseRiemannianMetric.from_hessian(tt, rt.SoftAbsMap(),
                                                   chunk_size=chunk)
        x = torch.as_tensor(th)
        np.testing.assert_allclose(_np(mt.g_fn(x)), g_j, **TOL)
        np.testing.assert_allclose(_np(mt.dg_fn(x)), dg_j, **TOL)


# --------------------------------------------------------------- ∂H∂θ
@pytest.mark.parametrize("map_name", ["identity", "softabs"])
def test_dH_dtheta_matches_jax_and_finite_differences(map_name):
    """(ℓπ, ∂H∂θ) against JAX to 1e-10 at several chains, the cached
    r-dependent part at a second r against a fresh call, and ∂H∂θ and
    ∂H∂r against central differences of H (the JAX test's check)."""
    hj, ht = _hamiltonians(map_name)
    th, r = _points(3, c=5)
    lt, gt = ht.dH_dtheta(torch.as_tensor(th), torch.as_tensor(r))
    lj, gj = jax.vmap(hj.dH_dtheta)(jnp.asarray(th), jnp.asarray(r))
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **TOL)
    np.testing.assert_allclose(_np(gt), np.asarray(gj), **TOL)
    (_, _), cache = ht.dH_dtheta(torch.as_tensor(th), torch.as_tensor(r),
                                 return_cache=True)
    r2 = torch.as_tensor(r[::-1].copy())
    _, g_cached = ht.dH_dtheta(torch.as_tensor(th), r2, cache=cache)
    _, g_fresh = ht.dH_dtheta(torch.as_tensor(th), r2)
    np.testing.assert_allclose(_np(g_cached), _np(g_fresh), **TOL)

    theta = torch.tensor([[0.3, -0.5, 0.8]], dtype=torch.float64)
    rr = torch.tensor([[0.7, 0.2, -0.4]], dtype=torch.float64)

    def ham(t, p):
        return float(-(ht.target.logdensity(t) + ht.neg_kinetic_energy(t, p)))

    eps = 1e-6
    fd_t, fd_r = np.zeros(D), np.zeros(D)
    for i in range(D):
        e = torch.zeros(1, D, dtype=torch.float64)
        e[0, i] = eps
        fd_t[i] = (ham(theta + e, rr) - ham(theta - e, rr)) / (2 * eps)
        fd_r[i] = (ham(theta, rr + e) - ham(theta, rr - e)) / (2 * eps)
    np.testing.assert_allclose(_np(ht.dH_dtheta(theta, rr)[1])[0], fd_t,
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(_np(ht.velocity(theta, rr))[0], fd_r,
                               rtol=2e-4, atol=1e-6)


# ------------------------------------------------- the generalised leapfrog
@pytest.mark.parametrize("map_name", ["identity", "softabs"])
def test_generalized_leapfrog_step_matches_jax(map_name):
    """One step of every chain from the same point, per-chain signed ε,
    against JAX's step vmapped, to 1e-10 in every field (∂H∂θ is the
    stored (θ₁, r½) one in both)."""
    hj, ht = _hamiltonians(map_name)
    th, r = _points(4, c=4)
    eps = np.array([0.1, -0.1, 0.05, 0.2])
    zj = jax.vmap(hj.phasepoint)(jnp.asarray(th), jnp.asarray(r))
    zt = ht.phasepoint(torch.as_tensor(th), torch.as_tensor(r))
    _close_z(zt, zj)
    ij = rj.GeneralizedLeapfrog(step_size=jnp.asarray(0.1), n_fp=6)
    it = rt.GeneralizedLeapfrog(step_size=torch.tensor(0.1,
                                                       dtype=torch.float64))
    z1j = jax.vmap(lambda z, e: rj.generalized_leapfrog_step(ij, hj, z, e))(
        zj, jnp.asarray(eps))
    z1t = rt.generalized_leapfrog_step(it, ht, zt, torch.as_tensor(eps))
    _close_z(z1t, z1j)
    z2t = it.step(ht, zt, torch.as_tensor(eps))        # the protocol's step
    assert torch.equal(z2t.theta, z1t.theta) and torch.equal(z2t.r, z1t.r)


def test_generalized_leapfrog_reversibility_and_energy():
    """Ten steps forward then ten back return to the start (n_fp 10), and
    the energy moves little (the JAX test's bounds), for three chains."""
    hj, ht = _hamiltonians("softabs")
    integ = rt.GeneralizedLeapfrog(
        step_size=torch.tensor(0.05, dtype=torch.float64), n_fp=10)
    theta = torch.tensor([[0.2, -0.1, 0.4], [0.0, 0.3, -0.2],
                          [0.5, 0.5, 0.5]], dtype=torch.float64)
    z = ht.init_phasepoint(torch.Generator().manual_seed(3), theta)
    e0 = _np(z.energy())
    zf = z
    for _ in range(10):
        zf = rt.generalized_leapfrog_step(integ, ht, zf, 0.05)
    assert (np.abs(_np(zf.energy()) - e0) < 0.05).all()
    zb = zf
    for _ in range(10):
        zb = rt.generalized_leapfrog_step(integ, ht, zb, -0.05)
    np.testing.assert_allclose(_np(zb.theta), _np(z.theta), atol=1e-5)
    np.testing.assert_allclose(_np(zb.r), _np(z.r), atol=1e-5)


def test_transition_rmhmc_matches_jax(monkeypatch):
    """The static endpoint transition of every chain given JAX's
    momenta-free start and its Exp(1) draws: the endpoint, the MH
    decision (both branches taken) and every stat against JAX's
    `transition_rmhmc` vmapped."""
    hj, ht = _hamiltonians("softabs")
    th, r = _points(5, c=6, scale=1.0)
    r = 2.5 * r                      # large moves, so some chains reject
    zj = jax.vmap(hj.phasepoint)(jnp.asarray(th), jnp.asarray(r))
    zt = ht.phasepoint(torch.as_tensor(th), torch.as_tensor(r))
    keys = jax.random.split(jax.random.PRNGKey(8), 6)
    ij = rj.GeneralizedLeapfrog(step_size=jnp.asarray(0.3), n_fp=6)
    z_j, st_j = jax.vmap(lambda k, z: rj.transition_rmhmc(k, hj, ij, 6, z))(
        keys, zj)
    e = jax.vmap(lambda k: jax.random.exponential(k, dtype=jnp.float64))(
        keys)
    monkeypatch.setattr(traj_t, "rand_exponential",
                        lambda *a: torch.from_numpy(np.asarray(e)))
    it = rt.GeneralizedLeapfrog(step_size=torch.tensor(0.3,
                                                       dtype=torch.float64))
    z_t, st_t = rt.transition_rmhmc(torch.Generator(), ht, it, 6, zt)
    _close_z(z_t, z_j, rtol=1e-9, atol=1e-9)
    for k, v in st_j.items():
        np.testing.assert_allclose(
            np.broadcast_to(_np(st_t[k]).astype(np.float64), (6,)),
            np.broadcast_to(np.asarray(v).astype(np.float64), (6,)),
            rtol=1e-9, atol=1e-9, err_msg=k)
    acc = _np(st_t["is_accept"])
    assert 0 < acc.sum() < 6, acc


# ------------------------------------------------------- Riemannian NUTS
@pytest.mark.parametrize("crit,dirs", [
    ("generalised", [1, 1, -1, 1]), ("generalised", [-1, 1, 1, -1]),
    ("classic", [1, 1, -1, 1]), ("strict", [-1, 1, 1, -1])])
def test_riemannian_nuts_matches_jax(crit, dirs):
    """`nuts_transition` with the Riemannian Hamiltonian under forced
    directions against JAX's: tree depth, n_steps, the tree's edges and
    its momentum sum to 1e-10 (the candidate is the one random part). The
    port carries velocities where JAX does (the velocity depends on θ)."""
    hj, ht = _hamiltonians("softabs")
    crits = {"generalised": (aj.GeneralisedNoUTurn, ah.GeneralisedNoUTurn),
             "classic": (aj.ClassicNoUTurn, ah.ClassicNoUTurn),
             "strict": (aj.StrictGeneralisedNoUTurn,
                        ah.StrictGeneralisedNoUTurn)}[crit]
    th, r = _points(6, c=3)
    fd = np.asarray(dirs, np.int32)
    zj = jax.vmap(hj.phasepoint)(jnp.asarray(th), jnp.asarray(r))
    eps = 0.25
    tj = aj.Trajectory(rj.GeneralizedLeapfrog(step_size=jnp.asarray(eps),
                                              n_fp=4), crits[0](max_depth=4))
    _, sj, dj = jax.vmap(lambda k, z: aj.nuts_transition(
        k, hj, tj, z, force_directions=jnp.asarray(fd), return_debug=True))(
        jax.random.split(jax.random.PRNGKey(0), 3), zj)
    zt = ht.phasepoint(torch.as_tensor(th), torch.as_tensor(r))
    tt = ah.Trajectory(rt.GeneralizedLeapfrog(
        step_size=torch.tensor(eps, dtype=torch.float64), n_fp=4),
        crits[1](max_depth=4))
    _, st, dt = ah.nuts_transition(torch.Generator().manual_seed(0), ht, tt,
                                   zt, force_directions=fd,
                                   return_debug=True)
    for k in ("tree_depth", "n_steps", "numerical_error"):
        np.testing.assert_array_equal(_np(st[k]), np.asarray(sj[k]),
                                      err_msg=k)
    for side in ("t_zleft", "t_zright"):
        for f in ("theta", "r"):
            np.testing.assert_allclose(
                _np(getattr(dt[side], f)),
                np.asarray(getattr(dj[side], f)), **TOL, err_msg=side + f)
    np.testing.assert_allclose(_np(dt["t_rho"]), np.asarray(dj["t_rho"]),
                               **TOL)
    np.testing.assert_allclose(_np(dt["t_vleft"]), np.asarray(dj["t_vleft"]),
                               **TOL)
    np.testing.assert_allclose(_np(st["acceptance_rate"]),
                               np.asarray(sj["acceptance_rate"]), **TOL)
    assert int(_np(st["tree_depth"]).max()) >= 2


def test_riemannian_nuts_equals_euclidean_on_constant_identity_metric():
    """G(θ) ≡ I: the generalised leapfrog is the plain leapfrog and the
    Riemannian tree (carrying velocities) is the Euclidean one (recomputing
    them), leaf for leaf, from the same generator state: the candidate θ
    to 1e-9, n_steps and depth equal, for each sampler."""
    tj, tt = _targets()
    th, r = _points(3, c=4)
    eps = torch.tensor(0.25, dtype=torch.float64)
    crit = ah.GeneralisedNoUTurn(max_depth=5)
    h_e = ah.Hamiltonian(metric=ah.UnitEuclideanMetric(
        size=D, dtype=torch.float64, device="cpu"), target=tt)
    z_e = h_e.phasepoint(torch.as_tensor(th), torch.as_tensor(r))
    metric_r = rt.DenseRiemannianMetric(
        size=D, g_fn=lambda t: torch.eye(D, dtype=t.dtype).expand(
            t.shape[0], D, D),
        dg_fn=lambda t: torch.zeros(t.shape[0], D, D, D, dtype=t.dtype),
        map=rt.IdentityMap())
    h_r = rt.RiemannianHamiltonian(metric=metric_r, target=tt)
    z_r = h_r.phasepoint(torch.as_tensor(th), torch.as_tensor(r))
    for ts in ("multinomial", "slice"):
        for seed in (0, 1):
            ze, se = ah.nuts_transition(
                torch.Generator().manual_seed(seed), h_e,
                ah.Trajectory(ah.Leapfrog(step_size=eps), crit, ts), z_e)
            zr, sr = ah.nuts_transition(
                torch.Generator().manual_seed(seed), h_r,
                ah.Trajectory(rt.GeneralizedLeapfrog(step_size=eps, n_fp=4),
                              crit, ts), z_r)
            np.testing.assert_allclose(_np(zr.theta), _np(ze.theta),
                                       rtol=1e-9, atol=1e-12)
            assert torch.equal(sr["n_steps"], se["n_steps"])
            assert torch.equal(sr["tree_depth"], se["tree_depth"])
            np.testing.assert_allclose(_np(sr["acceptance_rate"]),
                                       _np(se["acceptance_rate"]), rtol=1e-9)


def test_fused_loop_refuses_the_riemannian_hamiltonian():
    _, ht = _hamiltonians("softabs")
    th, r = _points(0, c=2)
    zt = ht.phasepoint(torch.as_tensor(th), torch.as_tensor(r))
    tt = ah.Trajectory(rt.GeneralizedLeapfrog(
        step_size=torch.tensor(0.1, dtype=torch.float64)),
        ah.GeneralisedNoUTurn())
    with pytest.raises(ValueError, match="Riemannian NUTS"):
        ah.nuts_transitions_fused(torch.Generator(), ht, tt, zt, 2,
                                  ah.FullMomentumRefreshment())


def test_convert_riemannian_phasepoint():
    rng = np.random.default_rng(9)
    zj = rj.RiemannianPhasePoint(
        theta=jnp.asarray(rng.normal(size=(2, D))),
        r=jnp.asarray(rng.normal(size=(2, D))),
        logdensity=jnp.asarray(rng.normal(size=2)),
        dHdtheta=jnp.asarray(rng.normal(size=(2, D))),
        neg_k=jnp.asarray(rng.normal(size=2)))
    zt = convert.riemannian_phasepoint(zj, device="cpu")
    assert isinstance(zt, rt.RiemannianPhasePoint)
    _close_z(zt, zj, rtol=0, atol=0)

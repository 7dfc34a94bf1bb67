"""The port's model zoo, distributions, transforms and `target_from_pytree`
against the JAX package (and scipy), at seeded points.

Value and gradient of every model the JAX `models` package exports and the
port lacked: float64 to rtol 1e-10, the port's float32 model to rtol 1e-5
of JAX's float64 (atol scaled by the largest entry). The non-centred
logistic's route through K1 (its algebra, run here through K1's plain
version, as a CPU tensor gets it) against its analytic route and autograd.
"""

import collections
import importlib

import numpy as np
import pytest
import scipy.stats as ss
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree as ravel_pytree_j

import advancedhmc_tpu as aj
from advancedhmc_tpu import transforms as tr_j
from advancedhmc_tpu.models import dists as dj
import advancedhmc_tpu.models as mj

import advancedhmc_torch as ah
from advancedhmc_torch import transforms as tr_t
from advancedhmc_torch.models import dists as dt
import advancedhmc_torch.models as mt

torch.set_num_threads(2)

C = 6


def _jax_vg(target, x):
    lp, g = jax.vmap(target.logdensity_and_grad)(jnp.asarray(x))
    return np.asarray(lp), np.asarray(g)


def _port_vg(target, x, dtype=torch.float64):
    lp, g = target.logdensity_and_grad(torch.as_tensor(x, dtype=dtype))
    lp2 = target.logdensity(torch.as_tensor(x, dtype=dtype))
    return lp.double().numpy(), g.double().numpy(), lp2.double().numpy()


def _close(got, want, rtol):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _points(dim, scale=1.0, shift=0.0, seed=0):
    return shift + scale * np.random.default_rng(seed).normal(size=(C, dim))


MODELS = {
    # name: (JAX target, port target in dtype, points)
    "banana": (lambda: mj.banana(0.05, 3.0),
               lambda dt_: mt.banana(0.05, 3.0, device="cpu"),
               _points(2, 2.0)),
    "eight_schools": (mj.eight_schools,
                      lambda dt_: mt.eight_schools(dt_, "cpu"),
                      _points(10)),
    "gdemo": (mj.gdemo, lambda dt_: mt.gdemo("cpu"), _points(2, 0.7)),
    "gaussian_mixture": (
        lambda: mj.gaussian_mixture([[0.0, 1.0, -1.0], [2.0, 0.0, 0.5],
                                     [-1.0, -2.0, 0.0]], [0.5, 1.0, 1.5],
                                    [0.2, 0.3, 0.5]),
        lambda dt_: mt.gaussian_mixture(
            [[0.0, 1.0, -1.0], [2.0, 0.0, 0.5], [-1.0, -2.0, 0.0]],
            [0.5, 1.0, 1.5], [0.2, 0.3, 0.5], dt_, "cpu"),
        _points(3, 1.5)),
    "two_gaussian_mixtures_2d": (
        mj.two_gaussian_mixtures_2d,
        lambda dt_: mt.two_gaussian_mixtures_2d(dtype=dt_, device="cpu"),
        _points(2, 1.5)),
    "spiral": (mj.spiral, lambda dt_: mt.spiral(device="cpu"),
               _points(2, 1.5)),
    "hierarchical_logistic_nc": (
        lambda: mj.hierarchical_logistic_nc(n=40, p=5, dtype=jnp.float64),
        lambda dt_: mt.hierarchical_logistic_nc(n=40, p=5, dtype=dt_,
                                                device="cpu"),
        _points(6, 0.5)),
    "german_credit_logistic": (
        lambda: mj.german_credit_logistic(jnp.float64),
        lambda dt_: mt.german_credit_logistic(dt_, "cpu"),
        _points(25, 0.2, seed=1)),
    "gdemo_declarative": (mj.gdemo_declarative,
                          lambda dt_: mt.gdemo_declarative(),
                          _points(2, 0.7)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_value_and_grad_match_jax(name):
    make_j, make_t, x = MODELS[name]
    lp_j, g_j = _jax_vg(make_j(), x)
    lp, g, lp2 = _port_vg(make_t(torch.float64), x)
    _close(lp, lp_j, 1e-10)
    _close(lp2, lp_j, 1e-10)
    _close(g, g_j, 1e-10)
    lp, g, _ = _port_vg(make_t(torch.float32), x, torch.float32)
    _close(lp, lp_j, 1e-5)
    _close(g, g_j, 1e-5)


def test_every_jax_model_name_exists_in_the_port():
    assert set(mj.__all__) <= set(mt.__all__)
    assert mt.GDEMO_MEAN == mj.GDEMO_MEAN
    x = _points(2)
    gdemo_t, gdemo_j = (importlib.import_module(f"{pkg}.models.gdemo")
                        for pkg in ("advancedhmc_torch", "advancedhmc_tpu"))
    np.testing.assert_allclose(
        gdemo_t.constrain(torch.as_tensor(x)).numpy(),
        np.asarray(gdemo_j.constrain(jnp.asarray(x))), rtol=1e-15)


def test_nc_k1_route_is_the_analytic_route(monkeypatch):
    """The non-centred model's route through K1 (the centred likelihood at
    θ' = (log σ, σ·β̃), then ∇β̃ = σ·g_β − β̃ and ∂/∂log σ = −log σ +
    g_β·β) against its analytic route and against autograd of its log
    density, in float64. On a CPU tensor K1's wrapper runs its plain
    version, so forcing the route runs the route's algebra here."""
    import advancedhmc_torch.models.logistic as lg

    x = torch.as_tensor(_points(11, 0.5, seed=4))
    tgt = lg.hierarchical_logistic_nc(n=60, p=10, dtype=torch.float64,
                                      device="cpu")
    lp_a, g_a = tgt.logdensity_and_grad(x)
    with torch.enable_grad():
        xr = x.clone().requires_grad_(True)
        (g_auto,) = torch.autograd.grad(tgt.logdensity(xr).sum(), xr)
    monkeypatch.setattr(lg, "kernel_route", lambda theta: True)
    lp_k, g_k = tgt.logdensity_and_grad(x)
    np.testing.assert_allclose(g_a.numpy(), g_auto.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(lp_k.numpy(), lp_a.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_k.numpy(), g_a.numpy(), rtol=1e-10,
                               atol=1e-12)


# ----------------------------------------------------------- distributions
DISTS = [
    # (name, args, scipy frozen, support (lo, hi) for the off-support point)
    ("Normal", (0.5, 2.0), ss.norm(0.5, 2.0), None),
    ("LogNormal", (0.3, 0.7), ss.lognorm(0.7, scale=np.exp(0.3)), (0, None)),
    ("StudentT", (4.0, -0.5, 1.5), ss.t(4.0, -0.5, 1.5), None),
    ("Cauchy", (0.2, 0.8), ss.cauchy(0.2, 0.8), None),
    ("Laplace", (-0.3, 1.2), ss.laplace(-0.3, 1.2), None),
    ("Exponential", (1.7,), ss.expon(scale=1 / 1.7), (0, None)),
    ("Gamma", (2.5, 1.5), ss.gamma(2.5, scale=1 / 1.5), (0, None)),
    ("InverseGamma", (3.0, 2.0), ss.invgamma(3.0, scale=2.0), (0, None)),
    ("Beta", (2.0, 3.5), ss.beta(2.0, 3.5), (0, 1)),
    ("Uniform", (-1.0, 2.0), ss.uniform(-1.0, 3.0), (-1, 2)),
]


def _support_points(support, rng, k):
    lo, hi = support or (None, None)
    if lo is None:
        return rng.normal(size=(C, k)) * 2
    if hi is None:
        return lo + rng.gamma(2.0, size=(C, k))
    return lo + (hi - lo) * rng.uniform(0.05, 0.95, size=(C, k))


@pytest.mark.parametrize("name,args,frozen,support", DISTS,
                         ids=[d[0] for d in DISTS])
def test_dist_logpdf_matches_jax_and_scipy(name, args, frozen, support):
    rng = np.random.default_rng(len(name))
    y = _support_points(support, rng, 3)
    if support is not None:          # one element of chain 0 off support
        y[0, 1] = support[0] - 0.5
    d_t, d_j = getattr(dt, name)(*args), getattr(dj, name)(*args)
    got = d_t.logpdf(torch.as_tensor(y)).numpy()
    want_j = np.asarray(jax.vmap(d_j.logpdf)(jnp.asarray(y)))
    with np.errstate(divide="ignore"):
        want_s = frozen.logpdf(y).sum(-1)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want_j))
    np.testing.assert_array_equal(got == -np.inf, want_s == -np.inf)
    ok = np.isfinite(want_s)
    np.testing.assert_allclose(got[ok], want_j[ok], rtol=1e-12)
    np.testing.assert_allclose(got[ok], want_s[ok], rtol=1e-10)
    if support is not None:
        assert got[0] == -np.inf and np.isfinite(got[1:]).all()
    # the default transform maps R onto the support: the target of the
    # distribution against JAX's, value and gradient
    x = rng.normal(size=(C, 3))
    lp_j, g_j = _jax_vg(dj.target_of(d_j, 3), x)
    lp, g, _ = _port_vg(dt.target_of(d_t, 3), x)
    _close(lp, lp_j, 1e-10)
    _close(g, g_j, 1e-10)


def test_dirichlet_bernoulli_poisson_match_jax_and_scipy():
    rng = np.random.default_rng(0)
    alpha = (1.5, 2.0, 0.7, 3.0)
    y = rng.dirichlet(alpha, size=C)
    got = dt.Dirichlet(alpha).logpdf(torch.as_tensor(y)).numpy()
    want = np.array([ss.dirichlet(alpha).logpdf(v) for v in y])
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(got, np.asarray(jax.vmap(
        dj.Dirichlet(alpha).logpdf)(jnp.asarray(y))), rtol=1e-12)
    x = rng.normal(size=(C, 3))
    lp_j, g_j = _jax_vg(dj.target_of(dj.Dirichlet(alpha), 3), x)
    lp, g, _ = _port_vg(dt.target_of(dt.Dirichlet(alpha), 3), x)
    _close(lp, lp_j, 1e-10)
    _close(g, g_j, 1e-10)

    logits = rng.normal(size=(C, 7))
    k = (rng.uniform(size=7) < 0.5).astype(np.float64)
    got = dt.BernoulliLogit(torch.as_tensor(logits)).logpdf(
        torch.as_tensor(k)).numpy()
    want = ss.bernoulli(1 / (1 + np.exp(-logits))).logpmf(k).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    rate = np.exp(rng.normal(size=(C, 1)))
    counts = np.array([0.0, 1.0, 3.0, 7.0])
    got = dt.Poisson(torch.as_tensor(rate)).logpdf(
        torch.as_tensor(counts)).numpy()
    np.testing.assert_allclose(got, ss.poisson(rate).logpmf(counts).sum(-1),
                               rtol=1e-10)
    np.testing.assert_allclose(got, np.asarray(jax.vmap(
        lambda r: dj.Poisson(r).logpdf(jnp.asarray(counts)))(
            jnp.asarray(rate))), rtol=1e-12)


# -------------------------------------------------------------- transforms
TRANSFORMS = [("Identity", (3,)), ("Positive", (3,)),
              ("Interval", (3, -2.0, 5.0)), ("Ordered", (4,)),
              ("Simplex", (3,))]


@pytest.mark.parametrize("name,args", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transform_matches_jax(name, args):
    t_t, t_j = getattr(tr_t, name)(*args), getattr(tr_j, name)(*args)
    x = np.random.default_rng(2).normal(size=(C, args[0]))
    y, ld = t_t.forward(torch.as_tensor(x))
    y_j, ld_j = jax.vmap(t_j.forward)(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-13)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-12,
                               atol=1e-14)
    back = t_t.inverse(y)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax.vmap(t_j.inverse)(y_j)), rtol=1e-10,
        atol=1e-12)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-9, atol=1e-10)
    # the log-det is log|det ∂y/∂x| (Simplex: of its first K−1 outputs)
    j = torch.autograd.functional.jacobian(
        lambda v: t_t.forward(v)[0][:args[0]], torch.as_tensor(x[0]))
    np.testing.assert_allclose(float(ld[0]),
                               float(torch.linalg.slogdet(j)[1]), rtol=1e-10,
                               atol=1e-12)


def test_transformed_target_and_constrain_match_jax():
    ts_t = [tr_t.Positive(2), tr_t.Ordered(3), tr_t.Simplex(2),
            tr_t.Interval(1, 0.0, 4.0)]
    ts_j = [tr_j.Positive(2), tr_j.Ordered(3), tr_j.Simplex(2),
            tr_j.Interval(1, 0.0, 4.0)]
    w = np.linspace(0.5, 1.5, 11)

    def ld_t(a, b, c, d):
        return (torch.sum(torch.log(a), -1) - torch.sum(b * b, -1)
                + torch.sum(torch.as_tensor(w[5:8]) * c, -1) - d[:, 0])

    def ld_j(a, b, c, d):
        return (jnp.sum(jnp.log(a)) - jnp.sum(b * b)
                + jnp.sum(jnp.asarray(w[5:8]) * c) - d[0])

    tgt_t = tr_t.transformed_target(ld_t, ts_t, names=list("abcd"))
    tgt_j = tr_j.transformed_target(ld_j, ts_j, names=list("abcd"))
    assert tgt_t.dim == tgt_j.dim == 8 and tgt_t.names == tgt_j.names
    x = _points(8, 0.8, seed=5)
    lp_j, g_j = _jax_vg(tgt_j, x)
    lp, g, _ = _port_vg(tgt_t, x)
    _close(lp, lp_j, 1e-10)
    _close(g, g_j, 1e-10)
    blocks_t = tr_t.constrain(ts_t, torch.as_tensor(x))
    blocks_j = tr_j.constrain(ts_j, jnp.asarray(x))
    for bt, bj in zip(blocks_t, blocks_j):
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-13)
    np.testing.assert_allclose(
        tr_t.unconstrain(ts_t, *[b[0] for b in blocks_t]).numpy(),
        np.asarray(tr_j.unconstrain(ts_j, *[b[0] for b in blocks_j])),
        rtol=1e-10)


# ---------------------------------------------------- target_from_pytree
Pair = collections.namedtuple("Pair", "b a")


def _tree(pkg):
    arr = torch.as_tensor if pkg == "torch" else jnp.asarray
    return {
        "zeta": arr(np.arange(3.0)),
        "alpha": [arr(np.full((2, 2), 4.0)), (arr(np.array(7.0)), None)],
        "mid": collections.OrderedDict(
            [("y", arr(np.array([8.0, 9.0]))), ("x", arr(np.array(10.0)))]),
        "beta": Pair(arr(np.array([11.0])), arr(np.array([12.0, 13.0]))),
    }


def test_ravel_order_and_target_from_pytree_match_jax():
    flat_t, unravel_t = ah.target.ravel_pytree(_tree("torch"))
    flat_j, _ = ravel_pytree_j(_tree("jax"))
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = unravel_t(flat_t)
    assert type(back["mid"]) is collections.OrderedDict
    assert isinstance(back["beta"], Pair) and back["alpha"][1][1] is None
    x = torch.as_tensor(_points(flat_t.numel(), seed=6))
    batched = unravel_t(x)
    assert batched["alpha"][0].shape == (C, 2, 2)
    assert batched["alpha"][1][0].shape == (C,)

    def ld_j(p):
        return (-jnp.sum(p["zeta"] ** 2) - jnp.sum(p["alpha"][0] ** 3) / 10
                + p["alpha"][1][0] * p["mid"]["x"]
                + jnp.sum(jnp.sin(p["mid"]["y"])) + p["beta"].b[0]
                * jnp.sum(p["beta"].a))

    def ld_t(p):
        return (-torch.sum(p["zeta"] ** 2, -1)
                - torch.sum(p["alpha"][0] ** 3, (-1, -2)) / 10
                + p["alpha"][1][0] * p["mid"]["x"]
                + torch.sum(torch.sin(p["mid"]["y"]), -1)
                + p["beta"].b[:, 0] * torch.sum(p["beta"].a, -1))

    tgt_t = ah.target_from_pytree(ld_t, _tree("torch"))
    tgt_j = aj.target_from_pytree(ld_j, _tree("jax"))
    assert tgt_t.dim == tgt_j.dim == 14
    lp_j, g_j = _jax_vg(tgt_j, x.numpy())
    lp, g, _ = _port_vg(tgt_t, x.numpy())
    _close(lp, lp_j, 1e-12)
    _close(g, g_j, 1e-12)

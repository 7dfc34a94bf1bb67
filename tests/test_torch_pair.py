"""The port's leaf-pair body (`nuts._leaf_pair`) against its single-leaf
body and the JAX package's `body_pair`.

1. Within one transition, bitwise: `nuts_transition(_pair=True)` draws the
   generator exactly as `_pair=False` and must give the same final state,
   every field and every stack slot a check reads, in float64, as
   tests/test_pair_loop.py pins for the JAX package.
2. Across the fused loop, in distribution only: the chains share one
   generator, and a chain whose transition ends at leaf A starts its next
   one an iteration later under the pair body, so the streams shift.
   `sample(fuse_pair=True)` is compared with `fuse_pair=False` and with JAX
   `sample(fuse_pair=True)` by moments, acceptance and the depth histogram,
   as the JAX package's tier 2 does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu.models import std_gaussian

import advancedhmc_torch as ah
from advancedhmc_torch import nuts

torch.set_num_threads(2)

D, C = 6, 16
PREC = torch.linspace(0.5, 3.0, D, dtype=torch.float64)


def _target():
    """A diagonal Gaussian whose stiffest dimension diverges at ε ≳ 1.2."""
    def value_and_grad(x):
        return -0.5 * torch.sum(PREC * x * x, -1), -PREC * x

    return ah.LogDensityTarget(lambda x: value_and_grad(x)[0], D,
                               value_and_grad)


def _setup(metric_kind, eps, max_depth, per_chain):
    metric = ah.make_metric(metric_kind, D, torch.float64, device="cpu")
    eps = torch.tensor(eps, dtype=torch.float64)
    if per_chain:      # each chain its own ε and M⁻¹
        metric = ah.DiagEuclideanMetric.create(
            torch.linspace(0.6, 1.4, C * D, dtype=torch.float64).view(C, D))
        eps = eps * torch.linspace(0.7, 1.3, C, dtype=torch.float64)
    h = ah.Hamiltonian(metric=metric, target=_target())
    traj = ah.Trajectory(ah.Leapfrog(step_size=eps),
                         ah.GeneralisedNoUTurn(max_depth=max_depth))
    gen = torch.Generator().manual_seed(1)
    z0 = h.init_phasepoint(
        gen, torch.randn(C, D, generator=gen, dtype=torch.float64))
    return h, traj, z0


def _mismatches(a, b, n_slots):
    """Fields of two final loop states that differ in any bit; a stack is
    compared on its n_slots real slots (the spare one is a write-only
    sink)."""
    bad = []
    for k in a:
        x, y = a[k], b[k]
        if k.startswith(("ck_", "sck_")):
            x, y = x[:, :n_slots], y[:, :n_slots]
        pairs = ([(getattr(x, f), getattr(y, f)) for f in
                  ("theta", "r", "logdensity", "grad", "neg_k")]
                 if isinstance(x, ah.PhasePoint) else [(x, y)])
        if not all(torch.equal(p, q) for p, q in pairs):
            bad.append(k)
    return bad


@pytest.mark.parametrize("metric_kind,eps,max_depth,per_chain", [
    ("unit", 0.4, 6, False),
    ("diagonal", 0.4, 6, False),
    ("diagonal", 0.4, 6, True),
    ("diagonal", 1.7, 6, False),     # divergent trees, at A and at B
    ("diagonal", 1.7, 6, True),
    ("diagonal", 0.005, 8, False),   # deep trees
])
def test_pair_transition_is_bitwise_the_single_one(metric_kind, eps,
                                                   max_depth, per_chain):
    h, traj, z0 = _setup(metric_kind, eps, max_depth, per_chain)
    runs = [nuts.nuts_transition(torch.Generator().manual_seed(5), h, traj,
                                 z0, return_debug=True, _pair=pair)
            for pair in (False, True)]
    (z1, s1, d1), (z2, s2, d2) = runs
    n_slots = d1["ck_r"].shape[1] - 1
    assert not _mismatches(d1, d2, n_slots)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert torch.equal(z1.theta, z2.theta)
    n, div = s1["n_steps"], s1["numerical_error"]
    if eps > 1:
        # a divergence past depth 0 at an even leaf (leaf A, n_steps even)
        # and at an odd one (leaf B)
        assert bool((div & (n % 2 == 0)).any())
        assert bool((div & (n > 1) & (n % 2 == 1)).any())
    if max_depth == 8:
        assert int(s1["tree_depth"].max()) == 8


def test_lone_leaf_ends_the_pair_at_a():
    """At a depth-0 doubling the pair ends at its lone leaf A: the state is
    one `_leaf`'s (B computed and masked), its draws those of two."""
    h, traj, z0 = _setup("diagonal", 0.4, 6, False)
    eps = traj.integrator.step_size
    outs, gens = [], []
    for body in (nuts._leaf, nuts._leaf_pair):
        gens.append(torch.Generator().manual_seed(3))
        outs.append(body(nuts._initial_state(z0, 6), h, eps, 6, 1000.0,
                         gens[-1]))
    assert not _mismatches(outs[0], outs[1], 5)
    assert bool((outs[1]["leaf"] == 0).all())
    assert bool((outs[1]["depth"] == 1).all())
    ref = torch.Generator().manual_seed(3)
    nuts._leaf(nuts._initial_state(z0, 6), h, eps, 6, 1000.0, ref)
    nuts._leaf(nuts._initial_state(z0, 6), h, eps, 6, 1000.0, ref)
    assert torch.equal(gens[1].get_state(), ref.get_state())


def test_force_directions_raise_on_the_pair_body():
    h, traj, z0 = _setup("diagonal", 0.4, 6, False)
    with pytest.raises(ValueError, match="force_directions"):
        nuts.nuts_transition(torch.Generator().manual_seed(0), h, traj, z0,
                             force_directions=np.ones(6), _pair=True)


N_DRAWS, FUSE, EPS, DEPTH = 256, 32, 0.7, 5


def _port_sample(pair):
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(EPS, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=DEPTH)))
    target = ah.LogDensityTarget(lambda x: -0.5 * torch.sum(x * x, -1), D,
                                 lambda x: (-0.5 * torch.sum(x * x, -1), -x))
    return ah.sample(
        torch.Generator().manual_seed(4), target, kernel,
        ah.make_metric("diagonal", D, torch.float64, device="cpu"),
        0.3 * np.random.default_rng(5).normal(size=(C, D)), N_DRAWS,
        init_eps=EPS, fuse_draws=FUSE, fuse_pair=pair, device="cpu")


def _jax_sample():
    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(EPS, jnp.float64)),
        aj.GeneralisedNoUTurn(max_depth=DEPTH), "multinomial"))
    return aj.sample(
        jax.random.PRNGKey(4), std_gaussian(D), kernel,
        aj.make_metric("diagonal", D, dtype=jnp.float64),
        jnp.asarray(0.3 * np.random.default_rng(5).normal(size=(C, D))),
        N_DRAWS, init_eps=EPS, fuse_draws=FUSE, fuse_pair=True)


def _summary(res):
    th = np.asarray(res.thetas).reshape(-1, D)
    depth = np.asarray(res.stats["tree_depth"]).ravel()
    return (th.mean(0), th.std(0),
            float(np.mean(np.asarray(res.stats["acceptance_rate"]))),
            np.bincount(depth, minlength=DEPTH + 1) / depth.size,
            int(np.asarray(res.stats["n_steps"]).min()))


def test_fused_pair_sample_matches_single_and_jax_in_distribution():
    """On a standard normal: moments within 0.1 (Monte Carlo error of 4096
    draws of 16 chains, a few times over), mean acceptance within 0.02, the
    depth histogram within 0.04; every recorded transition has a leaf (the
    lone pair's masked B is not counted)."""
    pair, single = _summary(_port_sample(True)), _summary(_port_sample(False))
    ref = _summary(_jax_sample())
    for other in (single, ref):
        np.testing.assert_allclose(pair[0], other[0], atol=0.1)
        np.testing.assert_allclose(pair[1], other[1], atol=0.1)
        assert abs(pair[2] - other[2]) <= 0.02, (pair[2], other[2])
        np.testing.assert_allclose(pair[3], other[3], atol=0.04)
    np.testing.assert_allclose(pair[0], 0.0, atol=0.1)
    np.testing.assert_allclose(pair[1], 1.0, atol=0.1)
    assert pair[4] >= 1


def test_fuse_pair_reaches_every_fused_phase(monkeypatch):
    """`sample(fuse_pair=True)` on the main path's shape (cross-chain fused
    warmup on a pool, fan-out, decorrelation, fused draws) runs every fused
    call on the pair body."""
    seen = []
    fused = nuts.nuts_transitions_fused

    def spy(*args, pair=False, **kw):
        seen.append(pair)
        return fused(*args, pair=pair, **kw)

    monkeypatch.setattr("advancedhmc_torch.sampler.nuts_transitions_fused",
                        spy)
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.3, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=4)))
    res = ah.sample(
        torch.Generator().manual_seed(0), _target(), kernel,
        ah.make_metric("diagonal", D, torch.float64, device="cpu"),
        0.1 * np.random.default_rng(0).normal(size=(8, D)), 16,
        n_adapts=8, adaptor=ah.AdaptorConfig(kind="stan"),
        init_mass_matrix="gradient", cross_chain=True, fuse_draws=4,
        fuse_warmup=True, fuse_warmup_block=4, drop_warmup=True,
        warmup_chains=4, fanout_decorrelate=4, fuse_pair=True,
        device="cpu")
    # two warmup blocks, one decorrelation call, two draw calls
    assert seen == [True] * 5
    assert res.thetas.shape == (8, 8, D)
    assert bool(torch.isfinite(res.thetas).all())

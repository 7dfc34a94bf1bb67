"""The classic and strict no-U-turn criteria and the slice sampler in the
port's NUTS, against the recursion oracle and the JAX package.

1. The batched `nuts_transition` under forced directions against
   `tests/nuts_oracle.py`, on every case of the JAX package's own oracle
   test (`tests/test_nuts_oracle.py`) that is not the generalised criterion
   with multinomial sampling at a small step (`test_torch_nuts_oracle.py`
   has those): the same start, directions and ℓu, one chain a case.
2. The leaf-pair body bitwise the single-leaf body within one transition,
   for every (criterion, sampler) pair, in float64.
3. The slice sampler's candidate law on a 1-D quadratic at depth 2, 20000
   chains from one start: uniform over the acceptable leaves of a subtree,
   min(1, n_new/n_old) at the top level.
4. The constructors, `convert.criterion` and the (criterion, sampler) pairs
   that `check_ts_kind` refuses.

`test_torch_criteria_sample.py` runs them through `sample()`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj

import advancedhmc_torch as ah
from advancedhmc_torch import convert, nuts
from advancedhmc_torch.integrators import leapfrog_step

from nuts_oracle import nuts_oracle
from test_nuts_oracle import CASES as JAX_CASES
from test_torch_nuts_oracle import _targets
from test_torch_pair import _mismatches

torch.set_num_threads(2)

CRITERIA = {"classic": ah.ClassicNoUTurn,
            "generalised": ah.GeneralisedNoUTurn,
            "strict": ah.StrictGeneralisedNoUTurn}
CRITERIA_J = {"classic": aj.ClassicNoUTurn,
              "generalised": aj.GeneralisedNoUTurn,
              "strict": aj.StrictGeneralisedNoUTurn}
PAIRS = [("classic", "multinomial"), ("classic", "slice"),
         ("generalised", "multinomial"), ("generalised", "slice"),
         ("strict", "multinomial"), ("strict", "slice")]

# ---------------------------------------------------------------- 1. oracle
ORACLE_CASES = [c + (1000.0,) for c in JAX_CASES
                if not (c[3] == "generalised" and c[4] == "multinomial"
                        and c[2] < 1.0)]
# Cases of this test alone, found by a search for starts where a wrong rule
# changes the tree: a tree that only the strict criterion's two checks
# across the old tree and the new subtree stop, and trees at Δmax = 1 where
# the slice sampler's divergence test (ℓu < Δmax − H) and the multinomial
# one (−H₀ < Δmax − H) disagree.
EXTRA_CASES = [
    ("corr", 3, 0.25, "strict", "multinomial", 8, 36, 1000.0),
    ("std", 3, 1.0, "generalised", "slice", 6, 6, 1.0),
    ("std", 3, 1.0, "generalised", "slice", 6, 15, 1.0),
    ("std", 3, 1.5, "generalised", "slice", 6, 0, 1.0),
    ("std", 3, 1.0, "strict", "slice", 6, 6, 1.0),
    ("std", 3, 1.0, "classic", "slice", 6, 15, 1.0),
]


@pytest.mark.parametrize("tname,dim,eps,crit,ts,max_depth,seed,delta_max",
                         ORACLE_CASES + EXTRA_CASES)
def test_transition_matches_recursion_for_every_criterion(
        tname, dim, eps, crit, ts, max_depth, seed, delta_max):
    """The JAX test's start (θ₀, r₀ and the directions from its key), one
    chain; the port draws ℓu and the oracle is given it. Tolerances as the
    JAX test's: Σα/n to rtol 1e-10, ΔH_max, ρ and the edges to 1e-8; the
    weight t_w is the oracle's count of acceptable leaves (slice) or its
    log weight (multinomial)."""
    k_dir, k_init, k_mom, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
    lp_j, lp_t = _targets(tname, dim)
    m_inv = np.asarray(jnp.linspace(0.5, 2.0, dim).astype(jnp.float64))
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(
        jnp.asarray(m_inv)), target=aj.LogDensityTarget(lp_j, dim))
    ht = ah.Hamiltonian(metric=convert.diag_metric(m_inv, "cpu"),
                        target=ah.LogDensityTarget(lp_t, dim))
    z0 = hj.init_phasepoint(
        k_mom, jax.random.normal(k_init, (dim,), jnp.float64))
    directions = np.where(np.asarray(
        jax.random.bernoulli(k_dir, shape=(max_depth,))), 1, -1)
    traj = ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(eps, dtype=torch.float64)),
        CRITERIA[crit](max_depth=max_depth, delta_max=delta_max), ts_kind=ts)
    zc, st, dbg = ah.nuts_transition(
        torch.Generator().manual_seed(seed), ht, traj,
        convert.phasepoint(jax.tree_util.tree_map(lambda a: a[None], z0),
                           "cpu"),
        force_directions=directions, return_debug=True)
    lu = float(dbg["lu"][0]) if ts == "slice" else None
    o = nuts_oracle(hj, aj.Leapfrog(step_size=jnp.asarray(eps, jnp.float64)),
                    CRITERIA_J[crit](max_depth=max_depth,
                                     delta_max=delta_max),
                    ts, z0, directions, lu=lu)
    assert int(st["n_steps"][0]) == o["n_steps"]
    assert int(st["tree_depth"][0]) == o["depth"]
    assert bool(st["numerical_error"][0]) == o["diverged"]
    np.testing.assert_allclose(float(st["acceptance_rate"][0]),
                               o["sum_alpha"] / max(o["n_steps"], 1),
                               rtol=1e-10)
    if np.isfinite(o["dh_max"]):
        np.testing.assert_allclose(
            float(st["max_hamiltonian_energy_error"][0]), o["dh_max"],
            rtol=1e-8)
    for got, want in ((dbg["t_rho"], o["rho"]),
                      (dbg["t_zleft"].theta, o["zleft_theta"]),
                      (dbg["t_zright"].theta, o["zright_theta"])):
        np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-8,
                                   atol=1e-12)
    if ts == "slice":
        assert float(dbg["t_w"][0]) == o["n_slice"]
        # the root is acceptable and the candidate is a point at or above ℓu
        assert lu <= -o["h0"]
        assert -float(zc.energy()[0]) >= lu
    elif np.isfinite(o["logw"]):
        np.testing.assert_allclose(float(dbg["t_w"][0]), o["logw"],
                                   rtol=1e-8, atol=1e-12)


def test_strict_checks_read_each_chains_own_metric():
    """The strict span checks apply M⁻¹ to stack rows (C, K, dim): with a
    per-chain dense and a per-chain diagonal M⁻¹ every chain's tree is the
    one it grows alone under its own shared M⁻¹ (forced directions: the
    tree does not depend on the draws)."""
    d, c, md = 4, 5, 6
    rng = np.random.default_rng(3)
    a = rng.normal(size=(c, d, d))
    dense = np.eye(d) + 0.3 * a @ a.transpose(0, 2, 1) / d
    diag = rng.uniform(0.5, 2.0, size=(c, d))
    lp = _targets("corr", d)[1]
    target = ah.LogDensityTarget(lp, d)
    theta = torch.as_tensor(rng.normal(size=(c, d)))
    r = torch.as_tensor(rng.normal(size=(c, d)))
    directions = np.array([1, -1, -1, 1, 1, -1])
    traj = ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.3, dtype=torch.float64)),
        ah.StrictGeneralisedNoUTurn(max_depth=md))
    for cls, m_all in ((ah.DenseEuclideanMetric, dense),
                       (ah.DiagEuclideanMetric, diag)):
        def make(m):
            return cls.create(torch.as_tensor(m))

        h = ah.Hamiltonian(metric=make(m_all), target=target)
        _, st, dbg = ah.nuts_transition(
            torch.Generator().manual_seed(0), h, traj,
            h.phasepoint(theta, r), force_directions=directions,
            return_debug=True)
        for k in range(c):
            hk = ah.Hamiltonian(metric=make(m_all[k]), target=target)
            _, sk, dk = ah.nuts_transition(
                torch.Generator().manual_seed(0), hk, traj,
                hk.phasepoint(theta[k:k + 1], r[k:k + 1]),
                force_directions=directions, return_debug=True)
            assert int(sk["n_steps"][0]) == int(st["n_steps"][k])
            assert int(sk["tree_depth"][0]) == int(st["tree_depth"][k])
            np.testing.assert_allclose(dk["t_rho"][0], dbg["t_rho"][k],
                                       rtol=1e-12)


# ------------------------------------------------------------- 2. pair body
D, C = 6, 16
PREC = torch.linspace(0.5, 3.0, D, dtype=torch.float64)


def _gaussian():
    return ah.LogDensityTarget(
        lambda x: -0.5 * torch.sum(PREC * x * x, -1), D,
        lambda x: (-0.5 * torch.sum(PREC * x * x, -1), -PREC * x))


@pytest.mark.parametrize("crit,ts", PAIRS)
@pytest.mark.parametrize("eps,max_depth,per_chain", [
    (0.4, 6, False),
    (1.7, 6, True),       # divergent trees, at A and at B
])
def test_pair_transition_is_bitwise_the_single_one(crit, ts, eps, max_depth,
                                                   per_chain):
    metric = ah.make_metric("diagonal", D, torch.float64, device="cpu")
    eps_t = torch.tensor(eps, dtype=torch.float64)
    if per_chain:
        metric = ah.DiagEuclideanMetric.create(
            torch.linspace(0.6, 1.4, C * D, dtype=torch.float64).view(C, D))
        eps_t = eps_t * torch.linspace(0.7, 1.3, C, dtype=torch.float64)
    h = ah.Hamiltonian(metric=metric, target=_gaussian())
    traj = ah.Trajectory(ah.Leapfrog(step_size=eps_t),
                         CRITERIA[crit](max_depth=max_depth), ts_kind=ts)
    gen = torch.Generator().manual_seed(1)
    z0 = h.init_phasepoint(
        gen, torch.randn(C, D, generator=gen, dtype=torch.float64))
    (z1, s1, d1), (z2, s2, d2) = [
        nuts.nuts_transition(torch.Generator().manual_seed(5), h, traj, z0,
                             return_debug=True, _pair=pair)
        for pair in (False, True)]
    assert not _mismatches(d1, d2, d1["ck_r"].shape[1] - 1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert torch.equal(z1.theta, z2.theta)
    if eps > 1:
        assert bool(s1["numerical_error"].any())
    else:       # trees past the depth that strict's half-span checks need
        assert int(s1["tree_depth"].max()) >= 3


# ------------------------------------------------------- 3. slice candidates
@pytest.mark.parametrize("theta0,directions", [(-0.5, (1, 1)),
                                               (0.5, (-1, -1))])
def test_slice_candidate_law_at_depth_two(theta0, directions):
    """All 20000 chains start at one point (θ₀, r₀ = 2) of −θ²/2 and grow
    the same depth-2 tree (ε 0.9, no U-turn, energy errors 0.2, 0.5 and
    0.13 at its three leaves); only ℓu and the draws differ. Given each
    chain's ℓu, its candidate is the root or leaf 1 or, with probability
    q = min(1, s_w/t_w), a uniform pick among the acceptable leaves of the
    second doubling (leaf 1 replaces the root when acceptable, since
    min(1, 1/1) = 1). The counts of the four points must lie within 4
    binomial σ of their sums of probabilities, and t_w must equal the
    count of acceptable points."""
    n, eps = 20000, 0.9
    target = ah.LogDensityTarget(lambda x: -0.5 * torch.sum(x * x, -1), 1,
                                 lambda x: (-0.5 * torch.sum(x * x, -1), -x))
    h = ah.Hamiltonian(metric=ah.make_metric("unit", 1, torch.float64,
                                             device="cpu"), target=target)
    z0 = h.phasepoint(torch.full((n, 1), theta0, dtype=torch.float64),
                      torch.full((n, 1), 2.0, dtype=torch.float64))
    traj = ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(eps, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=2), ts_kind="slice")
    zc, st, dbg = ah.nuts_transition(torch.Generator().manual_seed(7), h,
                                     traj, z0, force_directions=directions,
                                     return_debug=True)
    assert bool((st["n_steps"] == 3).all() & (st["tree_depth"] == 2).all())
    assert not bool(st["numerical_error"].any())
    step = torch.tensor(eps * directions[0], dtype=torch.float64)
    z1 = leapfrog_step(h, z0, step)
    z2 = leapfrog_step(h, z1, step)
    z3 = leapfrog_step(h, z2, step)
    points = (z0, z1, z2, z3)
    lu = dbg["lu"].numpy()
    acc = np.stack([lu <= -float(z.energy()[0]) for z in points[1:]],
                   1).astype(float)
    t_w = 1.0 + acc[:, 0]
    s_w = acc[:, 1] + acc[:, 2]
    q = np.minimum(1.0, s_w / t_w)
    p = np.stack([(1 - q) * (1 - acc[:, 0]), (1 - q) * acc[:, 0],
                  q * acc[:, 1] / np.maximum(s_w, 1),
                  q * acc[:, 2] / np.maximum(s_w, 1)], 1)
    theta = np.array([float(z.theta[0, 0]) for z in points])
    which = np.argmin(np.abs(zc.theta.numpy() - theta[None]), 1)
    counts = np.bincount(which, minlength=4)
    expected, sd = p.sum(0), np.sqrt((p * (1 - p)).sum(0))
    assert np.all(expected > 1000)
    assert np.all(np.abs(counts - expected) <= 4 * sd), (counts, expected,
                                                         sd)
    np.testing.assert_array_equal(dbg["t_w"].numpy(), t_w + s_w)


# ------------------------------------------------- 4. constructors, convert
@pytest.mark.parametrize("crit", sorted(CRITERIA))
@pytest.mark.parametrize("ts", ["multinomial", "slice"])
def test_constructors_and_convert_round_trip(crit, ts):
    cj = CRITERIA_J[crit](max_depth=7, delta_max=500.0)
    ct = convert.criterion(cj)
    assert ct == CRITERIA[crit](max_depth=7, delta_max=500.0)
    cfg = ah.NUTS(0.7, criterion=ct, ts_kind=ts)
    traj = cfg.kernel.trajectory
    assert (traj.criterion, traj.ts_kind) == (ct, ts)
    traj_j = aj.NUTS(0.7, criterion=cj, ts_kind=ts).kernel.trajectory
    back = convert.trajectory(traj_j, device="cpu")
    assert (back.criterion, back.ts_kind) == (ct, ts)


@pytest.mark.parametrize("crit,ts", [
    (ah.ClassicNoUTurn(), "endpoint"),
    (ah.StrictGeneralisedNoUTurn(), "endpoint"),
    (ah.FixedNSteps(4), "slice"),
    (ah.StrictGeneralisedNoUTurn(), "uniform"),
])
def test_invalid_pairs_raise_as_jax(crit, ts):
    lf = ah.Leapfrog(step_size=torch.tensor(0.1))
    crit_j = (aj.FixedNSteps(4) if isinstance(crit, ah.FixedNSteps)
              else CRITERIA_J[{ah.ClassicNoUTurn: "classic",
                               ah.StrictGeneralisedNoUTurn: "strict"}[
                                   type(crit)]]())
    with pytest.raises(ValueError) as err_j:
        aj.Trajectory(aj.Leapfrog(step_size=jnp.asarray(0.1)), crit_j, ts)
    with pytest.raises(ValueError) as err_t:
        ah.Trajectory(lf, crit, ts_kind=ts)
    assert str(err_t.value) == str(err_j.value)

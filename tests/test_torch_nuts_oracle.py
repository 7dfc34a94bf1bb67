"""The port's batched `nuts_transition` against the recursion oracle.

`tests/nuts_oracle.py` transliterates the reference's recursive doubling and
reproduces every deterministic quantity of a transition (leaf count, depth,
Σα, ΔH_max, ρ, tree edges, total log weight, termination) given a forced
direction sequence. The port runs a batch of chains, one per seed, under the
same `force_directions` and must match the oracle of each chain.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj

import advancedhmc_torch as ah
from advancedhmc_torch import convert

from nuts_oracle import nuts_oracle

torch.set_num_threads(2)

N_SEEDS = 3


def _targets(name, dim):
    if name == "std":
        return (lambda x: -0.5 * jnp.sum(x ** 2),
                lambda x: -0.5 * torch.sum(x ** 2, -1))
    if name == "corr":
        prec = np.eye(dim) + 0.5 * np.ones((dim, dim))
        pj, pt = jnp.asarray(prec), torch.as_tensor(prec)
        return (lambda x: -0.5 * x @ pj @ x,
                lambda x: -0.5 * torch.sum((x @ pt) * x, -1))

    def rosen_j(x):
        return -jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                        + (1.0 - x[:-1]) ** 2) / 20.0

    def rosen_t(x):
        return -torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                          + (1.0 - x[:, :-1]) ** 2, -1) / 20.0

    return rosen_j, rosen_t


CASES = [
    ("std", 5, 0.45, 6, 0),
    ("std", 5, 0.45, 6, 1),
    ("corr", 4, 0.3, 6, 2),
    ("rosen", 3, 0.15, 8, 3),
    # large step sizes: divergent trees
    ("std", 2, 2.9, 6, 4),
    ("rosen", 3, 1.5, 6, 5),
]


@pytest.mark.parametrize("tname,dim,eps,max_depth,seed", CASES)
def test_batched_transition_matches_recursion(tname, dim, eps, max_depth,
                                              seed):
    lp_j, lp_t = _targets(tname, dim)
    m_inv = np.linspace(0.5, 2.0, dim)
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(
        jnp.asarray(m_inv)), target=aj.LogDensityTarget(lp_j, dim))
    ht = ah.Hamiltonian(metric=convert.diag_metric(m_inv, "cpu"),
                        target=ah.LogDensityTarget(lp_t, dim))
    crit_j = aj.GeneralisedNoUTurn(max_depth=max_depth, delta_max=1000.0)
    integ = aj.Leapfrog(step_size=jnp.asarray(eps, jnp.float64))
    traj_t = ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(eps, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=max_depth, delta_max=1000.0))

    rng = np.random.default_rng(seed)
    directions = rng.choice([-1, 1], size=max_depth)
    theta0 = rng.normal(size=(N_SEEDS, dim))
    r0 = rng.normal(size=(N_SEEDS, dim)) / np.sqrt(m_inv)
    zj = jax.vmap(hj.phasepoint)(jnp.asarray(theta0), jnp.asarray(r0))
    zt = convert.phasepoint(zj, "cpu")

    gen = torch.Generator().manual_seed(seed)
    zc, stats, dbg = ah.nuts_transition(gen, ht, traj_t, zt,
                                        force_directions=directions,
                                        return_debug=True)
    assert zc.theta.shape == (N_SEEDS, dim)
    for c in range(N_SEEDS):
        z0 = jax.tree_util.tree_map(lambda a: a[c], zj)
        o = nuts_oracle(hj, integ, crit_j, "multinomial", z0, directions)
        assert int(stats["n_steps"][c]) == o["n_steps"]
        assert int(stats["tree_depth"][c]) == o["depth"]
        assert bool(stats["numerical_error"][c]) == o["diverged"]
        np.testing.assert_allclose(float(stats["acceptance_rate"][c]),
                                   o["sum_alpha"] / max(o["n_steps"], 1),
                                   rtol=1e-10)
        if np.isfinite(o["dh_max"]):
            np.testing.assert_allclose(
                float(stats["max_hamiltonian_energy_error"][c]), o["dh_max"],
                rtol=1e-8)
        np.testing.assert_allclose(dbg["t_rho"][c].numpy(), o["rho"],
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(dbg["t_zleft"].theta[c].numpy(),
                                   o["zleft_theta"], rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(dbg["t_zright"].theta[c].numpy(),
                                   o["zright_theta"], rtol=1e-8, atol=1e-12)
        if np.isfinite(o["logw"]):
            np.testing.assert_allclose(float(dbg["t_w"][c]), o["logw"],
                                       rtol=1e-8, atol=1e-12)
        # the candidate is a point of the trajectory, with a finite density
        assert np.isfinite(float(zc.logdensity[c]))

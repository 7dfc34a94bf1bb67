"""`sample(mesh=...)`: chain parallelism over processes under gloo.

Each run below is a group of processes started from this file run as a
script (`python tests/test_torch_mesh.py RANK WORLD STORE OUT`), joined by
`torch.distributed` over a file store, on the CPU, as the JAX package's
`tests/test_parallel.py` runs its mesh on virtual CPU devices: a standard
Gaussian in 4-D, float64, 16 chains. Every run samples the same paths from
the same seed and writes each rank's arrays to an npz:

* no mesh (one process, no process group), a world of one
  (`mesh_of_all_devices()` without a group), 2 ranks and 4 ranks;
* 2 ranks whose generators are seeded differently, where `sample` must
  raise before it draws.

The sharded runs must reproduce the unsharded one bit for bit: the draws,
every stat, the final ε and M⁻¹, on the cross-chain step path, per chain,
the fused warmup with fan-out, the pair-body fused draws, the ragged
draws, and the cross-chain step path with the Welford covariance, the
low-rank and the nutpie estimators. A last gate holds the 2-rank run to
JAX `sample(mesh=mesh_of_all_devices(8))` in distribution.
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import advancedhmc_torch as ah
from advancedhmc_torch.checkpoint import _flatten
from advancedhmc_torch.experimental import fused_draw_phase_ragged

D, N_CHAINS, N_SAMPLES, N_ADAPTS = 4, 16, 40, 20
SEED = 3
ROOT = Path(__file__).resolve().parent.parent

# path -> (sample's keywords, metric kind); every path adapts with Stan
PATHS = {
    "cross_step": (dict(cross_chain=True), "diagonal"),
    "per_chain": (dict(cross_chain=False), "diagonal"),
    "fused_fanout": (dict(cross_chain=True, drop_warmup=True,
                          fuse_warmup=True, fuse_warmup_block=4,
                          warmup_chains=8, fanout_decorrelate=4,
                          fuse_draws=10), "diagonal"),
    "pair_fused": (dict(cross_chain=True, drop_warmup=True,
                        fuse_warmup=True, fuse_warmup_block=4,
                        fuse_draws=10, fuse_pair=True), "diagonal"),
    "cov": (dict(cross_chain=True, mm_kind="welford_cov"), "dense"),
    "lowrank": (dict(cross_chain=True, mm_kind="lowrank"), "rank_update"),
    "nutpie": (dict(cross_chain=True, mm_kind="nutpie"), "diagonal"),
    # the run held to JAX's mesh run in distribution
    "long": (dict(cross_chain=True, drop_warmup=True, n=160, n_adapts=80),
             "diagonal"),
}


def _kernel():
    lf = ah.Leapfrog(step_size=torch.tensor(0.4, dtype=torch.float64))
    return ah.HMCKernel(ah.Trajectory(lf, ah.GeneralisedNoUTurn(max_depth=6)))


def _arrays(prefix, res):
    """The result's arrays: draws and stats (whole batch), and every tensor
    of the final state (ε, the metric, the adaptation state: this rank's
    rows of the chain-major ones)."""
    out = {f"{prefix}/thetas": res.thetas}
    out.update({f"{prefix}/stat/{k}": v for k, v in res.stats.items()})
    if res.warmup_stats is not None:
        out.update({f"{prefix}/warm/{k}": v
                    for k, v in res.warmup_stats.items()})
    leaves, _ = _flatten(res.final_state)
    out.update({f"{prefix}/state/{path}": v for path, v in leaves
                if isinstance(v, torch.Tensor)})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def _sample_paths(mesh, seed=SEED):
    """Every path from `seed`; the arrays of this process."""
    target = ah.std_gaussian(D, device="cpu")
    out = {}
    for name, (kw, kind) in PATHS.items():
        kw = dict(kw)
        adaptor = ah.AdaptorConfig(kind="stan",
                                   mm_kind=kw.pop("mm_kind", "welford_var"),
                                   mm_rank=2)
        metric = ah.make_metric(kind, D, torch.float64, device="cpu",
                                rank=2 if kind == "rank_update" else 0)
        gen = torch.Generator().manual_seed(seed)
        res = ah.sample(gen, target, _kernel(), metric,
                        torch.zeros(N_CHAINS, D, dtype=torch.float64),
                        kw.pop("n", N_SAMPLES),
                        n_adapts=kw.pop("n_adapts", N_ADAPTS),
                        adaptor=adaptor, init_eps=0.4, mesh=mesh,
                        device="cpu", **kw)
        out.update(_arrays(name, res))
        if name == "cross_step":
            # the ragged draws from this warmed state, on the same shard
            spec = ah.SampleSpec(target=target, kernel=_kernel(),
                                 adaptor=adaptor, cross_chain=True)
            with (ah.parallel.sharded(mesh) if mesh is not None
                  else contextlib.nullcontext()):
                _, th, counts, stats = fused_draw_phase_ragged(
                    gen, spec, res.final_state, 24, 12)
            out["ragged/thetas"] = th.numpy()
            out["ragged/counts"] = counts.numpy()
            out.update({f"ragged/stat/{k}": v.numpy()
                        for k, v in stats.items()})
    # a per-chain state built whole on every rank, then this rank's block
    spec = ah.SampleSpec(target=target, kernel=_kernel(),
                         adaptor=ah.AdaptorConfig(kind="stan"))
    full = ah.init_state(
        torch.Generator().manual_seed(seed), spec,
        ah.make_metric("diagonal", D, torch.float64, device="cpu"),
        torch.randn(N_CHAINS, D, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(seed)),
        init_eps=torch.linspace(0.3, 0.5, N_CHAINS, dtype=torch.float64),
        device="cpu")
    if mesh is not None:
        full = ah.parallel.shard_hmc_state(full, mesh, per_chain_adapt=True)
    out["shard/z"] = full.z.theta.numpy()
    out["shard/eps"] = full.adapt.da.eps.numpy()
    out["shard/m_inv"] = full.metric.m_inv.numpy()
    return out


def _worker(rank, world, store, out):
    """One process of a run: world 0 is the unsharded run (no group),
    world 1 a world of one started by `mesh_of_all_devices`; a negative
    world is a group of |world| whose ranks seed their generators
    differently."""
    torch.set_num_threads(1)
    mismatch = world < 0
    world = abs(world)
    mesh = None
    if world > 1:
        ah.parallel.distributed_init(backend="gloo",
                                     init_method=f"file://{store}",
                                     world_size=world, rank=rank)
    if world:
        mesh = ah.parallel.mesh_of_all_devices()
    if mismatch:
        try:
            _sample_paths(mesh, seed=SEED + rank)
        except ValueError as e:
            np.savez(out, error=np.array(str(e)))
        return
    np.savez(out, **_sample_paths(mesh))


RUNS = {"none": 0, "one": 1, "two": 2, "four": 4, "mismatch": -2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every run's processes together; {run: [each rank's npz]}."""
    tmp = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=str(ROOT))
    procs, files = [], {}
    for run, world in RUNS.items():
        files[run] = []
        for rank in range(max(1, abs(world))):
            out = tmp / f"{run}-{rank}.npz"
            files[run].append(out)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(rank), str(world),
                 str(tmp / f"{run}.store"), str(out)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {run: [dict(np.load(f)) for f in fs] for run, fs in files.items()}


def _whole(parts, key):
    """A per-rank array put back together: gathered arrays (draws, stats)
    and shared state are whole on every rank and must agree; sharded ones
    (the final phase points, a per-chain metric and adaptation state, the
    ragged outputs) are concatenated in rank order."""
    arrs = [p[key] for p in parts]
    path = key.split("/")
    sharded = path[0] in ("ragged", "shard") or path[1] == "state" and (
        path[2].startswith("z.")
        or path[0] == "per_chain" and arrs[0].ndim >= 1)
    if sharded:
        return np.concatenate(arrs, 0)
    for a in arrs[1:]:
        np.testing.assert_array_equal(a, arrs[0], err_msg=key)
    return arrs[0]


def _assert_same(ref, parts, paths):
    keys = [k for k in ref if k.split("/")[0] in paths]
    assert keys
    for key in keys:
        np.testing.assert_array_equal(_whole(parts, key), ref[key],
                                      err_msg=key)


@pytest.mark.parametrize("path", [*PATHS, "ragged"])
def test_two_ranks_reproduce_the_unsharded_run_bitwise(runs, path):
    _assert_same(runs["none"][0], runs["two"], [path])


def test_shard_hmc_state_keeps_each_ranks_rows(runs):
    """`shard_hmc_state` on a per-chain state: the ranks' rows of the
    phase points, ε and M⁻¹, in rank order, are the whole state's."""
    for run in ("two", "four"):
        _assert_same(runs["none"][0], runs[run], ["shard"])


def test_four_ranks_give_the_two_rank_result(runs):
    two = {k: _whole(runs["two"], k) for k in runs["two"][0]}
    _assert_same(two, runs["four"], [*PATHS, "ragged"])


def test_world_of_one_is_the_run_without_mesh(runs):
    _assert_same(runs["none"][0], runs["one"], [*PATHS, "ragged"])


def test_mismatched_generators_raise(runs):
    for part in runs["mismatch"]:
        assert "generators differ" in str(part["error"])


def test_two_ranks_match_jax_mesh_in_distribution(runs):
    """The port's 2-rank run against JAX's 8-device mesh run (conftest's
    host devices), cross-chain step path, 80 draws of 16 chains: the
    draws' mean and variance within 5 combined standard errors (the ESS
    taken as a tenth of the draws), mean acceptance within 0.1, and final
    ε within a factor 1.5, of each other."""
    import jax
    import jax.numpy as jnp

    from advancedhmc_tpu import AdaptorConfig, GeneralisedNoUTurn, \
        HMCKernel, Leapfrog, Trajectory, make_metric, sample
    from advancedhmc_tpu.models import std_gaussian
    from advancedhmc_tpu.parallel.mesh import mesh_of_all_devices

    port = runs["two"][0]
    jx = sample(jax.random.PRNGKey(0), std_gaussian(D),
                HMCKernel(Trajectory(Leapfrog(step_size=jnp.asarray(
                    0.4, jnp.float64)), GeneralisedNoUTurn(max_depth=6),
                    "multinomial")),
                make_metric("diagonal", D, dtype=jnp.float64),
                jnp.zeros((N_CHAINS, D), jnp.float64), 160, n_adapts=80,
                adaptor=AdaptorConfig(kind="stan"), init_eps=0.4,
                cross_chain=True, drop_warmup=True,
                mesh=mesh_of_all_devices(8))
    jd = np.asarray(jx.thetas).reshape(-1, D)
    pd = port["long/thetas"].reshape(-1, D)
    for a, b in ((pd, jd),):
        se = np.sqrt(a.var(0) / (0.1 * len(a)) + b.var(0) / (0.1 * len(b)))
        assert np.all(np.abs(a.mean(0) - b.mean(0)) < 5 * se)
        se_v = np.sqrt(2 * a.var(0) ** 2 / (0.1 * len(a))
                       + 2 * b.var(0) ** 2 / (0.1 * len(b)))
        assert np.all(np.abs(a.var(0) - b.var(0)) < 5 * se_v)
    acc_j = float(np.mean(np.asarray(jx.stats["acceptance_rate"])))
    acc_p = float(port["long/stat/acceptance_rate"].mean())
    assert abs(acc_j - acc_p) < 0.1, (acc_j, acc_p)
    eps_j = float(jx.final_state.adapt.da.eps)
    eps_p = float(port["long/state/adapt.da.eps"])
    assert 1 / 1.5 < eps_p / eps_j < 1.5, (eps_p, eps_j)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

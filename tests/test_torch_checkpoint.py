"""Checkpoints of the port (`advancedhmc_torch.checkpoint`), with the JAX
package's semantics (`tests/test_api.py`'s checkpoint tests): bitwise
round trips of cross-chain and per-chain states with every metric,
`SampleResult.save`/`load_result`, the field-level errors on a structure
mismatch, narrowing loads refused and widening ones warned, files holding
pickled objects refused, and N + N transitions from a loaded state and
generator bitwise the 2N of one run.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import checkpoint as ckj
from advancedhmc_tpu.models import std_gaussian as std_gaussian_j

import advancedhmc_torch as ah
from advancedhmc_torch import checkpoint as ck

torch.set_num_threads(2)

D, C = 3, 4
METRICS = {"diagonal": ("welford_var", {}), "dense": ("welford_cov", {}),
           "rank_update": ("lowrank", {"rank": 2})}


def _spec(metric_kind="diagonal", cross_chain=False):
    mm_kind = METRICS[metric_kind][0]
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.3, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=4)))
    return ah.SampleSpec(
        target=ah.std_gaussian(D, device="cpu"), kernel=kernel,
        adaptor=ah.AdaptorConfig(kind="stan", mm_kind=mm_kind, mm_rank=2),
        cross_chain=cross_chain)


def _state(metric_kind="diagonal", cross_chain=False, c=C, dim=D,
           dtype=torch.float64, steps=2, seed=4):
    spec = _spec(metric_kind, cross_chain)
    if dim != D:
        spec = ah.SampleSpec(target=ah.std_gaussian(dim, device="cpu"),
                             kernel=spec.kernel, adaptor=spec.adaptor,
                             cross_chain=cross_chain)
    gen = torch.Generator().manual_seed(seed)
    metric = ah.make_metric(metric_kind, dim, dtype=dtype, device="cpu",
                            **METRICS[metric_kind][1])
    state = ah.init_state(gen, spec, metric, torch.zeros(c, dim, dtype=dtype),
                          init_eps=0.3, device="cpu")
    flags = dict(is_adapt=True, in_window=True, window_end=False,
                 is_last=False)
    for _ in range(steps):
        state, _ = ah.sample_step(gen, spec, state, flags)
    return spec, state


def _leaves(tree):
    return [leaf for _, leaf in ck._flatten(tree)[0]]


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("metric_kind", list(METRICS))
@pytest.mark.parametrize("cross_chain", [False, True])
def test_state_round_trip_is_bitwise(tmp_path, metric_kind, cross_chain):
    spec, state = _state(metric_kind, cross_chain)
    path = str(tmp_path / "ck.npz")
    ck.save_state(path, state)
    _, like = _state(metric_kind, cross_chain, seed=9, steps=0)
    restored = ck.load_state(path, like)
    _assert_bitwise(restored, state)
    assert restored.iteration == state.iteration == 2
    # the manifest names every leaf by its field path
    names = [m[0] for m in ck._manifest_of(state)]
    assert names[:3] == ["iteration", "z.theta", "z.r"]
    assert "adapt.da.eps" in names


def test_manifest_paths_match_jax():
    """The port's paths are the JAX manifest's for the leaves both have
    (the JAX package's metric and estimator carry some leaves the port's
    do not, and the reverse)."""
    spec_j = aj.sampler.SampleSpec(
        target=std_gaussian_j(D),
        kernel=aj.HMCKernel(aj.Trajectory(aj.Leapfrog(
            step_size=jnp.asarray(0.3)), aj.GeneralisedNoUTurn(max_depth=4))),
        adaptor=aj.AdaptorConfig(kind="stan"), cross_chain=False)
    state_j = aj.init_state(jax.random.PRNGKey(4), spec_j,
                            aj.make_metric("diagonal", D, dtype=jnp.float64),
                            jnp.zeros((C, D), jnp.float64), init_eps=0.3)
    names_j = [m[0] for m in ckj._manifest_of(state_j)]
    names_t = [m[0] for m in ck._manifest_of(_state()[1])]
    common = [n for n in names_t if n in names_j]
    assert {"iteration", "z.theta", "z.r", "z.logdensity", "z.grad",
            "z.neg_k", "metric.m_inv", "adapt.da.eps"} <= set(common)
    assert common == [n for n in names_j if n in names_t]


def _result(collect="draws"):
    spec = _spec(cross_chain=True)
    return ah.sample(torch.Generator().manual_seed(1), spec.target,
                     spec.kernel, ah.make_metric("diagonal", D,
                                                 dtype=torch.float64,
                                                 device="cpu"),
                     torch.zeros(C, D, dtype=torch.float64), 24, n_adapts=8,
                     adaptor=spec.adaptor, cross_chain=True, drop_warmup=True,
                     collect=collect, device="cpu")


@pytest.mark.parametrize("collect", ["draws", "online"])
def test_result_round_trip_is_bitwise(tmp_path, collect):
    res = _result(collect)
    path = str(tmp_path / "res.npz")
    res.save(path)
    _, like = _state(cross_chain=True, seed=3, steps=0)
    back = ck.load_result(path, like_state=like, device="cpu")
    if collect == "draws":
        assert torch.equal(back.thetas, res.thetas)
        assert back.online is None
    else:
        assert back.thetas is None and res.thetas is None
        assert set(back.online) == set(res.online)
        for k, v in res.online.items():
            assert torch.equal(back.online[k], torch.as_tensor(v)), k
    assert set(back.stats) == set(res.stats)
    for k, v in res.stats.items():
        assert back.stats[k].dtype == v.dtype and torch.equal(back.stats[k],
                                                              v), k
    assert set(back.warmup_stats) == set(res.warmup_stats)
    for k, v in res.warmup_stats.items():
        assert torch.equal(back.warmup_stats[k], v), k
    _assert_bitwise(back.final_state, res.final_state)
    # without a like state, the draws and stats load and the state does not
    assert ck.load_result(path, device="cpu").final_state is None


def test_result_of_a_tuple_state_round_trips(tmp_path):
    """A result whose final state is any tree of dataclasses and tensors
    (here `sample_rmhmc`'s (phase points, dual-averaging state))."""
    from advancedhmc_torch.riemannian import RiemannianPhasePoint

    g = torch.Generator().manual_seed(0)
    z = RiemannianPhasePoint(*(torch.randn(C, D, generator=g,
                                           dtype=torch.float64)
                               for _ in range(2)),
                             torch.randn(C, generator=g, dtype=torch.float64),
                             torch.randn(C, D, generator=g,
                                         dtype=torch.float64),
                             torch.randn(C, generator=g, dtype=torch.float64))
    da = ah.DualAveragingState.init(torch.tensor(0.3, dtype=torch.float64))
    res = ah.SampleResult(thetas=torch.randn(5, C, D, generator=g),
                          stats={"n_steps": torch.ones(5, C,
                                                       dtype=torch.int32)},
                          warmup_stats=None, final_state=(z, da))
    path = str(tmp_path / "r.npz")
    res.save(path)
    back = ck.load_result(path, like_state=(z, da), device="cpu")
    _assert_bitwise(back.final_state, (z, da))
    assert torch.equal(back.thetas, res.thetas)


def test_mismatched_structure_raises_naming_the_field(tmp_path):
    """Chain count, dimension, per-chain against shared adaptation, metric
    kind (dense carries a Cholesky factor; unit has no M⁻¹ leaf): each a
    ValueError, the shape errors naming the field (`tests/test_api.py`'s
    cases)."""
    _, state = _state()
    path = str(tmp_path / "ck.npz")
    ck.save_state(path, state)
    with pytest.raises(ValueError, match=r"z\.theta.*shape"):
        ck.load_state(path, _state(c=5, steps=0)[1])
    with pytest.raises(ValueError, match=r"z\.theta.*shape"):
        ck.load_state(path, _state(dim=4, steps=0)[1])
    with pytest.raises(ValueError, match=r"metric\.m_inv.*shape"):
        ck.load_state(path, _state(cross_chain=True, steps=0)[1])
    with pytest.raises(ValueError, match=r"metric\.(m_inv|chol_u|sqrt_m_inv)"):
        ck.load_state(path, _state("dense", steps=0)[1])
    spec = _spec()
    unit = ah.init_state(torch.Generator(), spec, ah.make_metric(
        "unit", D, dtype=torch.float64, device="cpu"),
        torch.zeros(C, D, dtype=torch.float64), init_eps=0.3, device="cpu")
    with pytest.raises(ValueError, match="structure mismatch.*unexpected"):
        ck.load_state(path, unit)


def test_narrowing_raises_and_widening_warns(tmp_path):
    """A float64 checkpoint into a float32 state raises unless allowed
    (then warns and casts); float32 into float64 warns and casts."""
    _, s64 = _state(dtype=torch.float64, steps=0)
    _, s32 = _state(dtype=torch.float32, steps=0)
    p64, p32 = str(tmp_path / "ck64.npz"), str(tmp_path / "ck32.npz")
    ck.save_state(p64, s64)
    with pytest.raises(ValueError, match="narrow"):
        ck.load_state(p64, s32)
    with pytest.warns(UserWarning, match="stored as float64"):
        r = ck.load_state(p64, s32, allow_narrowing=True)
    assert r.z.theta.dtype == torch.float32
    ck.save_state(p32, s32)
    with pytest.warns(UserWarning, match="stored as float32"):
        r = ck.load_state(p32, s64)
    assert r.z.theta.dtype == torch.float64
    torch.testing.assert_close(r.z.theta, s32.z.theta.double())
    # the same dtypes load without a warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ck.load_state(p64, s64)


def test_pickled_objects_are_refused(tmp_path):
    """A file whose leaf is an object array (a pickle) is refused: the
    port reads with allow_pickle=False."""
    _, state = _state(steps=0)
    path = str(tmp_path / "ck.npz")
    ck.save_state(path, state)
    data = dict(np.load(path))
    data["leaf_1"] = np.array([object()] * (C * D), dtype=object).reshape(
        C, D)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **data)
    with pytest.raises(ValueError, match="allow_pickle"):
        ck.load_state(bad, state)
    res = str(tmp_path / "res.npz")
    ah.SampleResult(thetas=torch.zeros(2, C, D), stats={},
                    warmup_stats=None, final_state=state).save(res)
    data = dict(np.load(res))
    data["thetas"] = np.array([object()] * 2, dtype=object)
    np.savez(bad, **data)
    with pytest.raises(ValueError, match="allow_pickle"):
        ck.load_result(bad, device="cpu")


def test_generator_state_round_trips_and_is_required(tmp_path):
    _, state = _state(steps=0)
    path = str(tmp_path / "ck.npz")
    ck.save_state(path, state)
    with pytest.raises(ValueError, match="generator"):
        ck.load_state(path, state, generator=torch.Generator())


@pytest.mark.parametrize("cross_chain", [False, True])
def test_resume_is_bitwise_the_straight_run(tmp_path, cross_chain):
    """N transitions, a checkpoint with the generator, a restore into a
    fresh state and generator, N more: bitwise the 2N of one run (per
    chain: `sample_step` with adaptation; cross-chain: the fused draws)."""
    n = 3
    spec, state0 = _state(cross_chain=cross_chain, steps=1)
    flags = dict(is_adapt=True, in_window=True, window_end=False,
                 is_last=False)

    def run(gen, state, k):
        if cross_chain:
            state, th, _ = ah.fused_draw_phase(gen, spec, state, k, k)
            return state, list(th)
        out = []
        for _ in range(k):
            state, _ = ah.sample_step(gen, spec, state, flags)
            out.append(state.z.theta)
        return state, out

    _, straight = run(torch.Generator().manual_seed(7), state0, 2 * n)
    gen = torch.Generator().manual_seed(7)
    mid, first = run(gen, state0, n)
    path = str(tmp_path / "mid.npz")
    ck.save_state(path, mid, generator=gen)
    gen2 = torch.Generator().manual_seed(123)
    _, like = _state(cross_chain=cross_chain, seed=11, steps=0)
    restored = ck.load_state(path, like, generator=gen2)
    _, second = run(gen2, restored, n)
    for a, b in zip(straight, first + second):
        assert torch.equal(a, b)

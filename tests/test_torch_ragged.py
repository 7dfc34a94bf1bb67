"""The ragged draw mode, its ESS, the transient depth caps, the tail ESS
and the end-of-run report against the JAX package.

`transient_depth_caps` is a NumPy schedule: equal to JAX's, element for
element. `effective_sample_size_ragged` gets the same float64 draws and
counts on both sides: within 1e-10 (relative), then against iid ground
truth and the pooled ESS on rectangular draws as the JAX tests hold it.
The ragged fused loop is the rectangular one with another stopping rule:
each chain's first counts[c] draws and stats are bitwise those of the
port's rectangular run from the same generator seed, with a shared and a
per-chain ε and M⁻¹ (the chains share one generator, so the port is held
to its own rectangular run, not to JAX's streams). Against JAX the mode is
held in distribution: on a 5-D standard Gaussian, 64 chains, t_min 16,
t_max 24, four calls, the mean count within 0.5 of JAX's and the
count-weighted moments within 0.15 (mean) and 0.2 (variance) of the exact
ones on both sides. `ebfmi`, `summarize` (with `ess_tail`), `ess_tail` and
`split_rhat` get the same float64 inputs on both sides: 1e-12 (relative);
the linear-interpolation quantiles past 2^24 draws of one parameter (where
`torch.quantile` refuses) 1e-14.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import diagnostics as dj
from advancedhmc_tpu.adaptation import transient_depth_caps as caps_j
from advancedhmc_tpu.diagnostics import effective_sample_size as ess_j
from advancedhmc_tpu.diagnostics import effective_sample_size_ragged as \
    ess_ragged_j
from advancedhmc_tpu.experimental import fused_draw_phase_ragged as ragged_j
from advancedhmc_tpu.sampler import SampleSpec as SpecJ

import advancedhmc_torch as ah
from advancedhmc_torch import diagnostics as dt
from advancedhmc_torch import nuts as nuts_t
from advancedhmc_torch.experimental import fused_draw_phase_ragged
from test_torch_surface import _ar1, _close, _stats

torch.set_num_threads(2)

D, C = 5, 8


# ------------------------------------------------------------ depth caps
@pytest.mark.parametrize("args", [
    (256, 6, 3, 40, 16, 75, 50, 25),     # the JAX test's case
    (128, 6, 4, 40, 16, 75, 50, 25),     # bench.py's TCAP run
    (1000, 10, 5, 40, 16, 75, 50, 25),
    (300, 8, 2, 10, 30, 20, 20, 10),
    (60, 5, 3, 100, 16, 15, 10, 5),      # init_len past n_adapts
    (20, 6, 1, 0, 0, 5, 5, 5),
])
def test_transient_depth_caps_equal_jax(args):
    got = ah.transient_depth_caps(*args)
    want = np.asarray(caps_j(*args))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_transient_depth_caps_schedule():
    """The JAX test's own case: capped over the init ramp and after each
    window reset, full depth between."""
    caps = ah.transient_depth_caps(256, 6, 3, init_len=40, post_len=16)
    assert (caps[:40] == 3).all()
    _, w_end = ah.stan_schedule(256)
    resets = np.nonzero(w_end)[0]
    assert len(resets) >= 1
    for r in resets:
        assert (caps[r + 1:r + 17] == 3).all()
    assert caps[resets[0] - 5] == 6


# ------------------------------------------------------------ ragged ESS
def _ragged_draws(rng, c, t, dim, phi=0.6):
    x = np.zeros((c, t, dim))
    e = rng.normal(size=(c, t, dim))
    for i in range(1, t):
        x[:, i] = phi * x[:, i - 1] + e[:, i]
    return x


@pytest.mark.parametrize("case", ["random counts", "full", "degenerate"])
def test_ragged_ess_matches_jax(case):
    """Within 1e-10 of JAX's on the same float64 draws and counts: random
    counts, every count at T, and chains with no draw, one draw or no
    variance (each adds 0)."""
    rng = np.random.default_rng(3)
    c, t, dim = 24, 96, 3
    x = _ragged_draws(rng, c, t, dim)
    counts = {"random counts": rng.integers(2, t + 1, size=c),
              "full": np.full(c, t),
              "degenerate": rng.integers(0, t + 1, size=c)}[case]
    if case == "degenerate":
        counts[:3] = (0, 1, 2)
        x[3, :] = 1.5
    x = x * (np.arange(t)[None, :, None] < counts[:, None, None])
    got = ah.effective_sample_size_ragged(torch.from_numpy(x),
                                          torch.from_numpy(counts))
    want = np.asarray(ess_ragged_j(jnp.asarray(x), jnp.asarray(counts)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)


def test_ragged_ess_iid_ground_truth():
    """On iid draws with random counts the summed ESS is about the total
    count (JAX `tests/test_ragged.py`'s tolerance, 0.25)."""
    rng = np.random.default_rng(1)
    c, t, dim = 64, 256, 3
    x = rng.normal(size=(c, t, dim))
    counts = rng.integers(128, t + 1, size=c)
    ess = ah.effective_sample_size_ragged(torch.from_numpy(x),
                                          torch.from_numpy(counts))
    np.testing.assert_allclose(ess.numpy(), counts.sum(), rtol=0.25)


def test_ragged_ess_rectangular_matches_pooled():
    """On rectangular AR(1) draws the per-chain sum agrees with the pooled
    ESS within the JAX test's 0.25."""
    rng = np.random.default_rng(2)
    x = np.swapaxes(_ragged_draws(rng, 32, 512, 2, phi=0.7), 0, 1)
    pooled = ah.effective_sample_size(torch.from_numpy(x))
    ragged = ah.effective_sample_size_ragged(
        torch.from_numpy(np.swapaxes(x, 0, 1)), torch.full((32,), 512))
    np.testing.assert_allclose(ragged.numpy(), pooled.numpy(), rtol=0.25)
    np.testing.assert_allclose(
        pooled.numpy(), np.asarray(ess_j(jnp.asarray(x))), rtol=1e-10)


# ----------------------------------------- tail ESS, R̂ and the report
@pytest.mark.parametrize("shape", [(200, 4, 3, 0.5), (101, 8, 2, 0.9),
                                   (64, 1, 5, -0.3)])
def test_tail_ess_and_split_rhat_match_jax(shape):
    n, m, dim, phi = shape
    x = _ar1(n, m, dim, phi, seed=n)
    _close(ah.ess_tail(torch.from_numpy(x)), dj.ess_tail(jnp.asarray(x)))
    _close(ah.ess_tail(torch.from_numpy(x), prob=0.1),
           dj.ess_tail(jnp.asarray(x), prob=0.1))
    _close(ah.split_rhat(torch.from_numpy(x)),
           dj.split_rhat(jnp.asarray(x)))


def test_quantiles_and_tail_ess_past_2_24_draws():
    """4100 draws × 4100 chains of one parameter pool 16 810 000 > 2^24
    values, which `torch.quantile` refuses; the port's quantiles (two
    order statistics) agree with `jnp.quantile` and numpy's to 1e-14, and
    the tail ESS of these iid draws is within 5 % of their count (the tail
    ESS is held to JAX's on the shapes above)."""
    x = np.random.default_rng(0).normal(size=(4100, 4100, 1))
    flat = torch.from_numpy(x.reshape(-1, 1))
    assert flat.shape[0] > 1 << 24
    with pytest.raises(RuntimeError):
        torch.quantile(flat, 0.05, dim=0)
    # jnp.quantile sorts (about 11 s a call here): once, the others
    # against numpy's quantile, the same linear interpolation
    _close(dt.quantile0(flat, 0.05),
           jnp.quantile(jnp.asarray(x.reshape(-1, 1)), 0.05, axis=0),
           rtol=1e-14, atol=0)
    for q in (0.95, 0.5):
        _close(dt.quantile0(flat, q), np.quantile(x.reshape(-1, 1), q, 0),
               rtol=1e-14, atol=0)
    _close(ah.ess_tail(torch.from_numpy(x)), [x.size], rtol=0.05)


def test_ebfmi_and_summarize_match_jax():
    """The end-of-run report on the same float64 stats and draws: E-BFMI,
    the mean acceptance and divergence rate per chain, bulk and tail ESS
    and R̂, each to 1e-12; with online stats the report's ESS is the
    summary's."""
    rng = np.random.default_rng(5)
    stats = _stats(rng, 256, 6)
    x = _ar1(256, 6, 3, 0.6, seed=9)
    _close(ah.ebfmi(torch.from_numpy(stats["hamiltonian_energy"])),
           dj.ebfmi(jnp.asarray(stats["hamiltonian_energy"])))
    res_t = types.SimpleNamespace(
        stats={k: torch.from_numpy(v) for k, v in stats.items()},
        thetas=torch.from_numpy(x), online=None)
    res_j = types.SimpleNamespace(
        stats={k: jnp.asarray(v) for k, v in stats.items()},
        thetas=jnp.asarray(x), online=None)
    got, want = dt.summarize(res_t, verbose=False), \
        dj.summarize(res_j, verbose=False)
    assert set(got) == set(want) == {
        "ebfmi", "mean_acceptance_rate", "divergence_rate", "ess",
        "ess_tail", "rhat"}
    for k in want:
        _close(got[k], want[k])
    online = {"ess": np.arange(1.0, 4.0)}
    got = dt.summarize(dataclasses.replace(
        ah.SampleResult(None, res_t.stats, None, None),
        online={"ess": torch.from_numpy(online["ess"])}), verbose=False)
    _close(got["ess"], online["ess"])
    assert "ess_tail" not in got


# ------------------------------------------------------- the ragged loop
def _spec(cross_chain, criterion=None):
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.25, dtype=torch.float64)),
        criterion or ah.GeneralisedNoUTurn(max_depth=6)))
    return ah.SampleSpec(target=ah.std_gaussian(D, device="cpu"),
                         kernel=kernel,
                         adaptor=ah.AdaptorConfig(kind="none"),
                         cross_chain=cross_chain)


def _state(spec, seed=0):
    """Shared ε and M⁻¹ (cross-chain), or each chain its own."""
    rng = np.random.default_rng(seed)
    th0 = torch.as_tensor(0.3 * rng.normal(size=(C, D)))
    state = ah.init_state(torch.Generator().manual_seed(seed), spec,
                          ah.make_metric("diagonal", D, torch.float64,
                                         device="cpu"),
                          th0, init_eps=0.25, device="cpu")
    if spec.cross_chain:
        return state
    m_inv = torch.as_tensor(rng.uniform(0.6, 1.5, size=(C, D)))
    eps = torch.as_tensor(rng.uniform(0.2, 0.35, size=C))
    return dataclasses.replace(
        state, metric=ah.DiagEuclideanMetric.create(m_inv),
        adapt=dataclasses.replace(state.adapt, da=dataclasses.replace(
            state.adapt.da, eps=eps)))


@pytest.mark.parametrize("cross_chain", [False, True])
def test_ragged_prefix_is_bitwise_the_rectangular_run(cross_chain):
    """Each chain's first counts[c] draws and stats are the rectangular
    t_max run's, bit for bit (same generator seed); zero past the count,
    `is_accept` false there; the state resumes from each chain's last
    draw and `iteration` advances by t_min; the slowest chain has exactly
    t_min."""
    t_min, t_max = 12, 40
    spec = _spec(cross_chain)
    state = _state(spec)
    st_r, th_r, counts, stats_r = fused_draw_phase_ragged(
        torch.Generator().manual_seed(5), spec, state, t_max, t_min)
    _, th_f, stats_f = ah.fused_draw_phase(
        torch.Generator().manual_seed(5), spec, state, t_max, t_max)
    th_f = th_f.transpose(0, 1)
    assert th_r.shape == (C, t_max, D) and counts.shape == (C,)
    assert int(counts.min()) == t_min and int(counts.max()) <= t_max
    for c in range(C):
        k = int(counts[c])
        assert torch.equal(th_r[c, :k], th_f[c, :k])
        assert not th_r[c, k:].any()
        for key, v in stats_r.items():
            if key in ("is_accept", "is_adapt"):
                continue
            assert torch.equal(v[c, :k], stats_f[key].transpose(0, 1)[c, :k]), key
            assert not v[c, k:].any(), key
        assert stats_r["is_accept"][c, :k].all()
        assert not stats_r["is_accept"][c, k:].any()
        assert torch.equal(st_r.z.theta[c], th_r[c, k - 1])
    assert st_r.iteration == state.iteration + t_min


def test_ragged_stopping_rule_does_not_depend_on_the_check_period(
        monkeypatch):
    """The loop reads its exit every `_CHECK_EVERY` iterations; the
    iterations after every chain reached t_min are no-ops, so a check at
    every iteration gives the same counts, draws and final positions (at
    ε 1.0 trees are short, so chains finish transitions between checks)."""
    spec = _spec(True)
    state = _state(spec, seed=4).with_step_size(1.0)
    runs = []
    for every in (1, nuts_t._CHECK_EVERY, 16):
        monkeypatch.setattr(nuts_t, "_CHECK_EVERY", every)
        st, th, counts, _ = fused_draw_phase_ragged(
            torch.Generator().manual_seed(9), spec, state, 30, 10)
        runs.append((st.z.theta, th, counts))
    for st_theta, th, counts in runs[1:]:
        assert torch.equal(counts, runs[0][2])
        assert torch.equal(th, runs[0][1])
        assert torch.equal(st_theta, runs[0][0])


def _jax_ragged_runs(seed, c, t_min, t_max, calls):
    target = aj.LogDensityTarget(lambda x: -0.5 * jnp.sum(x ** 2), D)
    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.25, jnp.float64)),
        aj.GeneralisedNoUTurn(max_depth=6), "multinomial"))
    spec = SpecJ(target=target, kernel=kernel,
                 adaptor=aj.AdaptorConfig(kind="none"))
    th0 = np.random.default_rng(seed).normal(size=(c, D))
    st = aj.init_state(jax.random.PRNGKey(seed), spec,
                       aj.make_metric("diagonal", D, dtype=jnp.float64),
                       jnp.asarray(th0), init_eps=jnp.asarray(0.25))
    out = []
    for _ in range(calls):
        st, th, counts, _ = ragged_j(spec, st, t_max, t_min)
        out.append((np.asarray(th), np.asarray(counts)))
    return out


def _count_weighted(runs):
    """(mean count, count-weighted mean, count-weighted variance)."""
    x = np.concatenate([th for th, _ in runs], 1)
    mask = np.concatenate([np.arange(th.shape[1])[None] < cnt[:, None]
                           for th, cnt in runs], 1)[..., None]
    n = mask.sum()
    mean = (x * mask).sum((0, 1)) / n
    var = ((x - mean) ** 2 * mask).sum((0, 1)) / n
    return np.mean([cnt for _, cnt in runs]), mean, var


def test_ragged_matches_jax_in_distribution():
    c, t_min, t_max, calls = 64, 16, 24, 4
    spec = _spec(True)
    gen = torch.Generator().manual_seed(11)
    state = ah.init_state(
        gen, spec, ah.make_metric("diagonal", D, torch.float64, device="cpu"),
        torch.as_tensor(np.random.default_rng(11).normal(size=(c, D))),
        init_eps=0.25, device="cpu")
    runs = []
    for _ in range(calls):
        state, th, counts, _ = fused_draw_phase_ragged(gen, spec, state,
                                                       t_max, t_min)
        assert int(counts.min()) == t_min
        runs.append((th.numpy(), counts.numpy()))
    n_t, mean_t, var_t = _count_weighted(runs)
    n_j, mean_j, var_j = _count_weighted(
        _jax_ragged_runs(11, c, t_min, t_max, calls))
    assert abs(n_t - n_j) <= 0.5, (n_t, n_j)
    for mean, var in ((mean_t, var_t), (mean_j, var_j)):
        assert np.abs(mean).max() <= 0.15, mean
        assert np.abs(var - 1.0).max() <= 0.2, var
    assert state.iteration == calls * t_min


def test_ragged_validation_errors():
    """The JAX function's errors (t_min not below t_max, coupled chains, a
    static criterion, partial refreshment, a per-chain rank-update
    metric), and the fused loop's own guards (warmup mode, the pair body)."""
    spec = _spec(False)
    state = _state(spec)
    gen = torch.Generator().manual_seed(0)
    bad = [
        (spec, state, 16, 16),
        (spec, state, 16, 0),
        (dataclasses.replace(spec, coupled=True), state, 16, 8),
        (_spec(False, ah.FixedNSteps(4)), state, 16, 8),
        (dataclasses.replace(spec, kernel=dataclasses.replace(
            spec.kernel, refreshment=ah.PartialMomentumRefreshment(0.5))),
         state, 16, 8),
        (spec, dataclasses.replace(state, metric=ah.make_metric(
            "rank_update", D, torch.float64, device="cpu").per_chain(C)),
         16, 8),
    ]
    for sp, st, t_max, t_min in bad:
        with pytest.raises(ValueError):
            fused_draw_phase_ragged(gen, sp, st, t_max, t_min)
    h = ah.Hamiltonian(metric=state.metric, target=spec.target)
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    with pytest.raises(ValueError, match="pair"):
        ah.nuts_transitions_fused(gen, h, traj, state.z, 8,
                                  spec.kernel.refreshment, t_min=4,
                                  pair=True)
    cfg = ah.AdaptorConfig()
    with pytest.raises(ValueError, match="draw-phase"):
        ah.nuts_transitions_fused(
            gen, h, traj, state.z, 8, spec.kernel.refreshment, t_min=4,
            adapt_cfg=cfg, adapt_state=state.adapt,
            adapt_flags=ah.adapt_flags(cfg, 8, 8))

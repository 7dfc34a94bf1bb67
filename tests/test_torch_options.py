"""The options of `sample` that the port took over with the JAX package's
reduced-precision switches, against the JAX package.

* Online collection: `online_update`/`online_summary` against JAX's on
  the same draws (float64, 1e-12), and a JAX summary carried across
  (`convert.online_moments`).
* Thinning: the thinned rows are every thin-th row of the unthinned run on
  the same generator, on the step path and the fused path; `_thin_block`
  against JAX's.
* The depth-capped warmup's schedule (n_cap, n_cap2) and its ValueErrors,
  against JAX `sample` over a grid (its fused phases stubbed, so only the
  schedule runs).
* The per-chain fused warmup: its final adaptation state equals a float64
  replay of `adapt_step` over each chain's recorded transitions, exactly;
  in law it matches JAX `sample(fuse_warmup=True)`.
* Coupled chains: a coupled transition is the transition under the table
  of directions drawn once from the coupled generator, bit for bit, on
  the single-leaf and the leaf-pair body; in law `sample(coupled=True)`
  matches JAX's; coupling turns the fused paths off.
* The progress display, `collect_warmup_stats`, chain chunks and per-
  transition depth caps in the fused loop.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu import diagnostics as dj
from advancedhmc_tpu import sampler as sj
from advancedhmc_tpu.models import std_gaussian

import advancedhmc_torch as ah
from advancedhmc_torch import convert, sampler as st
from advancedhmc_torch.utils import rand_sign

torch.set_num_threads(2)

D, C = 4, 16
F64 = torch.float64


def _gauss():
    return ah.LogDensityTarget(lambda x: -0.5 * torch.sum(x * x, -1), D,
                               lambda x: (-0.5 * torch.sum(x * x, -1), -x))


def _kernel(eps=0.5, max_depth=5, **kw):
    return ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(eps, dtype=F64)),
        ah.GeneralisedNoUTurn(max_depth=max_depth), **kw))


def _theta0(c=C, seed=5):
    return 0.3 * np.random.default_rng(seed).normal(size=(c, D))


def _adaptor(**kw):
    return ah.AdaptorConfig(kind="stan", init_buffer=6, term_buffer=6,
                            window_size=4, **kw)


def _port(n, seed=1, **kw):
    return ah.sample(torch.Generator().manual_seed(seed), _gauss(),
                     kw.pop("kernel", _kernel()),
                     ah.make_metric("diagonal", D, F64, device="cpu"),
                     _theta0(), n, device="cpu", **kw)


# ---------------------------------------------------------------- online
def test_online_summary_matches_jax():
    draws = np.random.default_rng(0).normal(size=(40, 5, 3)).cumsum(0) / 5
    om_j = dj.online_init(5, 3, 6, jnp.float64)
    om_t = ah.online_init(5, 3, 6, F64, device="cpu")
    for i, x in enumerate(draws):
        om_j = dj.online_update(om_j, jnp.asarray(x))
        om_t = ah.online_update(om_t, torch.as_tensor(x))
        if i == 19:     # carry JAX's summary across and go on from it
            om_t = convert.online_moments(om_j, "cpu")
    for f in ("n", "mean", "m2", "lag_buf", "lag_acc"):
        np.testing.assert_allclose(getattr(om_t, f).numpy(),
                                   np.asarray(getattr(om_j, f)), rtol=1e-12,
                                   atol=1e-12)
    s_j, s_t = dj.online_summary(om_j), ah.online_summary(om_t)
    for k in ("n", "mean", "var", "ess"):
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(s_j[k]),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fused", [False, True])
def test_online_collection_summarises_the_draws(fused):
    """`collect="online"` stores no draws; its summary is that of the draws
    the same run stores with `collect="draws"` (the same generator)."""
    kw = dict(n_adapts=12, adaptor=_adaptor(), drop_warmup=True,
              fuse_draws=4 if fused else 0)
    full = _port(28, **kw)
    online = _port(28, collect="online", online_lags=4, **kw)
    assert online.thetas is None and full.online is None
    om = ah.online_init(C, D, 4, F64, device="cpu")
    for x in full.thetas:
        om = ah.online_update(om, x)
    ref = ah.online_summary(om)
    for k in ("n", "mean", "var", "ess"):
        torch.testing.assert_close(online.online[k], ref[k], rtol=1e-12,
                                   atol=1e-12)
    torch.testing.assert_close(online.stats["acceptance_rate"],
                               full.stats["acceptance_rate"])


# ---------------------------------------------------------------- thin
@pytest.mark.parametrize("fused", [False, True])
def test_thinned_rows_are_every_thin_th_row(fused):
    kw = dict(n_adapts=12, adaptor=_adaptor(), drop_warmup=True,
              fuse_draws=4 if fused else 0)
    full, thin = _port(28, **kw), _port(28, thin=2, **kw)
    assert thin.thetas.shape == (8, C, D)
    torch.testing.assert_close(thin.thetas, full.thetas[1::2], rtol=0,
                               atol=0)
    for k, v in thin.stats.items():
        if k == "n_steps":
            want = full.stats[k][0::2] + full.stats[k][1::2]
        elif k == "numerical_error":
            want = full.stats[k][0::2] | full.stats[k][1::2]
        else:
            want = full.stats[k][1::2]
        assert torch.equal(v, want), k


def test_thin_block_matches_jax():
    rng = np.random.default_rng(3)
    ths = rng.normal(size=(6, 3, 2))
    stats = {"n_steps": rng.integers(1, 9, size=(6, 3)).astype(np.int32),
             "numerical_error": rng.random((6, 3)) < 0.3,
             "acceptance_rate": rng.random((6, 3))}
    th_j, s_j = sj._thin_block(jnp.asarray(ths),
                               {k: jnp.asarray(v) for k, v in stats.items()},
                               3)
    th_t, s_t = st._thin_block(torch.as_tensor(ths),
                               {k: torch.as_tensor(v) for k, v in
                                stats.items()}, 3)
    np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_j))
    for k in stats:
        np.testing.assert_array_equal(s_t[k].numpy(), np.asarray(s_j[k]))


def test_thin_and_online_checks_match_jax():
    for kw in (dict(thin=2, collect="online", drop_warmup=True),
               dict(thin=2), dict(thin=5, drop_warmup=True),
               dict(collect="online"), dict(collect="nothing")):
        with pytest.raises(ValueError) as e_t:
            _port(20, n_adapts=8, adaptor=_adaptor(), **kw)
        with pytest.raises(ValueError) as e_j:
            aj.sample(jax.random.PRNGKey(0), std_gaussian(D),
                      aj.HMCKernel(aj.Trajectory(
                          aj.Leapfrog(step_size=jnp.asarray(0.5)),
                          aj.GeneralisedNoUTurn(max_depth=5))),
                      aj.make_metric("diagonal", D, dtype=jnp.float64),
                      jnp.asarray(_theta0()), 20, n_adapts=8,
                      adaptor=aj.AdaptorConfig(kind="stan"), init_eps=0.5,
                      **kw)
        assert str(e_t.value)[:30] == str(e_j.value)[:30], kw


# ---------------------------------------------------------------- depth cap
class _Stop(Exception):
    pass


def _jax_segments(monkeypatch, n_adapts, block, cap, frac, frac2, eps):
    seen = []

    def fwcc(spec, state, n, blk, flags=None, depth_caps=None, pair=False,
             progress_cb=None, chain_chunks=1):
        seen.append((n, int(spec.kernel.trajectory.criterion.max_depth)))
        c, d = state.z.theta.shape
        return state, jnp.zeros((n, c, d)), {"n_steps": jnp.zeros((n, c))}

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(sj, "fused_warmup_phase_crosschain", fwcc)
    monkeypatch.setattr(sj, "fused_draw_phase", stop)
    monkeypatch.setattr(sj, "find_good_stepsize",
                        lambda k, h, t: jnp.asarray(0.2, t.dtype))
    try:
        aj.sample(jax.random.PRNGKey(0), std_gaussian(D),
                  aj.HMCKernel(aj.Trajectory(
                      aj.Leapfrog(step_size=jnp.asarray(0.5)),
                      aj.GeneralisedNoUTurn(max_depth=5))),
                  aj.make_metric("diagonal", D, dtype=jnp.float64),
                  jnp.asarray(_theta0(2)), n_adapts + 2, n_adapts=n_adapts,
                  adaptor=aj.AdaptorConfig(kind="stan"), init_eps=0.5,
                  cross_chain=True, fuse_warmup=True,
                  fuse_warmup_block=block, drop_warmup=True, fuse_draws=2,
                  warmup_depth_cap=cap, warmup_cap_frac=frac,
                  warmup_eps_research=eps, warmup_cap_frac2=frac2)
    except _Stop:
        return seen
    except ValueError as e:
        return str(e)


def _port_segments(monkeypatch, n_adapts, block, cap, frac, frac2, eps):
    seen = []

    def fwcc(generator, spec, state, n, blk, flags=None, depth_caps=None,
             pair=False, progress_cb=None, chain_chunks=1):
        seen.append((n, int(spec.kernel.trajectory.criterion.max_depth)))
        th, stats = st._rows(n, state.z.theta.shape[0], state.z.theta)
        return state, th.zero_(), stats

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(st, "fused_warmup_phase_crosschain", fwcc)
    monkeypatch.setattr(st, "fused_draw_phase", stop)
    try:
        ah.sample(torch.Generator().manual_seed(0), _gauss(), _kernel(),
                  ah.make_metric("diagonal", D, F64, device="cpu"),
                  _theta0(2), n_adapts + 2, n_adapts=n_adapts,
                  adaptor=ah.AdaptorConfig(kind="stan"), init_eps=0.5,
                  cross_chain=True, fuse_warmup=True,
                  fuse_warmup_block=block, drop_warmup=True, fuse_draws=2,
                  warmup_depth_cap=cap, warmup_cap_frac=frac,
                  warmup_eps_research=eps, warmup_cap_frac2=frac2,
                  device="cpu")
    except _Stop:
        return seen
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("eps_research", [False, True])
def test_depth_cap_schedule_matches_jax(monkeypatch, block, eps_research):
    """The warmup's segments (length, tree depth) or the ValueError, over
    (n_adapts, cap_frac, cap_frac2), as JAX `sample` runs them."""
    for n_adapts in (24, 100):
        for frac in (0.2, 0.5, 1.0):
            for frac2 in (None, 0.3, 0.6, 1.0):
                args = (n_adapts, block, 2, frac, frac2, eps_research)
                want = _jax_segments(monkeypatch, *args)
                got = _port_segments(monkeypatch, *args)
                if isinstance(want, str):
                    assert isinstance(got, str) and \
                        got[:40] == want[:40], (args, got, want)
                    continue
                assert got == want, (args, got, want)
                n_cap, n_cap2 = ah.depth_cap_schedule(
                    n_adapts, frac, frac2, block, eps_research)
                assert sum(n for n, d in want if d == 2) == n_cap2
                assert want[0][0] == n_cap
    # a cap at max_depth is no cap: the 3-phase fraction then raises
    args = (24, block, 5, 0.5, 0.6, eps_research)
    want = _jax_segments(monkeypatch, *args)
    assert isinstance(want, str) and \
        _port_segments(monkeypatch, *args)[:40] == want[:40]


def test_depth_capped_step_warmup_runs_capped():
    """The depth cap on the step-by-step warmup (cross-chain,
    `drop_warmup`): the capped iterations' trees stay within the cap."""
    res = _port(40, n_adapts=32, adaptor=_adaptor(), cross_chain=True,
                drop_warmup=True, warmup_depth_cap=1, warmup_cap_frac=0.25,
                warmup_eps_research=True, warmup_cap_frac2=0.5,
                kernel=_kernel(eps=0.1))
    depth = res.warmup_stats["tree_depth"]
    assert int(depth[:16].max()) <= 1 < int(depth[16:].max())


# ------------------------------------------------ per-chain fused warmup
def test_per_chain_fused_warmup_replays_adapt_step():
    """Each chain's final adaptation state is `adapt_step` replayed over
    its own recorded transitions (their θ and acceptance, in its own order,
    the flags of its own transition count), and each transition ran at the
    step size that the replay had reached before it."""
    n_adapts, cfg = 40, _adaptor()
    res = _port(n_adapts, n_adapts=n_adapts, adaptor=cfg, init_eps=0.4,
                fuse_warmup=True, kernel=_kernel(max_depth=4))
    flags = ah.adapt_flags(cfg, n_adapts, n_adapts)
    assert bool(flags["window_end"].any())
    ad = ah.AdaptState.init(cfg, D, torch.full((C,), 0.4, dtype=F64), F64)
    ad = ah.AdaptState(da=ad.da, mm=ah.WelfordVarState.init(
        D, F64, "cpu", n_chains=C))
    for t in range(n_adapts):
        assert torch.equal(res.stats["step_size"][t], ad.da.eps), t
        ad = ah.adapt_step(cfg, ad, res.thetas[t], None,
                           res.stats["acceptance_rate"][t],
                           {k: bool(v[t]) for k, v in flags.items()})
    fin = res.final_state.adapt
    for part in ("da", "mm"):
        for f, want in vars(getattr(ad, part)).items():
            got = getattr(getattr(fin, part), f)
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want), (part, f)
    assert torch.equal(res.final_state.metric.m_inv, ad.mm.var)
    assert bool(res.stats["is_adapt"].all())


def test_per_chain_fused_warmup_matches_jax_in_law():
    """On a standard normal, 16 chains: the draws' moments within 0.12,
    the mean acceptance within 0.05 and the median final step size within
    25% of JAX `sample(fuse_warmup=True)`'s."""
    def summary(th, acc, eps):
        th = np.asarray(th).reshape(-1, D)
        return th.mean(0), th.std(0), float(np.mean(acc)), float(
            np.median(eps))

    kw = dict(n_adapts=150, fuse_warmup=True, drop_warmup=True)
    res = _port(250, adaptor=ah.AdaptorConfig(kind="stan"), **kw)
    port = summary(res.thetas.numpy(), res.stats["acceptance_rate"].numpy(),
                   res.final_state.adapt.da.eps.numpy())
    rj = aj.sample(jax.random.PRNGKey(2), std_gaussian(D),
                   aj.HMCKernel(aj.Trajectory(
                       aj.Leapfrog(step_size=jnp.asarray(0.5)),
                       aj.GeneralisedNoUTurn(max_depth=5))),
                   aj.make_metric("diagonal", D, dtype=jnp.float64),
                   jnp.asarray(_theta0()), 250,
                   adaptor=aj.AdaptorConfig(kind="stan"), **kw)
    ref = summary(rj.thetas, rj.stats["acceptance_rate"],
                  rj.final_state.adapt.da.eps)
    np.testing.assert_allclose(port[0], ref[0], atol=0.12)
    np.testing.assert_allclose(port[1], ref[1], atol=0.12)
    assert abs(port[2] - ref[2]) <= 0.05, (port[2], ref[2])
    assert abs(port[3] / ref[3] - 1) <= 0.25, (port[3], ref[3])


# ---------------------------------------------------------------- coupled
@pytest.mark.parametrize("pair", [False, True])
def test_coupled_transition_is_the_forced_table(pair):
    """With `coupled_key` every chain takes, at its depth, the sign of a
    table drawn once from that generator: the transition is the one under
    that table as `force_directions`, bit for bit (on the leaf-pair body
    as on the single-leaf one, which draw the generator alike)."""
    h = ah.Hamiltonian(metric=ah.make_metric("diagonal", D, F64,
                                             device="cpu"), target=_gauss())
    traj = _kernel(eps=0.3, max_depth=6).trajectory
    z0 = h.init_phasepoint(torch.Generator().manual_seed(0),
                           torch.as_tensor(_theta0()))
    table = rand_sign(torch.Generator().manual_seed(9), (6,), "cpu")
    z1, s1 = ah.nuts_transition(torch.Generator().manual_seed(3), h, traj,
                                z0, force_directions=table)
    z2, s2 = ah.nuts_transition(torch.Generator().manual_seed(3), h, traj,
                                z0, coupled_key=torch.Generator()
                                .manual_seed(9), _pair=pair)
    assert torch.equal(z1.theta, z2.theta)
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    assert int(s1["tree_depth"].max()) >= 2


def test_coupled_sample_matches_jax_in_law_and_is_step_by_step(monkeypatch):
    """`sample(coupled=True)` on a standard normal: moments within 0.12,
    acceptance within 0.05 and the depth histogram within 0.08 of JAX's;
    it asks for fused draws and runs none (JAX turns them off when
    coupled)."""
    fused = []
    monkeypatch.setattr(st, "nuts_transitions_fused",
                        lambda *a, **k: fused.append(1))

    def summary(res):
        depth = np.asarray(res.stats["tree_depth"]).ravel()
        th = np.asarray(res.thetas).reshape(-1, D)
        return (th.mean(0), th.std(0),
                float(np.mean(np.asarray(res.stats["acceptance_rate"]))),
                np.bincount(depth, minlength=6) / depth.size)

    port = summary(_port(200, init_eps=0.7, coupled=True, fuse_draws=8))
    assert not fused
    ref = summary(aj.sample(
        jax.random.PRNGKey(4), std_gaussian(D),
        aj.HMCKernel(aj.Trajectory(aj.Leapfrog(step_size=jnp.asarray(0.7)),
                                   aj.GeneralisedNoUTurn(max_depth=5))),
        aj.make_metric("diagonal", D, dtype=jnp.float64),
        jnp.asarray(_theta0()), 200, init_eps=0.7, coupled=True))
    np.testing.assert_allclose(port[0], ref[0], atol=0.12)
    np.testing.assert_allclose(port[1], ref[1], atol=0.12)
    assert abs(port[2] - ref[2]) <= 0.05
    np.testing.assert_allclose(port[3], ref[3], atol=0.08)


# ---------------------------------------------------------------- the rest
def test_progress_lines_and_warmup_stats(capsys):
    res = _port(24, n_adapts=12, adaptor=_adaptor(), drop_warmup=True,
                collect_warmup_stats=False, progress=True, progress_every=4,
                verbose=True)
    out = capsys.readouterr().out.splitlines()
    assert res.warmup_stats is None
    lines = [ln for ln in out if " | accept " in ln]
    assert [ln.split(" | ")[0] for ln in lines] == [
        f"[advancedhmc_torch] {p} {i}/24" for p, i in
        (("warmup", 4), ("warmup", 8), ("warmup", 12), ("sample", 16),
         ("sample", 20), ("sample", 24))]
    assert any("sampling finished" in ln for ln in out)
    # the fused paths: a line after every fused call
    _port(24, n_adapts=12, adaptor=_adaptor(), cross_chain=True,
          fuse_warmup=True, fuse_warmup_block=4, fuse_draws=6,
          progress=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " | accept " in ln]
    assert len(lines) == 12 // 4 + 12 // 6


def test_chain_chunks_keep_each_chains_step_size():
    """`chain_chunks` runs the chains in sequential sub-batches: each chain
    keeps its own ε and M⁻¹, and a count that does not divide raises."""
    spec = ah.SampleSpec(target=_gauss(), kernel=_kernel(), adaptor=_adaptor())
    eps = torch.linspace(0.3, 0.6, C, dtype=F64)
    state = ah.init_state(torch.Generator().manual_seed(0), spec,
                          ah.make_metric("diagonal", D, F64, device="cpu"),
                          _theta0(), init_eps=eps, device="cpu")
    gen = torch.Generator().manual_seed(1)
    _, th, stats = ah.fused_draw_phase(gen, spec, state, 8, 4,
                                       chain_chunks=4)
    assert th.shape == (8, C, D)
    assert torch.equal(stats["step_size"], eps.expand(8, C))
    with pytest.raises(ValueError, match="chain_chunks"):
        ah.fused_draw_phase(gen, spec, state, 8, 4, chain_chunks=3)


def test_depth_caps_bound_each_transition():
    h = ah.Hamiltonian(metric=ah.make_metric("unit", D, F64, device="cpu"),
                       target=_gauss())
    traj = _kernel(eps=0.05, max_depth=5).trajectory
    z0 = h.init_phasepoint(torch.Generator().manual_seed(0),
                           torch.as_tensor(_theta0()))
    caps = [1, 3, 9, 2]
    _, _, stats = ah.nuts_transitions_fused(
        torch.Generator().manual_seed(1), h, traj, z0, 4,
        ah.FullMomentumRefreshment(), depth_caps=caps)
    depth = stats["tree_depth"]
    for t, cap in enumerate(caps):
        assert int(depth[:, t].max()) == min(cap, 5), t

"""The last options of JAX `sample`'s fused loop, and the float16
switches, against the JAX package.

* The layout options of `nuts_transitions_fused` and `fused_draw_phase`
  (`unroll`, `stage_slots`, `pack_carry`, through `experimental.
  Experimental` too) change no bit of the port's draws and stats; their
  preconditions raise in the port where they raise in JAX. `stage_slots`
  and `pack_carry` are taken and change nothing (the port's loop writes
  the full draw buffer directly and has no carry to pack).
* `out_dtype` stores the draws rounded through it, in both packages: the
  draws are the default run's rounded to bfloat16.
* `metric_batch` and `eps_batch` give each chain its own M⁻¹ and ε: the
  port's call is bitwise the one with the same per-chain metric and ε in
  `h` and `traj`, and each chain's step size is its own, as in JAX.
* `batched=False` is JAX's one-chain call: outputs without the chain axis.
* float16 for `x_dtype` and `resid_dtype` (the model against JAX in
  float64, K1's float16 mode's plain twin against its float64 reference)
  and for `stack_dtype` (`nuts_transition` under forced directions
  against JAX's, the stacks bit for bit).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu.experimental import Experimental as JaxExperimental
from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)
from advancedhmc_tpu.nuts import nuts_transitions_fused as jax_fused
from advancedhmc_tpu.sampler import fused_draw_phase as jax_fused_draws

import advancedhmc_torch as ah
from advancedhmc_torch import convert
from advancedhmc_torch.experimental import Experimental, \
    fused_draw_phase_ragged
from advancedhmc_torch.models.logistic import _synthetic_data
from advancedhmc_torch.ops import fused_logistic as k1
from advancedhmc_torch.sampler import fused_draw_phase

torch.set_num_threads(2)

D, C = 4, 16


def _setup(per_chain=False):
    target = ah.std_gaussian(D, device="cpu")
    lf = ah.Leapfrog(step_size=torch.tensor(0.5, dtype=torch.float64))
    kernel = ah.HMCKernel(ah.Trajectory(lf, ah.GeneralisedNoUTurn(
        max_depth=5)))
    spec = ah.SampleSpec(target=target, kernel=kernel,
                         adaptor=ah.AdaptorConfig(kind="stan"),
                         cross_chain=not per_chain)
    theta = torch.randn(C, D, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(1))
    state = ah.init_state(
        torch.Generator().manual_seed(0), spec,
        ah.make_metric("diagonal", D, torch.float64, device="cpu"), theta,
        init_eps=0.5, device="cpu")
    return spec, state


def _draws(spec, state, pair=False, **options):
    return fused_draw_phase(torch.Generator().manual_seed(2), spec, state,
                            24, 12, pair=pair, **options)


def _same(a, b):
    return torch.equal(a[1], b[1]) and all(
        torch.equal(a[2][k], b[2][k]) for k in a[2])


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("options", [
    dict(unroll=3),
    dict(experimental=Experimental(stage_slots=1)),
    dict(experimental=Experimental(stage_slots=5)),
    dict(experimental=Experimental(pack_carry="fc")),
    dict(unroll=2, experimental=Experimental(stage_slots=2)),
], ids=["unroll", "stage1", "stage5", "pack", "unroll+stage"])
def test_layout_options_change_no_bit(options, pair):
    spec, state = _setup()
    assert _same(_draws(spec, state, pair, **options),
                 _draws(spec, state, pair))


def test_layout_options_per_chain_and_in_the_warmup_mode():
    spec, state = _setup(per_chain=True)
    h = ah.Hamiltonian(metric=state.metric, target=spec.target)
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    cfg = spec.adaptor
    flags = ah.adapt_flags(cfg, 20, 20)

    def run(**kw):
        return ah.nuts_transitions_fused(
            torch.Generator().manual_seed(5), h, traj, state.z, 20,
            spec.kernel.refreshment, adapt_cfg=cfg, adapt_state=state.adapt,
            adapt_flags=flags, **kw)

    a, b = run(), run(unroll=2, stage_slots=3)
    assert torch.equal(a[1], b[1])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    assert torch.equal(a[3].da.eps, b[3].da.eps)


@pytest.mark.parametrize("case,pattern", [
    (dict(stage_slots=2, pack_carry="fc"), "pack_carry cannot be combined"),
    (dict(t_min=3, pack_carry="fc"), "pack_carry cannot be combined"),
])
def test_layout_option_errors_match_jax(case, pattern):
    spec, state = _setup()
    h = ah.Hamiltonian(metric=state.metric, target=spec.target)
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    with pytest.raises(ValueError, match=pattern):
        ah.nuts_transitions_fused(torch.Generator(), h, traj, state.z, 6,
                                  spec.kernel.refreshment, **case)
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(
        jnp.ones(D)), target=aj.LogDensityTarget(
        lambda x: -0.5 * jnp.sum(x ** 2), D))
    tj = aj.Trajectory(aj.Leapfrog(step_size=jnp.asarray(0.5)),
                       aj.GeneralisedNoUTurn(max_depth=5), "multinomial")
    zj = jax.vmap(hj.phasepoint)(jnp.zeros((C, D)), jnp.ones((C, D)))
    with pytest.raises(ValueError, match=pattern):
        jax_fused(
            jax.random.split(jax.random.PRNGKey(0), C), hj, tj, zj, 6,
            aj.FullMomentumRefreshment(), batched=True, **case)


def test_ragged_needs_the_single_loop_layout_as_in_jax():
    spec, state = _setup()
    h = ah.Hamiltonian(metric=state.metric, target=spec.target)
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    for kw in (dict(unroll=2), dict(stage_slots=2)):
        with pytest.raises(ValueError, match="single-loop layout"):
            ah.nuts_transitions_fused(torch.Generator(), h, traj, state.z,
                                      6, spec.kernel.refreshment, t_min=3,
                                      **kw)
    with pytest.raises(ValueError, match="eps_batch requires batched"):
        ah.nuts_transitions_fused(torch.Generator(), h, traj, state.z, 6,
                                  spec.kernel.refreshment, batched=False,
                                  eps_batch=state.adapt.da.eps)


def test_out_dtype_rounds_the_draws_in_both_packages():
    spec, state = _setup()
    ref = _draws(spec, state)
    got = _draws(spec, state, experimental=Experimental(
        out_dtype=torch.bfloat16))
    assert got[1].dtype == torch.float64
    assert torch.equal(got[1], ref[1].to(torch.bfloat16).double())
    assert all(torch.equal(got[2][k], ref[2][k]) for k in ref[2])
    _, th, n, _ = fused_draw_phase_ragged(torch.Generator().manual_seed(3),
                                          spec, state, 12, 6)
    _, th2, n2, _ = fused_draw_phase_ragged(
        torch.Generator().manual_seed(3), spec, state, 12, 6,
        out_dtype="bfloat16")
    assert torch.equal(n, n2)
    assert torch.equal(th2, th.to(torch.bfloat16).double())
    # JAX: the same rounding of the same run
    target = aj.LogDensityTarget(lambda x: -0.5 * jnp.sum(x ** 2), D)
    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.5, jnp.float64)),
        aj.GeneralisedNoUTurn(max_depth=5), "multinomial"))
    spec_j = aj.SampleSpec(target=target, kernel=kernel,
                           adaptor=aj.AdaptorConfig(kind="stan"),
                           cross_chain=True)
    st_j = aj.init_state(jax.random.PRNGKey(0), spec_j,
                         aj.make_metric("diagonal", D, dtype=jnp.float64),
                         jnp.asarray(state.z.theta.numpy()), init_eps=0.5)
    _, th_j, _ = jax_fused_draws(spec_j, st_j, 24, 12)
    _, th_jb, _ = jax_fused_draws(spec_j, st_j, 24, 12,
                                  experimental=JaxExperimental(
                                      out_dtype=jnp.bfloat16))
    np.testing.assert_array_equal(
        np.asarray(th_jb), np.asarray(th_j.astype(jnp.bfloat16)
                                      .astype(jnp.float64)))


def test_metric_batch_and_eps_batch_are_each_chains_own():
    spec, state = _setup()
    rng = np.random.default_rng(4)
    m_inv = torch.as_tensor(rng.uniform(0.5, 2.0, (C, D)))
    eps = torch.as_tensor(rng.uniform(0.3, 0.7, C))
    per_chain = ah.DiagEuclideanMetric.create(m_inv)
    shared = ah.Hamiltonian(metric=state.metric, target=spec.target)
    traj = spec.kernel.trajectory.with_nom_step_size(torch.tensor(
        0.5, dtype=torch.float64))

    def run(h, traj, **kw):
        return ah.nuts_transitions_fused(
            torch.Generator().manual_seed(6), h, traj, state.z, 8,
            spec.kernel.refreshment, **kw)

    a = run(shared, traj, metric_batch=per_chain, eps_batch=eps)
    b = run(ah.Hamiltonian(metric=per_chain, target=spec.target),
            spec.kernel.trajectory.with_nom_step_size(eps))
    assert torch.equal(a[1], b[1])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    assert torch.equal(a[2]["step_size"], eps[:, None].expand(C, 8))
    assert torch.equal(a[2]["nom_step_size"], eps[:, None].expand(C, 8))
    # JAX: each chain's recorded step size is its eps_batch entry
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(
        jnp.ones(D, jnp.float64)), target=aj.LogDensityTarget(
        lambda x: -0.5 * jnp.sum(x ** 2), D))
    tj = aj.Trajectory(aj.Leapfrog(step_size=jnp.asarray(0.5, jnp.float64)),
                       aj.GeneralisedNoUTurn(max_depth=5), "multinomial")
    zj = jax.vmap(hj.phasepoint)(jnp.asarray(state.z.theta.numpy()),
                                 jnp.zeros((C, D), jnp.float64))
    _, _, st_j = jax_fused(
        jax.random.split(jax.random.PRNGKey(0), C), hj, tj, zj, 8,
        aj.FullMomentumRefreshment(), batched=True,
        metric_batch=aj.DiagEuclideanMetric.create(jnp.asarray(
            m_inv.numpy())), eps_batch=jnp.asarray(eps.numpy()))
    np.testing.assert_array_equal(np.asarray(st_j["step_size"]),
                                  a[2]["step_size"].numpy())


def test_unbatched_call_is_one_chain_as_in_jax():
    spec, state = _setup()
    h = ah.Hamiltonian(metric=state.metric, target=spec.target)
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    one = ah.PhasePoint(*(getattr(state.z, f)[0] for f in (
        "theta", "r", "logdensity", "grad", "neg_k")))
    z, th, st = ah.nuts_transitions_fused(
        torch.Generator().manual_seed(7), h, traj, one, 5,
        spec.kernel.refreshment, batched=False)
    z1, th1, st1 = ah.nuts_transitions_fused(
        torch.Generator().manual_seed(7), h, traj,
        ah.PhasePoint(*(getattr(state.z, f)[:1] for f in (
            "theta", "r", "logdensity", "grad", "neg_k"))), 5,
        spec.kernel.refreshment)
    assert th.shape == (5, D) and z.theta.shape == (D,)
    assert st["n_steps"].shape == (5,)
    assert torch.equal(th, th1[0]) and torch.equal(z.theta, z1.theta[0])
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(jnp.ones(D)),
                        target=aj.LogDensityTarget(
                            lambda x: -0.5 * jnp.sum(x ** 2), D))
    tj = aj.Trajectory(aj.Leapfrog(step_size=jnp.asarray(0.5)),
                       aj.GeneralisedNoUTurn(max_depth=5), "multinomial")
    _, th_j, st_j = jax_fused(
        jax.random.PRNGKey(0), hj, tj, hj.phasepoint(jnp.zeros(D),
                                                     jnp.ones(D)), 5,
        aj.FullMomentumRefreshment())
    assert th_j.shape == th.shape
    assert st_j["n_steps"].shape == st["n_steps"].shape


def _np_logistic(th, p, x_dtype, resid_dtype):
    """The hierarchical logistic's value and gradient in float64 numpy with
    the switches' roundings (the JAX model's function, sums exact)."""
    x, y = _synthetic_data(200, p)
    r16 = (lambda a: a.astype(np.float16).astype(np.float64))
    xr = r16(x) if x_dtype else x
    ls, beta = th[:, 0], th[:, 1:]
    inv_s2 = np.exp(-2 * ls)
    bsq = (beta ** 2).sum(1)
    logits = (r16(beta) if x_dtype else beta) @ xr.T
    lp = (-0.5 * ls ** 2 - 0.5 * bsq * inv_s2 - p * ls
          + (y * logits - np.logaddexp(0.0, logits)).sum(1))
    resid = y - 1 / (1 + np.exp(-logits))
    if resid_dtype or x_dtype:
        resid = r16(resid)
    g = np.concatenate([(-ls + bsq * inv_s2 - p)[:, None],
                        resid @ xr - beta * inv_s2[:, None]], 1)
    return lp, g


@pytest.mark.parametrize("p", [9, 150])
@pytest.mark.parametrize("switch", ["x_dtype", "resid_dtype"])
def test_model_float16_switch_matches_jax(p, switch):
    """The float16 switches in float64: against the function with their
    roundings and exact sums (numpy) to 1e-10, and against JAX's at p = 9.
    JAX's CPU dot of float16 operands sums in float32 whatever
    `preferred_element_type` asks: at p = 150 its logits lie some 4e-7 from
    exact sums, which flips the float16 rounding of a few residuals, so the
    JAX comparison is made where the contraction is short, to 1e-6."""
    kw = {switch: "float16"}
    th = 0.1 * np.random.default_rng(p).normal(size=(6, p + 1))
    tt = ah.hierarchical_logistic(n=200, p=p, dtype=torch.float64,
                                  device="cpu", **kw)
    lp_t, g_t = tt.logdensity_and_grad(torch.as_tensor(th))
    ld_t = tt.logdensity(torch.as_tensor(th))
    lp_n, g_n = _np_logistic(th, p, switch == "x_dtype",
                             switch == "resid_dtype")
    for a, b in ((lp_t, lp_n), (g_t, g_n), (ld_t, lp_n)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-10)
    if p == 9:
        tj = jax_logistic(n=200, p=p, dtype=jnp.float64, **kw)
        lp_j, g_j = jax.vmap(tj.logdensity_and_grad)(jnp.asarray(th))
        for a, b in ((lp_t, lp_j), (g_t, g_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-8)
    g_b = ah.hierarchical_logistic(
        n=200, p=p, dtype=torch.float64, device="cpu",
        **{switch: "bfloat16"}).logdensity_and_grad(torch.as_tensor(th))[1]
    g_0 = ah.hierarchical_logistic(
        n=200, p=p, dtype=torch.float64,
        device="cpu").logdensity_and_grad(torch.as_tensor(th))[1]
    # the switch moves the gradient past the tolerances, not as bfloat16
    # does
    scale = float(g_0.abs().max())
    assert float((g_t - g_0).abs().max()) > 1e-5 * scale
    assert float((g_t - g_b).abs().max()) > 1e-5 * scale


def test_k1_float16_modes():
    """K1's float16 modes: which switches take them, the plain twin within
    K1's gate of the mode's float64 function (the allowance covering the
    float16 residual roundings float32 logits can flip), the wide layout
    rounded to float16 (exact in TF32) with a zero lo plane, and a design
    and a residual in two different reduced dtypes having no mode."""
    assert k1.mode_of(torch.float16, None) == k1.MODE_F16
    assert k1.mode_of(torch.float16, torch.float16) == k1.MODE_F16
    assert k1.mode_of(None, torch.float16) == k1.MODE_RESID_F16
    assert k1.mode_of(torch.bfloat16, torch.float16) is None
    x_np, y_np = _synthetic_data(1000, 99)
    x = torch.as_tensor(x_np, dtype=torch.float32)
    y = torch.as_tensor(y_np, dtype=torch.float32)
    theta = 0.3 * torch.randn(64, 100, generator=torch.Generator()
                              .manual_seed(3), dtype=torch.float32)
    for mode in (k1.MODE_F16, k1.MODE_RESID_F16):
        lp_p, g_p = k1.plain_logistic_value_grad(theta, x, y, mode)
        lp_r, g_r, allow, n_near = k1.rounding_reference(theta, x, y, mode)
        diff = (g_p.double() - g_r).abs()
        assert bool((diff <= 1e-4 * g_r.abs().max() + allow).all())
        assert float((lp_p.double() - lp_r).abs().max()) <= 1e-4 * float(
            lp_r.abs().max())
        # the mode is not bfloat16's, nor float32's
        g_b = k1.plain_logistic_value_grad(theta, x, y, mode - 2)[1]
        assert float((g_p - g_b).abs().max()) > 1e-4 * float(
            g_r.abs().max())
    xw = torch.as_tensor(_synthetic_data(45, 140)[0], dtype=torch.float32)
    planes, _ = k1.wide_layout(xw, k1.MODE_F16)
    assert torch.equal(planes[0, :45, 1:141],
                       xw.to(torch.float16).to(torch.float32))
    assert torch.equal(k1.tf32_round(planes[0]), planes[0])
    assert not bool(planes[1].any())
    with pytest.raises(ValueError, match="a reduced dtype"):
        ah.hierarchical_logistic(n=20, p=3, x_dtype="float32", device="cpu")


@pytest.mark.parametrize("tname,dim,eps,max_depth,seed", [
    ("std", 5, 0.45, 6, 0), ("corr", 8, 0.3, 7, 1)])
def test_f16_stacks_match_jax_under_forced_directions(tname, dim, eps,
                                                      max_depth, seed):
    prec = np.eye(dim) + (0.5 * np.ones((dim, dim)) if tname == "corr"
                          else 0.0)
    pj, pt = jnp.asarray(prec), torch.as_tensor(prec)
    m_inv = np.linspace(0.5, 2.0, dim)
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(
        jnp.asarray(m_inv)), target=aj.LogDensityTarget(
        lambda x: -0.5 * x @ pj @ x, dim))
    ht = ah.Hamiltonian(metric=convert.diag_metric(m_inv, "cpu"),
                        target=ah.LogDensityTarget(
                            lambda x: -0.5 * torch.sum((x @ pt) * x, -1),
                            dim))
    traj_j = aj.Trajectory(aj.Leapfrog(step_size=jnp.asarray(eps)),
                           aj.GeneralisedNoUTurn(max_depth=max_depth),
                           "multinomial", stack_dtype="float16")
    traj_t = convert.trajectory(traj_j, "cpu")
    assert traj_t.stack_torch_dtype == torch.float16
    rng = np.random.default_rng(seed)
    directions = rng.choice([-1, 1], size=max_depth)
    zj = jax.vmap(hj.phasepoint)(jnp.asarray(rng.normal(size=(12, dim))),
                                 jnp.asarray(rng.normal(size=(12, dim))))
    _, st_j, dbg_j = jax.vmap(lambda z: aj.nuts_transition(
        jax.random.PRNGKey(0), hj, traj_j, z, force_directions=directions,
        return_debug=True))(zj)
    _, st_t, dbg_t = ah.nuts_transition(
        torch.Generator().manual_seed(0), ht, traj_t,
        convert.phasepoint(zj, "cpu"), force_directions=directions,
        return_debug=True)
    for k in ("n_steps", "tree_depth", "numerical_error"):
        assert np.array_equal(st_t[k].numpy(), np.asarray(st_j[k])), k
    np.testing.assert_allclose(st_t["acceptance_rate"].numpy(),
                               np.asarray(st_j["acceptance_rate"]),
                               rtol=1e-10, atol=1e-12)
    n_slots = max(1, max_depth - 1)
    for kt, kj in (("ck_r", "ck_r"), ("ck_d", "ck_cum")):
        assert dbg_t[kt].dtype == torch.float16
        assert np.array_equal(
            dbg_t[kt][:, :n_slots].to(torch.float64).numpy(),
            np.asarray(dbg_j[kj]).astype(np.float64)), kt

"""Kernels of the port on the card, against their plain PyTorch versions.

These tests need a CUDA card and skip without one. The module imports no
JAX, so that on the card it runs without the JAX package:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import ctypes

import numpy as np
import pytest
import torch

from advancedhmc_torch.models.gaussian import std_gaussian_block
from advancedhmc_torch.models.logistic import _synthetic_data, \
    hierarchical_logistic, hierarchical_logistic_block
from advancedhmc_torch.ops import fused_leapfrog as k3
from advancedhmc_torch.ops import fused_logistic as k1
from advancedhmc_torch.ops import fused_nuts_kernel as k2

# K2 against its plain version: both draw the same counter stream, but a
# float32 rounding difference can decide a near-tie the other way and send
# a chain down another tree (or pick another candidate of the same tree),
# so a share of the chains, not all, must agree at every transition, in the
# integer outputs and in θ within K2_THETA_TOL.
K2_AGREE_SHARE = 0.999
K2_THETA_TOL = 1e-3


def _k2_agreement(out, ref):
    same = (out[1] == ref[1]).all(0) & (out[2] == ref[2]).all(0) & \
        (out[3] == ref[3]).all(0)
    close = same & ((out[0] - ref[0]).abs().amax((0, 2)) <= K2_THETA_TOL)
    return float(same.double().mean()), float(close.double().mean())


@pytest.mark.gpu
def test_k1_kernel_matches_plain_on_card():
    """K1 on the card against its plain version (float32, summation order
    differs: 1e-4 of the largest magnitude), at the draw phase's and the
    warmup pool's chain counts, the step-size search's one chain and a
    ragged count, over 1000 and 300 rows; two calls on the same inputs give
    the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (1000, 300):
        x, y = _synthetic_data(n, 99)
        xt = torch.as_tensor(x, dtype=torch.float32, device="cuda")
        yt = torch.as_tensor(y, dtype=torch.float32, device="cuda")
        for c in (32768, 4096, 13, 1):
            th = 0.3 * torch.randn(c, 100, generator=gen, device="cuda")
            before = k1.logistic_value_grad.launches
            lp, g = k1.logistic_value_grad(th, xt, yt)
            assert k1.logistic_value_grad.launches == before + 1
            lp2, g2 = k1.logistic_value_grad(th, xt, yt)
            lp_p, g_p = k1.plain_logistic_value_grad(th, xt, yt)
            torch.cuda.synchronize()
            assert torch.equal(lp, lp2) and torch.equal(g, g2), (c, n)
            assert bool((g[:, 0] == 0).all())
            assert float((g - g_p).abs().max()) <= 1e-4 * float(
                g_p.abs().max()), (c, n)
            assert float((lp - lp_p).abs().max()) <= 1e-4 * max(
                1.0, float(lp_p.abs().max())), (c, n)


@pytest.mark.gpu
@pytest.mark.parametrize("c,p,n", [(32768, 99, 1000), (4096, 99, 1000),
                                   (13, 99, 300), (1, 99, 1000),
                                   (1024, 999, 1000), (1000, 200, 997),
                                   (1, 999, 1000)])
@pytest.mark.parametrize("mode", [k1.MODE_BF16, k1.MODE_RESID_BF16])
def test_k1_reduced_modes_match_plain_on_card(mode, c, p, n):
    """K1's bfloat16 modes (the model's `x_dtype`, `resid_dtype`), narrow
    and wide, against the mode's float64 function: K1's gate (1e-4 of the
    largest magnitude) plus, on the gradient, the residual roundings that
    float32 logits can flip (`rounding_reference`); its float32 plain twin
    is held to the same gate. Two calls give the same bits, the launches a
    call are the float32 mode's, and the bfloat16-operand mode counts its
    own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x_np, y_np = _synthetic_data(n, p)
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    th = 0.3 * torch.randn(c, p + 1, generator=torch.Generator(
        device="cuda").manual_seed(c + p), device="cuda")
    design = k1.WideDesign(x, mode) if p > 128 else None
    f = k1.logistic_value_grad
    before = (f.launches, f.bf16_launches)
    lp, g = f(th, x, y, design, mode)
    per_call = (f.launches - before[0], f.bf16_launches - before[1])
    lp2, g2 = f(th, x, y, design, mode)
    lp_p, g_p = k1.plain_logistic_value_grad(th, x, y, mode)
    lp_r, g_r, allow, _ = k1.rounding_reference(th, x, y, mode)
    torch.cuda.synchronize()
    launches = 2 if p > 128 else 1
    assert per_call == (launches, launches if mode == k1.MODE_BF16 else 0)
    assert torch.equal(lp, lp2) and torch.equal(g, g2)
    assert bool((g[:, 0] == 0).all())
    tol_g = 1e-4 * float(g_r.abs().max())
    tol_lp = 1e-4 * max(1.0, float(lp_r.abs().max()))
    for gg, ll in ((g, lp), (g_p, lp_p)):
        assert bool(((gg.double() - g_r).abs() <= tol_g + allow).all())
        assert float((ll.double() - lp_r).abs().max()) <= tol_lp


@pytest.mark.gpu
@pytest.mark.parametrize("c,p,n", [(32768, 99, 1000), (13, 99, 300),
                                   (1024, 999, 1000), (1000, 200, 997)])
@pytest.mark.parametrize("mode", [k1.MODE_F16, k1.MODE_RESID_F16])
def test_k1_float16_modes_match_plain_on_card(mode, c, p, n):
    """K1's float16 modes (`x_dtype`, `resid_dtype` "float16"), narrow and
    wide, held as the bfloat16 modes are: the mode's float64 function to
    K1's gate plus the residual roundings that float32 logits can flip, two
    calls bitwise equal, the float16-operand mode counting its own
    launches; and not the bfloat16 mode's function."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x_np, y_np = _synthetic_data(n, p)
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    th = 0.3 * torch.randn(c, p + 1, generator=torch.Generator(
        device="cuda").manual_seed(c + p), device="cuda")
    design = k1.WideDesign(x, mode) if p > 128 else None
    f = k1.logistic_value_grad
    before = (f.launches, f.f16_launches)
    lp, g = f(th, x, y, design, mode)
    per_call = (f.launches - before[0], f.f16_launches - before[1])
    lp2, g2 = f(th, x, y, design, mode)
    lp_r, g_r, allow, _ = k1.rounding_reference(th, x, y, mode)
    _, g_b, _, _ = k1.rounding_reference(th, x, y, mode - 2)
    torch.cuda.synchronize()
    launches = 2 if p > 128 else 1
    assert per_call == (launches, launches if mode == k1.MODE_F16 else 0)
    assert torch.equal(lp, lp2) and torch.equal(g, g2)
    assert bool((g[:, 0] == 0).all())
    tol_g = 1e-4 * float(g_r.abs().max())
    tol_lp = 1e-4 * max(1.0, float(lp_r.abs().max()))
    assert bool(((g.double() - g_r).abs() <= tol_g + allow).all())
    assert float((lp.double() - lp_r).abs().max()) <= tol_lp
    assert float((g_b - g_r).abs().max()) > tol_g


# K1 with the prior folded in: the cells' widths and chain counts, p = 24
# (German credit's width), and one chain
K1_PRIOR_SHAPES = [(24, 1), (24, 4096), (24, 32768), (99, 1), (99, 4096),
                   (99, 32768), (999, 1), (999, 1024), (999, 16384)]
K1_MODES = [k1.MODE_F32, k1.MODE_BF16, k1.MODE_RESID_BF16, k1.MODE_F16,
            k1.MODE_RESID_F16]


@pytest.mark.gpu
@pytest.mark.parametrize("p,c", K1_PRIOR_SHAPES)
@pytest.mark.parametrize("mode", K1_MODES)
def test_k1_prior_matches_float64_on_card(mode, p, c):
    """K1 with the prior (p = dim − 1), narrow and wide, in every mode,
    against the mode's float64 function plus the float64 prior at the
    unrounded θ: K1's gate (1e-4 of the largest magnitude) plus, on the gradient, the
    residual roundings that float32 logits can flip (`rounding_reference`,
    zero in float32). Two calls give the same bits and launch what a
    likelihood call launches; without the prior component 0 is exactly 0
    and the difference of the two calls is the prior's terms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from advancedhmc_torch.models.logistic import _prior

    torch.backends.cuda.matmul.allow_tf32 = False
    x_np, y_np = _synthetic_data(1000, p)
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(c + p + mode)
    th = (0.1 if p > 128 else 0.3) * torch.randn(c, p + 1, generator=gen,
                                                 device="cuda")
    th[:, 0] -= 0.7                  # σ ≈ 0.5: the prior's terms weigh in
    design = k1.WideDesign(x, mode) if p > 128 else None
    f = k1.logistic_value_grad
    before = f.launches
    lp, g = f(th, x, y, design, mode, prior=True)
    assert f.launches - before == (2 if p > 128 else 1)
    lp2, g2 = f(th, x, y, design, mode, prior=True)
    lp0, g0 = f(th, x, y, design, mode)
    lp_r, g_r, allow, _ = k1.rounding_reference(th, x, y, mode)
    lp_pri, g_pri = _prior(th.double(), p)
    lp_r, g_r = lp_r + lp_pri, g_r + g_pri
    torch.cuda.synchronize()
    assert torch.equal(lp, lp2) and torch.equal(g, g2)
    assert bool((g0[:, 0] == 0).all())
    tol_g = 1e-4 * float(g_r.abs().max())
    tol_lp = 1e-4 * max(1.0, float(lp_r.abs().max()))
    assert bool(((g.double() - g_r).abs() <= tol_g + allow).all())
    assert float((lp.double() - lp_r).abs().max()) <= tol_lp
    assert float(((g - g0).double() - g_pri).abs().max()) <= tol_g
    assert float(((lp - lp0).double() - lp_pri).abs().max()) <= tol_lp


@pytest.mark.gpu
@pytest.mark.parametrize("p", [24, 99, 999])
def test_centred_model_value_grad_is_k1_alone_on_card(p):
    """A float32 value+grad of `hierarchical_logistic` on the card is one
    K1 call with the prior folded in: K1's launches (1 up to p = 128, 2
    above) and no PyTorch operation but the outputs' allocation (a
    dispatch mode records every ATen operation, without the profiler,
    whose clock alignment a later test in the process relies on); its
    `ahmc.k1` span notes prior = p and the logistic link and no
    `ahmc.target.prior` span opens; the non-centred model's K1 call notes
    prior 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.utils._python_dispatch import TorchDispatchMode

    from advancedhmc_torch import profiling
    from advancedhmc_torch.models.logistic import hierarchical_logistic_nc

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    tgt = hierarchical_logistic(n=1000, p=p, device="cuda")
    th = 0.1 * torch.randn(4096, p + 1, generator=torch.Generator(
        device="cuda").manual_seed(p), device="cuda")
    tgt.logdensity_and_grad(th)          # lays out the wide design
    before = k1.logistic_value_grad.launches
    profiling.enable_spans(True)
    try:
        with Ops() as ops:
            lp, g = tgt.logdensity_and_grad(th)
        launched = k1.logistic_value_grad.launches - before
        spans = profiling.spans()
        hierarchical_logistic_nc(n=1000, p=p, device="cuda"
                                 ).logdensity_and_grad(th)
        nc = profiling.spans()
    finally:
        profiling.enable_spans(False)
    assert launched == (2 if p > 128 else 1)
    assert set(ops.names) == {"aten.empty.memory_format"}, ops.names
    assert [r["name"] for r in spans] == ["ahmc.target.value_grad",
                                          "ahmc.k1"]
    assert spans[1]["attrs"] == {"chains": 4096, "prior": p,
                                 "link": "logistic"}
    assert [r["attrs"] for r in nc if r["name"] == "ahmc.k1"] == [
        {"chains": 4096, "prior": 0, "link": "logistic"}]
    # the model's call is K1's with the prior, bit for bit
    x_np, y_np = _synthetic_data(1000, p)
    lp_k, g_k = k1.logistic_value_grad(
        th, torch.as_tensor(x_np, dtype=torch.float32, device="cuda"),
        torch.as_tensor(y_np, dtype=torch.float32, device="cuda"),
        prior=True)
    torch.cuda.synchronize()
    assert torch.equal(lp, lp_k) and torch.equal(g, g_k)


@pytest.mark.gpu
def test_sample_options_run_on_card(capsys):
    """The options of `sample()` that phase 12 of chip_smoke.py does not
    drive, on the card: `resid_dtype` (K1's residual mode), the progress
    display, `verbose`, `collect_warmup_stats=False`, and the stepwise
    thinned and online draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import advancedhmc_torch as ah

    target = ah.hierarchical_logistic(n=300, p=9, resid_dtype="bfloat16",
                                      device="cuda")
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.1, device="cuda")),
        ah.GeneralisedNoUTurn(max_depth=5)))
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(0).normal(size=(64, 10)),
        dtype=torch.float32, device="cuda")
    for kw in (dict(thin=2), dict(collect="online")):
        before = k1.logistic_value_grad.calls
        res = ah.sample(torch.Generator(device="cuda").manual_seed(0),
                        target, kernel,
                        ah.make_metric("diagonal", 10, device="cuda"),
                        theta0, 40, n_adapts=20,
                        adaptor=ah.AdaptorConfig(kind="stan"),
                        drop_warmup=True, collect_warmup_stats=False,
                        progress=True, progress_every=10, verbose=True,
                        device="cuda", **kw)
        assert k1.logistic_value_grad.calls > before
        assert res.warmup_stats is None
        if "thin" in kw:
            assert res.thetas.shape == (10, 64, 10)
            assert bool(torch.isfinite(res.thetas).all())
        else:
            assert res.thetas is None and int(res.online["n"]) == 20
    out = capsys.readouterr().out
    assert out.count(" | accept ") == 8 and "sampling finished" in out


@pytest.mark.gpu
def test_bf16_design_model_runs_k1_bf16_on_card():
    """`hierarchical_logistic(x_dtype="bfloat16")` sends its float32
    batches on the card to K1's bfloat16 mode, and agrees with the mode's
    float64 function plus the float64 prior at K1's gate (with the
    residual-rounding allowance, as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from advancedhmc_torch.models.logistic import _prior

    th = torch.as_tensor(0.1 * np.random.default_rng(2).normal(
        size=(64, 1000)), dtype=torch.float32)
    tgt = hierarchical_logistic(n=1000, p=999, x_dtype="bfloat16",
                                device="cuda")
    f = k1.logistic_value_grad
    before = f.bf16_calls
    lp, g = tgt.logdensity_and_grad(th.cuda())
    assert f.bf16_calls == before + 1
    x_np, y_np = _synthetic_data(1000, 999)
    lp_r, g_r, allow, _ = k1.rounding_reference(
        th, torch.as_tensor(x_np), torch.as_tensor(y_np), k1.MODE_BF16)
    lp_pri, g_pri = _prior(th.double(), 999)
    lp_r, g_r = lp_r + lp_pri, g_r + g_pri
    assert float((lp.cpu().double() - lp_r).abs().max()) <= 1e-4 * float(
        lp_r.abs().max())
    assert bool(((g.cpu().double() - g_r).abs()
                 <= 1e-4 * g_r.abs().max() + allow).all())


@pytest.mark.gpu
@pytest.mark.parametrize("p,dtype", [(200, torch.float32),
                                     (99, torch.float64)])
def test_logistic_model_beyond_k1_runs_on_card(p, dtype):
    """A float64 model runs on the card through its analytic value+grad, as
    the JAX model does, launching nothing, and agrees with the float64
    analytic value on the CPU to 1e-10 of the largest magnitude. A float32
    model wider than K1's narrow instances (p = 200 > 128) is K1's to
    compute, as it is the Pallas kernel's: one call of its wide path (two
    launches: the two GEMMs), agreeing with the float64 value at K1's float32 gate (1e-4 of the
    largest magnitude, as chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    th = 0.1 * np.random.default_rng(6).normal(size=(4096, p + 1))
    tgt = hierarchical_logistic(n=1000, p=p, dtype=dtype, device="cuda")
    before = k1.logistic_value_grad.launches
    calls = k1.logistic_value_grad.calls
    th_card = torch.as_tensor(th, dtype=dtype, device="cuda")
    lp, g = tgt.logdensity_and_grad(th_card)
    torch.cuda.synchronize()
    called = 1 if dtype == torch.float32 else 0
    assert k1.logistic_value_grad.calls == calls + called
    assert k1.logistic_value_grad.launches == before + 2 * called
    assert lp.dtype == g.dtype == dtype and g.shape == (4096, p + 1)
    ref = hierarchical_logistic(n=1000, p=p, dtype=torch.float64,
                                device="cpu")
    lp64, g64 = ref.logdensity_and_grad(torch.as_tensor(th))
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert float((lp.cpu().double() - lp64).abs().max()) <= tol * max(
        1.0, float(lp64.abs().max()))
    assert float((g.cpu().double() - g64).abs().max()) <= tol * float(
        g64.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("p", [129, 200, 999, 2047])
@pytest.mark.parametrize("c", [1, 63, 64, 65, 1000, 4096])
def test_k1_wide_matches_float64_and_repeats_on_card(c, p):
    """K1's wide path at the step-size search's one chain, around the
    64-chain tile (63, 64, 65), at ragged and large C, from one column past
    the narrow instances (p = 129) to p = 2047, over n = 997 and 1000 rows:
    within 1e-4 of float64's largest magnitude, component 0 zero, one call
    and two launches (the two GEMMs) counted a call, and two calls, the
    first preparing its own design and the second given one prepared
    before, give the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(c + p)
    for n in (997, 1000):
        x_np, y_np = _synthetic_data(n, p)
        x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
        y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
        th = 0.1 * torch.randn(c, p + 1, generator=gen, device="cuda")
        design = k1.WideDesign(x)
        before = k1.logistic_value_grad.launches
        calls = k1.logistic_value_grad.calls
        lp, g = k1.logistic_value_grad(th, x, y)
        assert k1.logistic_value_grad.calls == calls + 1
        assert k1.logistic_value_grad.launches == before + 2
        lp2, g2 = k1.logistic_value_grad(th, x, y, design)
        lp64, g64 = k1.plain_logistic_value_grad(th.double(), x.double(),
                                                 y.double())
        torch.cuda.synchronize()
        assert torch.equal(lp, lp2) and torch.equal(g, g2), n
        assert bool((g[:, 0] == 0).all())
        assert float((g.double() - g64).abs().max()) <= 1e-4 * float(
            g64.abs().max()), n
        assert float((lp.double() - lp64).abs().max()) <= 1e-4 * max(
            1.0, float(lp64.abs().max())), n
    shape = k1.wide_launch_shape(c, p + 1, 1000)
    assert shape["chain_tiles"] == -(-c // 128)
    assert shape["stage_a_blocks"] == (shape["chain_tiles"] * shape[
        "stage_a_column_tiles"] * shape["stage_a_ranks"])


@pytest.mark.gpu
def test_k1_wide_design_is_prepared_once_per_model():
    """The model's likelihood (`fused_logistic_value_grad(x, y)`'s apply)
    lays out its design for the wide path at its first call on the card and
    not again while x is unchanged; once x is written in place it lays it
    out anew, so that it computes with the new x as the plain version does.
    `logistic_value_grad` with a raw x and no design prepares one a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x_np, y_np = _synthetic_data(300, 999)
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    th = 0.1 * torch.randn(64, 1000, device="cuda")
    apply = k1.fused_logistic_value_grad(x, y)
    before = k1.WideDesign.builds
    first = apply(th)
    design = apply.design
    assert k1.WideDesign.builds == before + 1 and design is not None
    for _ in range(3):
        again = apply(th)
    torch.cuda.synchronize()
    assert k1.WideDesign.builds == before + 1 and apply.design is design
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])
    raw = k1.logistic_value_grad(th, x, y)
    k1.logistic_value_grad(th, x, y)
    assert k1.WideDesign.builds == before + 3
    assert torch.equal(raw[1], first[1])
    x.mul_(2.0)          # a new version of x: its design is laid out anew
    lp, g = apply(th)
    assert k1.WideDesign.builds == before + 4 and apply.design is not design
    apply(th)
    assert k1.WideDesign.builds == before + 4
    lp64, g64 = k1.plain_logistic_value_grad(th.double(), x.double(),
                                             y.double())
    torch.cuda.synchronize()
    assert float((g.double() - g64).abs().max()) <= 1e-4 * float(
        g64.abs().max())
    assert float((lp.double() - lp64).abs().max()) <= 1e-4 * max(
        1.0, float(lp64.abs().max()))


# the logistic cases: (ε, max_depth, T)
K2_LOGISTIC = {"logistic": (0.03, 6, 4), "deep": (0.02, 8, 4),
               "divergent": (2.4, 6, 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["gaussian", *K2_LOGISTIC])
def test_k2_kernel_matches_plain_on_card(what):
    """The JAX megakernel test's configuration (8 chains × 5-D standard
    normal, ε 0.5, seed 42, max_depth 6, T 80, blocks of 8), and the
    100-D logistic over 1000 rows at 512 chains: at an ε whose trees
    stop at the depth cap of 6, at one whose trees reach depth 7-8 of 8
    (the deep checkpoint slots), and at one where about a quarter of the
    trees diverge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if what == "gaussian":
        tgt, data = std_gaussian_block(5, device="cuda")
        args = (tgt, torch.zeros(8, 5, device="cuda"),
                torch.ones(5, device="cuda"), 0.5, 42, data, 5, 80, 6, 8)
    else:
        tgt, data = hierarchical_logistic_block(n=1000, p=99, d_pad=128,
                                                device="cuda")
        th0 = torch.as_tensor(
            0.05 * np.random.default_rng(0).normal(size=(512, 100)),
            dtype=torch.float32, device="cuda")
        th0[:, 0] = -0.7
        m_inv = torch.full((100,), 2e-3, device="cuda")
        eps, max_depth, T = K2_LOGISTIC[what]
        args = (tgt, th0, m_inv, eps, 3, data, 100, T, max_depth, 256)
    before = k2.fused_nuts.launches
    out = k2.fused_nuts(*args)
    assert k2.fused_nuts.launches == before + 1
    ref = k2.plain_fused_nuts(*args)
    torch.cuda.synchronize()
    assert out[0].shape == ref[0].shape and out[3].dtype == torch.bool
    assert bool(torch.isfinite(out[0]).all())
    share, share_theta = _k2_agreement(out, ref)
    assert min(share, share_theta) >= K2_AGREE_SHARE, (share, share_theta)
    if what == "gaussian":
        d = out[0][20:].reshape(-1, 5).double()
        assert float(d.mean(0).abs().max()) < 0.35
        assert float((d.var(0, correction=0) - 1.0).abs().max()) < 0.45
        assert not bool(out[3].any())
        assert 2 <= float(out[2].double().mean()) <= 4
    elif what == "deep":
        assert float(out[2].double().mean()) >= 7.0
    elif what == "divergent":
        assert float(out[3].double().mean()) >= 0.1


@pytest.mark.gpu
def test_k2_ragged_block_and_repeatable_bits_on_card():
    """1000 chains: neither the warp tile (16 chains) nor the block (64)
    divides them. K2 agrees with its plain version at the 0.999 share, two
    calls on the same inputs give the same bits (no atomics), and the
    scratch is the block-padded chains' tree state and scalar records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tgt, data = hierarchical_logistic_block(n=1000, p=99, d_pad=128,
                                            device="cuda")
    th0 = torch.as_tensor(
        0.05 * np.random.default_rng(1).normal(size=(1000, 100)),
        dtype=torch.float32, device="cuda")
    th0[:, 0] = -0.7
    args = (tgt, th0, torch.full((100,), 2e-3, device="cuda"), 0.05, 5,
            data, 100, 4, 6, 256)
    out = k2.fused_nuts(*args)
    again = k2.fused_nuts(*args)
    ref = k2.plain_fused_nuts(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert bool(torch.isfinite(out[0]).all())
    share, share_theta = _k2_agreement(out, ref)
    assert min(share, share_theta) >= K2_AGREE_SHARE, (share, share_theta)
    lib = k2._build.load("fused_nuts")
    k2._kernel(lib)
    assert lib.fused_nuts_chains_per_block() == 64
    padded, vectors, record = 1024, 15 + 2 * 6, 16
    assert lib.fused_nuts_scratch_floats(1000, 100, 6) == padded * (
        vectors * 100 + record)


# K2's wide instance against its plain version: at 1000-D a float32
# rounding difference in lp is ~10x the 100-D one (K1's wide kernel: up to
# 5.1e-4 on lp), so near-ties flip more often; the share chip_smoke.py's
# phase 10 gates on.
K2_WIDE_AGREE_SHARE = 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("p,n", [(129, 1000), (200, 997), (999, 1000),
                                 (200, 797)])
def test_k2_wide_logistic_matches_plain_on_card(p, n):
    """Wider than the warp tile (p > 128): K2's wide instance launches in
    clusters of several ranks (no raise, no fallback), agrees with its
    plain version at the wide share, and two calls on the same inputs give
    the same bits. p = 129 leaves one column in the last chunk of 128,
    n = 997 a ragged row tile; at n = 797 the 25 row tiles do not divide
    over the ranks, so some rank takes fewer tiles or none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dim = p + 1
    tgt, data = hierarchical_logistic_block(n=n, p=p, d_pad=-(-dim // 128)
                                            * 128, device="cuda")
    th0 = torch.as_tensor(
        0.05 * np.random.default_rng(p).normal(size=(256, dim)),
        dtype=torch.float32, device="cuda")
    th0[:, 0] = -1.5
    args = (tgt, th0, torch.full((dim,), 5e-3, device="cuda"), 0.3, 7,
            data, dim, 4, 6, 256)
    lib = k2._build.load("fused_nuts")
    k2._kernel(lib)
    ranks, clusters = ctypes.c_int(), ctypes.c_int()
    lib.fused_nuts_cluster_shape(0, 256, dim, n, ctypes.byref(ranks),
                                 ctypes.byref(clusters))
    assert ranks.value > 1 and clusters.value > 0
    if n == 797:     # ceil(25 / R) tiles a rank: the last ranks fewer
        assert ranks.value * -(-25 // ranks.value) > 25
    before = k2.fused_nuts.launches
    out = k2.fused_nuts(*args)
    assert k2.fused_nuts.launches == before + 1
    again = k2.fused_nuts(*args)
    ref = k2.plain_fused_nuts(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert bool(torch.isfinite(out[0]).all())
    assert out[0].shape == (4, 256, dim)
    share, share_theta = _k2_agreement(out, ref)
    assert min(share, share_theta) >= K2_WIDE_AGREE_SHARE, (share,
                                                            share_theta)
    assert float(out[2].double().mean()) >= 2.0        # real trees


@pytest.mark.gpu
@pytest.mark.parametrize("c,d,n_steps,eps", [
    (1024, 8, 100, 0.05), (4096, 128, 100, 0.05), (16384, 128, 100, 0.05),
    (65536, 8, 100, 0.05), (20, 5, 17, 0.12), (1000, 5, 100, 0.05),
    (333, 37, 50, 0.05), (64, 5000, 20, 0.05)])
def test_k3_kernel_matches_plain_on_card(c, d, n_steps, eps):
    """The microbenchmark's four shapes, the JAX test's ragged case, the
    reference's GPU test (1000 chains of a 5-D target), a D that does not
    divide a block and a D longer than a block (a block a chain, in
    chunks), at the JAX test's tolerance (2e-5, relative and absolute); one
    launch a call, and two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    th = torch.randn(c, d, generator=gen, device="cuda")
    r = torch.randn(c, d, generator=gen, device="cuda")
    prec = torch.linspace(0.5, 2.0, d, device="cuda")
    m_inv = torch.linspace(0.8, 1.2, d, device="cuda")
    before = k3.fused_gaussian_leapfrog.launches
    out = k3.fused_gaussian_leapfrog(th, r, prec, m_inv, eps, n_steps)
    assert k3.fused_gaussian_leapfrog.launches == before + 1
    again = k3.fused_gaussian_leapfrog(th, r, prec, m_inv, eps, n_steps)
    ref = k3.reference_gaussian_leapfrog(th, r, prec, m_inv, eps, n_steps)
    torch.cuda.synchronize()
    for a, b, c2 in zip(out, ref, again):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        assert torch.equal(a, c2)


@pytest.mark.gpu
def test_pair_transition_is_bitwise_the_single_one_on_card():
    """The leaf-pair body on the card: one transition of 256 chains of the
    100-D hierarchical logistic (K1 at every leaf) gives the single-leaf
    body's bits, every field and every stack slot a check reads (the spare
    slot is a write-only sink)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import advancedhmc_torch as ah
    from advancedhmc_torch import nuts

    target = hierarchical_logistic(n=1000, p=99, dtype=torch.float32,
                                   device="cuda")
    h = ah.Hamiltonian(metric=ah.make_metric("diagonal", 100, device="cuda"),
                       target=target)
    traj = ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.01, device="cuda")),
        ah.GeneralisedNoUTurn(max_depth=6))
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(0).normal(size=(256, 100)),
        dtype=torch.float32, device="cuda")
    z0 = h.init_phasepoint(torch.Generator(device="cuda").manual_seed(1),
                           theta0)
    before = k1.logistic_value_grad.calls
    (z1, s1, d1), (z2, s2, d2) = [
        nuts.nuts_transition(torch.Generator(device="cuda").manual_seed(2),
                             h, traj, z0, return_debug=True, _pair=pair)
        for pair in (False, True)]
    assert k1.logistic_value_grad.calls > before
    n_slots = d1["ck_r"].shape[1] - 1
    for k in d1:
        a, b = d1[k], d2[k]
        if k.startswith(("ck_", "sck_")):
            a, b = a[:, :n_slots], b[:, :n_slots]
        if isinstance(a, ah.PhasePoint):
            assert torch.equal(a.theta, b.theta) and torch.equal(a.r, b.r) \
                and torch.equal(a.grad, b.grad), k
        else:
            assert torch.equal(a, b), k
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert torch.equal(z1.theta, z2.theta)
    assert float(s1["tree_depth"].double().mean()) >= 3.0    # real trees


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["chees", "hmcda"])
def test_static_family_runs_k1_once_a_value_grad_on_card(what):
    """`sample_chees` and `HMCDA(...).sample` on the 100-D logistic at 1024
    chains: every value+grad call of the target is one K1 call and one
    launch, and the draws are finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import advancedhmc_torch as ah

    tgt = hierarchical_logistic(n=1000, p=99, device="cuda")
    calls = []
    inner = tgt.logdensity_and_grad

    def counted(theta):
        calls.append(theta.shape[0])
        return inner(theta)

    tgt = dataclasses.replace(tgt, logdensity_and_grad=counted)
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(0).normal(size=(1024, 100)),
        dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    f = k1.logistic_value_grad
    launches, k1_calls = f.launches, f.calls
    if what == "chees":
        res = ah.sample_chees(gen, tgt, theta0, 60, 40, init_t=2.0,
                              da=ah.DualAveragingConfig(delta=0.75),
                              max_steps=64, drop_warmup=True, device="cuda")
        assert bool((res.stats["n_steps"] == res.stats["n_steps"][:, :1])
                    .all())
    else:
        res = ah.HMCDA(0.8, 1.0).sample(gen, tgt, theta0, 60, n_adapts=30,
                                        drop_warmup=True, device="cuda")
    assert f.launches - launches == f.calls - k1_calls == len(calls) > 0
    assert bool(torch.isfinite(res.thetas).all())
    assert float(res.stats["numerical_error"].double().mean()) <= 1e-3


@pytest.mark.gpu
def test_static_family_entry_points_run_on_card():
    """`as_target`'s batched callable, the five integrators with endpoint
    and multinomial sampling, and partial momentum refreshment on the
    static and the NUTS paths, on the card: finite draws on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import advancedhmc_torch as ah

    tgt = ah.as_target(lambda x: -0.5 * torch.sum(x * x, -1), dim=5)
    theta0 = 0.1 * torch.randn(64, 5, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def stepper(q, p, eps, grad_fn, velocity_fn):
        q = q + 0.5 * eps * velocity_fn(p)
        p = p + eps * grad_fn(q)
        return q + 0.5 * eps * velocity_fn(p), p

    metric = ah.make_metric("diagonal", 5, device="cuda")
    for kind in ("leapfrog", "jitteredleapfrog", "temperedleapfrog",
                 "yoshida4", "solver"):
        integ = ah.make_integrator(kind, 0.3, stepper=stepper)
        for ts in ("endpoint", "multinomial"):
            for crit in (ah.FixedNSteps(5), ah.FixedIntegrationTime(1.5)):
                kernel = ah.HMCKernel(ah.Trajectory(integ, crit, ts_kind=ts))
                res = ah.sample(gen, tgt, kernel, metric, theta0, 20,
                                init_eps=0.3, device="cuda")
                assert res.thetas.is_cuda
                assert bool(torch.isfinite(res.thetas).all()), (kind, ts)
    partial = ah.PartialMomentumRefreshment(0.5)
    for cfg in (ah.HMCDA(0.8, 1.0), ah.NUTS(0.8, max_depth=5)):
        kernel = ah.HMCKernel(cfg.kernel.trajectory, partial)
        res = ah.sample(gen, tgt, kernel, metric, theta0, 30, n_adapts=15,
                        adaptor=cfg.adaptor, device="cuda")
        assert bool(torch.isfinite(res.thetas).all())


@pytest.mark.gpu
def test_dense_metric_sample_runs_k1_and_keeps_factors_on_card():
    """`sample()` with a per-chain dense metric (the Welford covariance in
    the per-chain fused warmup) and with a shared one (cross-chain) on the
    100-D logistic at 256 chains: every value+grad call is one K1 launch,
    the draws are finite, and each chain's factor is positive definite
    with UᵀU = M⁻¹."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import advancedhmc_torch as ah

    tgt = hierarchical_logistic(n=1000, p=99, device="cuda")
    calls = []
    inner = tgt.logdensity_and_grad

    def counted(theta):
        calls.append(theta.shape[0])
        return inner(theta)

    tgt = dataclasses.replace(tgt, logdensity_and_grad=counted)
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(0).normal(size=(256, 100)),
        dtype=torch.float32, device="cuda")
    kernel = ah.NUTS(0.8, max_depth=5).kernel
    adaptor = ah.AdaptorConfig(mm_kind="welford_cov", init_buffer=20,
                               term_buffer=20, window_size=20)
    f = k1.logistic_value_grad
    for cross_chain in (False, True):
        calls.clear()
        launches = f.launches
        gen = torch.Generator(device="cuda").manual_seed(0)
        res = ah.sample(gen, tgt, kernel,
                        ah.make_metric("dense", 100, device="cuda"), theta0,
                        80, n_adapts=64, adaptor=adaptor,
                        cross_chain=cross_chain, fuse_warmup=True,
                        fuse_warmup_block=8, fuse_draws=8, drop_warmup=True,
                        device="cuda")
        assert f.launches - launches == len(calls) > 0
        assert bool(torch.isfinite(res.thetas).all())
        m = res.final_state.metric
        assert isinstance(m, ah.DenseEuclideanMetric)
        assert m.m_inv.shape == ((100, 100) if cross_chain
                                 else (256, 100, 100))
        u = m.chol_u.double()
        m_inv = m.m_inv.double()
        err = torch.linalg.matrix_norm(u.mT @ u - m_inv) \
            / torch.linalg.matrix_norm(m_inv)
        assert float(err.max()) <= 1e-4
        assert bool((torch.linalg.eigvalsh(m_inv) > 0).all())


@pytest.mark.gpu
def test_per_chain_rank_update_sample_runs_k1_on_card():
    """`sample()` step by step with a per-chain rank-update metric (rank 8)
    adapted by each chain's low-rank estimator, on the 100-D logistic at
    256 chains: every value+grad call is one K1 launch, the draws are
    finite, and each chain ends with its own positive-definite M⁻¹."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import advancedhmc_torch as ah

    tgt = hierarchical_logistic(n=1000, p=99, device="cuda")
    calls = []
    inner = tgt.logdensity_and_grad

    def counted(theta):
        calls.append(theta.shape[0])
        return inner(theta)

    tgt = dataclasses.replace(tgt, logdensity_and_grad=counted)
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(0).normal(size=(256, 100)),
        dtype=torch.float32, device="cuda")
    adaptor = ah.AdaptorConfig(mm_kind="lowrank", mm_rank=8, init_buffer=10,
                               term_buffer=10, window_size=10)
    f = k1.logistic_value_grad
    launches = f.launches
    res = ah.sample(torch.Generator(device="cuda").manual_seed(0), tgt,
                    ah.NUTS(0.8, max_depth=5).kernel,
                    ah.make_metric("rank_update", 100, device="cuda",
                                   rank=8),
                    theta0, 60, n_adapts=40, adaptor=adaptor,
                    init_mass_matrix="identity", drop_warmup=True,
                    device="cuda")
    assert f.launches - launches == len(calls) > 0
    assert res.thetas.shape == (20, 256, 100)
    assert bool(torch.isfinite(res.thetas).all())
    m = res.final_state.metric
    assert isinstance(m, ah.RankUpdateEuclideanMetric)
    assert m.b.shape == (256, 100, 8)
    assert isinstance(res.final_state.adapt.mm, ah.LowRankCovState)
    assert bool((torch.linalg.eigvalsh(m.m_inv_matrix().double()) > 0).all())


@pytest.mark.gpu
def test_nc_model_through_k1_matches_its_plain_route_on_card():
    """The non-centred logistic on the card takes K1 (one launch a
    value+grad) at θ' = (log σ, σ·β̃); its value+grad agree with the
    model's analytic route in float32 (the route's plain version) and in
    float64, within 1e-4 of the largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from unittest import mock

    from advancedhmc_torch.models import logistic as lg

    t32 = lg.hierarchical_logistic_nc(n=1000, p=99, device="cuda")
    t64 = lg.hierarchical_logistic_nc(n=1000, p=99, dtype=torch.float64,
                                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c in (4096, 13, 1):
        th = torch.randn(c, 100, generator=gen, device="cuda")
        th[:, 0] = -0.7 + 0.1 * th[:, 0]
        before = k1.logistic_value_grad.launches
        lp, g = t32.logdensity_and_grad(th)
        assert k1.logistic_value_grad.launches == before + 1
        with mock.patch.object(lg, "kernel_route", lambda t: False):
            lp_p, g_p = t32.logdensity_and_grad(th)
        assert k1.logistic_value_grad.launches == before + 1
        lp_r, g_r = t64.logdensity_and_grad(th.double())
        for lpx, gx in ((lp, g), (lp_p, g_p)):
            assert float((gx.double() - g_r).abs().max()) <= \
                1e-4 * float(g_r.abs().max())
            assert float((lpx.double() - lp_r).abs().max()) <= \
                1e-4 * float(lp_r.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("crit,ts", [
    ("ClassicNoUTurn", "multinomial"), ("ClassicNoUTurn", "slice"),
    ("GeneralisedNoUTurn", "slice"),
    ("StrictGeneralisedNoUTurn", "multinomial"),
    ("StrictGeneralisedNoUTurn", "slice")])
def test_criteria_pair_transition_is_bitwise_the_single_one_on_card(crit,
                                                                    ts):
    """The leaf-pair body with each new (criterion, sampler) pair on the
    card: one transition of 256 chains of the 100-D logistic (K1 at every
    leaf) gives the single-leaf body's bits on every stack slot a check
    reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import advancedhmc_torch as ah
    from advancedhmc_torch import nuts

    target = hierarchical_logistic(n=1000, p=99, dtype=torch.float32,
                                   device="cuda")
    h = ah.Hamiltonian(metric=ah.make_metric("diagonal", 100, device="cuda"),
                       target=target)
    traj = ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.01, device="cuda")),
        getattr(ah, crit)(max_depth=6), ts)
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(0).normal(size=(256, 100)),
        dtype=torch.float32, device="cuda")
    z0 = h.init_phasepoint(torch.Generator(device="cuda").manual_seed(1),
                           theta0)
    (z1, s1, d1), (z2, s2, d2) = [
        nuts.nuts_transition(torch.Generator(device="cuda").manual_seed(2),
                             h, traj, z0, return_debug=True, _pair=pair)
        for pair in (False, True)]
    n_slots = d1["ck_r"].shape[1] - 1
    for k in d1:
        a, b = d1[k], d2[k]
        if k.startswith(("ck_", "sck_")):
            a, b = a[:, :n_slots], b[:, :n_slots]
        if isinstance(a, ah.PhasePoint):
            assert torch.equal(a.theta, b.theta) and torch.equal(a.r, b.r), k
        else:
            assert torch.equal(a, b), k
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert torch.equal(z1.theta, z2.theta)
    assert float(s1["tree_depth"].double().mean()) >= 2.0


def _counted(target):
    """`target` with its value+grad calls recorded (chain counts)."""
    import dataclasses

    calls = []
    inner = target.logdensity_and_grad

    def counted(theta):
        calls.append(theta.shape[0])
        return inner(theta)

    return dataclasses.replace(target, logdensity_and_grad=counted), calls


@pytest.mark.gpu
def test_relativistic_fused_draws_run_k1_on_card():
    """The relativistic kinetic energy (m 1, c 2) on phase 18a's path at a
    small size: 512 chains of the 100-D logistic, the cross-chain fused
    warmup (32 iterations in blocks of 8; at 16 the two dual-averaging
    updates leave ε far too large) and 8 fused draws on the leaf-pair
    body: every value+grad call is one K1 launch, the draws are
    finite and the momenta the fused loop drew have the relativistic
    magnitude law's support (finite)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import advancedhmc_torch as ah

    tgt, calls = _counted(hierarchical_logistic(n=1000, p=99,
                                                device="cuda"))
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.05, device="cuda")),
        ah.GeneralisedNoUTurn(max_depth=6)))
    spec = ah.SampleSpec(
        target=tgt, kernel=kernel, adaptor=ah.AdaptorConfig(
            kind="stan", da=ah.DualAveragingConfig(delta=0.55, kappa=0.8),
            init_buffer=10, term_buffer=10, window_size=10),
        cross_chain=True, kinetic=ah.RelativisticKinetic(m=1.0, c=2.0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    theta0 = torch.as_tensor(
        0.1 * np.random.default_rng(0).normal(size=(512, 100)),
        dtype=torch.float32, device="cuda")
    f = k1.logistic_value_grad
    launches = f.launches
    state = ah.init_state(gen, spec, ah.make_metric("diagonal", 100,
                                                    device="cuda"),
                          theta0, device="cuda")
    state, _, _ = ah.fused_warmup_phase_crosschain(gen, spec, state, 32, 8,
                                                   pair=True)
    state, th, st = ah.fused_draw_phase(gen, spec, state, 8, 8, pair=True)
    torch.cuda.synchronize()
    assert f.launches - launches == len(calls) > 0
    assert th.shape == (8, 512, 100) and bool(torch.isfinite(th).all())
    assert bool(torch.isfinite(state.z.r).all())
    assert float(st["acceptance_rate"].mean()) > 0.2


@pytest.mark.gpu
def test_softabs_dH_dtheta_on_logistic_through_k1_on_card():
    """One SoftAbs ∂H∂θ on the 100-D logistic at 8 chains in float32: ℓπ
    and ∇ℓπ from K1 (one launch), G and ∂G by AD of the plain log density,
    against the float64 route (no kernel) on the same (θ, r) within 1e-4
    of its largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from advancedhmc_torch import riemannian as rt

    rng = np.random.default_rng(0)
    theta = rng.normal(size=(8, 100)) * 0.1
    theta[:, 0] = -0.7
    r = rng.normal(size=(8, 100))
    out = {}
    for dtype in (torch.float32, torch.float64):
        tgt, calls = _counted(hierarchical_logistic(n=1000, p=99,
                                                    dtype=dtype,
                                                    device="cuda"))
        h = rt.RiemannianHamiltonian(
            metric=rt.DenseRiemannianMetric.from_hessian(
                tgt, rt.SoftAbsMap(20.0), chunk_size=4), target=tgt)
        f = k1.logistic_value_grad
        launches = f.launches
        lp, g = h.dH_dtheta(torch.as_tensor(theta, dtype=dtype,
                                            device="cuda"),
                            torch.as_tensor(r, dtype=dtype, device="cuda"))
        torch.cuda.synchronize()
        assert len(calls) == 1
        assert f.launches - launches == (1 if dtype == torch.float32 else 0)
        out[dtype] = (lp.double(), g.double())
    lp32, g32 = out[torch.float32]
    lp64, g64 = out[torch.float64]
    assert bool(torch.isfinite(g32).all())
    assert float((g32 - g64).abs().max()) <= 1e-4 * float(g64.abs().max())
    assert float((lp32 - lp64).abs().max()) <= 1e-4 * float(
        lp64.abs().max())


def _mesh_card_run(mesh):
    """A short cross-chain run on the card (4-D standard Gaussian, float64,
    16 chains, the fused warmup with fan-out and the fused draws): no K1,
    so a sharded run can be bitwise the unsharded one."""
    import advancedhmc_torch as ah

    lf = ah.Leapfrog(step_size=torch.tensor(0.4, dtype=torch.float64,
                                            device="cuda"))
    res = ah.sample(
        torch.Generator(device="cuda").manual_seed(3), ah.std_gaussian(4),
        ah.HMCKernel(ah.Trajectory(lf, ah.GeneralisedNoUTurn(max_depth=6))),
        ah.make_metric("diagonal", 4, torch.float64),
        torch.zeros(16, 4, dtype=torch.float64, device="cuda"), 40,
        n_adapts=20, adaptor=ah.AdaptorConfig(kind="stan"), init_eps=0.4,
        cross_chain=True, drop_warmup=True, fuse_warmup=True,
        fuse_warmup_block=4, warmup_chains=8, fanout_decorrelate=4,
        fuse_draws=10, mesh=mesh)
    return {"thetas": res.thetas.cpu().numpy(),
            "eps": res.final_state.adapt.da.eps.cpu().numpy(),
            "m_inv": res.final_state.metric.m_inv.cpu().numpy()}


@pytest.mark.gpu
def test_two_ranks_share_the_card_under_gloo(tmp_path):
    """Two processes on the one card, a gloo group (its collectives copy
    the CUDA tensors through host memory), reproduce the run of one
    process without a mesh bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "mesh", str(r), "2",
         str(tmp_path / "store"), str(tmp_path / f"r{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    ref = _mesh_card_run(None)
    for p in procs:
        log = p.communicate(timeout=300)[0].decode()
        assert p.returncode == 0, log[-3000:]
    for r in (0, 1):
        got = dict(np.load(tmp_path / f"r{r}.npz"))
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.gpu
def test_aot_cache_hit_in_a_fresh_process_starts_no_nvcc(tmp_path):
    """`aot_program` on a program through K1: the first lookup traces and
    its call writes a manifest naming K1's library; a new process, where
    starting nvcc would raise, finds it ("cache"), loads the library and
    computes the same bits. (`_build`'s cache by source hash alone keeps
    nvcc from starting there; the manifest adds the label.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    import subprocess
    import sys
    from pathlib import Path

    call, src = _aot_program(tmp_path)
    assert src == "trace"
    lp, g = call(_aot_theta())
    manifest = next(tmp_path.glob("*.json")).read_text()
    assert "fused_logistic" in manifest
    np.savez(tmp_path / "ref.npz", lp=lp.cpu().numpy(), g=g.cpu().numpy())
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, __file__, "aot", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.split()[-1] == "cache"


def _aot_theta():
    gen = torch.Generator(device="cuda").manual_seed(0)
    return 0.3 * torch.randn(64, 100, generator=gen, device="cuda")


def _aot_program(cache):
    from advancedhmc_torch import aot_program

    target = hierarchical_logistic(n=1000, p=99, device="cuda")
    return aot_program(target.logdensity_and_grad, (_aot_theta(),),
                       program_id="k1_value_grad", cache_dir=cache)


def _aot_child(cache):
    """The fresh process of the aot test: nvcc must not start."""
    from pathlib import Path

    from advancedhmc_torch.ops import _build

    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc started")

    _build.subprocess.Popen = no_nvcc
    call, src = _aot_program(cache)
    lp, g = call(_aot_theta())
    ref = np.load(Path(cache) / "ref.npz")
    np.testing.assert_array_equal(lp.cpu().numpy(), ref["lp"])
    np.testing.assert_array_equal(g.cpu().numpy(), ref["g"])
    print(src)


if __name__ == "__main__":
    import sys

    if sys.argv[1] == "aot":
        _aot_child(sys.argv[2])
    else:
        import advancedhmc_torch as ah

        rank, world, store, out = sys.argv[2:6]
        ah.parallel.distributed_init(backend="gloo",
                                     init_method=f"file://{store}",
                                     world_size=int(world), rank=int(rank))
        np.savez(out, **_mesh_card_run(ah.parallel.mesh_of_all_devices()))

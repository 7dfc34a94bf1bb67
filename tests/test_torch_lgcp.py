"""The log-Gaussian Cox process (`advancedhmc_torch.log_gaussian_cox`) and
K1's Poisson-log link, against the benchmark's plain float64 reference of
the model (`hmcbench/reference/log_gaussian_cox.py`, which imports nothing
of the port), on the CPU at small grids; the card tests (`-m gpu`) hold
K1's Poisson link to float64 at the benchmark cell's shapes. The module
imports no JAX, so that on the card it runs without the JAX package:

    python -m pytest tests/test_torch_lgcp.py -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import math

import numpy as np
import pytest
import torch

import advancedhmc_torch as ah
from advancedhmc_torch.models import lgcp
from advancedhmc_torch.models import logistic as lg
from advancedhmc_torch.ops import fused_logistic as k1
from hmcbench.reference.log_gaussian_cox import Reference, synthetic_data

SIDE = 8
# float32 route against float64: lp to 1e-5 of 1 + |ℓ|, ∇ to 1e-5 of |∇|
# (a sound float32 evaluation reads ~5e-7 at side 8; L₀ rounded to
# bfloat16 ~2e-3)
F32_TOL = 1e-5


def _cfg(side, seed=0):
    return {"n_rows": side * side, "n_features": side * side,
            "data_seed": seed}


def _theta(side, chains=33, seed=1, dtype=torch.float64):
    """Seeded θ = (log σ, z) with log σ uniform in [−1, 1], z ~ N(0, I)."""
    rng = np.random.default_rng(seed)
    th = np.concatenate([rng.uniform(-1.0, 1.0, (chains, 1)),
                         rng.normal(size=(chains, side * side))], 1)
    return torch.as_tensor(th, dtype=dtype)


def _gaps(lp, g, lp_r, g_r):
    """(max |ℓ − ℓ_ref| / (1 + |ℓ_ref|), max ‖∇ − ∇_ref‖ / ‖∇_ref‖)."""
    lp, g = lp.double(), g.double()
    return (float(((lp - lp_r).abs() / (1.0 + lp_r.abs())).max()),
            float((torch.linalg.vector_norm(g - g_r, dim=1)
                   / torch.linalg.vector_norm(g_r, dim=1)).max()))


def test_generator_is_the_references():
    """The model's data (L₀ and the counts) are the reference's own copy's,
    bit for bit, at two grids and two seeds."""
    for side, seed in ((4, 0), (8, 0), (8, 3)):
        l0, y = lgcp.lgcp_data(side, seed, "cpu")
        l0_r, y_r = synthetic_data(side, seed, "cpu")
        assert torch.equal(l0, l0_r)
        assert np.array_equal(y, y_r)
        assert y.sum() > 0 and bool((y == np.round(y)).all())


def test_float64_route_matches_the_reference():
    """Side 8 (dim 65), float64: value and gradient to 1e-10 relative."""
    target = ah.log_gaussian_cox(side=SIDE, dtype=torch.float64,
                                 device="cpu")
    assert target.dim == SIDE * SIDE + 1
    theta = _theta(SIDE)
    lp, g = target.logdensity_and_grad(theta)
    lp_r, g_r = Reference(_cfg(SIDE), "cpu", block=7).value_and_grad(theta)
    np.testing.assert_allclose(lp.numpy(), lp_r.numpy(), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), g_r.numpy(), rtol=1e-10,
                               atol=1e-10 * float(g_r.abs().max()))
    # the value is the log density's, whose gradient autograd takes
    with torch.enable_grad():
        t = theta.clone().requires_grad_(True)
        (g_auto,) = torch.autograd.grad(target.logdensity(t).sum(), t)
    np.testing.assert_allclose(g_auto.numpy(), g_r.numpy(), rtol=1e-10,
                               atol=1e-10 * float(g_r.abs().max()))


@pytest.mark.parametrize("x_dtype,passes", [(None, True),
                                            ("bfloat16", False)])
def test_float32_route_matches_the_reference(x_dtype, passes):
    """Side 8, float32 θ and factor: within F32_TOL of the float64
    reference; with L₀ rounded to bfloat16 (the control) outside it."""
    target = ah.log_gaussian_cox(side=SIDE, x_dtype=x_dtype, device="cpu")
    theta = _theta(SIDE)
    lp, g = target.logdensity_and_grad(theta.float())
    assert lp.dtype == g.dtype == torch.float32
    lp_r, g_r = Reference(_cfg(SIDE), "cpu").value_and_grad(
        theta.float().double())
    gaps = _gaps(lp, g, lp_r, g_r)
    assert (max(gaps) <= F32_TOL) == passes, gaps


def test_log_sigma_derivative_is_the_finite_difference():
    """∂ℓ/∂log σ (the non-centred chain rule's −log σ + rᵀη) against a
    central difference of the float64 value."""
    target = ah.log_gaussian_cox(side=SIDE, dtype=torch.float64,
                                 device="cpu")
    theta = _theta(SIDE, chains=5, seed=2)
    g = target.logdensity_and_grad(theta)[1][:, 0]
    h = 1e-6
    up, down = theta.clone(), theta.clone()
    up[:, 0] += h
    down[:, 0] -= h
    fd = (target.logdensity(up) - target.logdensity(down)) / (2 * h)
    np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=1e-7, atol=1e-6)


def test_k1_route_on_the_cpu_is_the_analytic_route(monkeypatch):
    """The card's route (K1 at θ' = (log σ, σ·z) with the Poisson link, then
    the non-centred chain rule), forced on the CPU where K1's wrapper runs
    its plain version, against the analytic route in float64."""
    target = ah.log_gaussian_cox(side=SIDE, dtype=torch.float64,
                                 device="cpu")
    theta = _theta(SIDE, seed=4)
    lp_a, g_a = target.logdensity_and_grad(theta)
    monkeypatch.setattr(lg, "kernel_route", lambda t: True)
    lp_k, g_k = target.logdensity_and_grad(theta)
    np.testing.assert_allclose(lp_k.numpy(), lp_a.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_k.numpy(), g_a.numpy(), rtol=1e-10,
                               atol=1e-12 * float(g_a.abs().max()))


def test_plain_poisson_link_is_the_references_likelihood():
    """K1's plain version with the Poisson link at θ' = (log σ, σ·z) over
    L₀ is the reference's likelihood: ℓ less the prior's terms, and g_β =
    (∇z + z)/σ; its column 0 is 0. In MODE_F32 `rounding_reference` is
    the same float64 function with no allowance."""
    theta = _theta(SIDE, seed=5)
    l0, y = synthetic_data(SIDE, 0, "cpu")
    y = torch.as_tensor(y)
    c = lgcp.MU - math.log(SIDE * SIDE)
    ls, z = theta[:, :1], theta[:, 1:]
    s = torch.exp(ls)
    th1 = torch.cat([ls, s * z], 1)
    lp, g = k1.plain_logistic_value_grad(th1, l0, y, link="poisson",
                                         offset=c)
    lp_r, g_r = Reference(_cfg(SIDE), "cpu").value_and_grad(theta)
    prior = -0.5 * ls[:, 0] ** 2 - 0.5 * torch.sum(z * z, -1)
    np.testing.assert_allclose(lp.numpy(), (lp_r - prior).numpy(),
                               rtol=1e-12)
    assert bool((g[:, 0] == 0).all())
    np.testing.assert_allclose(g[:, 1:].numpy(),
                               ((g_r[:, 1:] + z) / s).numpy(), rtol=1e-9,
                               atol=1e-12)
    lp_x, g_x, allow, near = k1.rounding_reference(
        th1, l0, y, k1.MODE_F32, link="poisson", offset=c)
    assert torch.equal(lp_x, lp) and torch.equal(g_x, g)
    assert near == 0 and not bool(allow.any())
    # the bfloat16 mode's float64 function rounds θ', L₀ and the residual
    lp_b, g_b, allow_b, _ = k1.rounding_reference(
        th1, l0, y, k1.MODE_BF16, link="poisson", offset=c)
    lp_p, g_p = k1.plain_logistic_value_grad(th1, l0, y, k1.MODE_BF16,
                                             link="poisson", offset=c)
    assert torch.equal(lp_b, lp_p) and torch.equal(g_b, g_p)
    assert bool((allow_b >= 0).all()) and not torch.equal(g_b, g)


def test_links_and_modes_k1_refuses():
    """An unknown link, and the Poisson link in a mode that has no
    instances of it, are refused before any kernel is asked."""
    x = torch.zeros(3, 2)
    y = torch.zeros(3)
    theta = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="unknown link"):
        k1.logistic_value_grad(theta, x, y, link="probit")
    for mode in (k1.MODE_RESID_BF16, k1.MODE_F16, k1.MODE_RESID_F16):
        with pytest.raises(ValueError, match="no poisson link"):
            k1.fused_logistic_value_grad(x, y, mode, link="poisson")
    with pytest.raises(ValueError, match="no poisson link"):
        ah.log_gaussian_cox(side=2, x_dtype="float16", device="cpu")


def test_nuts_sample_runs_at_side_4():
    """`sample()`'s NUTS path takes the model as any `LogDensityTarget`:
    a short run at side 4 (dim 17) gives finite draws."""
    target = ah.log_gaussian_cox(side=4, device="cpu")
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.1)),
        ah.GeneralisedNoUTurn(max_depth=5)))
    metric = ah.make_metric("diagonal", target.dim, device="cpu")
    res = ah.sample(torch.Generator().manual_seed(0), target, kernel, metric,
                    (0.1 * np.random.default_rng(0).normal(
                        size=(4, target.dim))).astype(np.float32), 24,
                    n_adapts=12,
                    adaptor=ah.AdaptorConfig(kind="stan"), device="cpu")
    draws = res.thetas
    assert draws.shape[1:] == (4, target.dim) and draws.shape[0] > 0
    assert bool(torch.isfinite(draws).all())
    assert bool((draws[-1] != draws[0]).any())


# ------------------------------------------------------------ on the card
# (C, side): the cell's chains and the step-size search's one chain over
# the 64 × 64 grid (K1 wide), and a grid of 81 cells (narrow, p = 81)
POISSON_SHAPES = [(2048, 64), (1, 64), (1024, 9), (13, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,side", POISSON_SHAPES)
@pytest.mark.parametrize("mode", [k1.MODE_F32, k1.MODE_BF16])
def test_k1_poisson_link_matches_float64_on_card(c, side, mode):
    """K1 with the Poisson link at θ' = (log σ, σ·z) over the grid's L₀
    against the mode's float64 function (`rounding_reference` with the
    link): 1e-4 of the largest magnitude (float32 sums in other orders),
    plus in bfloat16 the residual roundings that float32 logits can flip.
    Two calls give the same bits and launch one kernel (p ≤ 128) or two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    l0, y_np = lgcp.lgcp_data(side, 0, "cuda")
    od = k1._ROUNDING[mode][0]
    x = (l0 if od is None else l0.to(od)).float().contiguous()
    del l0
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    offset = lgcp.MU - math.log(side * side)
    theta = _theta(side, chains=c, seed=c + side).to("cuda")
    theta = torch.cat([theta[:, :1], torch.exp(theta[:, :1])
                       * theta[:, 1:]], 1).float()
    f = k1.fused_logistic_value_grad(x, y, mode, link="poisson",
                                     offset=offset)
    before = k1.logistic_value_grad.launches
    lp, g = f(theta)
    assert k1.logistic_value_grad.launches - before == (
        1 if side * side <= k1.NARROW_MAX_P else 2)
    lp2, g2 = f(theta)
    lp_r, g_r, allow, _ = k1.rounding_reference(
        theta, x, y, mode, link="poisson", offset=offset)
    torch.cuda.synchronize()
    assert torch.equal(lp, lp2) and torch.equal(g, g2)
    assert bool((g[:, 0] == 0).all())
    tol_g = 1e-4 * float(g_r.abs().max())
    tol_lp = 1e-4 * max(1.0, float(lp_r.abs().max()))
    assert bool(((g.double() - g_r).abs() <= tol_g + allow).all())
    assert float((lp.double() - lp_r).abs().max()) <= tol_lp


@pytest.mark.gpu
def test_model_is_one_k1_call_with_the_poisson_link_on_card():
    """The model at side 64 on the card: a float32 value+grad is one K1
    call (two launches of the wide path) noted `link` "poisson" on its
    `ahmc.k1` span, within the cell's gates of the float64 reference; the
    bfloat16 control is farther from it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from advancedhmc_torch import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    side = 64
    ref = Reference(_cfg(side), "cuda")
    theta = _theta(side, chains=2048, seed=7).to("cuda")
    theta[:, 0] = 0.3 + 0.1 * theta[:, 0]
    theta = theta.float()
    lp_r, g_r = ref.value_and_grad(theta)
    gaps = {}
    for x_dtype in (None, "bfloat16"):
        target = ah.log_gaussian_cox(side=side, x_dtype=x_dtype)
        target.logdensity_and_grad(theta)         # lays out the design
        calls = k1.logistic_value_grad.calls
        launches = k1.logistic_value_grad.launches
        profiling.enable_spans(True)
        try:
            lp, g = target.logdensity_and_grad(theta)
            spans = profiling.spans()
        finally:
            profiling.enable_spans(False)
        assert k1.logistic_value_grad.calls - calls == 1
        assert k1.logistic_value_grad.launches - launches == 2
        k1_spans = [r["attrs"] for r in spans if r["name"] == "ahmc.k1"]
        assert k1_spans == [{"chains": 2048, "prior": 0, "link": "poisson"}]
        gaps[x_dtype] = _gaps(lp, g, lp_r, g_r)
        del target
    assert max(gaps[None]) <= F32_TOL, gaps
    assert gaps["bfloat16"][1] > 10 * gaps[None][1], gaps

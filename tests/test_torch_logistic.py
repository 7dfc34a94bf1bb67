"""The port's hierarchical logistic and kernel K1 against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function and
its PyTorch counterpart. The JAX side runs in float64 (conftest enables x64)
except where the Pallas kernel is run, in interpret mode, as its own test
does; the PyTorch side runs on the CPU, where K1's wrapper takes its plain
version.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advancedhmc_tpu.models.logistic import _synthetic_data as jax_data
from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)
from advancedhmc_tpu.ops.fused_logistic import (
    fused_logistic_value_grad as jax_fused,
)

import advancedhmc_torch as ah
from advancedhmc_torch import convert
from advancedhmc_torch.models.logistic import _synthetic_data
from advancedhmc_torch.ops import fused_logistic as k1

torch.set_num_threads(2)

N, P = 300, 19


def _thetas(c, seed=0, scale=0.3):
    return scale * np.random.default_rng(seed).normal(size=(c, P + 1))


@pytest.mark.parametrize("n,p,seed", [(300, 19, 0), (1000, 99, 0),
                                      (50, 3, 7)])
def test_synthetic_data_bit_equal(n, p, seed):
    x_j, y_j = jax_data(n, p, seed)
    x_t, y_t = _synthetic_data(n, p, seed)
    assert x_t.dtype == x_j.dtype and y_t.dtype == y_j.dtype
    assert np.array_equal(x_t, x_j) and np.array_equal(y_t, y_j)
    # the data carried across as tensors
    xc, yc = convert.model_data(jnp.asarray(x_j), jnp.asarray(y_j), "cpu")
    assert np.array_equal(xc.numpy(), x_t) and np.array_equal(yc.numpy(), y_t)


def test_value_and_grad_match_jax_analytic():
    th = _thetas(40)
    tj = jax_logistic(n=N, p=P, dtype=jnp.float64)
    lp_j, g_j = jax.vmap(tj.logdensity_and_grad)(jnp.asarray(th))
    tt = ah.hierarchical_logistic(n=N, p=P, dtype=torch.float64,
                                  device="cpu")
    lp_t, g_t = tt.logdensity_and_grad(torch.as_tensor(th))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-10)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-10)
    # the value-only function agrees with the value of the pair
    np.testing.assert_allclose(tt.logdensity(torch.as_tensor(th)).numpy(),
                               np.asarray(lp_j), rtol=1e-10)


def test_plain_k1_matches_pallas_interpret():
    """The plain version of K1 against the Pallas kernel in interpret mode,
    at the JAX test's bf16-input tolerance (tests/test_pallas_ops.py), with
    the padding case of a chain count that is not a multiple of the
    block."""
    x, y = _synthetic_data(N, P)
    th = _thetas(40).astype(np.float32)
    apply = jax_fused(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                      block_chains=16, interpret=True)
    xt = torch.as_tensor(x, dtype=torch.float32)
    yt = torch.as_tensor(y, dtype=torch.float32)
    for c in (40, 13):
        lp_j, g_j = apply(jnp.asarray(th[:c]))
        lp_t, g_t = k1.logistic_value_grad(torch.as_tensor(th[:c]), xt, yt)
        assert lp_t.shape == (c,) and g_t.shape == (c, P + 1)
        np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=3e-3)
        scale = float(np.abs(np.asarray(g_j)).max())
        assert float(np.abs(g_t.numpy() - np.asarray(g_j)).max()) \
            < 0.01 * scale
        assert np.all(g_t[:, 0].numpy() == 0.0)


def test_cpu_tensors_take_the_plain_version():
    before = k1.logistic_value_grad.launches
    x, y = _synthetic_data(N, P)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    th = torch.as_tensor(_thetas(7))
    lp, g = k1.logistic_value_grad(th, xt, yt)
    lp_p, g_p = k1.plain_logistic_value_grad(th, xt, yt)
    assert torch.equal(lp, lp_p) and torch.equal(g, g_p)
    tgt = ah.hierarchical_logistic(n=N, p=P, dtype=torch.float64,
                                   device="cpu")
    tgt.logdensity_and_grad(th)
    assert k1.logistic_value_grad.launches == before == 0


def test_model_dispatch_predicate_matches_the_kernel_source():
    """The model sends every float32 θ on CUDA to K1, as the JAX model sends
    every float32 θ to its Pallas kernel; float64 and the CPU take the
    model's analytic path. K1 has no width limit, read from its source: the
    narrow instances hold p ≤ 8 · kMaxKSteps = 128, and every wider p goes
    to the wide kernel, with no limit of its own and no `max_dim` entry
    point. So a θ wider than the narrow instances reaches the kernel's input
    checks (here on meta tensors, which no kernel could take, refused there
    with a ValueError) and no NotImplementedError about width."""
    src = (Path(k1.__file__).resolve().parent.parent / "csrc" /
           "fused_logistic.cu").read_text()
    k_max = int(re.search(r"constexpr int kMaxKSteps = (\d+);", src).group(1))
    assert 8 * k_max == 128
    assert "max_dim" not in src
    entry = src[src.index("int fused_logistic_value_grad_f32("):]
    entry = entry[:entry.index("\n}\n")]
    assert re.search(r"inst \? inst->launch\(.*?\)\s*: launch_wide\(", entry,
                     re.S)
    assert "cudaErrorInvalidValue" not in entry

    def theta(cuda, dtype, dim):
        return SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=(64, dim))

    f32, f64 = torch.float32, torch.float64
    for dim in (100, 8 * k_max + 1, 8 * k_max + 2, 1000, 2048):
        assert k1.kernel_route(theta(True, f32, dim))
    assert not k1.kernel_route(theta(True, f64, 100))
    assert not k1.kernel_route(theta(False, f32, 100))
    assert not hasattr(k1, "MAX_DIM")
    for wide in (8 * k_max + 2, 1000, 2048):
        with pytest.raises(ValueError, match="must be on"):
            k1.logistic_value_grad(torch.empty(4, wide, device="meta"),
                                   torch.empty(N, wide - 1, device="meta"),
                                   torch.empty(N, device="meta"))


@pytest.mark.parametrize("p,dtype", [(200, torch.float64),
                                     (200, torch.float32)])
def test_model_wider_than_k1_matches_jax_analytic(p, dtype):
    """p = 200, beyond K1's width: the model's analytic value+grad against
    the JAX model's in float64 (float32 held to its own rounding)."""
    th = 0.1 * np.random.default_rng(3).normal(size=(6, p + 1))
    tj = jax_logistic(n=N, p=p, dtype=jnp.float64)
    lp_j, g_j = jax.vmap(tj.logdensity_and_grad)(jnp.asarray(th))
    tt = ah.hierarchical_logistic(n=N, p=p, dtype=dtype, device="cpu")
    lp_t, g_t = tt.logdensity_and_grad(torch.as_tensor(th, dtype=dtype))
    assert lp_t.dtype == g_t.dtype == dtype and g_t.shape == (6, p + 1)
    rtol = 1e-10 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(lp_t.double().numpy(), np.asarray(lp_j),
                               rtol=rtol)
    scale = float(np.abs(np.asarray(g_j)).max())
    assert float(np.abs(g_t.double().numpy() - np.asarray(g_j)).max()) \
        <= rtol * scale


def test_non_cpu_tensor_is_never_run_plain():
    """A tensor that is not on the CPU goes to the kernel's input checks,
    never to the plain version (here a meta tensor, refused there)."""
    th = torch.empty(4, P + 1, device="meta")
    x = torch.empty(N, P, device="meta")
    y = torch.empty(N, device="meta")
    with pytest.raises(ValueError, match="must be on"):
        k1.logistic_value_grad(th, x, y)


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ah.hierarchical_logistic(n=N, p=P)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ah.make_metric("diagonal", P + 1)
    tgt = ah.hierarchical_logistic(n=N, p=P, device="cpu")
    kernel = ah.HMCKernel(ah.Trajectory(ah.Leapfrog(torch.tensor(0.1)),
                                        ah.GeneralisedNoUTurn(max_depth=3)))
    metric = ah.make_metric("diagonal", P + 1, device="cpu")
    spec = ah.SampleSpec(target=tgt, kernel=kernel,
                         adaptor=ah.AdaptorConfig(), cross_chain=True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ah.init_state(gen, spec, metric, np.zeros(P + 1, np.float32),
                      init_eps=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ah.sample(gen, tgt, kernel, metric,
                  np.zeros((4, P + 1), np.float32), 16,
                  n_adapts=8, adaptor=ah.AdaptorConfig(), cross_chain=True,
                  fuse_draws=4, fuse_warmup=True, fuse_warmup_block=4)
    # with device="cpu" the same calls run
    state = ah.init_state(gen, spec, metric, np.zeros(P + 1, np.float32),
                          init_eps=0.1, n_chains=3, device="cpu")
    assert state.z.theta.shape == (3, P + 1)



# --- the prior folded into K1 (`prior=True`) ------------------------------
@pytest.mark.parametrize("mode", [k1.MODE_F32, k1.MODE_BF16,
                                  k1.MODE_RESID_BF16, k1.MODE_F16,
                                  k1.MODE_RESID_F16])
@pytest.mark.parametrize("p", [24, 99, 200])
def test_plain_with_the_prior_is_the_prior_plus_the_likelihood(p, mode):
    """In float64, K1's plain version with the prior equals the model's
    `_prior` (θ unrounded, p = dim − 1) plus the likelihood alone to 1e-12
    of the largest magnitude, in every mode; without it component 0 of
    the gradient stays exactly 0."""
    from advancedhmc_torch.models.logistic import _prior

    x, y = (torch.as_tensor(a) for a in _synthetic_data(N, p))
    th = torch.as_tensor(0.1 * np.random.default_rng(p).normal(
        size=(9, p + 1)))
    th[:, 0] = -0.7 + th[:, 0]
    lp_l, g_l = k1.plain_logistic_value_grad(th, x, y, mode)
    assert bool((g_l[:, 0] == 0).all())
    lp_pri, g_pri = _prior(th, p)
    lp, g = k1.plain_logistic_value_grad(th, x, y, mode, prior=True)
    scale = float((lp_l + lp_pri).abs().max())
    assert float((lp - (lp_l + lp_pri)).abs().max()) <= 1e-12 * scale
    gscale = float((g_l + g_pri).abs().max())
    assert float((g - (g_l + g_pri)).abs().max()) <= 1e-12 * gscale
    # the wrapper's CPU route is the plain version, option included
    lp_w, g_w = k1.logistic_value_grad(th, x, y, mode=mode, prior=True)
    assert torch.equal(lp_w, lp) and torch.equal(g_w, g)


@pytest.mark.parametrize("p", [19, 200])
def test_centred_k1_route_is_the_analytic_route(monkeypatch, p):
    """The centred model's K1 route (one call with the prior folded in)
    against its analytic route and the JAX model, in float64: on a CPU
    tensor K1's wrapper runs its plain version, so forcing the route runs
    the route here. The analytic route keeps its `ahmc.target.prior` span;
    the K1 route opens none."""
    import advancedhmc_torch.models.logistic as lg
    from advancedhmc_torch import profiling

    th = 0.1 * np.random.default_rng(p + 5).normal(size=(11, p + 1))
    th[:, 0] -= 0.7
    tj = jax_logistic(n=N, p=p, dtype=jnp.float64)
    lp_j, g_j = jax.vmap(tj.logdensity_and_grad)(jnp.asarray(th))
    tgt = ah.hierarchical_logistic(n=N, p=p, dtype=torch.float64,
                                   device="cpu")
    th = torch.as_tensor(th)
    profiling.enable_spans(True)
    try:
        lp_a, g_a = tgt.logdensity_and_grad(th)
        analytic = [r["name"] for r in profiling.spans()]
        monkeypatch.setattr(lg, "kernel_route", lambda theta: True)
        lp_k, g_k = tgt.logdensity_and_grad(th)
        routed = [r["name"] for r in profiling.spans()]
    finally:
        profiling.enable_spans(False)
    assert analytic == ["ahmc.target.value_grad", "ahmc.target.prior"]
    assert routed == ["ahmc.target.value_grad"]
    np.testing.assert_allclose(lp_a.numpy(), np.asarray(lp_j), rtol=1e-10)
    np.testing.assert_allclose(g_a.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(lp_k.numpy(), lp_a.numpy(), rtol=1e-12)
    scale = float(g_a.abs().max())
    assert float((g_k - g_a).abs().max()) <= 1e-12 * scale

"""The port's hierarchical logistic and kernel K1 against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function and
its PyTorch counterpart. The JAX side runs in float64 (conftest enables x64)
except where the Pallas kernel is run, in interpret mode, as its own test
does; the PyTorch side runs on the CPU, where K1's wrapper takes its plain
version.
"""

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


"""The port's ESS, bulk ESS and R̂ against the JAX package on identical draws
(float64 on both sides, 1e-10)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from advancedhmc_tpu import diagnostics as dj

from advancedhmc_torch import diagnostics as dt

torch.set_num_threads(2)


def _ar1(n, m, dim, phi, seed):
    """AR(1) chains with per-chain offsets (so R̂ has something to see)."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, m, dim))
    x[0] = rng.normal(size=(m, dim))
    for t in range(1, n):
        x[t] = phi * x[t - 1] + np.sqrt(1 - phi ** 2) * rng.normal(
            size=(m, dim))
    return x + 0.1 * rng.normal(size=(1, m, dim))


SHAPES = [(200, 4, 3, 0.5, 0), (101, 8, 2, 0.9, 1), (64, 1, 5, -0.3, 2),
          (33, 16, 4, 0.0, 3)]


@pytest.mark.parametrize("n,m,dim,phi,seed", SHAPES)
def test_ess_rhat_match(n, m, dim, phi, seed):
    x = _ar1(n, m, dim, phi, seed)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    for fn in ("effective_sample_size", "ess_bulk", "rhat", "split_rhat"):
        np.testing.assert_allclose(getattr(dt, fn)(xt).numpy(),
                                   np.asarray(getattr(dj, fn)(xj)),
                                   rtol=1e-10, err_msg=fn)


def test_two_dim_input_is_one_chain():
    x = _ar1(80, 1, 3, 0.6, 4)[:, 0]
    np.testing.assert_allclose(
        dt.effective_sample_size(torch.as_tensor(x)).numpy(),
        np.asarray(dj.effective_sample_size(jnp.asarray(x))), rtol=1e-10)
    np.testing.assert_allclose(dt.rhat(torch.as_tensor(x)).numpy(),
                               np.asarray(dj.rhat(jnp.asarray(x))),
                               rtol=1e-10)


def test_float32_draws_are_summarised_in_float64():
    x = _ar1(50, 4, 2, 0.3, 5).astype(np.float32)
    out = dt.effective_sample_size(torch.as_tensor(x))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(dj.effective_sample_size(jnp.asarray(x, jnp.float64))),
        rtol=1e-10)

"""The port's fused Gaussian leapfrog (K3) against the JAX package.

The plain PyTorch version of kernel K3 is held against the Pallas kernel in
interpret mode at tests/test_pallas_ops.py's configuration and tolerance
(2e-5), on the same numpy inputs, float32 on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from advancedhmc_tpu.ops.fused_leapfrog import (
    fused_gaussian_leapfrog as jax_fused,
    reference_gaussian_leapfrog as jax_reference,
)

from advancedhmc_torch.ops import fused_leapfrog as k3

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(c, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(c, d)).astype(np.float32),
            rng.normal(size=(c, d)).astype(np.float32),
            np.linspace(0.5, 2.0, d).astype(np.float32),
            np.linspace(0.8, 1.2, d).astype(np.float32))


@pytest.mark.parametrize("c,d,eps,n_steps", [(20, 5, 0.12, 17),
                                             (13, 130, 0.05, 9)])
def test_plain_k3_matches_pallas_interpret(c, d, eps, n_steps):
    """Ragged chain counts (not a multiple of the block of 8) and a width
    past one 128-lane tile."""
    th, r, prec, m_inv = _inputs(c, d)
    out_j = jax_fused(jnp.asarray(th), jnp.asarray(r), jnp.asarray(prec),
                      jnp.asarray(m_inv), eps, n_steps, block_chains=8,
                      interpret=True)
    out_t = k3.fused_gaussian_leapfrog(
        torch.as_tensor(th), torch.as_tensor(r), torch.as_tensor(prec),
        torch.as_tensor(m_inv), eps, n_steps)
    for a, b, shape in zip(out_t, out_j, ((c, d), (c, d), (c,), (c,))):
        assert a.shape == shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_plain_k3_matches_jax_reference_scan():
    th, r, prec, m_inv = _inputs(64, 8, seed=1)
    out_j = jax_reference(jnp.asarray(th), jnp.asarray(r), jnp.asarray(prec),
                          jnp.asarray(m_inv), 0.3, 100)
    out_t = k3.reference_gaussian_leapfrog(
        torch.as_tensor(th), torch.as_tensor(r), torch.as_tensor(prec),
        torch.as_tensor(m_inv), 0.3, 100)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_cpu_tensors_take_the_plain_version():
    th, r, prec, m_inv = (torch.as_tensor(a) for a in _inputs(5, 3))
    before = k3.fused_gaussian_leapfrog.launches
    for a, b in zip(k3.fused_gaussian_leapfrog(th, r, prec, m_inv, 0.1, 4),
                    k3.reference_gaussian_leapfrog(th, r, prec, m_inv, 0.1,
                                                   4)):
        assert torch.equal(a, b)
    assert k3.fused_gaussian_leapfrog.launches == before == 0


def test_non_cpu_tensor_is_never_run_plain():
    th = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="must be on"):
        k3.fused_gaussian_leapfrog(th, th, torch.ones(3), torch.ones(3),
                                   0.1, 2)

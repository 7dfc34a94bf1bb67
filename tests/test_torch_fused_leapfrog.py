"""The port's fused Gaussian leapfrog (K3) against the JAX package.

The plain PyTorch version of kernel K3 is held against the Pallas kernel in
interpret mode at tests/test_pallas_ops.py's configuration and tolerance
(2e-5), on the same numpy inputs, float32 on both sides. A float32 mirror of
the CUDA kernel's order of operations (merged kicks, two FMAs a step) is
held to both at the shapes `chip_smoke.py` runs it at, cut in C.
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


# chip_smoke.py's K3_SHAPES (C, D, L, ε), C cut to at most 16 chains
MIRROR_SHAPES = [(16, 8, 100, 0.05), (16, 128, 100, 0.05), (13, 8, 100, 0.05),
                 (20, 5, 17, 0.12), (16, 5, 100, 0.05), (11, 37, 50, 0.05),
                 (3, 5000, 20, 0.05)]


def _fma32(a, b, c):
    """float32 fma(a, b, c): the float32 product is exact in float64, so
    one float64 add and one rounding to float32 (a double rounding that
    differs from the card's FMA only in rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_order(theta, r, prec, m_inv, eps, n_steps):
    """csrc/fused_leapfrog.cu's arithmetic in float32: a = ε·m_inv and
    nb = −ε·prec per element, a half-kick, then L drifts with L − 1 full
    kicks between them, then a half-kick, each an FMA."""
    eps32 = torch.tensor(eps, dtype=torch.float32)
    a, nb = eps32 * m_inv, -(eps32 * prec)
    th, rr = theta, r
    if n_steps > 0:
        rr = _fma32(0.5 * nb, th, rr)
        for s in range(n_steps):
            th = _fma32(a, rr, th)
            rr = _fma32(nb if s < n_steps - 1 else 0.5 * nb, th, rr)
    pot = 0.5 * torch.sum(prec * th * th, -1)
    kin = 0.5 * torch.sum(m_inv * rr * rr, -1)
    return th, rr, pot, kin


@pytest.mark.parametrize("c,d,n_steps,eps", MIRROR_SHAPES)
def test_kernel_order_matches_plain_and_pallas(c, d, n_steps, eps):
    """The merged kicks' rounding stays within chip_smoke.py's K3_TOL of
    the step-by-step order: the port's plain loop and the Pallas kernel."""
    th, r, prec, m_inv = _inputs(c, d, seed=c + d)
    args_t = [torch.as_tensor(v) for v in (th, r, prec, m_inv)]
    out = _kernel_order(*args_t, eps, n_steps)
    plain = k3.reference_gaussian_leapfrog(*args_t, eps, n_steps)
    pallas = jax_fused(*(jnp.asarray(v) for v in (th, r, prec, m_inv)), eps,
                       n_steps, block_chains=8, interpret=True)
    for a, b, p in zip(out, plain, pallas):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(p), **TOL)


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


def _k3_ablation():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "k3_ablation.py"
    spec = importlib.util.spec_from_file_location("k3_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, (path.parent.parent / "advancedhmc_torch" / "csrc" /
                 mod.CU).read_text()


@pytest.mark.parametrize("variant", [
    "unroll8", "unroll32", "warps6", "warps24", "e1", "blocks2", "blocks8",
    "no_energies", "unmerged"])
def test_ablation_edits_apply_at_one_place(variant):
    """scripts/k3_ablation.py makes its variants by editing the kernel's
    text; each edit must still match the source exactly once."""
    mod, src = _k3_ablation()
    for old, new in mod.EDITS[variant]:
        assert src.count(old) == 1, (variant, old)

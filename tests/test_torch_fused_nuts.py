"""The port's NUTS megakernel path (K2) against the JAX package on the CPU.

The splitmix32 counter stream, the block targets and `plain_fused_nuts` —
the plain PyTorch version of kernel K2 — are fed the same numpy inputs as
the JAX functions. The JAX megakernel runs in Pallas interpret mode, as its
own test does, at T ≤ 8 transitions (interpret mode unrolls the output
writes over T, so its cost grows faster than T). Both sides draw the same
counter stream, so the integer outputs must be equal and θ agrees to
float32 rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic_block as jax_block,
)
from advancedhmc_tpu.ops import fused_nuts_kernel as jk

import advancedhmc_torch as ah
from advancedhmc_torch.diagnostics import effective_sample_size
from advancedhmc_torch.models.gaussian import mvn_diag_block, \
    std_gaussian_block
from advancedhmc_torch.models.logistic import _synthetic_data, \
    hierarchical_logistic_block
from advancedhmc_torch import utils as ut
from advancedhmc_torch.ops import counter_rng as rng
from advancedhmc_torch.ops import fused_nuts_kernel as k2

torch.set_num_threads(2)

N, P = 200, 9
DIM = P + 1
THETA_TOL = 1e-5


# ------------------------------------------------------------ counter RNG
@pytest.mark.parametrize("seed,block", [(0, 0), (42, 1), (2_000_000, 3),
                                        (-7, 2)])
def test_counter_stream_matches_jax(seed, block):
    """Bits and uniforms bit-equal, normals and exponentials within 1e-6,
    over counters, salts and shapes; seed 2e6 wraps seed·7919 in int32."""
    base_j = jnp.int32(seed) * jnp.int32(7919) \
        + jnp.int32(block) * jnp.int32(104729)
    assert int(rng.rng_base(seed, block)) == int(base_j) & 0xFFFFFFFF
    for c in (0, 1, 77, 2**31 - 1):
        ctr_j, ctr_t = base_j + jnp.int32(c), rng.rng_base(seed, block) + c
        for shape, salt in (((8, 1), 2), ((4, 128), 5), ((3, 7), 106)):
            bj = np.asarray(jk._bits(ctr_j, shape, salt)).astype(np.int64)
            assert np.array_equal(rng._bits(ctr_t, shape, salt).numpy(), bj)
            uj = np.asarray(jk._uniform(ctr_j, shape, salt))
            assert np.array_equal(rng._uniform(ctr_t, shape, salt).numpy(),
                                  uj)
            for fj, ft in ((jk._normal, rng._normal),
                           (jk._exponential, rng._exponential)):
                np.testing.assert_allclose(
                    ft(ctr_t, shape, salt).numpy(),
                    np.asarray(fj(ctr_j, shape, salt)), rtol=0, atol=1e-6)


def test_trailing_bit_counts_match_jax():
    """The megakernel's `_tz` and `_t_ones` are the port's utils."""
    i = np.concatenate([np.arange(0, 300), [1023, 1024, 2**30,
                                           2**31 - 1]]).astype(np.int32)
    it = torch.as_tensor(i)
    assert np.array_equal(ut.trailing_zeros(it[1:]).numpy(),
                          np.asarray(jk._tz(jnp.asarray(i[1:]))))
    assert np.array_equal(ut.trailing_ones(it).numpy(),
                          np.asarray(jk._t_ones(jnp.asarray(i))))
    assert jk._round_up(100, 128) == rng._round_up(100, 128) == 128


# ---------------------------------------------------------- block targets
def _thetas(c, seed=0, d_pad=128):
    th = np.zeros((c, d_pad))
    th[:, :DIM] = 0.3 * np.random.default_rng(seed).normal(size=(c, DIM))
    return th


def test_logistic_block_matches_jax_float32():
    fn_j, (xt_j, y_j) = jax_block(n=N, p=P, d_pad=128)
    tgt, (xt, y) = hierarchical_logistic_block(n=N, p=P, d_pad=128,
                                               device="cpu")
    assert np.array_equal(xt.numpy(), np.asarray(xt_j))
    assert np.array_equal(y.numpy(), np.asarray(y_j))
    th = _thetas(24).astype(np.float32)
    lp_j, g_j = fn_j(jnp.asarray(th), xt_j, y_j)
    lp_t, g_t = tgt(torch.as_tensor(th), xt, y)
    assert lp_t.shape == (24, 1) and g_t.shape == (24, 128)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-4)
    assert np.all(g_t[:, DIM:].numpy() == 0)


def test_logistic_block_matches_the_model_float64():
    """The block form is the same function of θ as the port's analytic
    `hierarchical_logistic` (float64 data in the block's layout, so the
    tolerance is 1e-10)."""
    tgt, _ = hierarchical_logistic_block(n=N, p=P, d_pad=128, device="cpu")
    model = ah.hierarchical_logistic(n=N, p=P, dtype=torch.float64,
                                     device="cpu")
    x, y = _synthetic_data(N, P)
    xt = torch.zeros(128, N, dtype=torch.float64)
    xt[1:DIM] = torch.as_tensor(x.T)
    th = torch.as_tensor(_thetas(16, seed=1))
    lp_b, g_b = tgt(th, xt, torch.as_tensor(y)[None])
    lp_m, g_m = model.logdensity_and_grad(th[:, :DIM])
    np.testing.assert_allclose(lp_b[:, 0].numpy(), lp_m.numpy(), rtol=1e-10)
    np.testing.assert_allclose(g_b[:, :DIM].numpy(), g_m.numpy(),
                               rtol=1e-10, atol=1e-10)


def test_gaussian_blocks_match_jax_targets():
    """The standard normal of the JAX megakernel's test and the diagonal
    Gaussian of K3 (∇ = −prec ⊙ θ) in block form."""
    th = _thetas(6, seed=2).astype(np.float32)[:, :8]
    th[:, 5:] = 0.0                       # padded dims of a 5-D target
    tgt, (prec,) = std_gaussian_block(5, device="cpu")
    lp, g = tgt(torch.as_tensor(np.pad(th, ((0, 0), (0, 120)))), prec)
    np.testing.assert_array_equal(
        lp[:, 0].numpy(), -0.5 * np.sum(th * th, 1, dtype=np.float32))
    np.testing.assert_array_equal(g[:, :8].numpy(), -th)
    var = np.linspace(0.5, 2.0, 5)
    tgt, (prec,) = mvn_diag_block(var, device="cpu")
    assert prec.shape == (1, 128) and float(prec[0, 5:].abs().sum()) == 0
    lp, g = tgt(torch.as_tensor(th[:, :5]).double(), prec[:, :5].double())
    np.testing.assert_allclose(lp[:, 0].numpy(),
                               -0.5 * np.sum(th[:, :5] ** 2 / var, 1),
                               rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), -th[:, :5] / var, rtol=1e-6)


# ----------------------------------------------------- the megakernel body
def _assert_same_draws(out_t, out_j, what):
    names = ("n_steps", "depth", "diverged")
    for name, a, b in zip(names, out_t[1:], out_j[1:]):
        a, b = a.numpy(), np.asarray(b)
        bad = np.argwhere(a != b)
        assert bad.size == 0, (
            f"{what}: {name} differs at (transition, chain) {bad[:5]} — a "
            f"near-tie decided the other way; port {a[tuple(bad[0])]}, "
            f"JAX {b[tuple(bad[0])]}")
    err = float(np.abs(out_t[0].numpy() - np.asarray(out_j[0])).max())
    assert err <= THETA_TOL, (what, err)


def test_plain_megakernel_matches_pallas_gaussian():
    """tests/test_pallas_ops.py's configuration (8 chains × 5-D standard
    normal, ε 0.5, seed 42, max_depth 6, one block of 8) at T = 8."""
    def vg(th):
        return -0.5 * jnp.sum(th * th, axis=1, keepdims=True), -th

    out_j = jk.fused_nuts_pallas(
        vg, jnp.zeros((8, 5), jnp.float32), jnp.ones(5, jnp.float32), 0.5,
        42, (), dim=5, n_transitions=8, max_depth=6, block_chains=8,
        interpret=True)
    tgt, data = std_gaussian_block(5, device="cpu")
    out_t = k2.plain_fused_nuts(tgt, torch.zeros(8, 5), torch.ones(5), 0.5,
                                42, data, 5, n_transitions=8, max_depth=6,
                                block_chains=8)
    assert out_t[0].shape == (8, 8, 5) and out_t[3].dtype == torch.bool
    _assert_same_draws(out_t, out_j, "gaussian")


def _logistic_start(c):
    th0 = (0.1 * np.random.default_rng(0).normal(size=(c, DIM))).astype(
        np.float32)
    m_inv = (0.05 * np.linspace(0.5, 1.5, DIM)).astype(np.float32)
    return th0, m_inv


def test_plain_megakernel_matches_pallas_logistic():
    """The logistic block (n 200, p 9), 16 chains in two blocks of 8 (so
    the block index enters the stream), T 4, max_depth 6, at an ε where
    tree depths range over 3..6."""
    th0, m_inv = _logistic_start(16)
    fn_j, data_j = jax_block(n=N, p=P, d_pad=128)
    out_j = jk.fused_nuts_pallas(
        fn_j, jnp.asarray(th0), jnp.asarray(m_inv), 0.1, 7, data_j,
        dim=DIM, n_transitions=4, max_depth=6, block_chains=8,
        interpret=True)
    tgt, data = hierarchical_logistic_block(n=N, p=P, d_pad=128,
                                            device="cpu")
    out_t = k2.fused_nuts(tgt, torch.as_tensor(th0), torch.as_tensor(m_inv),
                          0.1, 7, data, DIM, n_transitions=4, max_depth=6,
                          block_chains=8)
    depths = set(out_t[2].flatten().tolist())
    assert len(depths) >= 3, depths
    _assert_same_draws(out_t, out_j, "logistic")


def test_chains_are_independent():
    """A chain's draws depend on its block and row only: the first 9 of 16
    chains give the same outputs alone (ragged last block)."""
    th0, m_inv = _logistic_start(16)
    tgt, data = hierarchical_logistic_block(n=N, p=P, d_pad=128,
                                            device="cpu")
    args = (torch.as_tensor(m_inv), 0.2, 11, data, DIM, 4, 6, 8)
    full = k2.plain_fused_nuts(tgt, torch.as_tensor(th0), *args)
    part = k2.plain_fused_nuts(tgt, torch.as_tensor(th0[:9]), *args)
    for a, b in zip(full, part):
        assert torch.equal(a[:, :9], b)


# ------------------------------------------- wider than the warp tile
# p > 128 pads θ to Dp = 256 (the CUDA kernel's wide instance); p = 129
# leaves one column in the last chunk of 128. 97 rows, 16 chains in two
# blocks of 8, T 4, max_depth 4, at a start, ε and M⁻¹ where trees of
# several depths and no divergence occur.
N_WIDE = 97


def _wide_start(p, c=16):
    th0 = (0.05 * np.random.default_rng(p).normal(size=(c, p + 1))).astype(
        np.float32)
    th0[:, 0] = -1.5
    m_inv = (5e-3 * np.linspace(0.5, 1.5, p + 1)).astype(np.float32)
    return th0, m_inv


@pytest.mark.parametrize("p", [129, 200])
def test_plain_megakernel_matches_pallas_wide_logistic(p):
    th0, m_inv = _wide_start(p)
    fn_j, data_j = jax_block(n=N_WIDE, p=p, d_pad=256)
    out_j = jk.fused_nuts_pallas(
        fn_j, jnp.asarray(th0), jnp.asarray(m_inv), 0.3, 3, data_j,
        dim=p + 1, n_transitions=4, max_depth=4, block_chains=8,
        interpret=True)
    tgt, data = hierarchical_logistic_block(n=N_WIDE, p=p, d_pad=256,
                                            device="cpu")
    out_t = k2.fused_nuts(tgt, torch.as_tensor(th0), torch.as_tensor(m_inv),
                          0.3, 3, data, p + 1, n_transitions=4, max_depth=4,
                          block_chains=8)
    assert out_t[0].shape == (4, 16, p + 1)
    assert len(set(out_t[2].flatten().tolist())) >= 2
    _assert_same_draws(out_t, out_j, f"logistic p={p}")


def test_wide_chains_are_independent():
    """At Dp = 256 too a chain's draws depend on its block and row only:
    the first 9 of 16 chains give the same outputs alone."""
    th0, m_inv = _wide_start(200)
    tgt, data = hierarchical_logistic_block(n=N_WIDE, p=200, d_pad=256,
                                            device="cpu")
    args = (torch.as_tensor(m_inv), 0.3, 11, data, 201, 4, 4, 8)
    full = k2.plain_fused_nuts(tgt, torch.as_tensor(th0), *args)
    part = k2.plain_fused_nuts(tgt, torch.as_tensor(th0[:9]), *args)
    for a, b in zip(full, part):
        assert torch.equal(a[:, :9], b)


# Two independent runs: per-dimension means (sds) agree within this many
# combined Monte Carlo standard errors. The sd's error comes from the ESS of
# the squared deviations (sd/sqrt(2 ESS) assumes a Gaussian and too high an
# ESS, and under it two runs of the same sampler differ by up to 7 errors).
K_MCSE = 5.0


def _mean_sd_mcse(th):
    mean, sd = th.mean((0, 1)), th.std((0, 1))
    sq = (th - mean) ** 2
    ess = effective_sample_size(torch.as_tensor(th)).numpy()
    ess_sq = effective_sample_size(torch.as_tensor(sq)).numpy()
    return mean, sd, sd / np.sqrt(ess), \
        sq.std((0, 1)) / np.sqrt(ess_sq) / (2 * sd)


def test_plain_megakernel_matches_nuts_transitions_fused_in_law():
    """The megakernel and the port's fused NUTS loop sample the same
    posterior at the same ε and M⁻¹ (128 chains × 40 transitions, the first
    16 discarded), with the same mean tree depth within 0.3."""
    c, T, burn, eps = 128, 40, 16, 0.5
    th0 = torch.as_tensor(0.1 * np.random.default_rng(0).normal(
        size=(c, DIM)), dtype=torch.float32)
    m_inv = torch.full((DIM,), 0.04)
    m_inv[0] = 0.1
    target = ah.hierarchical_logistic(n=N, p=P, device="cpu")
    h = ah.Hamiltonian(metric=ah.DiagEuclideanMetric.create(m_inv),
                       target=target)
    traj = ah.Trajectory(ah.Leapfrog(step_size=torch.tensor(eps)),
                         ah.GeneralisedNoUTurn(max_depth=6))
    gen = torch.Generator().manual_seed(0)
    _, ths, stats = ah.nuts_transitions_fused(
        gen, h, traj, h.init_phasepoint(gen, th0), T,
        ah.FullMomentumRefreshment())
    tgt, data = hierarchical_logistic_block(n=N, p=P, d_pad=128,
                                            device="cpu")
    out = k2.plain_fused_nuts(tgt, th0, m_inv, eps, 5, data, DIM, T, 6, 64)
    a = _mean_sd_mcse(ths.transpose(0, 1)[burn:].numpy())
    b = _mean_sd_mcse(out[0][burn:].numpy())
    z_mean = np.abs(a[0] - b[0]) / np.hypot(a[2], b[2])
    z_sd = np.abs(a[1] - b[1]) / np.hypot(a[3], b[3])
    assert np.all(z_mean <= K_MCSE), z_mean
    assert np.all(z_sd <= K_MCSE), z_sd
    depth_loop = float(stats["tree_depth"][:, burn:].double().mean())
    depth_k2 = float(out[2][burn:].double().mean())
    assert abs(depth_loop - depth_k2) <= 0.3, (depth_loop, depth_k2)
    assert not bool(out[3].any())


# ---------------------------------------------------------------- dispatch
def test_cpu_tensors_take_the_plain_version():
    tgt, data = std_gaussian_block(5, device="cpu")
    args = (tgt, torch.zeros(3, 5), torch.ones(5), 0.5, 1, data, 5, 2, 4, 8)
    before = k2.fused_nuts.launches
    for a, b in zip(k2.fused_nuts(*args), k2.plain_fused_nuts(*args)):
        assert torch.equal(a, b)
    assert k2.fused_nuts.launches == before == 0


def test_non_cpu_tensor_is_never_run_plain():
    """A tensor that is not on the CPU goes to the kernel's input checks
    (here a meta tensor, refused there), never to the plain version."""
    tgt, _ = std_gaussian_block(5, device="cpu")
    th = torch.empty(4, 5, device="meta")
    with pytest.raises(ValueError, match="must be on"):
        k2.fused_nuts(tgt, th, torch.ones(5), 0.5, 1,
                      (torch.ones(1, 128),), 5)
    with pytest.raises(ValueError, match="max_depth"):
        k2.fused_nuts(tgt, th, torch.ones(5), 0.5, 1,
                      (torch.ones(1, 128),), 5, max_depth=11)


def test_block_targets_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: hierarchical_logistic_block(n=N, p=P),
                 lambda: std_gaussian_block(5),
                 lambda: mvn_diag_block(np.ones(3))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()

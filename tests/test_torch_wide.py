"""K1's wide variant (p > 128) and the 1000-D slice, on the CPU.

K1's wide kernel (`advancedhmc_torch/csrc/fused_logistic.cu`,
`fused_logistic_wide_kernel`, its stages in `csrc/logistic_wide_tile.cuh`)
runs only on the card. Here:

* its index arithmetic, with the constants read from the source: the row
  tiles split across a cluster's ranks, the panels every rank walks, the
  column chunks and their ragged last k-steps, the lanes' fragment offsets
  into the panel's logits/residuals and into the partial gradient (each
  element written once, the float2 accesses free of bank conflicts), and
  the output elements the ranks share in the cluster's sums;
* the kernel's order of work at block granularity in float64 (chunks added
  into the panel's logits, the epilogue's masked rows, product 2 by warp
  halves, the rank-ordered sums, the panels added into the gradient),
  against the direct function, at ragged shapes;
* the plain version at p = 999 against the JAX model in float64 and the
  Pallas kernel in interpret mode;
* the slice as a whole: the port's `sample()` on a 151-D hierarchical
  logistic against the JAX package's, in distribution.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu.adaptation import AdaptorConfig as AdaptorConfigJ
from advancedhmc_tpu.adaptation import DualAveragingConfig as DAConfigJ
from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)
from advancedhmc_tpu.ops.fused_logistic import (
    fused_logistic_value_grad as jax_fused,
)

import advancedhmc_torch as ah
from advancedhmc_torch.diagnostics import effective_sample_size
from advancedhmc_torch.models.logistic import _prior, _synthetic_data
from advancedhmc_torch.ops import fused_logistic as k1

torch.set_num_threads(2)

CSRC = Path(k1.__file__).resolve().parent.parent / "csrc"
SRC = (CSRC / "fused_logistic.cu").read_text()
TILE_SRC = (CSRC / "logistic_tile.cuh").read_text()
WIDE_SRC = (CSRC / "logistic_wide_tile.cuh").read_text()


def _constant(name, src=SRC):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


TILE_ROWS = _constant("kTileRows", TILE_SRC)
CHAINS = 16 * _constant("kWarps")                 # chains per block
KSTEPS = _constant("kWideKSteps", WIDE_SRC)
CHUNK = 8 * KSTEPS
STRIDE = 8 * KSTEPS + 4                           # x_stride(kWideKSteps)
PANEL_TILES = _constant("kPanelTiles", WIDE_SRC)
PANEL_ROWS = PANEL_TILES * TILE_ROWS
RES_STRIDE = PANEL_ROWS + int(re.search(
    r"constexpr int kResStride = kPanelRows \+ (\d+);", WIDE_SRC).group(1))
WARPS = _constant("kWideWarps")
THREADS = 32 * WARPS
HALVES = WARPS // 4
NJ, NNT = 4 // HALVES, KSTEPS // HALVES
MAX_SPLIT = _constant("kWideMaxSplit")


# --- the kernel's index arithmetic, in Python --------------------------
def rank_tiles(n, ranks, rank):
    n_tiles = -(-n // TILE_ROWS)
    return rank * n_tiles // ranks, (rank + 1) * n_tiles // ranks


def n_panels(n, ranks):
    max_tiles = -(-(-(-n // TILE_ROWS)) // ranks)
    return max(1, -(-max_tiles // PANEL_TILES))


def panel_tiles(panel, begin, end):
    t0 = begin + panel * PANEL_TILES
    return t0, max(0, min(end, t0 + PANEL_TILES) - t0)


def wide_split(c, n, slots):
    chain_tiles = -(-c // CHAINS)
    row_tiles = -(-n // TILE_ROWS)
    return max(1, min(slots // chain_tiles, MAX_SPLIT, row_tiles))


def lanes():
    """(warp, group, half, g, t) of every lane of a block."""
    for warp in range(WARPS):
        for lane in range(32):
            yield warp, warp % 4, warp // 4, lane // 4, lane % 4


def res_offsets(i):
    """Stage A's float2 offsets into the panel's logits for tile i, by lane:
    (chain cw | cw+8, rows r0, r0+1), r0 = 32 i + 8 (j0 + j) + 2 t."""
    for warp, group, half, g, t in lanes():
        for j in range(NJ):
            r0 = TILE_ROWS * i + 8 * (NJ * half + j) + 2 * t
            cw = 16 * group + g
            yield warp, g, t, cw * RES_STRIDE + r0, (cw + 8) * RES_STRIDE + r0


def test_source_constants():
    """The constants the wide kernel's design rests on."""
    assert (KSTEPS, CHUNK, STRIDE) == (16, 128, 132)
    assert RES_STRIDE % 32 == 8 and PANEL_ROWS % TILE_ROWS == 0
    assert WARPS in (4, 8) and 4 % HALVES == 0
    assert 8 <= MAX_SPLIT <= 16
    # the narrow instances hold p <= 128; every wider p is the wide kernel's
    assert 8 * _constant("kMaxKSteps") == CHUNK
    floats = (CHAINS * STRIDE + 2 * TILE_ROWS * STRIDE
              + CHAINS * RES_STRIDE + PANEL_ROWS + HALVES * CHAINS)
    assert 4 * floats <= 227 * 1024     # a block's shared memory on an H100


@pytest.mark.parametrize("c,p,n,ranks", [
    (1, 999, 1000, 16), (1000, 999, 997, 16), (4096, 999, 1000, 4),
    (1024, 2047, 1000, 16), (4096, 200, 1000, 4), (13, 129, 300, 8),
    (64, 130, 33, 2), (5, 300, 0, 1), (70, 300, 5000, 3)])
def test_rows_chunks_and_ranks_cover_the_work(c, p, n, ranks):
    """Every row tile belongs to one rank and one of its panels, every rank
    walks the same number of panels (the cluster meets at each chunk of
    stage B), every column lies in one chunk, and the cluster's sums give
    every output element of a chunk to one thread of one rank."""
    n_tiles = -(-n // TILE_ROWS)
    seen = np.zeros(n_tiles, int)
    panels = n_panels(n, ranks)
    assert panels >= 1
    for rank in range(ranks):
        begin, end = rank_tiles(n, ranks, rank)
        assert end - begin <= -(-n_tiles // ranks)
        covered = []
        for panel in range(panels):
            t0, nt_p = panel_tiles(panel, begin, end)
            assert 0 <= nt_p <= PANEL_TILES
            covered += list(range(t0, t0 + nt_p))
        assert covered == list(range(begin, end))
        seen[begin:end] += 1
    assert np.all(seen == 1)
    # columns: chunks of 128, the last one's k-steps and n-tiles cut at p
    n_chunks = -(-p // CHUNK)
    cols = np.zeros(p, int)
    for chunk in range(n_chunks):
        k0 = chunk * CHUNK
        n_ks = min(KSTEPS, (p - k0 + 7) // 8)
        assert n_ks >= 1 and k0 + 8 * n_ks >= min(p, k0 + CHUNK)
        cols[k0:min(p, k0 + CHUNK)] += 1
    assert np.all(cols == 1)
    # the cluster's sums: element e of a chunk goes to rank e // THREADS %
    # ranks and thread e % THREADS, once
    owner = np.zeros(CHAINS * CHUNK, int)
    for rank in range(ranks):
        for tid in range(THREADS):
            owner[rank * THREADS + tid::ranks * THREADS] += 1
    assert np.all(owner == 1)
    # a split the launch can take
    assert 1 <= wide_split(c, n, 132) <= MAX_SPLIT


def test_fragment_offsets_cover_the_panel_without_bank_conflicts():
    """Stage A's C fragments (and the epilogue, which rewrites the same
    elements) cover the panel's 64 chains × 128 rows once; stage B's A
    fragments of a warp read its group's 16 chains × the tile's 32 rows;
    its partial gradient covers 64 chains × 128 columns once. Each float2
    access of a half-warp touches 32 distinct banks."""
    logits = np.zeros((CHAINS, RES_STRIDE), int)
    for i in range(PANEL_TILES):
        by_warp = {}
        for warp, g, t, o0, o8 in res_offsets(i):
            assert o0 % 2 == 0 and o8 % 2 == 0
            for o in (o0, o8):
                logits[o // RES_STRIDE, o % RES_STRIDE] += 1
                logits[o // RES_STRIDE, o % RES_STRIDE + 1] += 1
            by_warp.setdefault(warp, []).append((4 * g + t, o0, o8))
        for items in by_warp.values():
            # per j, lanes in order: half-warps of 16 lanes
            for j in range(NJ):
                row = sorted(items)[j::NJ] if NJ > 1 else sorted(items)
                for half_warp in (row[:16], row[16:]):
                    for pick in (1, 2):
                        banks = set()
                        for _, o0, o8 in half_warp:
                            o = o0 if pick == 1 else o8
                            banks |= {o % 32, (o + 1) % 32}
                        assert len(banks) == 32
    assert np.all(logits[:, :PANEL_ROWS] == 1)
    assert np.all(logits[:, PANEL_ROWS:] == 0)
    # stage B: the warp's A fragments over the tile's rows (all four j)
    for group in range(4):
        reads = np.zeros((16, TILE_ROWS), int)
        for g in range(8):
            for t in range(4):
                for j in range(4):
                    r0 = 8 * j + 2 * t
                    reads[[g, g, g + 8, g + 8], [r0, r0 + 1, r0, r0 + 1]] \
                        += 1
        assert np.all(reads == 1)
    part = np.zeros((CHAINS, STRIDE), int)
    for warp, group, half, g, t in lanes():
        cw = 16 * group + g
        for nt in range(NNT):
            k = 8 * (NNT * half + nt) + 2 * t
            for c in (cw, cw + 8):
                part[c, k:k + 2] += 1
    assert np.all(part[:, :CHUNK] == 1) and np.all(part[:, CHUNK:] == 0)


def _wide_kernel_model(theta, x, y, ranks):
    """The wide kernel's order of work in float64, block by block: chunks
    added into the panel's logits, the epilogue with its row weights, the
    warp halves' products, the rank-ordered sums of each chunk and the
    panels added into the gradient, the lp over the lanes' halves and the
    ranks in order."""
    c, dim = theta.shape
    n, p = x.shape
    n_chunks = -(-p // CHUNK)
    lp = np.zeros(c)
    grad = np.full((c, dim), np.nan)
    for c0 in range(0, c, CHAINS):
        beta = np.zeros((CHAINS, p))
        rows = min(CHAINS, c - c0)
        beta[:rows] = theta[c0:c0 + rows, 1:]
        lp_part = np.zeros((ranks, HALVES, CHAINS))
        panels = n_panels(n, ranks)
        for panel in range(panels):
            parts = np.zeros((ranks, n_chunks, CHAINS, CHUNK))
            for rank in range(ranks):
                t0, nt_p = panel_tiles(panel, *rank_tiles(n, ranks, rank))
                r_lo = t0 * TILE_ROWS
                res = np.zeros((CHAINS, PANEL_ROWS))
                xp = np.zeros((PANEL_ROWS, n_chunks * CHUNK))
                yp = np.zeros(PANEL_ROWS)
                w = np.zeros(PANEL_ROWS)
                r_hi = min(n, (t0 + nt_p) * TILE_ROWS)
                if r_hi > r_lo:
                    xp[:r_hi - r_lo, :p] = x[r_lo:r_hi]
                    yp[:r_hi - r_lo] = y[r_lo:r_hi]
                    w[:r_hi - r_lo] = 1.0
                bp = np.zeros((CHAINS, n_chunks * CHUNK))
                bp[:, :p] = beta
                for chunk in range(n_chunks):
                    cols = slice(chunk * CHUNK, (chunk + 1) * CHUNK)
                    for i in range(nt_p):
                        for half in range(HALVES):
                            r = slice(TILE_ROWS * i + 8 * NJ * half,
                                      TILE_ROWS * i + 8 * NJ * (half + 1))
                            res[:, r] += bp[:, cols] @ xp[r, cols].T
                used = TILE_ROWS * nt_p
                lg = res[:, :used]
                softplus = np.logaddexp(0.0, lg)
                sig = 1.0 / (1.0 + np.exp(-lg))
                for half in range(HALVES):
                    for i in range(nt_p):
                        r = slice(TILE_ROWS * i + 8 * NJ * half,
                                  TILE_ROWS * i + 8 * NJ * (half + 1))
                        lp_part[rank, half] += (
                            yp[r] * lg[:, r] - w[r] * softplus[:, r]).sum(1)
                resid = yp[:used] - w[:used] * sig
                for chunk in range(n_chunks):
                    cols = slice(chunk * CHUNK, (chunk + 1) * CHUNK)
                    for half in range(HALVES):
                        cc = slice(chunk * CHUNK + 8 * NNT * half,
                                   chunk * CHUNK + 8 * NNT * (half + 1))
                        parts[rank, chunk, :, cc.start - cols.start:
                              cc.stop - cols.start] = \
                            resid @ xp[:used, cc]
            for chunk in range(n_chunks):
                k0 = chunk * CHUNK
                k1_ = min(p, k0 + CHUNK)
                total = np.zeros((CHAINS, CHUNK))
                for rank in range(ranks):
                    total = total + parts[rank, chunk]
                out = grad[c0:c0 + rows, 1 + k0:1 + k1_]
                add = total[:rows, :k1_ - k0]
                grad[c0:c0 + rows, 1 + k0:1 + k1_] = \
                    add if panel == 0 else out + add
        lp[c0:c0 + rows] = lp_part.sum((0, 1))[:rows]
        grad[c0:c0 + rows, 0] = 0.0
    return lp, grad


@pytest.mark.parametrize("c,p,n,ranks", [
    (70, 300, 555, 3), (13, 129, 300, 8), (64, 130, 33, 2), (5, 200, 0, 1),
    (3, 260, 1000, 1)])
def test_wide_kernel_order_of_work_matches_the_function(c, p, n, ranks):
    """The kernel's tiling and sums, in float64, agree with the direct
    float64 function to 1e-12 of the largest magnitude: no element of the
    work is dropped or counted twice, at ragged C, p and n, one or several
    ranks and one or two panels."""
    x, y = _synthetic_data(max(n, 2), p, 3)
    x, y = x[:n], y[:n]
    theta = 0.1 * np.random.default_rng(c + p + n).normal(size=(c, p + 1))
    lp, grad = _wide_kernel_model(theta, x, y, ranks)
    lp_ref, g_ref = k1.plain_logistic_value_grad(
        torch.as_tensor(theta), torch.as_tensor(x), torch.as_tensor(y))
    scale = max(1.0, float(lp_ref.abs().max()))
    assert np.abs(lp - lp_ref.numpy()).max() <= 1e-12 * scale
    assert np.all(np.isfinite(grad))
    gscale = max(1.0, float(g_ref.abs().max()))
    assert np.abs(grad - g_ref.numpy()).max() <= 1e-12 * gscale


# --- the plain version at p = 999 against the JAX package --------------
N_WIDE, P_WIDE = 1000, 999


@pytest.fixture(scope="module")
def wide_inputs():
    x, y = _synthetic_data(N_WIDE, P_WIDE)
    th = 0.05 * np.random.default_rng(9).normal(size=(12, P_WIDE + 1))
    return x, y, th


def test_plain_k1_at_p999_matches_jax_model_float64(wide_inputs):
    """The plain K1 plus the model's prior, in float64, against the JAX
    model's float64 value and gradient, to 1e-10 of the largest magnitude."""
    x, y, th = wide_inputs
    tj = jax_logistic(n=N_WIDE, p=P_WIDE, dtype=jnp.float64)
    lp_j, g_j = jax.vmap(tj.logdensity_and_grad)(jnp.asarray(th))
    tt = torch.as_tensor(th)
    lp_l, g_l = k1.plain_logistic_value_grad(tt, torch.as_tensor(x),
                                             torch.as_tensor(y))
    lp_p, g_p = _prior(tt, P_WIDE)
    lp_t, g_t = (lp_l + lp_p).numpy(), (g_l + g_p).numpy()
    lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    assert np.abs(lp_t - lp_j).max() <= 1e-10 * np.abs(lp_j).max()
    assert np.abs(g_t - g_j).max() <= 1e-10 * np.abs(g_j).max()


def test_plain_k1_at_p999_matches_pallas_interpret(wide_inputs):
    """The plain version in float32 against the Pallas kernel in interpret
    mode at p = 999, at the JAX test's bf16-input tolerance
    (tests/test_pallas_ops.py): lp to 3e-3 relative, the gradient to 1 % of
    its largest magnitude; component 0 is 0 in both."""
    x, y, th = wide_inputs
    th = th.astype(np.float32)
    apply = jax_fused(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                      block_chains=8, interpret=True)
    lp_j, g_j = apply(jnp.asarray(th))
    lp_t, g_t = k1.logistic_value_grad(
        torch.as_tensor(th), torch.as_tensor(x, dtype=torch.float32),
        torch.as_tensor(y, dtype=torch.float32))
    assert lp_t.shape == (12,) and g_t.shape == (12, P_WIDE + 1)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=3e-3)
    scale = float(np.abs(np.asarray(g_j)).max())
    assert float(np.abs(g_t.numpy() - np.asarray(g_j)).max()) < 0.01 * scale
    assert np.all(g_t[:, 0].numpy() == 0.0)
    assert np.all(np.asarray(g_j)[:, 0] == 0.0)


# --- the slice as a whole ---------------------------------------------
# sample() on a 151-D hierarchical logistic over 200 rows, cross-chain fused
# warmup and fused draws, 16 chains; δ 0.8 and short Stan buffers as in
# tests/test_torch_sampler.py (at this size the δ 0.55 dual averaging of
# both packages overshoots).
N_S, P_S, CHAINS_S = 200, 150, 16
WARMUP_S, DRAWS_S, FUSE_S, BLOCK_S = 64, 48, 4, 4
DELTA_S = 0.8
BUFFERS_S = dict(init_buffer=16, term_buffer=32, window_size=16)
# two independent runs: a difference of means (sds) within this many
# combined Monte Carlo standard errors, over 151 dimensions (as
# tests/test_torch_sampler.py)
K_MCSE = 5.0


def _ess(th):
    return effective_sample_size(torch.as_tensor(np.array(th))).numpy()


def _mcse_mean_sd(th):
    """Per-dimension MCSE of the mean (sd/√ESS) and of the sd: the MCSE of
    the variance from the ESS of the squared deviations, over 2·sd. The
    β's marginals here are far from normal (they scale with σ), so the
    normal-theory sd/√(2·ESS) understates the sd's error: with it, two runs
    of the port with different seeds differ by up to 10 MCSEs."""
    sd = th.std((0, 1))
    dev2 = (th - th.mean((0, 1))) ** 2
    se_var = dev2.std((0, 1)) / np.sqrt(_ess(dev2))
    return sd / np.sqrt(_ess(th)), se_var / (2 * sd)


def _theta0_s():
    return 0.1 * np.random.default_rng(4).normal(size=(CHAINS_S, P_S + 1))


def _jax_slice():
    kernel = aj.HMCKernel(aj.Trajectory(
        aj.Leapfrog(step_size=jnp.asarray(0.05)),
        aj.GeneralisedNoUTurn(max_depth=6), "multinomial"))
    adaptor = AdaptorConfigJ(kind="stan", da=DAConfigJ(delta=DELTA_S,
                                                       kappa=0.8), **BUFFERS_S)
    return aj.sample(
        jax.random.PRNGKey(0), jax_logistic(n=N_S, p=P_S, dtype=jnp.float64),
        kernel, aj.make_metric("diagonal", P_S + 1, dtype=jnp.float64),
        jnp.asarray(_theta0_s()), WARMUP_S + DRAWS_S, n_adapts=WARMUP_S,
        adaptor=adaptor, init_mass_matrix="gradient", cross_chain=True,
        fuse_draws=FUSE_S, fuse_warmup=True, fuse_warmup_block=BLOCK_S,
        drop_warmup=True)


@pytest.fixture(scope="module")
def jax_slice():
    return _jax_slice()


def _port_slice():
    target = ah.hierarchical_logistic(n=N_S, p=P_S, dtype=torch.float64,
                                      device="cpu")
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.05, dtype=torch.float64)),
        ah.GeneralisedNoUTurn(max_depth=6)))
    adaptor = ah.AdaptorConfig(kind="stan", da=ah.DualAveragingConfig(
        delta=DELTA_S, kappa=0.8), **BUFFERS_S)
    return ah.sample(
        torch.Generator().manual_seed(0), target, kernel,
        ah.make_metric("diagonal", P_S + 1, dtype=torch.float64,
                       device="cpu"),
        _theta0_s(), WARMUP_S + DRAWS_S, n_adapts=WARMUP_S, adaptor=adaptor,
        init_mass_matrix="gradient", cross_chain=True, fuse_draws=FUSE_S,
        fuse_warmup=True, fuse_warmup_block=BLOCK_S, drop_warmup=True,
        device="cpu")


def test_wide_slice_matches_jax_in_distribution(jax_slice):
    """The port's `sample()` at p = 150 (beyond the narrow kernel's width)
    on the CPU against the JAX package's: per-dimension mean and sd within
    K_MCSE combined MCSEs, acceptance within 0.05, no divergence."""
    res = _port_slice()
    th_t = res.thetas.numpy()
    th_j = np.asarray(jax_slice.thetas)
    assert th_t.shape == th_j.shape == (DRAWS_S, CHAINS_S, P_S + 1)
    assert np.all(np.isfinite(th_t))
    mcse = []
    for th in (th_t, th_j):
        mcse.append(_mcse_mean_sd(th))
    se_mean = np.hypot(mcse[0][0], mcse[1][0])
    se_sd = np.hypot(mcse[0][1], mcse[1][1])
    d_mean = np.abs(th_t.mean((0, 1)) - th_j.mean((0, 1)))
    d_sd = np.abs(th_t.std((0, 1)) - th_j.std((0, 1)))
    assert np.all(d_mean <= K_MCSE * se_mean), (d_mean / se_mean).max()
    assert np.all(d_sd <= K_MCSE * se_sd), (d_sd / se_sd).max()
    acc_t = float(res.stats["acceptance_rate"].mean())
    acc_j = float(np.mean(jax_slice.stats["acceptance_rate"]))
    assert abs(acc_t - acc_j) <= 0.05, (acc_t, acc_j)
    assert not bool(res.stats["numerical_error"].any())
    assert not bool(np.any(jax_slice.stats["numerical_error"]))

"""K1's wide path (p > 128) on the CPU: the design laid out once per model,
and the kernels' order of work.

The wide path's kernels (`advancedhmc_torch/csrc/fused_logistic.cu`,
namespace `wide`: stage A's and stage B's `wgmma` GEMMs) run
only on the card. Here:

* the prepared layout, `ops.fused_logistic.wide_layout`: padding to the
  K tile (read from the source), the zero column for θ's column 0, zero
  rows past n and columns past dim, hi + lo == x exactly in the x and xᵀ
  planes, hi TF32-representable and rounded to nearest with ties away;
* the split-K rule (`split_for`) and the tiles of each launch, with the
  constants read from the source;
* the ablation's variants (`scripts/k1_wide_ablation.py`): each of its
  text edits applies at one place of the wide path's source;
* the order of work in float64: 64 × 128 output tiles, K in stages of 32
  summed apart and then added (the promotion), K split over a cluster's
  ranks whose partial tiles add in rank order, the epilogue's masked rows,
  its threads' lp sums and the lp partials per row tile summed in order;
  with the prior folded in (`prior=True`), stage A's sums of θ² from the
  fragments its consumers split (column 0 left out, quad lanes and ranks
  in order) and stage B's epilogue terms; held against the plain version
  and the JAX model in float64;
* the numerics of the planes: 3xTF32 products of the TF32 parts the tensor
  cores read, against float64, well inside the card's gate.
"""

import functools
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)

from advancedhmc_torch.models.logistic import _prior, _synthetic_data
from advancedhmc_torch.ops import fused_logistic as k1

torch.set_num_threads(2)

SRC = (Path(k1.__file__).resolve().parent.parent / "csrc" /
       "fused_logistic.cu").read_text()
WIDE_SRC = SRC[SRC.index("namespace wide {"):]
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _constant(name, src=WIDE_SRC):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


BM, BN, BK = _constant("kBM"), _constant("kBN"), _constant("kBK")
MAX_SPLIT = _constant("kMaxSplit")
CONSUMERS = 2 * BM          # kConsumers: a warpgroup a 64 rows of the tile
SMS = 132                                # an H100 SXM's SMs


def test_source_constants_match_the_wrapper():
    """The wrapper pads to the kernels' K tile and sends every p past the
    narrow instances (8 · kMaxKSteps) to the wide path; a stage's K row is
    one 128-byte swizzle row; the tile is one warpgroup's 64 rows; the
    split-K sizes are powers of two within the portable cluster size."""
    assert k1.WIDE_K_TILE == BK and 4 * BK == 128
    assert k1.NARROW_MAX_P == 8 * _constant("kMaxKSteps", SRC)
    # a warpgroup (128 threads) takes 64 rows of the tile: wgmma's M
    assert BM % 64 == 0
    assert "constexpr int kConsumers = 2 * kBM;" in WIDE_SRC
    assert BN % 8 == 0 and BN <= 256
    assert MAX_SPLIT in (1, 2, 4, 8)
    # the ring and the barriers fit in a block's shared memory
    # B's hi and lo planes by TMA, A's float32 tile in rows of kBK + 4
    assert "constexpr int kAStride = kBK + 4;" in WIDE_SRC
    stage = 2 * BN * BK * 4 + BM * (BK + 4) * 4
    assert stage % 1024 == 0           # every stage's B on 1024 bytes
    assert 1024 + _constant("kStages") * stage + 64 <= 227 * 1024
    # the epilogue's tile (rows of kBN + 8 floats) fits in the ring
    assert BM * (BN + 8) * 4 <= _constant("kStages") * stage


# --- the prepared layout ------------------------------------------------
def _rna_tf32(v):
    """Round to 11 significant bits, to nearest, ties away from zero, in
    float64 arithmetic (independent of the integer trick)."""
    v = np.asarray(v, np.float64)
    m, e = np.frexp(v)                      # v = m · 2^e, 0.5 ≤ |m| < 1
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return (r * 2.0 ** (e - 11)).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_tf32_round_is_round_to_nearest_away(scale):
    """`tf32_round` gives TF32-representable values (13 low mantissa bits
    zero), equal to rounding to nearest with ties away at 10 mantissa bits,
    ties included."""
    rng = np.random.default_rng(int(scale * 7) + 1)
    v = (scale * rng.normal(size=4000)).astype(np.float32)
    # exact ties: a value halfway between two TF32 neighbours, both signs
    ties = ((1.0 + np.arange(8) * 2.0 ** -10 + 2.0 ** -11)
            * 2.0 ** np.arange(-6, 2)).astype(np.float32)
    v = np.concatenate([v, ties, -ties, [0.0, -0.0]]).astype(np.float32)
    hi = k1.tf32_round(torch.as_tensor(v)).numpy()
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    np.testing.assert_array_equal(hi, _rna_tf32(v))
    assert np.all(np.abs(ties) < np.abs(k1.tf32_round(
        torch.as_tensor(ties)).numpy()))     # ties go away from zero


@pytest.mark.parametrize("p", [129, 200, 999, 2047])
@pytest.mark.parametrize("n", [997, 1000])
def test_wide_layout_pads_zeroes_and_splits_exactly(n, p):
    """x (n, p) → planes (2, n_pad, k_pad) and their transpose: n_pad and
    k_pad are n and dim = p + 1 rounded up to the K tile (rows 16-byte
    aligned), column 0 and everything past n and dim is zero, hi is TF32
    and round-to-nearest-away of x, and hi + lo == x exactly."""
    x_np, _ = _synthetic_data(n, p, 2)
    x = torch.as_tensor(x_np, dtype=torch.float32)
    planes, t_planes = k1.wide_layout(x)
    n_pad, k_pad = -(-n // BK) * BK, -(-(p + 1) // BK) * BK
    assert planes.shape == (2, n_pad, k_pad) and planes.is_contiguous()
    assert t_planes.shape == (2, k_pad, n_pad) and t_planes.is_contiguous()
    assert (4 * k_pad) % 16 == 0 and (4 * n_pad) % 16 == 0
    hi, lo = planes[0].numpy(), planes[1].numpy()
    assert np.all(hi[:, 0] == 0) and np.all(lo[:, 0] == 0)
    assert np.all(planes[:, n:].numpy() == 0)
    assert np.all(planes[:, :, p + 1:].numpy() == 0)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    np.testing.assert_array_equal(hi[:n, 1:p + 1], _rna_tf32(x_np.astype(
        np.float32)))
    np.testing.assert_array_equal((planes[0] + planes[1])[:n, 1:p + 1],
                                  x)
    assert torch.equal(t_planes, planes.transpose(1, 2))
    # the remainder is what hi leaves: below half a TF32 step of x
    assert np.all(np.abs(lo) <= np.abs(hi) * 2.0 ** -11 + 1e-38)


# --- the launches -------------------------------------------------------
def split_for(tiles, k_blocks, sms=SMS):
    """`wide::split_for` on a card that places every cluster size."""
    split = 1
    while (2 * split <= MAX_SPLIT and tiles * 2 * split <= sms
           and 2 * split <= k_blocks):
        split *= 2
    return split


def launches(c, p, n):
    """(m_tiles, n_tiles, split, k_blocks) of stage A and of stage B."""
    n_pad, k_pad = -(-max(n, 1) // BK) * BK, -(-(p + 1) // BK) * BK
    m_tiles = -(-c // BM)
    out = []
    for n_tiles, k_blocks in ((-(-n_pad // BN), k_pad // BK),
                              (-(-k_pad // BN), n_pad // BK)):
        out.append((m_tiles, n_tiles,
                    split_for(m_tiles * n_tiles, k_blocks), k_blocks))
    return out


@pytest.mark.parametrize("c,p,n,splits", [
    (1024, 999, 1000, (2, 2)), (1, 999, 1000, (8, 8)),
    (64, 2047, 333, (8, 8)), (65, 999, 997, (8, 8)),
    (4096, 999, 1000, (1, 1)), (3, 129, 5, (4, 1)),
    (1088, 999, 1000, (1, 1)), (320, 200, 1000, (4, 8))])
@pytest.mark.parametrize("stage", [0, 1])
def test_split_k_fills_the_card_and_covers_the_work(c, p, n, splits, stage):
    """At the path's C = 1024 the 64 tiles of each GEMM (stage A, stage B)
    split K over 2 ranks, one wave of 128 blocks; at small C the K range
    splits over up to kMaxSplit ranks, never more than the K blocks nor
    the card's SMs; at large C not at all. Every rank's K range is
    non-empty and the ranks cover K once, in order; each rank's epilogue
    takes kBM / split rows, 2 · split threads a row, every float4 of the
    row once."""
    m_tiles, n_tiles, split, k_blocks = launches(c, p, n)[stage]
    assert split == splits[stage]
    assert m_tiles * n_tiles * split <= max(SMS, m_tiles * n_tiles)
    assert split <= 8                     # a portable cluster
    bounds = [r * k_blocks // split for r in range(split + 1)]
    assert bounds[0] == 0 and bounds[-1] == k_blocks
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    rows, tpr = BM // split, CONSUMERS // (BM // split)
    assert tpr == 2 * split and 32 % tpr == 0
    seen = np.zeros((BM, BN), int)
    for rank in range(split):
        for tid in range(CONSUMERS):
            row, q = rank * rows + tid // tpr, tid % tpr
            for col in range(4 * q, BN, 4 * tpr):
                seen[row, col:col + 4] += 1
    assert np.all(seen == 1)


def _ablation_edits():
    sys.path.insert(0, str(SCRIPTS))
    try:
        import k1_wide_ablation
    finally:
        sys.path.remove(str(SCRIPTS))
    return k1_wide_ablation.EDITS


@pytest.mark.parametrize("variant", [
    "no_mma", "one_mma", "no_promote", "stages2", "stages3", "no_split",
    "a_copies", "stage_a", "stage_b"])
def test_ablation_edits_apply_at_one_place(variant):
    """Each variant of scripts/k1_wide_ablation.py is the kernels' source
    with text edits to the wide path's code; every edit finds its text
    once (else the script stops on the card), and applied in turn they
    change the source."""
    edits = _ablation_edits()[variant]
    text = WIDE_SRC
    assert edits
    for f, old, new in edits:
        assert f == "fused_logistic.cu"
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert text != WIDE_SRC


@pytest.mark.parametrize("tma", [True, False])
def test_a_tile_layouts_cover_the_tile_and_reads_miss_no_bank(tma):
    """A stage's A tile (kBM rows × kBK columns) where A's rows are aligned
    for TMA: 128-byte rows whose 16-byte chunks are swizzled by the row mod
    8, a place for every float once; where they are not: the producer
    warpgroup's 128 threads copy every float once into rows of kBK + 4. A
    consumer warp's fragment reads (rows g and g + 8 of its 16, columns t
    and t + 4 of a k-step) each touch 32 different banks."""
    stride = BK if tma else BK + 4

    def place(row, col):
        chunk = (col // 4) ^ (row % 8 if tma else 0)
        return row * stride + 4 * chunk + col % 4

    places = {place(r, c) for r in range(BM) for c in range(BK)}
    assert len(places) == BM * BK and max(places) < BM * stride
    if not tma:
        seen = np.zeros((BM, BK), int)
        for p in range(128):
            for i in range(BM * BK // 128):
                seen[p // 32 + 4 * i, p % 32] += 1
        assert np.all(seen == 1)
    for warp in range(CONSUMERS // 32):
        for kk in range(BK // 8):
            for i in range(4):
                banks = {place(16 * warp + g + 8 * (i & 1),
                               8 * kk + t + 4 * (i >> 1)) % 32
                         for g in range(8) for t in range(4)}
                assert len(banks) == 32


# --- the order of work, in float64 -------------------------------------
def _row_lp(terms, split):
    """A tile's lp terms (rows, BN) summed as the epilogue's threads do:
    thread q of a row adds the float4s at columns 4(q + 2·split·m), then
    the row's threads add in a butterfly of shuffles."""
    tpr = 2 * split
    per = terms.reshape(terms.shape[0], BN // (4 * tpr), tpr, 4)
    s = per.sum(axis=(1, 3))                         # (rows, tpr)
    o = 1
    while o < tpr:
        s = s + s[:, np.arange(tpr) ^ o]
        o *= 2
    return s[:, 0]


def _gemm_tiles(a, b, n_cols, split):
    """A (M, K) · Bᵀ (N, K) tile by tile as the kernel sums it: each rank
    of the cluster adds its stages' products (each stage of BK summed
    apart, then added: the promotion), the ranks' tiles added in rank
    order. Yields (m0, n0, tile)."""
    k_blocks = a.shape[1] // BK
    for m0 in range(0, a.shape[0], BM):
        for n0 in range(0, n_cols, BN):
            at = np.zeros((BM, a.shape[1]))
            rows = a[m0:m0 + BM]
            at[:len(rows)] = rows
            bt = np.zeros((BN, a.shape[1]))
            cols = b[n0:n0 + BN]
            bt[:len(cols)] = cols
            tile = np.zeros((BM, BN))
            for rank in range(split):
                acc = np.zeros((BM, BN))
                for kb in range(rank * k_blocks // split,
                                (rank + 1) * k_blocks // split):
                    ks = slice(kb * BK, (kb + 1) * BK)
                    acc = acc + at[:, ks] @ bt[:, ks].T
                tile = tile + acc
            yield m0, n0, tile


def stage_a_bsq(theta, split):
    """Each chain's Σ θ_k² (k ≥ 1) as stage A's consumers sum it: lane t of
    a row's quad adds, stage by stage of its rank's K range, columns 8 kk +
    t and 8 kk + 4 + t of each k-step kk (column 0 of θ left out); the
    quad's lanes add as (t0 + t1) + (t2 + t3), the ranks in rank order.
    Every column of θ past 0 is added once."""
    c, dim = theta.shape
    k_blocks = -(-dim // BK)
    padded = np.zeros((c, k_blocks * BK))
    padded[:, :dim] = theta
    seen = np.zeros(k_blocks * BK, int)
    total = np.zeros(c)
    for rank in range(split):
        lanes = np.zeros((4, c))
        for kb in range(rank * k_blocks // split,
                        (rank + 1) * k_blocks // split):
            for kk in range(BK // 8):
                for t in range(4):
                    for col in (8 * kk + t, 8 * kk + 4 + t):
                        k = kb * BK + col
                        if k == 0:
                            continue
                        seen[k] += 1
                        lanes[t] += padded[:, k] ** 2
        total = total + ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
    assert seen[0] == 0 and np.all(seen[1:] == 1)
    return total


def wide_model(theta, x, y, prior=False):
    """The wide path in float64, launch by launch: stage A's tiles (θ
    read as A, zero past dim; x's planes padded, column 0 zero) and
    epilogue (residuals, lp partials per row tile), stage B's tiles
    (gradient columns k < dim, column 0 written 0) and the lp partials
    summed over the row tiles in order. With `prior`, stage A's Σ θ_k²
    and stage B's prior terms (column 0 written, θ_k · e^(−2 log σ)
    taken from each element, the prior's lp added in column tile 0)."""
    c, dim = theta.shape
    n = x.shape[0]
    (m_tiles, a_tiles, split_a, _), (_, _, split_b, _) = launches(
        c, dim - 1, n)
    n_pad, k_pad = -(-max(n, 1) // BK) * BK, -(-dim // BK) * BK
    beta = np.zeros((c, k_pad))
    beta[:, :dim] = theta
    xk = np.zeros((n_pad, k_pad))
    xk[:n, 1:dim] = x
    yk = np.zeros(n_pad + BN)
    yk[:n] = y
    w = np.zeros(n_pad + BN)
    w[:n] = 1.0
    resid = np.zeros((c, n_pad))
    lp_part = np.zeros((a_tiles, c))
    for m0, n0, tile in _gemm_tiles(beta, xk, n_pad, split_a):
        yt, wt = yk[n0:n0 + BN], w[n0:n0 + BN]
        e = np.exp(-np.abs(tile))
        softplus = np.maximum(tile, 0.0) + np.log1p(e)
        sig = np.where(tile >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
        terms = yt * tile - wt * softplus
        r = yt - wt * sig
        rows = min(BM, c - m0)
        cols = min(BN, n_pad - n0)
        resid[m0:m0 + rows, n0:n0 + cols] = r[:rows, :cols]
        lp_part[n0 // BN, m0:m0 + rows] = _row_lp(terms, split_a)[:rows]
    grad = np.full((c, dim), np.nan)
    for m0, n0, tile in _gemm_tiles(resid, xk.T, k_pad, split_b):
        rows = min(BM, c - m0)
        cols = min(BN, dim - n0)
        if cols > 0:
            grad[m0:m0 + rows, n0:n0 + cols] = tile[:rows, :cols]
    grad[:, 0] = 0.0
    lp = np.zeros(c)
    for t in range(a_tiles):
        lp = lp + lp_part[t]
    if prior:
        p = dim - 1
        ls, bsq = theta[:, 0], stage_a_bsq(theta, split_a)
        inv_s2 = np.exp(-2.0 * ls)
        grad[:, 1:] = grad[:, 1:] - theta[:, 1:] * inv_s2[:, None]
        grad[:, 0] = -ls + bsq * inv_s2 - p
        lp = lp + (-0.5 * ls * ls - 0.5 * bsq * inv_s2 - p * ls)
    return lp, grad


@functools.lru_cache(maxsize=None)
def _jax_reference(n, p):
    """The JAX model's float64 value and gradient (prior included) at 64
    chains of θ from a fixed seed; a case takes its first C."""
    theta = 0.1 * np.random.default_rng(n + p).normal(size=(64, p + 1))
    model = jax_logistic(n=n, p=p, dtype=jnp.float64)
    lp, g = jax.jit(jax.vmap(model.logdensity_and_grad))(jnp.asarray(theta))
    return theta, np.asarray(lp), np.asarray(g)


@pytest.mark.parametrize("c", [1, 3, 64])
@pytest.mark.parametrize("n", [997, 1000])
@pytest.mark.parametrize("p", [129, 200, 999])
def test_wide_order_of_work_matches_plain_and_jax(p, n, c):
    """The wide path's tiling, split-K, promotion, epilogue and ordered
    sums, in float64, agree with the plain version to 1e-12 and, with the
    model's prior added, with the JAX model to 1e-10 of the largest
    magnitude: no element of the work is dropped or counted twice, at
    ragged C, p and n, with and without a split K."""
    theta_all, lp_j, g_j = _jax_reference(n, p)
    theta = theta_all[:c]
    x, y = _synthetic_data(n, p)
    lp, grad = wide_model(theta, x, y)
    lp_ref, g_ref = k1.plain_logistic_value_grad(
        torch.as_tensor(theta), torch.as_tensor(x), torch.as_tensor(y))
    assert np.all(np.isfinite(grad)) and np.all(grad[:, 0] == 0)
    scale = max(1.0, float(lp_ref.abs().max()))
    assert np.abs(lp - lp_ref.numpy()).max() <= 1e-12 * scale
    gscale = max(1.0, float(g_ref.abs().max()))
    assert np.abs(grad - g_ref.numpy()).max() <= 1e-12 * gscale
    lp_pri, g_pri = _prior(torch.as_tensor(theta), p)
    lp_t, g_t = lp + lp_pri.numpy(), grad + g_pri.numpy()
    assert np.abs(lp_t - lp_j[:c]).max() <= 1e-10 * np.abs(lp_j[:c]).max()
    assert np.abs(g_t - g_j[:c]).max() <= 1e-10 * np.abs(g_j[:c]).max()


@pytest.mark.parametrize("c", [1, 3, 64])
@pytest.mark.parametrize("n", [997, 1000])
@pytest.mark.parametrize("p", [129, 200, 999])
def test_wide_order_of_work_with_the_prior_matches_jax(p, n, c):
    """With the prior folded in (`prior=True`): stage A's sums of θ² over
    its ranks' K ranges and stage B's epilogue terms, in float64, agree
    with the plain version with the prior to 1e-12 and with the JAX model
    (prior included) to 1e-10 of the largest magnitude, at ragged C, p and
    n, with and without a split K (1 chain: 8 ranks; 64: fewer)."""
    theta_all, lp_j, g_j = _jax_reference(n, p)
    theta = theta_all[:c]
    x, y = _synthetic_data(n, p)
    lp, grad = wide_model(theta, x, y, prior=True)
    lp_ref, g_ref = k1.plain_logistic_value_grad(
        torch.as_tensor(theta), torch.as_tensor(x), torch.as_tensor(y),
        prior=True)
    assert np.all(np.isfinite(grad))
    assert np.abs(lp - lp_ref.numpy()).max() <= 1e-12 * float(
        lp_ref.abs().max())
    assert np.abs(grad - g_ref.numpy()).max() <= 1e-12 * float(
        g_ref.abs().max())
    assert np.abs(lp - lp_j[:c]).max() <= 1e-10 * np.abs(lp_j[:c]).max()
    assert np.abs(grad - g_j[:c]).max() <= 1e-10 * np.abs(g_j[:c]).max()


def test_prior_sums_fit_the_tiles_spare_column():
    """Stage A leaves each row's sum of squares in the epilogue tile's
    column kBN, which its rows of kBN + 8 floats hold and no float4 of the
    epilogue reads; the scratch holds the residuals, the lp partials and
    one sum a chain."""
    assert "constexpr int kEpiStride = kBN + 8;" in WIDE_SRC
    assert "row * kEpiStride + kBN]" in WIDE_SRC
    assert max(range(0, BN, 4)) + 4 <= BN < BN + 8
    scratch = re.search(r"size_t scratch_floats\(int n_chains, int n\) \{"
                        r"(.*?)\n\}", WIDE_SRC, re.S).group(1)
    assert scratch.rstrip().endswith("* n_chains + n_chains;")


# --- the numerics of the planes -----------------------------------------
def _read_tf32(v):
    """What a tensor core reads of a float32 operand: its TF32 part, the
    13 low mantissa bits dropped."""
    v = np.ascontiguousarray(v, np.float32)
    return (v.view(np.uint32) & np.uint32(0xFFFFE000)).view(
        np.float32).astype(np.float64)


def _split(v):
    """A float32 array's hi and lo parts, as the layout and the kernels'
    consumers split them (hi rounded to nearest away, lo = v − hi)."""
    hi = k1.tf32_round(torch.as_tensor(np.asarray(v, np.float32))).numpy()
    return hi, (np.asarray(v, np.float32) - hi)


def _product_3x(a, b):
    """A · Bᵀ from the planes as the kernels multiply them: lo·hi, hi·lo
    and hi·hi of the parts the tensor cores read, exact in float64."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    ah, al, bh, bl = map(_read_tf32, (ah, al, bh, bl))
    return al @ bh.T + ah @ bl.T + ah @ bh.T


@pytest.mark.parametrize("p,n", [(999, 1000), (200, 997)])
def test_planes_give_float32_accuracy(p, n):
    """With every operand in TF32 hi and lo planes (lo read truncated by
    the tensor cores, lo·lo dropped), the value and gradient land within a
    tenth of the card's gate (1e-4 of the largest magnitude) of float64."""
    x, y = _synthetic_data(n, p)
    theta = 0.1 * np.random.default_rng(p).normal(size=(8, p + 1))
    planes, _ = k1.wide_layout(torch.as_tensor(x, dtype=torch.float32))
    xk = (planes[0] + planes[1]).numpy()[:n]
    beta = np.zeros((8, xk.shape[1]), np.float32)
    beta[:, :p + 1] = theta
    logits = _product_3x(beta, xk).astype(np.float32).astype(np.float64)
    e = np.exp(-np.abs(logits))
    lp = np.sum(y * logits - (np.maximum(logits, 0) + np.log1p(e)), 1)
    resid = (y - np.where(logits >= 0, 1 / (1 + e), e / (1 + e))).astype(
        np.float32)
    grad = _product_3x(resid, np.ascontiguousarray(xk.T))[:, :p + 1]
    grad[:, 0] = 0.0
    lp64, g64 = k1.plain_logistic_value_grad(
        torch.as_tensor(theta), torch.as_tensor(x), torch.as_tensor(y))
    assert np.abs(grad - g64.numpy()).max() <= 1e-5 * float(
        g64.abs().max())
    assert np.abs(lp - lp64.numpy()).max() <= 1e-5 * max(
        1.0, float(lp64.abs().max()))

"""K2's Hopper design, modelled on the CPU.

K2 (`advancedhmc_torch/csrc/fused_nuts.cu`) gives each warp 16 chains, the
M rows of K1's warp tile (`csrc/logistic_tile.cuh`), and each block
kWarps warps. The leaf's logistic value and gradient run through the tile
in 3xTF32 on the tensor cores; the tree state lies in a device scratch
buffer, one contiguous run of vectors per chain.

The first test walks the kernel's index arithmetic lane by lane, with the
constants read from the kernel's source, and checks it against direct
indexing: chain ↔ (block, warp, fragment row g | g + 8), the gradient's C
fragments scattered over the warp's rows of the shared β tile and read back
by the per-chain pass, the lp gather, the pad columns, the scratch offsets
(tree-state vectors, then the chains' scalar records) and the output rows,
at ragged chain counts and two widths.

The second runs the plain twin `plain_fused_nuts` twice on the 100-D model,
once with the logistic evaluated as the kernel evaluates it (the 3xTF32
emulation of tests/test_torch_tf32_split.py, with the tile's short
accumulation chains and the tensor cores' truncating adds) and once in
float32, and holds the draws to the card's agreement gate at a small size.

The rest model the wide instance (p > 128, `WideLogisticTarget`), whose
leaf runs the column-tiled stages of `csrc/logistic_wide_tile.cuh` on a
thread-block cluster of R ranks per group of 64 chains: the chunk, tile
and panel bounds with the rows split over the ranks (uneven ranges, ranks
with no tile), the staging of β from the frontiers in the scratch and of x
from xᵀ with their zero padding, the gradient's rank-ordered sum into the
frontiers' gradient vectors, the order of work in float64 against the
direct function, and the walk spread over the cluster's warps with each
chain's counter stream unchanged.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from advancedhmc_torch.models.logistic import _synthetic_data, \
    hierarchical_logistic_block
from advancedhmc_torch.ops import fused_nuts_kernel as k2
from advancedhmc_torch.ops.counter_rng import _round_up, rng_base
from advancedhmc_torch.target import BlockTarget
from test_torch_tf32_split import TILE_ROWS, _c_pos, _epilogue, \
    _mma_chain, _split

torch.set_num_threads(2)

CSRC = Path(k2.__file__).resolve().parent.parent / "csrc"
SRC = (CSRC / "fused_nuts.cu").read_text()
WIDE_SRC = (CSRC / "logistic_wide_tile.cuh").read_text()


def _constant(name, src=SRC):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _n_vectors(max_depth):
    """15 + 2S: the vectors of `enum Vec` before kCk, then the stacks."""
    enum = re.search(r"enum Vec \{(.*?)\};", SRC, re.S).group(1)
    names = re.findall(r"\bk[A-Z]\w*", re.sub(r"//[^\n]*", "", enum))
    return names.index("kCk") + 2 * max_depth


def _ksteps(p):
    """The logistic instance a call takes: the smallest that holds p."""
    for bound, ks in re.findall(
            r"if \(p <= (\d+)\) return f\(LogisticTarget<(\d+)>", SRC):
        if p <= int(bound):
            assert int(bound) == 8 * int(ks)
            return int(ks)
    raise AssertionError(f"no instance for p = {p}")


def _record_words():
    """32-bit words of a chain's scalar record, `struct Chain`."""
    body = re.search(r"struct alignas\(16\) Chain \{(.*?)\};", SRC,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    words = 0
    for decl in body.split(";")[:-1]:
        names = decl.split(None, 1)[1].split(",")
        for name in names:
            m = re.search(r"\[(\d+)\]", name)
            words += int(m.group(1)) if m else 1
    return words


WARPS, PER_WARP = _constant("kWarps"), _constant("kChainsPerWarp")
BLOCK = WARPS * PER_WARP
RECORD = _record_words()


@pytest.mark.parametrize("dim", [5, 100])
@pytest.mark.parametrize("chains", [8, 1000, 4101])
def test_k2_index_arithmetic(chains, dim, max_depth=6, T=3):
    assert PER_WARP == 16 and BLOCK == 64 and RECORD == 16
    p, ks = dim - 1, _ksteps(dim - 1)
    stride = 8 * ks + 4                      # logistic_tile x_stride
    blocks = -(-chains // BLOCK)
    padded = blocks * BLOCK
    rng = np.random.default_rng(dim)

    # chain <-> (block, warp, fragment row): lane 4g + t holds C rows g and
    # g + 8 (elements 0, 1 and 2, 3); the per-chain pass takes chain cc of
    # the warp at c0 + cc and its β row at 16 warp + cc
    seen = np.zeros(padded, int)
    for b in range(blocks):
        for w in range(WARPS):
            c0 = b * BLOCK + PER_WARP * w
            rows = {r for lane in range(32)
                    for r, _ in _c_pos(*divmod(lane, 4))}
            assert rows == set(range(PER_WARP))
            for r in rows:
                chain = c0 + r
                seen[chain] += 1
                assert chain - b * BLOCK == PER_WARP * w + r   # its β row
    assert (seen == 1).all()
    assert int((np.arange(padded) < chains).sum()) == chains

    # the gradient's C fragments over a warp's β rows, read back by the
    # per-chain pass: element k > 0 of chain cc's gradient is column k - 1
    grad = rng.normal(size=(BLOCK, 8 * ks))
    bs = np.full(BLOCK * stride, np.nan)
    for w in range(WARPS):
        rows = PER_WARP * w * stride                   # the warp's first row
        for lane in range(32):
            g, t = divmod(lane, 4)
            for nt in range(ks):
                acc = [grad[PER_WARP * w + r, 8 * nt + col]
                       for r, col in _c_pos(g, t)]
                k = 8 * nt + 2 * t
                bs[rows + g * stride + k] = acc[0]
                bs[rows + g * stride + k + 1] = acc[1]
                bs[rows + (g + 8) * stride + k] = acc[2]
                bs[rows + (g + 8) * stride + k + 1] = acc[3]
    for cb in range(BLOCK):
        got = [bs[cb * stride + k - 1] for k in range(1, dim)]
        np.testing.assert_array_equal(got, grad[cb, :p])
        # clear_pad zeroes columns p .. 8 ks - 1; 8 ks .. stride - 1 are
        # never written
        for lane in range(32):
            for k in range(p + lane, 8 * ks, 32):
                bs[cb * stride + k] = 0.0
        assert not bs[cb * stride + p:cb * stride + 8 * ks].any()
        assert np.isnan(bs[cb * stride + 8 * ks:(cb + 1) * stride]).all()

    # lp: lane c < 16 takes lp_g (c < 8) or lp_g8 from lane 4 (c & 7)
    lp_rows = rng.normal(size=PER_WARP)
    lp_g = [lp_rows[lane // 4] for lane in range(32)]
    lp_g8 = [lp_rows[lane // 4 + 8] for lane in range(32)]
    for lane in range(PER_WARP):
        src = 4 * (lane & 7)
        assert (lp_g[src] if lane < 8 else lp_g8[src]) == lp_rows[lane]

    # scratch: chain, vector, element at (chain * nvec + v) * dim + k, for
    # every chain of every block (a vector is one contiguous run of dim),
    # then a record of 16 scalars per chain, 16-byte aligned
    nvec = _n_vectors(max_depth)
    chain, v, k = np.meshgrid(np.arange(padded), np.arange(nvec),
                              np.arange(dim), indexing="ij")
    offsets = ((chain * nvec + v) * dim + k).ravel()
    records = padded * nvec * dim + RECORD * np.arange(padded)[:, None] \
        + np.arange(RECORD)[None]
    assert records[0, 0] % 4 == 0
    assert np.array_equal(np.concatenate([offsets, records.ravel()]),
                          np.arange(padded * (nvec * dim + RECORD)))
    assert offsets.size + records.size == _round_up(chains, BLOCK) * (
        (15 + 2 * max_depth) * dim + 16)
    ck = _n_vectors(0)                                  # kCk
    slots = np.arange(max_depth)
    assert ck + max_depth + slots.max() < nvec          # ck_cum's last slot

    # outputs: real chains only, at ((t * C + chain) * dim + k)
    t, chain, k = np.meshgrid(np.arange(T), np.arange(chains),
                              np.arange(dim), indexing="ij")
    assert np.array_equal(((t * chains + chain) * dim + k).ravel(),
                          np.arange(T * chains * dim))


def _mma_chains(a, b, chain):
    """`_mma_chain(a, b, "rna", chain, truncate=True)` of
    tests/test_torch_tf32_split.py with every k-step's products taken at
    once: a (m, K) · b (K, n)."""
    # K padded to whole chains: a padded k-step adds exact zeros, which
    # leave a float32 sum unchanged
    m, groups = a.shape[0], -(-a.shape[1] // (8 * chain))
    steps = groups * chain
    a = F.pad(a, (0, 8 * steps - a.shape[1]))
    b = F.pad(b, (0, 0, 0, 8 * steps - b.shape[0]))
    a_hi, a_lo = _split(a, "rna")
    b_hi, b_lo = _split(b, "rna")
    per_step = torch.stack([
        torch.einsum("msk,skn->smn", u.double().reshape(m, steps, 8),
                     v.double().reshape(steps, 8, -1))
        for u, v in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))], 1)
    per_step = per_step.reshape(groups, 3 * chain, m, -1)
    acc = torch.zeros(groups, m, per_step.shape[-1], dtype=torch.float64)
    for j in range(3 * chain):
        # float64 -> float32 toward zero: the low 29 mantissa bits cleared
        acc = ((acc + per_step[:, j]).view(torch.int64) & ~(2 ** 29 - 1)
               ).view(torch.float64)
    acc = acc.to(torch.float32)
    total = torch.zeros_like(acc[0])
    for part in acc:
        total = total + part
    return total


def test_vectorised_emulation_matches_the_loop():
    """The vectorised emulation gives `_mma_chain`'s float32 results."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(size=(16, 104)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(104, 40)), dtype=torch.float32)
    for chain in (2, 4):
        want = _mma_chain(a, b, "rna", chain, True)
        torch.testing.assert_close(_mma_chains(a, b, chain), want, rtol=0,
                                   atol=1e-5)


def _tf32_logistic_block(p):
    """The logistic block target with its likelihood evaluated as K2's warp
    tile evaluates it: both products 3xTF32 by k-steps of 8, product 1 in
    chains of two k-steps, product 2 in chains of one 32-row tile, each
    mma's sum truncated to float32, the chains added in float32."""
    k_pad = 8 * _ksteps(p)

    def fn(th, xt_m, y_m):
        ls = th[:, :1]
        inv_s2 = torch.exp(-2.0 * ls)
        beta = F.pad(th[:, 1:p + 1], (0, k_pad - p))
        x = F.pad(xt_m[1:p + 1].T, (0, k_pad - p))
        logits = _mma_chains(beta, x.T.contiguous(), 2)
        lik, resid = _epilogue(logits, y_m)
        g_data = _mma_chains(resid, x, TILE_ROWS // 8)[:, :p]
        beta_sq = torch.sum(th * th, 1, keepdim=True) - ls ** 2
        lp = -0.5 * ls ** 2 - 0.5 * beta_sq * inv_s2 - p * ls + lik[:, None]
        g = torch.zeros_like(th)
        g[:, :1] = -ls + beta_sq * inv_s2 - p
        g[:, 1:p + 1] = g_data - th[:, 1:p + 1] * inv_s2
        return lp, g

    return BlockTarget("logistic", fn, p=p)


def test_k2_tf32_leaf_agrees_with_float32():
    """64 chains of the 100-D model, T 4, max_depth 6: draws with the
    emulated 3xTF32 likelihood agree with float32 draws in n_steps, depth
    and diverged and in θ within 1e-3 at every transition, for a 0.99 share
    of the chains (the card's gate is 0.999 at 4096 chains)."""
    tgt, data = hierarchical_logistic_block(n=1000, p=99, d_pad=128,
                                            device="cpu")
    th0 = torch.as_tensor(
        0.05 * np.random.default_rng(0).normal(size=(64, 100)),
        dtype=torch.float32)
    th0[:, 0] = -0.7
    args = (th0, torch.full((100,), 0.02), 0.3, 3, data, 100, 4, 6, 64)
    f32 = k2.plain_fused_nuts(tgt, *args)
    tf32 = k2.plain_fused_nuts(_tf32_logistic_block(99), *args)
    same = ((f32[1] == tf32[1]) & (f32[2] == tf32[2])
            & (f32[3] == tf32[3])).all(0)
    close = same & ((f32[0] - tf32[0]).abs().amax((0, 2)) <= 1e-3)
    assert float(close.double().mean()) >= 0.99
    assert 3.0 <= float(f32[2].double().mean()) <= 5.0     # real trees
    assert not torch.equal(f32[0], tf32[0])                # not the same sums


# ------------------------------------------------------ the wide instance
W_KSTEPS = _constant("kWideKSteps", WIDE_SRC)
CHUNK = 8 * W_KSTEPS
W_STRIDE = CHUNK + 4                               # x_stride(kWideKSteps)
PANEL_TILES = _constant("kPanelTiles", WIDE_SRC)
PANEL_ROWS = PANEL_TILES * TILE_ROWS
RES_STRIDE = PANEL_ROWS + int(re.search(
    r"constexpr int kResStride = kPanelRows \+ (\d+);", WIDE_SRC).group(1))
K_THE, K_GE = 0, 2                                 # enum Vec: kThE, kGE
MAX_RANKS = _constant("kMaxRanks")                 # blocks per cluster
RANKS = (1, 2, 11, 12, MAX_RANKS)


def _walk_begin(gw, warps):
    """`walk_begin`: the row in its group of the first chain that warp gw
    of a cluster's `warps` walks (contiguous runs, in order)."""
    return BLOCK * gw // warps


def _rank_chains(ranks, rank):
    """The rows in its group of the chains rank `rank` walks, whose
    gradient and lp sums it takes."""
    return range(_walk_begin(WARPS * rank, WARPS * ranks),
                 _walk_begin(WARPS * (rank + 1), WARPS * ranks))


def _wide_bounds(p, n, ranks=1, rank=0):
    """The kernel's chunks (k0, n_ks = n_nt) and the panels (t0, nt_p) of
    rank `rank` of `ranks`: a contiguous range of ceil(n_tiles / ranks) row
    tiles, the last ranks fewer or none; every rank walks as many panels,
    at least one."""
    n_chunks = -(-p // CHUNK)
    n_tiles = -(-n // TILE_ROWS)
    per_rank = -(-n_tiles // ranks)
    begin = min(n_tiles, rank * per_rank)
    end = min(n_tiles, begin + per_rank)
    n_panels = max(1, -(-per_rank // PANEL_TILES))
    chunks = [(c * CHUNK, min(W_KSTEPS, (p - c * CHUNK + 7) // 8))
              for c in range(n_chunks)]
    panels = [(begin + q * PANEL_TILES,
               max(0, min(end, begin + q * PANEL_TILES + PANEL_TILES)
                   - begin - q * PANEL_TILES)) for q in range(n_panels)]
    return chunks, panels


def _stage_x(xt, n, p, k0, tile):
    """`stage_x`: warp w stages the chunk's columns w, w + kWarps, ..; lane
    l row j0 + l from x^T row 1 + k0 + k; rows past n and columns past p
    zero-filled. Returns the tile (kTileRows, W_STRIDE), NaN where never
    written, and how often each element was written."""
    j0 = tile * TILE_ROWS
    xs = np.full((TILE_ROWS, W_STRIDE), np.nan)
    writes = np.zeros((TILE_ROWS, W_STRIDE), int)
    for warp in range(WARPS):
        for lane in range(32):
            for k in range(warp, CHUNK, WARPS):
                ok = j0 + lane < n and k0 + k < p
                xs[lane, k] = xt[1 + k0 + k, j0 + lane] if ok else 0.0
                writes[lane, k] += 1
    return xs, writes


def _stage_beta(scratch, nvec, dim, p, k0):
    """`stage_beta`: warp w stages rows w, w + kWarps, .. (the block's
    chains) from their frontier θ at 1 + k0 + k, zero past p."""
    bs = np.full((BLOCK, W_STRIDE), np.nan)
    for warp in range(WARPS):
        for r in range(warp, BLOCK, WARPS):
            src = (r * nvec + K_THE) * dim + 1
            for lane in range(32):
                for k in range(lane, CHUNK, 32):
                    ok = k0 + k < p
                    bs[r, k] = scratch[src + k0 + k] if ok else 0.0
    return bs


def test_k2_dispatches_every_wider_p_to_the_wide_instance():
    """After the narrow instances (p <= 128) the dispatch returns the wide
    one, with no bound on p; the wide target keeps M⁻¹ out of shared
    memory and its shared memory fits two blocks on an H100 SM."""
    body = re.search(r"R dispatch\(.*?\n\}", SRC, re.S).group(0)
    assert body.rstrip("}").strip().endswith(
        "return f(WideLogisticTarget{d0, d1, n, p});")
    assert max(int(b) for b in re.findall(r"p <= (\d+)", body)) == 128
    wide = re.search(r"struct WideLogisticTarget \{(.*?)\n\};", SRC,
                     re.S).group(1)
    assert "kMInvShared = false" in wide and "kMinBlocks = 2" in wide
    assert "kCluster = true" in wide
    # the tiles, the panel's y, the partial lp of the group's chains, the
    # "done" flag
    floats = ((BLOCK + 2 * TILE_ROWS) * W_STRIDE + BLOCK * RES_STRIDE
              + PANEL_ROWS + BLOCK + 4)
    assert 2 * (4 * floats + 1024) <= 228 * 1024
    # ranks per cluster: a chain for every warp of a cluster, non-portable
    # above 8, at most 16 on an H100
    assert WARPS * MAX_RANKS <= BLOCK and MAX_RANKS <= 16


# Clusters of the wide instance the card holds at once, by ranks R: what
# cudaOccupancyMaxActiveClusters gives on an H100 SXM (132 SMs, two blocks
# of ~101 KB an SM); a cluster's blocks share one GPC, so the large sizes
# leave slots empty.
H100_RESIDENT = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30,
                 9: 23, 10: 21, 11: 16, 12: 16, 13: 14, 14: 14, 15: 14,
                 16: 14}


def _cluster_ranks(chains, n, resident=H100_RESIDENT):
    """`cluster_ranks`: of R up to kMaxRanks and one per row tile, the one
    with the fewest waves of clusters times row tiles a rank, the smallest
    on a tie. Returns (R, resident clusters)."""
    groups = max(1, -(-chains // BLOCK))
    tiles = -(-n // TILE_ROWS)
    best = None
    for r in range(1, max(1, min(MAX_RANKS, tiles)) + 1):
        if resident[r] == 0:
            continue
        cost = -(-groups // resident[r]) * max(1, -(-tiles // r))
        if best is None or cost < best[0]:
            best = (cost, r, resident[r])
    return best[1:]


def test_k2_wide_rank_choice():
    """On an H100: phase 10's 16 groups (C = 1024, n = 1000) take 11
    ranks of 3 row tiles, all 16 clusters at once (12 ranks cost the same
    with a rank that holds no tile; 16 would leave two groups for a second
    wave); four groups (the card test's 256 chains) take 13 ranks at 25
    row tiles (the last rank one tile) and 16 at 32; n = 97 (4 row tiles)
    4; n = 0 one; 64 groups seven (two waves of 5 tiles, tied with 16's
    five waves of 2); 512 groups (C = 32768) one, tied with two."""
    body = re.search(r"cudaError_t cluster_ranks\(.*?\n\}", SRC,
                     re.S).group(0)
    for line in ("std::min(kMaxRanks, row_tiles)",
                 "const int cost = (groups + resident - 1) / resident *",
                 "std::max(1, (row_tiles + r - 1) / r);",
                 "if (best_cost == 0 || cost < best_cost) {"):
        assert line in body, line
    assert _cluster_ranks(1024, 1000) == (11, 16)
    assert _cluster_ranks(256, 797) == (13, 14)
    assert _cluster_ranks(256, 1000) == (16, 14)
    assert _cluster_ranks(64, 1000) == (16, 14)
    assert _cluster_ranks(4096, 1000) == (7, 32)
    assert _cluster_ranks(256, 97) == (4, 62)
    assert _cluster_ranks(256, 0) == (1, 264)
    assert _cluster_ranks(32768, 1000) == (1, 264)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("p,n", [(129, 1000), (999, 1000), (2047, 1000),
                                 (999, 997), (200, 797), (200, 97),
                                 (200, 0)])
def test_k2_wide_chunks_panels_and_padding(p, n, ranks):
    """Every column lies in one chunk, whose k-steps reach p; every row
    tile in one panel of one rank, the ranks' ranges contiguous and in
    rank order, every rank with as many panels (at least one, also at
    n = 0), some ranks with fewer tiles or none where the ranges do not
    divide; each warp's staging covers the chunk's columns and β's rows
    once; the last chunk's β and x columns past p and the x rows past n
    read as zeros; the gradient's write-out covers every column < p of the
    group's chains once a chunk."""
    chunks, _ = _wide_bounds(p, n)
    cols = np.zeros(p, int)
    for k0, n_ks in chunks:
        assert 1 <= n_ks <= W_KSTEPS and k0 + 8 * n_ks >= min(p, k0 + CHUNK)
        cols[k0:min(p, k0 + CHUNK)] += 1
    assert np.all(cols == 1)
    if p == 129:
        assert chunks[-1] == (128, 1)          # one column in the last chunk
    if p == 999:
        assert chunks[-1] == (896, 13)         # columns 896..998
    n_tiles = -(-n // TILE_ROWS)
    by_rank = [_wide_bounds(p, n, ranks, r)[1] for r in range(ranks)]
    assert len({len(panels) for panels in by_rank}) == 1
    assert len(by_rank[0]) >= 1
    tiles = [t for panels in by_rank for t0, nt in panels
             for t in range(t0, t0 + nt)]
    assert tiles == list(range(n_tiles))       # once each, in rank order
    for panels in by_rank:
        t0s = [t0 for t0, _ in panels]
        assert t0s == list(range(t0s[0], t0s[0] + len(panels) * PANEL_TILES,
                                 PANEL_TILES))
    per_rank = [sum(nt for _, nt in panels) for panels in by_rank]
    assert max(per_rank) == -(-n_tiles // ranks)
    if (ranks, n) == (16, 797):
        # 25 tiles: ranks 0-11 take 2, rank 12 takes 1, ranks 13-15 none
        assert per_rank == [2] * 12 + [1] + [0] * 3
    if (ranks, n) == (16, 1000):
        assert per_rank == [2] * 16
    if (ranks, n) == (11, 1000):
        assert per_rank == [3] * 10 + [2]      # phase 10's split
    if (ranks, n) == (12, 1000):
        assert per_rank == [3] * 10 + [2, 0]
    if ranks == 16 and n == 97:
        assert per_rank == [1] * 4 + [0] * 12

    # the last chunk, the last row tile: staged from x^T as it lies
    dim = p + 1
    x, _ = _synthetic_data(max(n, 2), p)
    xt = np.zeros((-(-dim // 128) * 128, max(n, 2)))
    xt[1:dim] = x.T
    k0 = chunks[-1][0]
    tile = max(0, n_tiles - 1)
    xs, writes = _stage_x(xt, n, p, k0, tile)
    assert np.all(writes[:, :CHUNK] == 1) and np.all(writes[:, CHUNK:] == 0)
    j0 = tile * TILE_ROWS
    want = np.zeros((TILE_ROWS, CHUNK))
    rows = max(0, min(n, j0 + TILE_ROWS) - j0)
    want[:rows, :p - k0] = x[j0:j0 + rows, k0:p]
    np.testing.assert_array_equal(xs[:, :CHUNK], want)

    # β's last chunk from the frontiers in the scratch (other vectors NaN)
    nvec = _n_vectors(6)
    theta = np.random.default_rng(p).normal(size=(BLOCK, dim))
    scratch = np.full(BLOCK * nvec * dim, np.nan)
    for r in range(BLOCK):
        scratch[(r * nvec + K_THE) * dim:(r * nvec + K_THE + 1) * dim] = \
            theta[r]
    bs = _stage_beta(scratch, nvec, dim, p, k0)
    want = np.zeros((BLOCK, CHUNK))
    want[:, :p - k0] = theta[:, 1 + k0:dim]
    np.testing.assert_array_equal(bs[:, :CHUNK], want)

    # write-out: each rank's threads over the columns of the chains it
    # walks (e = tid, tid + kThreads, .. < span * kChunk)
    for k0, _ in chunks:
        out = np.zeros((BLOCK, dim), int)
        for rank in range(ranks):
            mine = _rank_chains(ranks, rank)
            e = np.arange(len(mine) * CHUNK)
            c, k = mine.start + e // CHUNK, e % CHUNK
            ok = k0 + k < p
            np.add.at(out, (c[ok], 1 + k0 + k[ok]), 1)
        assert np.all(out[:, 0] == 0)
        assert np.all(out[:, 1 + k0:1 + min(p, k0 + CHUNK)] == 1)
        assert out.sum() == BLOCK * (min(p, k0 + CHUNK) - k0)


def _wide_leaf_model(theta, xt, y, n, p, ranks=1, max_depth=6):
    """The wide likelihood's order of work in float64, group by group, on a
    cluster of `ranks`: β (every rank stages the whole group's) and x
    staged as above; in each rank, over its panels, stage A's chunks added
    into the panel's logits, the epilogue's masked rows, stage B's chunk
    sums over its tiles left as the rank's partial; then each rank adds
    every rank's partial in rank order (from 0) into the gradient vectors
    of the chains it walks (the first panel writes, later panels add); lp
    over each lane's panels, then over the lanes t in the kernel's xor
    order, then over the ranks in order. Returns (lp (C,), the gradient
    vectors (C, dim))."""
    c, dim = theta.shape
    nvec = _n_vectors(max_depth)
    chunks, _ = _wide_bounds(p, n)
    blocks = -(-c // BLOCK)
    scratch = np.zeros(blocks * BLOCK * nvec * dim)
    vec = scratch.reshape(blocks * BLOCK, nvec, dim)
    vec[:c, K_THE] = theta
    vec[:, K_GE] = np.nan
    lp = np.zeros(blocks * BLOCK)
    x_tiles = {}
    for b in range(blocks):
        blk = scratch[b * BLOCK * nvec * dim:(b + 1) * BLOCK * nvec * dim]
        betas = [_stage_beta(blk, nvec, dim, p, k0) for k0, _ in chunks]
        lp_rank = np.zeros((ranks, BLOCK))
        parts = {}                               # (panel, chunk): by rank
        for rank in range(ranks):
            _, panels = _wide_bounds(p, n, ranks, rank)
            lp_lane = np.zeros((BLOCK, 4))       # chain, lane t of its group
            for panel, (t0, nt_p) in enumerate(panels):
                res = np.zeros((BLOCK, RES_STRIDE))
                yp = np.zeros(PANEL_ROWS)
                for i in range(PANEL_ROWS):
                    row = t0 * TILE_ROWS + i
                    if i < nt_p * TILE_ROWS and row < n:
                        yp[i] = y[row]
                for ci, (k0, n_ks) in enumerate(chunks):
                    for i in range(nt_p):
                        if (ci, t0 + i) not in x_tiles:
                            x_tiles[ci, t0 + i] = _stage_x(xt, n, p, k0,
                                                           t0 + i)[0]
                        xs = x_tiles[ci, t0 + i]
                        cols = slice(0, 8 * n_ks)
                        part = betas[ci][:, cols] @ xs[:, cols].T  # (64, 32)
                        r = slice(TILE_ROWS * i, TILE_ROWS * (i + 1))
                        res[:, r] = part if ci == 0 else res[:, r] + part
                rows_left = n - t0 * TILE_ROWS
                for i in range(nt_p):
                    for j in range(4):
                        for t in range(4):
                            for r0 in (TILE_ROWS * i + 8 * j + 2 * t,
                                       TILE_ROWS * i + 8 * j + 2 * t + 1):
                                w = 1.0 if r0 < rows_left else 0.0
                                lg = res[:, r0]
                                lp_lane[:, t] += yp[r0] * lg \
                                    - w * np.logaddexp(0.0, lg)
                                res[:, r0] = yp[r0] - w / (1.0 + np.exp(-lg))
                for ci, (k0, n_ks) in enumerate(chunks):
                    acc = np.zeros((BLOCK, CHUNK))
                    for i in range(nt_p):
                        xs = x_tiles[ci, t0 + i]
                        r = slice(TILE_ROWS * i, TILE_ROWS * (i + 1))
                        acc[:, :8 * n_ks] += res[:, r] @ xs[:, :8 * n_ks]
                    parts.setdefault((panel, ci), []).append(acc)
            # lp_g += shfl_xor(lp_g, 1); lp_g += shfl_xor(lp_g, 2): lane 0
            s1 = lp_lane[:, [0, 1, 2, 3]] + lp_lane[:, [1, 0, 3, 2]]
            lp_rank[rank] = s1[:, 0] + s1[:, 2]
        # the rank-ordered sums, each rank over the chains it walks
        written = np.zeros((BLOCK, dim), int)
        for (panel, ci), by_rank in sorted(parts.items()):
            assert len(by_rank) == ranks
            k0 = chunks[ci][0]
            total = np.zeros((BLOCK, CHUNK))
            for part in by_rank:
                total = total + part
            for rank in range(ranks):
                cb = np.array(_rank_chains(ranks, rank))[:, None]
                k = np.arange(min(CHUNK, p - k0))[None]
                out = (cb * nvec + K_GE) * dim + 1 + k0 + k
                blk[out] = total[cb, k] if panel == 0 else \
                    blk[out] + total[cb, k]
                np.add.at(written, (np.broadcast_to(cb, out.shape),
                                    1 + k0 + k), 1)
        assert np.all(written[:, 1:] == len(parts) // len(chunks))
        total = np.zeros(BLOCK)
        for rank in range(ranks):
            total = total + lp_rank[rank]
        lp[b * BLOCK:(b + 1) * BLOCK] = total
    return lp[:c], vec[:c, K_GE].copy()


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("c,p,n", [(64, 129, 97), (70, 200, 300),
                                   (5, 260, 0), (16, 999, 40)])
def test_k2_wide_leaf_order_of_work_matches_the_function(c, p, n, ranks):
    """The wide leaf's tiling, staging, row split and rank-ordered sums in
    float64 agree with the direct function to 1e-12 of the largest
    magnitude: no element of the work is dropped or counted twice, at
    ragged C, p and n, one or several panels, ranks with uneven ranges or
    no tile, and n = 0. The prior completes it as the walk does (`grad`:
    element 0 from q, log σ and 1/σ², element k the data gradient the
    leaf left plus −θ_k/σ²), giving the block target's value+grad."""
    dim = p + 1
    d_pad = -(-dim // 128) * 128
    tgt, _ = hierarchical_logistic_block(n=max(n, 2), p=p, d_pad=d_pad,
                                         device="cpu")
    x, y = _synthetic_data(max(n, 2), p)
    xt = np.zeros((d_pad, max(n, 2)))
    xt[1:dim] = x.T
    theta = 0.1 * np.random.default_rng(c + p).normal(size=(c, dim))
    theta[:, 0] = -1.0
    lp_d, ge = _wide_leaf_model(theta, xt, y, n, p, ranks)
    assert np.all(np.isnan(ge[:, 0]))                 # element 0 untouched
    xn, yn = x[:n], y[:n]
    logits = theta[:, 1:] @ xn.T
    lp_ref = (yn * logits - np.logaddexp(0.0, logits)).sum(1)
    g_ref = (yn - 1.0 / (1.0 + np.exp(-logits))) @ xn
    scale = max(1.0, np.abs(lp_ref).max())
    assert np.abs(lp_d - lp_ref).max() <= 1e-12 * scale
    gscale = max(1.0, np.abs(g_ref).max())
    assert np.abs(ge[:, 1:] - g_ref).max() <= 1e-12 * gscale

    # the walk's completion against the block target (float64 data)
    if n > 1:
        ls = theta[:, 0]
        inv_s2 = np.exp(-2.0 * ls)
        q = (theta ** 2).sum(1)
        beta_sq = q - ls * ls
        lp = -0.5 * ls * ls - 0.5 * beta_sq * inv_s2 - p * ls + lp_d
        g = np.empty_like(theta)
        g[:, 0] = -ls + (q - ls * ls) * inv_s2 - p
        g[:, 1:] = ge[:, 1:] + (-theta[:, 1:] * inv_s2[:, None])
        th_pad = torch.zeros(c, d_pad, dtype=torch.float64)
        th_pad[:, :dim] = torch.as_tensor(theta)
        lp_b, g_b = tgt(th_pad, torch.as_tensor(xt),
                        torch.as_tensor(y[None]))
        np.testing.assert_allclose(lp, lp_b[:, 0].numpy(), rtol=1e-10)
        np.testing.assert_allclose(g, g_b[:, :dim].numpy(), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("ranks", range(1, MAX_RANKS + 1))
def test_k2_cluster_walk_and_counter_indices(ranks, chains=1000, dim=1000,
                                             block_chains=256, seed=12):
    """The kWarps·R warps of a cluster walk its group's 64 chains in
    contiguous runs: every chain by exactly one warp, which belongs to the
    rank whose stage-B and lp sums take that chain, one or two chains a
    warp from R = 8 on; lane c of a warp receives the lp of the c-th chain
    it walks. A chain's counter indices (its row, its block's base, the
    momentum lanes row·Dp + k) come from its index in the launch alone, so
    they are those of the one-block design and of the plain twin."""
    for line in (
            "const int group = blockIdx.x / ranks;",
            "const int gw = kWarps * rank + warp;",
            "const int cb0 = Target::kCluster ? walk_begin(gw, kWarps * ranks)",
            "? walk_begin(gw + 1, kWarps * ranks) - cb0",
            "const int c0 = group * kChains + cb0;",
            "scratch + (size_t)(gridDim.x / ranks) * kChains * nvec * dim) + c0;",
            "return kChains * gw / warps;",
            "const int first = walk_begin(kWarps * rank, kWarps * ranks);",
            "const int span = walk_begin(kWarps * (rank + 1), kWarps * ranks) "
            "- first;",
            "const int wb = walk_begin(gw, kWarps * ranks);",
            "return lane < walk_begin(gw + 1, kWarps * ranks) - wb",
            "? rank_sum(cluster, part_lp + wb + lane, ranks)",
            "const int c = first + e / kChunk, k = e % kChunk;",
            "return (uint32_t)((c0 + c) % block_chains);",
            "return seed * 7919u + (uint32_t)((c0 + c) / block_chains) * "
            "104729u;"):
        assert line in SRC, line
    groups, warps = -(-chains // BLOCK), WARPS * ranks
    dp = _round_up(dim, 128)
    walker = {}
    for g in range(groups):
        for rank in range(ranks):
            mine = _rank_chains(ranks, rank)
            for w in range(WARPS):
                gw = WARPS * rank + w
                cb0 = _walk_begin(gw, warps)
                cpw = _walk_begin(gw + 1, warps) - cb0
                assert 1 <= cpw <= -(-BLOCK // warps)
                assert ranks < 8 or cpw <= 2
                c0 = g * BLOCK + cb0
                for c in range(cpw):
                    assert cb0 + c in mine       # summed by the walking rank
                    row = (c0 + c) % block_chains
                    base = (seed * 7919 + (c0 + c) // block_chains
                            * 104729) % 2 ** 32
                    assert c0 + c not in walker
                    walker[c0 + c] = (row, base, row * dp + np.arange(dim))
    assert sorted(walker) == list(range(groups * BLOCK))
    # the one-block design (block b, warp w, its chain c of 16) and the
    # plain twin's stream for the same chains
    for b in range(groups):
        for w in range(WARPS):
            for c in range(PER_WARP):
                chain = b * BLOCK + PER_WARP * w + c
                row, base, lanes = walker[chain]
                assert row == chain % block_chains
                assert base == int(rng_base(seed, torch.tensor(
                    chain // block_chains)))
                np.testing.assert_array_equal(
                    lanes, (chain % block_chains) * dp + np.arange(dim))

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
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from advancedhmc_torch.models.logistic import hierarchical_logistic_block
from advancedhmc_torch.ops import fused_nuts_kernel as k2
from advancedhmc_torch.ops.counter_rng import _round_up
from advancedhmc_torch.target import BlockTarget
from test_torch_tf32_split import TILE_ROWS, _c_pos, _epilogue, \
    _mma_chain, _split

torch.set_num_threads(2)

SRC = (Path(k2.__file__).resolve().parent.parent / "csrc" /
       "fused_nuts.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


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

"""The numerics of K1's tensor-core design, emulated on the CPU.

K1 (`advancedhmc_torch/csrc/fused_logistic.cu`, warp tile in
`csrc/logistic_tile.cuh`) computes both of its products on the tensor cores
in TF32 with the 3xTF32 split: a = a_hi + a_lo, a_hi = tf32(a),
a_lo = tf32(a − a_hi), and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi summed in
float32. These tests emulate TF32 rounding in torch (through an int32 view
of float32: 10 mantissa bits, the low 13 bits zero) and hold the design
against float64 on the 100-D model's synthetic design (n = 1000, p = 99) at
64 chains drawn as 0.3·N(0, 1) from a numpy seed, with the gate that
`chip_smoke.py` phase 2 applies on the card: 1e-4 × max|grad| and
1e-4 × max(1, max|lp|).

Why three products: one TF32 product (each operand rounded to 11
significant bits) misses the gradient gate on these inputs, by about 2×
(max error 4.3e-2 against a gate of 2.1e-2, and 0.153 on lp against
0.167); the 3xTF32 split stays at float32's error (6.1e-5 against 5.0e-5).

Why short accumulation chains: the tensor cores truncate, not round,
where they add into the float32 accumulator. Modelled as one truncation of
each mma's exact sum, a single chain through all of n drifts to 1.8e-3 on
this gradient (1.7e-3 was measured on an H100); the kernel's chains (two
k-steps in product 1, one 32-row tile in product 2, each added into a
float32 sum) stay within 2× of float32.

The last test walks the kernel's fragment index arithmetic (mma.m16n8k8
.tf32 layouts from the PTX ISA) lane by lane, to show that product 1's
accumulator is product 2's A operand as the header says.
"""

import numpy as np
import pytest
import torch

from advancedhmc_torch.models.logistic import _synthetic_data
from advancedhmc_torch.ops.fused_logistic import plain_logistic_value_grad

N_ROWS, P, CHAINS = 1000, 99, 64
K_PAD = 104                       # p padded to 13 k-steps of 8
GATE = 1e-4                       # chip_smoke.py phase 2's relative gate
TILE_ROWS = 32                    # logistic_tile.cuh kTileRows


def _tf32(x, mode="rna"):
    """x (float32) rounded to TF32: to nearest at 10 mantissa bits, ties
    away from zero (`rna`, the kernel's rounding) or to even (`rne`)."""
    b = x.contiguous().view(torch.int32)
    if mode == "rna":
        b = b + 0x1000
    else:
        b = b + 0xFFF + ((b >> 13) & 1)
    return (b & ~0x1FFF).view(torch.float32)


def _split(x, mode):
    hi = _tf32(x, mode)
    return hi, _tf32(x - hi, mode)


def _trunc32(x64):
    """float64 → float32 rounded toward zero."""
    f = x64.to(torch.float32)
    over = f.double().abs() > x64.abs()
    return torch.where(over, (f.view(torch.int32) - 1).view(torch.float32), f)


def _mma_chain(a, b, mode, chain, truncate):
    """a (m, K) · b (K, n) in 3xTF32, by k-steps of 8: `chain` k-steps run
    on one accumulator from zero (each mma's exact sum rounded to float32,
    or truncated as the tensor cores do), and the chains are added in
    float32. chain=None: one chain through all of K."""
    k_steps = range(0, a.shape[1], 8)
    chain = chain or len(k_steps)
    total = torch.zeros(a.shape[0], b.shape[1])
    a_hi, a_lo = _split(a, mode)
    b_hi, b_lo = _split(b, mode)
    rnd = _trunc32 if truncate else (lambda v: v.to(torch.float32))
    for c0 in range(0, len(k_steps), chain):
        acc = torch.zeros_like(total)
        for k0 in list(k_steps)[c0:c0 + chain]:
            s = slice(k0, k0 + 8)
            for u, v in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                acc = rnd(acc.double() + u[:, s].double() @ v[s].double())
        total = total + acc
    return total


def _epilogue(logits, y):
    """The kernel's epilogue: one e = exp(−|l|) for softplus and sigmoid."""
    e = torch.exp(-logits.abs())
    softplus = logits.clamp(min=0) + torch.log1p(e)
    inv = 1.0 / (1.0 + e)
    sig = torch.where(logits >= 0, inv, e * inv)
    return (y * logits - softplus).sum(1), y - sig


def _k1(theta, x, y, product):
    """K1's function with both products done by `product(a, b)` on the
    padded operands (β (C, 104), x (n, 104))."""
    beta = torch.nn.functional.pad(theta[:, 1:], (0, K_PAD - P))
    xp = torch.nn.functional.pad(x, (0, K_PAD - P))
    lp, resid = _epilogue(product(beta, xp.T.contiguous(), "logits"), y)
    g = product(resid, xp, "grad")[:, :P]
    return lp, torch.cat([torch.zeros_like(lp[:, None]), g], 1)


@pytest.fixture(scope="module")
def inputs():
    x, y = _synthetic_data(N_ROWS, P)
    theta = 0.3 * np.random.default_rng(0).normal(size=(CHAINS, P + 1))
    t = [torch.tensor(a, dtype=torch.float32) for a in (theta, x, y)]
    ref = plain_logistic_value_grad(*(a.double() for a in t))
    return t, ref


def _errors(out, ref):
    return (float((out[0].double() - ref[0]).abs().max()),
            float((out[1].double() - ref[1]).abs().max()))


def _gates(ref):
    return (GATE * max(1.0, float(ref[0].abs().max())),
            GATE * float(ref[1].abs().max()))


@pytest.mark.parametrize("mode", ["rna", "rne"])
def test_tf32_rounding(mode):
    """10 mantissa bits, the low 13 zero, relative error ≤ 2^-11, and the
    tie 1 + 2^-11 resolved by the mode."""
    x = torch.tensor(np.random.default_rng(1).normal(size=4096),
                     dtype=torch.float32) * 100
    r = _tf32(x, mode)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - x) / x).abs().max()) <= 2.0 ** -11
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    want = 1 + 2.0 ** -10 if mode == "rna" else 1.0
    assert _tf32(tie, mode).tolist() == [want, -want]


@pytest.mark.parametrize("mode", ["rna", "rne"])
def test_3xtf32_logistic_within_gate(inputs, mode):
    """The 3xTF32 split at float32 accuracy: within phase 2's gate against
    float64, and within 10× the error of plain float32."""
    (theta, x, y), ref = inputs
    out = _k1(theta, x, y, lambda a, b, _: _mma_chain(
        a, b, mode, chain=None, truncate=False))
    err_lp, err_g = _errors(out, ref)
    gate_lp, gate_g = _gates(ref)
    f32_lp, f32_g = _errors(plain_logistic_value_grad(theta, x, y), ref)
    assert err_g <= gate_g and err_lp <= gate_lp
    assert err_g <= 10 * f32_g and err_lp <= 10 * max(f32_lp, 1e-6)


def test_single_tf32_misses_the_gate(inputs):
    """One TF32 product, the reason for three: the gradient's error is
    above phase 2's gate."""
    (theta, x, y), ref = inputs

    def one_product(a, b, _):
        return _tf32(a) @ _tf32(b)

    err_lp, err_g = _errors(_k1(theta, x, y, one_product), ref)
    assert err_g > _gates(ref)[1]


def test_truncating_accumulation_needs_short_chains(inputs):
    """With a truncating accumulator, one chain per product drifts by more
    than 10× float32's error; the kernel's chains (2 k-steps of product 1,
    one tile of product 2) stay within 10× of it, and inside the gate."""
    (theta, x, y), ref = inputs
    f32_lp, f32_g = _errors(plain_logistic_value_grad(theta, x, y), ref)

    def run(chains):
        return _errors(_k1(theta, x, y, lambda a, b, which: _mma_chain(
            a, b, "rna", chain=chains[which], truncate=True)), ref)

    long_lp, long_g = run({"logits": None, "grad": None})
    short_lp, short_g = run({"logits": 2, "grad": TILE_ROWS // 8})
    assert long_g > 10 * f32_g
    assert short_g <= 10 * f32_g and short_lp <= 10 * max(f32_lp, 1e-6)
    gate_lp, gate_g = _gates(ref)
    assert short_g <= gate_g and short_lp <= gate_lp


# --- the warp tile's fragment index arithmetic, lane by lane -------------
# mma.m16n8k8 .tf32 (PTX ISA), lane = 4g + t: element i of a fragment sits
# at (row, column) of its matrix.
def _a_pos(g, t):
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


def _b_pos(g, t):
    return [(t, g), (t + 4, g)]


def _c_pos(g, t):
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


def _mma(acc, a_frag, b_frag):
    """One mma.m16n8k8 from per-lane fragments (lists of 32 lanes)."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for v, pos in zip(a_frag[lane], _a_pos(g, t)):
            a[pos] = v
        for v, pos in zip(b_frag[lane], _b_pos(g, t)):
            b[pos] = v
    d = a @ b
    return [[acc[lane][i] + d[p] for i, p in enumerate(_c_pos(*divmod(
        lane, 4)))] for lane in range(32)]


@pytest.mark.parametrize("rows", [TILE_ROWS, 19])
def test_warp_tile_fragments(rows):
    """One warp tile (16 chains, a staged tile of 32 rows, p = 13 in two
    k-steps) with the kernel's shared-memory addresses and fragment orders:
    product 1's accumulator of n-tile j, read in the order (0, 2, 1, 3), is
    product 2's A operand at k-step j, and the tile's logits, lp and
    gradient equal the plain products (float64, no split). `rows` < 32 is a
    ragged last tile."""
    rng = np.random.default_rng(2)
    p, k_steps = 13, 2
    stride = 36                            # x_stride(2): >= 16, 4 mod 32
    bs = np.zeros((16, stride))
    bs[:, :p] = 0.3 * rng.normal(size=(16, p))
    xs = np.zeros((TILE_ROWS, stride))
    xs[:rows, :p] = rng.normal(size=(rows, p))
    ys = np.zeros(TILE_ROWS)
    ys[:rows] = rng.integers(0, 2, rows)
    bs_f, xs_f = bs.ravel(), xs.ravel()
    zero = [[0.0] * 4 for _ in range(32)]

    # product 1, n-tile j: A from bs at (g | g+8, 8ks + t | +4), B from xs
    # at (row 8j + g, column 8ks + t | +4)
    logit = []
    for j in range(TILE_ROWS // 8):
        acc = zero
        for ks in range(k_steps):
            a = [[bs_f[(g + dg) * stride + 8 * ks + t + dk]
                  for dg, dk in ((0, 0), (8, 0), (0, 4), (8, 4))]
                 for g, t in map(lambda ln: divmod(ln, 4), range(32))]
            b = [[xs_f[(8 * j + g) * stride + 8 * ks + t + dk]
                  for dk in (0, 4)]
                 for g, t in map(lambda ln: divmod(ln, 4), range(32))]
            acc = _mma(acc, a, b)
        logit.append(acc)

    # epilogue and product 2: rows r0 = 8j + 2t (elements 0, 2), r0 + 1
    # (elements 1, 3); B from xs at (row r0 | r0 + 1, column 8nt + g)
    grad = [zero for _ in range(k_steps)]
    lp = np.zeros(16)
    logits = np.zeros((16, TILE_ROWS))
    for j in range(TILE_ROWS // 8):
        r_frag = []
        for lane in range(32):
            g, t = divmod(lane, 4)
            r0 = 8 * j + 2 * t
            res = []
            for i in (0, 2, 1, 3):
                row = r0 + (i & 1)
                chain = g + (8 if i >= 2 else 0)
                l = logit[j][lane][i]
                logits[chain, row] = l
                w = 1.0 if row < rows else 0.0
                lp[chain] += ys[row] * l - w * np.logaddexp(0.0, l)
                res.append(ys[row] - w / (1.0 + np.exp(-l)))
            r_frag.append(res)
        for nt in range(k_steps):
            b = [[xs_f[(8 * j + 2 * t + dr) * stride + 8 * nt + g]
                  for dr in (0, 1)]
                 for g, t in map(lambda ln: divmod(ln, 4), range(32))]
            grad[nt] = _mma(grad[nt], r_frag, b)

    g_out = np.zeros((16, 8 * k_steps))
    for nt in range(k_steps):
        for lane in range(32):
            for v, (c, k) in zip(grad[nt][lane], _c_pos(*divmod(lane, 4))):
                g_out[c, 8 * nt + k] = v

    want_logits = bs[:, :p] @ xs[:, :p].T
    w = (np.arange(TILE_ROWS) < rows).astype(float)
    want_lp = (ys * want_logits - w * np.logaddexp(0.0, want_logits)).sum(1)
    resid = ys - w / (1.0 + np.exp(-want_logits))
    np.testing.assert_allclose(logits, want_logits, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lp, want_lp, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g_out[:, :p], resid @ xs[:, :p], rtol=0,
                               atol=1e-12)
    assert not g_out[:, p:].any()


def _narrow_bsq(beta32):
    """Σ β_k² as the narrow kernel sums it for one chain, in float32: lane l
    of the warp adds columns l, l + 32, ... (each square added by one fma),
    then the lanes add in a butterfly of shuffles (xor 16, 8, 4, 2, 1)."""
    lanes = np.zeros(32, np.float32)
    for k, b in enumerate(beta32):
        lanes[k % 32] = np.float32(np.float64(lanes[k % 32])
                                   + np.float64(b) * np.float64(b))
    o = 16
    while o:
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
        o //= 2
    assert np.all(lanes == lanes[0])      # every lane holds the same bits
    return lanes[0]


@pytest.mark.parametrize("p", [24, 99, 128])
def test_narrow_prior_terms_in_float32(p):
    """The narrow instances' prior (`prior_of` after the warp's sum of β²,
    every product and sum rounded once in float32, as the kernel writes
    them) against the model's float64 prior: within float32's error, far
    inside the card's gate, at each instance's width; and the terms of the
    block's 64 chains fit in the x buffers' spare columns of every
    instance."""
    import re
    from pathlib import Path

    from advancedhmc_torch.models.logistic import _prior

    src = (Path(__file__).resolve().parent.parent / "advancedhmc_torch" /
           "csrc" / "fused_logistic.cu").read_text()
    k_max = re.search(r"constexpr int kMaxKSteps = (\d+);", src).group(1)
    ksteps = [int(k_max if k == "kMaxKSteps" else k)
              for k in re.findall(r"\{(\w+), prepare<", src)]
    assert ksteps == [4, 8, 13, 16]
    for k in ksteps:             # 2 · kTileRows rows of x_stride floats
        assert 2 * TILE_ROWS * (8 * k + 4) >= 64 * 8 * k + 64 * 3
    theta = (0.3 * np.random.default_rng(p).normal(size=(16, p + 1))
             ).astype(np.float32)
    theta[:, 0] -= 0.7
    f = np.float32
    lp_ref, g_ref = (t.numpy() for t in _prior(
        torch.as_tensor(theta, dtype=torch.float64), p))
    for c in range(theta.shape[0]):
        ls, beta = theta[c, 0], theta[c, 1:]
        bsq = _narrow_bsq(beta)
        inv = f(np.exp(f(-2.0) * ls))
        t = f(bsq * inv)
        lp = f(f(f(-0.5) * f(ls * ls)) - f(f(0.5) * t)) - f(f(p) * ls)
        g0 = f(f(-ls + t) - f(p))
        g = np.concatenate([[g0], (f(0.0) - (beta * inv)).astype(f)])
        assert abs(lp - lp_ref[c]) <= 1e-6 * abs(lp_ref[c])
        assert np.abs(g - g_ref[c]).max() <= 1e-6 * np.abs(g_ref[c]).max()

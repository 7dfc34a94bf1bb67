"""K2: the NUTS megakernel — T transitions of every chain in one launch.

Replaces the Pallas kernel `advancedhmc_tpu/ops/fused_nuts_kernel.py:105`
(`make_fused_nuts_kernel`; wrapper `fused_nuts_pallas` :417). Per chain it
computes the JAX kernel's function: iterative NUTS with one leaf per loop
iteration, multinomial reservoir and biased progressive sampling, the
generalised no-U-turn check over aligned spans with checkpoint stacks
`ck_r`/`ck_cum` of S = max_depth slots (slot tz(i), capped at S − 1),
divergence at ΔH ≥ 1000, diagonal M⁻¹, full momentum refresh at a fixed ε,
and the splitmix32 counter stream of `ops/counter_rng.py`. Like the JAX
kernel it keeps no acceptance statistic and does not adapt.

A chain's random stream depends only on the seed, its block
`chain // block_chains`, its row `chain % block_chains`, Dp = round_up(dim,
128) (the momentum draws' lane index is row·Dp + col) and its own leaf
count; chains are otherwise independent. So `block_chains` is a parameter
of the stream, and both versions here draw what the Pallas kernel draws:

* `plain_fused_nuts`, a batched twin of the Pallas body in PyTorch over the
  same padded layout (Cp = round_up(C, block_chains) chains, Dp columns,
  m_inv = 0 on padded dims), with every chain block in one batch. It drops
  the JAX carry's dead fields (the subtree's first leaf, the candidates'
  energies, the acceptance sum), which no output reads;
* the CUDA kernel `csrc/fused_nuts.cu`: 64 chains per thread block, 16 per
  warp, which walk their leaves in lock step. The logistic's value and
  gradient at each leaf run on the tensor cores: up to p = 128 through K1's
  warp tile (`csrc/logistic_tile.cuh`: 3xTF32 `mma.sync`, 32-row design
  tiles staged by `cp.async` and shared by the block), at any wider p
  through the column-tiled stages of K1's wide kernel
  (`csrc/logistic_wide_tile.cuh`: chunks of 128 columns, row panels whose
  logits stay in shared memory), with each group of 64 chains owned by a
  thread-block cluster whose ranks split the rows and walk the chains
  (`fused_nuts_cluster_shape` gives the ranks the card takes for a call's
  shape). The tree state lies in a device scratch
  buffer that the wrapper allocates, one contiguous run of
  15 + 2·max_depth vectors per chain. The target is compiled in: a
  `BlockTarget` of kind "logistic" (`models.logistic.
  hierarchical_logistic_block`, any p) or "gaussian" (`models.gaussian`).

`fused_nuts` dispatches on the device of θ₀: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. `fused_nuts.launches`
counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trailing_ones, trailing_zeros
from . import _build
from .counter_rng import (
    _round_up,
    exponential_at,
    normal_at,
    rng_base,
    uniform_at,
)

_LIB = "fused_nuts"
MAX_DEPTH = 10              # the CUDA kernel takes max_depth 1..10
DELTA_MAX = 1000.0
_KINDS = {"logistic": 0, "gaussian": 1}


def plain_fused_nuts(target, theta0, m_inv, eps, seed, data, dim,
                     n_transitions=16, max_depth=8, block_chains=256):
    """The megakernel's function in plain PyTorch, on θ₀'s device.

    Returns (thetas (T, C, dim), n_steps (T, C), depth (T, C), diverged
    (T, C) bool), as `fused_nuts_pallas` does."""
    c, d = theta0.shape
    if d != dim:
        raise ValueError(f"theta0 has {d} columns, dim is {dim}")
    dev, f32, i32 = theta0.device, torch.float32, torch.int32
    dp, cp = _round_up(d, 128), _round_up(c, block_chains)
    S, K, T = max_depth, max_depth - 1, n_transitions

    th0 = torch.zeros(cp, dp, dtype=f32, device=dev)
    th0[:c, :d] = theta0
    mi = torch.zeros(1, dp, dtype=f32, device=dev)
    mi[0, :d] = torch.as_tensor(m_inv, dtype=f32, device=dev)
    eps = torch.tensor(float(eps), dtype=f32, device=dev)
    chain = torch.arange(cp, device=dev)
    base = rng_base(seed, chain // block_chains)[:, None]       # (Cp, 1)
    row = (chain % block_chains)[:, None]                      # (Cp, 1)
    lane = row * dp + torch.arange(dp, device=dev)[None]       # (Cp, Dp)

    sqrt_m = torch.sqrt(mi)
    inv_sqrt_m_inv = torch.where(
        mi > 0, 1.0 / torch.clamp(sqrt_m, min=1e-30), torch.zeros_like(mi))
    neg_inf = float("-inf")

    def vg(th):
        return target(th, *data)

    def rand_momentum(ctr, salt):
        return normal_at(base + ctr, lane, salt) * inv_sqrt_m_inv

    def neg_kin(r):
        return -0.5 * torch.sum(r * r * mi, 1, keepdim=True)

    # ---- initial transition state ----
    lp0, g0 = vg(th0)
    r0 = rand_momentum(0, 1)
    h0 = -(lp0 + neg_kin(r0))
    zeros_bd = torch.zeros_like(th0)
    izeros = torch.zeros(cp, 1, dtype=i32, device=dev)
    bzeros = torch.zeros(cp, 1, dtype=torch.bool, device=dev)
    th_e, r_e, g_e = th0, r0, g0
    th_l, r_l, g_l = th0, r0, g0
    th_r, r_r, g_r = th0, r0, g0
    th_c, lp_c, g_c = th0, lp0, g0
    th_sc, lp_sc, g_sc = th0, lp0, g0
    rho_t, rho_s = r0, zeros_bd
    ck_r = torch.zeros(cp, S, dp, dtype=f32, device=dev)
    ck_cum = torch.zeros_like(ck_r)
    t_w = torch.zeros(cp, 1, dtype=f32, device=dev)
    s_w = torch.full((cp, 1), neg_inf, dtype=f32, device=dev)
    n_alpha, depth, leaf, t = izeros, izeros, izeros, izeros
    v = izeros + 1
    diverged, all_done = bzeros, bzeros
    slots = torch.arange(S, device=dev)
    # one spare row: chains that record nothing write there
    out_theta = torch.zeros(cp, T + 1, dp, dtype=f32, device=dev)
    out_int = torch.zeros(cp, T + 1, 3, dtype=i32, device=dev)

    max_iters = T * (2 ** S) + 16
    it = 0
    while it < max_iters and not bool(all_done.all()):
        ctr = base + (it + 1)
        start = leaf == 0
        # direction
        u_dir = uniform_at(ctr, row, 2)
        v_draw = torch.where(u_dir < 0.5, -1, 1).to(i32)
        v = torch.where(start, v_draw, v)
        fwd = v > 0
        th_e = torch.where(start, torch.where(fwd, th_r, th_l), th_e)
        r_e = torch.where(start, torch.where(fwd, r_r, r_l), r_e)
        g_e = torch.where(start, torch.where(fwd, g_r, g_l), g_e)
        rho_s = torch.where(start, zeros_bd, rho_s)
        s_w = torch.where(start, neg_inf, s_w)

        # ---- one leapfrog step ----
        eps_s = eps * v.to(f32)
        r_half = r_e + 0.5 * eps_s * g_e
        th_n = th_e + eps_s * (r_half * mi)
        lp_n, g_n = vg(th_n)
        lp_n = torch.where(torch.isfinite(lp_n), lp_n, neg_inf)
        r_n = r_half + 0.5 * eps_s * g_n
        nk = neg_kin(r_n)
        nk = torch.where(torch.isfinite(nk), nk, neg_inf)
        h_n = -(lp_n + nk)
        dh = h_n - h0
        vel_n = r_n * mi
        i = leaf

        # multinomial leaf weight + reservoir
        lw_leaf = -dh
        new_sw = torch.logaddexp(s_w, lw_leaf)
        u_res = uniform_at(ctr, row, 3)
        take = torch.log(u_res) < lw_leaf - new_sw
        diverging = ~(dh < DELTA_MAX)
        s_w = new_sw
        th_sc = torch.where(take, th_n, th_sc)
        lp_sc = torch.where(take, lp_n, lp_sc)
        g_sc = torch.where(take, g_n, g_sc)
        rho_s = rho_s + r_n
        n_alpha = n_alpha + 1

        # ---- U-turn checks over aligned spans (k = 1..K) ----
        i_even = (i % 2) == 0
        tones = trailing_ones(i)
        s_turning = bzeros
        for k in range(1, K + 1):
            a = i - (1 << k) + 1
            active = ~i_even & (k <= tones) & (a >= 0)
            a_safe = torch.clamp(a, min=0)
            tz_a = trailing_zeros(torch.clamp(a_safe, min=1))
            slot = torch.where(a_safe == 0, S - 1,
                               torch.clamp(tz_a, max=S - 1))
            at = slot.long()[:, :, None].expand(cp, 1, dp)
            r_a = ck_r.gather(1, at)[:, 0]
            cum_a = ck_cum.gather(1, at)[:, 0]
            rho_span = rho_s - cum_a + r_a
            d1 = torch.sum(rho_span * (r_a * mi), 1, keepdim=True)
            d2 = torch.sum(rho_span * vel_n, 1, keepdim=True)
            s_turning = s_turning | (active & ((d1 <= 0) | (d2 <= 0)))
        s_diverged = diverging

        # ---- store checkpoints (even leaves) ----
        tz_i = torch.where(i == 0, S - 1,
                           torch.clamp(trailing_zeros(torch.clamp(i, min=1)),
                                       max=S - 1))
        store = ((slots[None] == tz_i) & i_even)[:, :, None]     # (Cp, S, 1)
        ck_r = torch.where(store, r_n[:, None], ck_r)
        ck_cum = torch.where(store, rho_s[:, None], ck_cum)

        # ---- doubling complete? ----
        n_leaves = torch.bitwise_left_shift(torch.ones_like(depth), depth)
        sub_done = s_turning | s_diverged
        complete = sub_done | (i >= n_leaves - 1)
        not_term = ~sub_done

        # biased progressive sampling
        e_mh = exponential_at(ctr, row, 4)
        acc = complete & not_term & (t_w < s_w + e_mh)
        th_c = torch.where(acc, th_sc, th_c)
        lp_c = torch.where(acc, lp_sc, lp_c)
        g_c = torch.where(acc, g_sc, g_c)

        # combined tree: the doubling's far edge is the new leaf
        c_th_l = torch.where(fwd, th_l, th_n)
        c_r_l = torch.where(fwd, r_l, r_n)
        c_g_l = torch.where(fwd, g_l, g_n)
        c_th_r = torch.where(fwd, th_n, th_r)
        c_r_r = torch.where(fwd, r_n, r_r)
        c_g_r = torch.where(fwd, g_n, g_r)
        c_rho = rho_t + rho_s
        fl = torch.sum(c_rho * (c_r_l * mi), 1, keepdim=True) <= 0
        fr = torch.sum(c_rho * (c_r_r * mi), 1, keepdim=True) <= 0
        full_turn = fl | fr
        c_w = torch.logaddexp(t_w, s_w)
        depth_new = depth + (complete & not_term).to(i32)
        diverged_new = diverged | (complete & s_diverged)
        done_new = (complete & (sub_done | full_turn)) | (depth_new >= S)

        th_e, r_e, g_e = th_n, r_n, g_n
        th_l = torch.where(complete, c_th_l, th_l)
        r_l = torch.where(complete, c_r_l, r_l)
        g_l = torch.where(complete, c_g_l, g_l)
        th_r = torch.where(complete, c_th_r, th_r)
        r_r = torch.where(complete, c_r_r, r_r)
        g_r = torch.where(complete, c_g_r, g_r)
        rho_t = torch.where(complete, c_rho, rho_t)
        t_w = torch.where(complete, c_w, t_w)
        s_w = torch.where(complete, neg_inf, s_w)
        leaf = torch.where(complete, 0, i + 1).to(i32)

        # ---------- transition boundary ----------
        boundary = done_new & ~all_done
        t_new = t + boundary.to(i32)
        finished = t_new >= T
        # record at slot t when the boundary fires
        rec = torch.where(boundary, t, T).long()[:, :, None]
        out_theta.scatter_(1, rec.expand(cp, 1, dp), th_c[:, None])
        out_int.scatter_(1, rec.expand(cp, 1, 3), torch.stack(
            [n_alpha, depth_new, diverged_new.to(i32)], -1))

        # fresh transition from the candidate with refreshed momentum
        r_new0 = rand_momentum(it + 1, 5)
        h0_new = -(lp_c + neg_kin(r_new0))
        reset = boundary & ~finished
        th_e = torch.where(reset, th_c, th_e)
        r_e = torch.where(reset, r_new0, r_e)
        g_e = torch.where(reset, g_c, g_e)
        th_l = torch.where(reset, th_c, th_l)
        r_l = torch.where(reset, r_new0, r_l)
        g_l = torch.where(reset, g_c, g_l)
        th_r = torch.where(reset, th_c, th_r)
        r_r = torch.where(reset, r_new0, r_r)
        g_r = torch.where(reset, g_c, g_r)
        th_sc = torch.where(reset, th_c, th_sc)
        lp_sc = torch.where(reset, lp_c, lp_sc)
        g_sc = torch.where(reset, g_c, g_sc)
        rho_t = torch.where(reset, r_new0, rho_t)
        rho_s = torch.where(reset, zeros_bd, rho_s)
        h0 = torch.where(reset, h0_new, h0)
        t_w = torch.where(reset, 0.0, t_w)
        s_w = torch.where(reset, neg_inf, s_w)
        n_alpha = torch.where(reset, izeros, n_alpha)
        depth = torch.where(reset, izeros, depth_new)
        leaf = torch.where(reset, izeros, leaf)
        diverged = diverged_new & ~reset
        t = t_new
        all_done = all_done | finished
        it += 1

    return (out_theta[:c, :T, :d].transpose(0, 1).contiguous(),
            out_int[:c, :T, 0].T.contiguous(),
            out_int[:c, :T, 1].T.contiguous(),
            out_int[:c, :T, 2].T.contiguous().bool())


def _kernel(lib):
    fn = lib.fused_nuts_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_float, ctypes.c_uint32]
                       + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        lib.fused_nuts_chains_per_block.restype = ctypes.c_int
        lib.fused_nuts_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.fused_nuts_scratch_floats.restype = ctypes.c_size_t
        lib.fused_nuts_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.fused_nuts_smem_bytes.restype = ctypes.c_size_t
        lib.fused_nuts_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.fused_nuts_blocks_per_sm.restype = ctypes.c_int
        lib.fused_nuts_cluster_shape.argtypes = ([ctypes.c_int] * 4
                                                 + [ctypes.c_void_p] * 2)
        lib.fused_nuts_cluster_shape.restype = None
        lib.fused_nuts_sms_used.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.fused_nuts_sms_used.restype = ctypes.c_int
        lib.fused_nuts_error_string.argtypes = [ctypes.c_int]
        lib.fused_nuts_error_string.restype = ctypes.c_char_p
    return fn


def _check_inputs(target, theta0, m_inv, data, dim, max_depth):
    if target.kind not in _KINDS:
        raise ValueError(f"no CUDA kernel for a {target.kind!r} block target; "
                         f"the kernel has {sorted(_KINDS)}")
    if not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"max_depth {max_depth} is outside the kernel's "
                         f"1..{MAX_DEPTH}")
    for name, t in (("theta0", theta0), ("m_inv", m_inv)) + tuple(
            (f"data[{j}]", a) for j, a in enumerate(data)):
        if not t.is_cuda or t.device != theta0.device:
            raise ValueError(f"{name} must be on {theta0.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if theta0.dim() != 2 or theta0.shape[1] != dim or m_inv.shape != (dim,):
        raise ValueError(f"shapes theta0 {tuple(theta0.shape)}, m_inv "
                         f"{tuple(m_inv.shape)} do not fit (C, {dim}), "
                         f"({dim},)")
    if target.kind == "logistic":
        if len(data) != 2 or data[0].dim() != 2 or \
                data[0].shape[0] < dim or data[1].numel() != data[0].shape[1]:
            raise ValueError("the logistic block takes (xt (d_pad, n), "
                             "y (1, n)) with d_pad >= dim")
        if dim != target.p + 1:
            raise ValueError(f"the logistic block has p = {target.p}, so "
                             f"dim must be {target.p + 1}, got {dim}")
    elif len(data) != 1 or data[0].numel() < dim:
        raise ValueError("the Gaussian block takes (prec (1, Dp),)")


def _launch(lib, kind, theta0, m_inv, eps, seed, d0, d1, n, dim, T,
            max_depth, block_chains):
    """One call of `lib`'s kernel on CUDA tensors (d1 None for a target
    with one data tensor), not counted: (thetas (T, C, dim), stats (3, T,
    C) int32, the scratch it left)."""
    fn = _kernel(lib)
    dev, c = theta0.device, theta0.shape[0]
    thetas = torch.empty(T, c, dim, dtype=torch.float32, device=dev)
    stats = torch.empty(3, T, c, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.fused_nuts_scratch_floats(c, dim, max_depth),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(kind, theta0.data_ptr(), m_inv.data_ptr(), float(eps),
             int(seed) & 0xFFFFFFFF, block_chains, _round_up(dim, 128), c,
             dim, T, max_depth, d0.data_ptr(),
             None if d1 is None else d1.data_ptr(), n, scratch.data_ptr(),
             thetas.data_ptr(), stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("fused_nuts kernel launch failed: "
                           + lib.fused_nuts_error_string(err).decode())
    return thetas, stats, scratch


def _target_args(target, data):
    """The library's kind, second data tensor and row count of a target."""
    if target.kind == "logistic":
        return _KINDS[target.kind], data[1], data[0].shape[1]
    return _KINDS[target.kind], None, 0


def fused_nuts(target, theta0, m_inv, eps, seed, data, dim,
               n_transitions=16, max_depth=8, block_chains=256):
    """Run the NUTS megakernel over all chains: the counterpart of
    `fused_nuts_pallas`. `target` is a `BlockTarget`, `data` its data
    tensors, `theta0` (C, dim), `m_inv` (dim,). Returns (thetas (T, C,
    dim), n_steps (T, C), depth (T, C), diverged (T, C) bool)."""
    if theta0.device.type == "cpu":
        return plain_fused_nuts(target, theta0, m_inv, eps, seed, data, dim,
                                n_transitions, max_depth, block_chains)
    _check_inputs(target, theta0, m_inv, data, dim, max_depth)
    kind, d1, n = _target_args(target, data)
    thetas, stats, _ = _launch(_build.load(_LIB), kind, theta0, m_inv, eps,
                               seed, data[0], d1, n, dim, n_transitions,
                               max_depth, block_chains)
    fused_nuts.launches += 1
    return thetas, stats[0], stats[1], stats[2].bool()


fused_nuts.launches = 0


def sms_used(target, theta0, m_inv, eps, seed, data, dim, max_depth=8,
             block_chains=256):
    """The SMs that held a block of the wide logistic instance (p > 128,
    the one that records them) in one call of one transition on
    `fused_nuts`'s arguments (CUDA tensors). Not counted in
    `fused_nuts.launches`."""
    _check_inputs(target, theta0, m_inv, data, dim, max_depth)
    if target.kind != "logistic" or target.p <= 128:
        raise ValueError("only the wide logistic instance (p > 128) records "
                         "the SMs that held its blocks")
    kind, d1, n = _target_args(target, data)
    lib = _build.load(_LIB)
    _, _, scratch = _launch(lib, kind, theta0, m_inv, eps, seed, data[0],
                            d1, n, dim, 1, max_depth, block_chains)
    used = lib.fused_nuts_sms_used(theta0.shape[0], dim, max_depth,
                                   scratch.data_ptr())
    if used < 0:
        raise RuntimeError("fused_nuts: reading the chains' records failed")
    return used

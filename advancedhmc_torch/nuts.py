"""NUTS: iterative tree doubling over a batch of chains.

PyTorch counterpart of `advancedhmc_tpu/nuts.py` for the main path: the
generalised no-U-turn criterion, multinomial sampling, unit or diagonal M⁻¹
and full momentum refreshment. As in the JAX package the recursive
`build_tree` is flattened into a loop that takes ONE leapfrog step per
iteration, with the doubling bookkeeping done in O(max_depth) masked
arithmetic; here the loop is a Python `while` over the batched state
(chains on the leading axis) instead of a vmapped `lax.while_loop`.

Checkpoint stacks (see the JAX module docstring): the even-visit leaf i of a
doubling stores r_i and d_i = r_i − Σ_{j≤i} r_j at slot tz(i)−1 (the top
slot for i=0), plus the scalar dot(d_i, M⁻¹r_i). A U-turn check over the span
a..i then needs only dot products with the stored rows:
dot(ρ, M⁻¹r_a) = dot(M⁻¹ρ_sub, r_a) + dot(d_a, M⁻¹r_a) and
dot(ρ, M⁻¹r_i) = dot(ρ_sub, M⁻¹r_i) + dot(d_a, M⁻¹r_i), ρ_sub being the
running momentum sum of the current doubling. The stacks are updated in
place; they carry one spare slot that odd leaves write to, so the write is a
single scatter for every chain.
"""

from __future__ import annotations

import torch

from .hamiltonian import PhasePoint, select_phasepoint
from .integrators import leapfrog_step
from .termination import GeneralisedNoUTurn, MULTINOMIAL
from .utils import maxabs, rand_exponential, rand_sign, trailing_ones, \
    trailing_zeros

_LATER = "(ROADMAP.md section 1, item 11)"
# The fused loop reads its exit condition back to the host every this many
# iterations; the iterations run after every chain finished are masked
# no-ops, exactly as in the JAX batch loop.
_CHECK_EVERY = 4


def _check_trajectory(traj):
    if not isinstance(traj.criterion, GeneralisedNoUTurn) or \
            traj.ts_kind != MULTINOMIAL:
        raise NotImplementedError(
            "only the generalised criterion with multinomial sampling is "
            "ported " + _LATER)


def _sel(pred, a, b):
    if isinstance(a, PhasePoint):
        return select_phasepoint(pred, a, b)
    return torch.where(pred[:, None] if a.dim() == 2 else pred, a, b)


def _fresh_fields(z: PhasePoint, h0):
    """Per-transition tree fields for a transition starting at `z`. The
    checkpoint stacks are not among them: every slot is written before it is
    read within a doubling."""
    c = z.theta.shape[0]
    dev = z.theta.device
    zeros = torch.zeros(c, dtype=z.theta.dtype, device=dev)
    izeros = torch.zeros(c, dtype=torch.int32, device=dev)
    false = torch.zeros(c, dtype=torch.bool, device=dev)
    return dict(
        h0=h0, t_zleft=z, t_zright=z, t_rho=z.r, zcand=z, t_w=zeros,
        sum_alpha=zeros, n_alpha=izeros, dh_max=zeros, depth=izeros,
        turning=false, diverged=false, done=false, v=izeros + 1, leaf=izeros,
        z_edge=z, s_rho=torch.zeros_like(z.r),
        s_w=torch.full_like(zeros, float("-inf")), s_zcand=z,
        s_sum_alpha=zeros, s_n_alpha=izeros, s_dh_max=zeros,
        s_turning=false, s_diverged=false,
    )


def _initial_state(z: PhasePoint, max_depth: int):
    c, d = z.theta.shape
    n_slots = max(1, max_depth - 1)
    st = _fresh_fields(z, z.energy())
    st["ck_r"] = z.theta.new_zeros(c, n_slots + 1, d)
    st["ck_d"] = z.theta.new_zeros(c, n_slots + 1, d)
    st["sck_ad"] = z.theta.new_zeros(c, n_slots + 1)
    return st


def _leaf(st, h, eps, max_depth, delta_max, generator,
          force_directions=None, act=None):
    """Advance every chain by one leaf: the body of the iterative NUTS loop
    (single-leaf form of `advancedhmc_tpu/nuts.py` `body`)."""
    z_prev = st["z_edge"]
    c, d = z_prev.theta.shape
    dtype, dev = z_prev.theta.dtype, z_prev.theta.device
    ck_r, ck_d, sck_ad = st["ck_r"], st["ck_d"], st["sck_ad"]
    n_slots = ck_r.shape[1] - 1
    i = st["leaf"]
    h0 = st["h0"]
    start = i == 0

    # --- begin a new doubling: direction, edge, subtree reset ---
    if force_directions is None:
        v_draw = rand_sign(generator, (c,), dev)
    else:
        fd = torch.as_tensor(force_directions, dtype=torch.int32, device=dev)
        v_draw = fd[torch.clamp(st["depth"], max=max_depth - 1).long()]
    v = torch.where(start, v_draw, st["v"])
    fwd = v > 0
    z_edge = _sel(start, _sel(fwd, st["t_zright"], st["t_zleft"]), z_prev)
    s_rho = st["s_rho"].masked_fill(start[:, None], 0.0)
    s_w = st["s_w"].masked_fill(start, float("-inf"))
    s_sum_alpha = st["s_sum_alpha"].masked_fill(start, 0.0)
    s_n_alpha = st["s_n_alpha"].masked_fill(start, 0)
    s_dh_max = st["s_dh_max"].masked_fill(start, 0.0)
    s_turning = st["s_turning"] & ~start
    s_diverged = st["s_diverged"] & ~start

    # --- one leapfrog step in direction v ---
    z_new = leapfrog_step(h, z_edge, eps * v.to(dtype))
    vel_new = h.velocity(z_new.r)
    h_new = z_new.energy()
    dh = h_new - h0
    alpha_leaf = torch.nan_to_num(torch.exp(torch.clamp(-dh, max=0.0)),
                                  nan=0.0)

    # --- multinomial leaf sampler: reservoir update and divergence ---
    lw_leaf = h0 - h_new
    s_w_new = torch.logaddexp(s_w, lw_leaf)
    u = torch.rand(c, generator=generator, dtype=dtype, device=dev)
    take = torch.log(u) < lw_leaf - s_w_new
    diverging = ~(-h0 < delta_max - h_new)
    s_w = s_w_new
    s_zcand = _sel(take, z_new, st["s_zcand"])
    s_rho = s_rho + z_new.r
    s_sum_alpha = s_sum_alpha + alpha_leaf
    s_n_alpha = s_n_alpha + 1
    s_dh_max = maxabs(s_dh_max, dh)

    # --- U-turn checks of the aligned subtrees that end at leaf i ---
    i_even = (i % 2) == 0
    ks = torch.arange(1, max_depth, dtype=torch.int32, device=dev)   # (K,)
    a_s = i[:, None] - torch.bitwise_left_shift(torch.ones_like(ks), ks) + 1
    active = (~i_even)[:, None] & (ks <= trailing_ones(i)[:, None]) & (a_s >= 0)
    a_safe = torch.clamp(a_s, min=0)
    # (an odd a gives slot -1; such spans are never active, clamp to gather)
    slot_a = torch.where(
        a_safe == 0, n_slots - 1,
        torch.clamp(trailing_zeros(torch.clamp(a_safe, min=1)) - 1,
                    min=0, max=n_slots - 1))                           # (C, K)
    u_a = torch.bmm(ck_r, h.velocity(s_rho)[:, :, None])[:, :, 0] + sck_ad
    u_b = torch.bmm(ck_d, vel_new[:, :, None])[:, :, 0]
    srv = torch.sum(s_rho * vel_new, -1)
    turn_slot = (u_a <= 0) | (u_b <= -srv[:, None])                   # (C, S+1)
    turn_k = torch.gather(turn_slot, 1, slot_a.long())
    s_turning = s_turning | torch.any(active & turn_k, 1)
    s_diverged = s_diverged | diverging

    # --- store the even leaf's checkpoint (odd leaves: the spare slot) ---
    slot_even = torch.where(
        i == 0, n_slots - 1,
        torch.clamp(trailing_zeros(torch.clamp(i, min=1)) - 1,
                    max=n_slots - 1))
    slot_w = torch.where(i_even, slot_even, n_slots).long()
    idx = slot_w[:, None, None].expand(c, 1, d)
    d_row = z_new.r - s_rho
    ck_r.scatter_(1, idx, z_new.r[:, None])
    ck_d.scatter_(1, idx, d_row[:, None])
    sck_ad.scatter_(1, slot_w[:, None], torch.sum(d_row * vel_new, -1)[:, None])

    # --- is the doubling finished?  then merge it into the tree ---
    n_leaves = torch.bitwise_left_shift(torch.ones_like(i), st["depth"])
    sub_done = s_turning | s_diverged
    complete = sub_done | (i >= n_leaves - 1)
    not_term = ~sub_done
    # biased progressive sampling at the top level
    e_mh = rand_exponential(generator, (c,), dtype, dev)
    take_top = complete & not_term & (st["t_w"] < s_w + e_mh)
    if act is not None:
        take_top = take_top & act
    # combined tree: the doubling's far edge is z_new; velocities of the old
    # edges are recomputed from their momenta (unit/diagonal M⁻¹ is cheap)
    t_vleft = h.velocity(st["t_zleft"].r)
    t_vright = h.velocity(st["t_zright"].r)
    c_vleft = torch.where(fwd[:, None], t_vleft, vel_new)
    c_vright = torch.where(fwd[:, None], vel_new, t_vright)
    c_rho = st["t_rho"] + s_rho
    full_turn = (torch.sum(c_rho * c_vleft, -1) <= 0) | (
        torch.sum(c_rho * c_vright, -1) <= 0)
    depth = st["depth"] + (complete & not_term).to(torch.int32)
    return dict(
        h0=h0,
        t_zleft=_sel(complete & ~fwd, z_new, st["t_zleft"]),
        t_zright=_sel(complete & fwd, z_new, st["t_zright"]),
        t_rho=_sel(complete, c_rho, st["t_rho"]),
        zcand=_sel(take_top, s_zcand, st["zcand"]),
        t_w=_sel(complete, torch.logaddexp(st["t_w"], s_w), st["t_w"]),
        sum_alpha=st["sum_alpha"] + s_sum_alpha * complete,
        n_alpha=st["n_alpha"] + s_n_alpha * complete,
        dh_max=_sel(complete, maxabs(st["dh_max"], s_dh_max), st["dh_max"]),
        depth=depth,
        turning=st["turning"] | (complete & (s_turning | full_turn)),
        diverged=st["diverged"] | (complete & s_diverged),
        done=(complete & (sub_done | full_turn)) | (depth >= max_depth),
        v=v,
        leaf=torch.where(complete, 0, i + 1),
        z_edge=z_new,
        s_rho=s_rho,
        s_w=s_w.masked_fill(complete, float("-inf")),
        s_zcand=s_zcand,
        s_sum_alpha=s_sum_alpha.masked_fill(complete, 0.0),
        s_n_alpha=s_n_alpha.masked_fill(complete, 0),
        s_dh_max=s_dh_max.masked_fill(complete, 0.0),
        s_turning=s_turning & ~complete,
        s_diverged=s_diverged & ~complete,
        ck_r=ck_r, ck_d=ck_d, sck_ad=sck_ad,
    )


def _stats(zcand: PhasePoint, h0, n_alpha, sum_alpha, dh_max, depth,
           diverged, eps):
    n_alpha_f = n_alpha.to(zcand.theta.dtype)
    energy = zcand.energy()
    return {
        "n_steps": n_alpha,
        "is_accept": torch.ones_like(diverged),
        "acceptance_rate": sum_alpha / torch.clamp(n_alpha_f, min=1.0),
        "log_density": zcand.logdensity,
        "hamiltonian_energy": energy,
        "hamiltonian_energy_error": energy - h0,
        "max_hamiltonian_energy_error": dh_max,
        "tree_depth": depth,
        "numerical_error": diverged,
        "step_size": torch.broadcast_to(eps, diverged.shape),
        "nom_step_size": torch.broadcast_to(eps, diverged.shape),
    }


def nuts_transition(generator, h, traj, z0: PhasePoint,
                    force_directions=None, return_debug=False, **options):
    """One NUTS transition of every chain of `z0`; returns (z_next, stats).

    Test hook: `force_directions` ((max_depth,) array of ±1) overrides the
    per-doubling direction draw; `return_debug` also returns the final loop
    state (tree edges, ρ, log weight). The JAX function's other options
    (`coupled_key`, the leaf-pair body) are not ported yet."""
    if options:
        raise NotImplementedError(
            f"nuts_transition options {sorted(options)} are not ported yet "
            + _LATER)
    _check_trajectory(traj)
    crit = traj.criterion
    max_depth = int(crit.max_depth)
    eps = torch.as_tensor(traj.integrator.current_step_size,
                          dtype=z0.theta.dtype, device=z0.theta.device)
    st = _initial_state(z0, max_depth)
    while not bool(st["done"].all()):
        new = _leaf(st, h, eps, max_depth, crit.delta_max, generator,
                    force_directions)
        running = ~st["done"]     # finished chains keep their state
        st = {k: v if k.startswith(("ck_", "sck_")) else _sel(running, v, st[k])
              for k, v in new.items()}
    stats = _stats(st["zcand"], st["h0"], st["n_alpha"], st["sum_alpha"],
                   st["dh_max"], st["depth"], st["diverged"], eps)
    if return_debug:
        return st["zcand"], stats, st
    return st["zcand"], stats


_STAT_FIELDS = ("n_steps", "acceptance_rate", "log_density",
                "hamiltonian_energy", "hamiltonian_energy_error",
                "max_hamiltonian_energy_error", "tree_depth",
                "numerical_error", "step_size")


def nuts_transitions_fused(generator, h, traj, z0: PhasePoint,
                           n_transitions: int, refreshment,
                           batched: bool = True, **options):
    """Run `n_transitions` NUTS transitions per chain inside ONE loop.

    Chains advance through their own transition sequences asynchronously:
    when a chain's transition ends, its candidate is recorded, its momentum
    is refreshed and its next transition starts in the next iteration, while
    other chains are still mid-tree. The loop ends when every chain has
    completed `n_transitions`. Step size and metric are frozen for the call.

    Returns (z_final, thetas (C, n_transitions, dim), stats of
    (C, n_transitions)). `z_final` is each chain's last candidate; its
    momentum is stale and is refreshed before any further use.
    """
    if not batched or options:
        raise NotImplementedError(
            "only the batch-explicit fused loop without in-loop adaptation "
            f"is ported (got batched={batched}, {sorted(options)}) " + _LATER)
    _check_trajectory(traj)
    crit = traj.criterion
    max_depth = int(crit.max_depth)
    c, d = z0.theta.shape
    dtype, dev = z0.theta.dtype, z0.theta.device
    eps = torch.as_tensor(traj.integrator.current_step_size, dtype=dtype,
                          device=dev)
    n_t = n_transitions

    st = _initial_state(refreshment.refresh(generator, h, z0), max_depth)
    t = torch.zeros(c, dtype=torch.int32, device=dev)
    all_done = torch.zeros(c, dtype=torch.bool, device=dev)
    # one spare row: chains that record nothing write there
    out_theta = z0.theta.new_zeros(c, n_t + 1, d)
    out_stats = z0.theta.new_zeros(c, n_t + 1, len(_STAT_FIELDS))
    it = 0
    while True:
        act = ~all_done
        st2 = _leaf(st, h, eps, max_depth, crit.delta_max, generator, act=act)
        boundary = st2["done"] & act
        zc = st2["zcand"]
        s = _stats(zc, st2["h0"], st2["n_alpha"], st2["sum_alpha"],
                   st2["dh_max"], st2["depth"], st2["diverged"], eps)
        vals = torch.stack([s[k].to(dtype) for k in _STAT_FIELDS], -1)
        row = torch.where(boundary, t, n_t).long()[:, None, None]
        out_theta.scatter_(1, row.expand(c, 1, d), zc.theta[:, None])
        out_stats.scatter_(1, row.expand(c, 1, len(_STAT_FIELDS)),
                           vals[:, None])
        t = t + boundary.to(torch.int32)
        all_done = t >= n_t

        # prepare the next transition of the chains that just finished one
        z_next = h.phasepoint(zc.theta, h.rand_momentum(generator, c),
                              logdensity=zc.logdensity, grad=zc.grad)
        fresh = _fresh_fields(z_next, z_next.energy())
        reset = boundary & ~all_done
        st = {k: _sel(reset, fresh[k], v) if k in fresh else v
              for k, v in st2.items()}
        it += 1
        if it % _CHECK_EVERY == 0 and bool(all_done.all()):
            break

    out = out_stats[:, :n_t]
    stats = {k: out[..., j] for j, k in enumerate(_STAT_FIELDS)}
    for k in ("n_steps", "tree_depth"):
        stats[k] = stats[k].to(torch.int32)
    stats["numerical_error"] = stats["numerical_error"] > 0
    stats["is_accept"] = torch.ones_like(stats["numerical_error"])
    stats["nom_step_size"] = stats["step_size"]
    return st["zcand"], out_theta[:, :n_t], stats

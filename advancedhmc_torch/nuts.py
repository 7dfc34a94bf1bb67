"""NUTS: iterative tree doubling over a batch of chains.

PyTorch counterpart of `advancedhmc_tpu/nuts.py`: the generalised no-U-turn
criterion, multinomial sampling, any Euclidean M⁻¹ (unit, diagonal or
dense, shared or per chain; rank-update, shared), full or partial
momentum refreshment, and each leaf one step of the trajectory's
integrator. As in the JAX package the recursive
`build_tree` is flattened into a loop that takes ONE leapfrog step per
iteration, with the doubling bookkeeping done in O(max_depth) masked
arithmetic; here the loop is a Python `while` over the batched state
(chains on the leading axis) instead of a vmapped `lax.while_loop`. The
leaf-pair body (`_leaf_pair`) takes two leapfrog steps an iteration, the
aligned (even, odd) leaf pair of a doubling, and runs the checks, the
checkpoint write and the merge once for both.

Checkpoint stacks (see the JAX module docstring): the even-visit leaf i of a
doubling stores r_i and d_i = r_i − Σ_{j≤i} r_j at slot tz(i)−1 (the top
slot for i=0), plus the scalar dot(d_i, M⁻¹r_i). A U-turn check over the span
a..i then needs only dot products with the stored rows:
dot(ρ, M⁻¹r_a) = dot(M⁻¹ρ_sub, r_a) + dot(d_a, M⁻¹r_a) and
dot(ρ, M⁻¹r_i) = dot(ρ_sub, M⁻¹r_i) + dot(d_a, M⁻¹r_i), ρ_sub being the
running momentum sum of the current doubling. The stacks are updated in
place; they carry one spare slot that odd leaves (and chains that store
nothing) write to, so the write is a single scatter for every chain. They
are kept in the trajectory's `stack_dtype` (see `trajectory.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hamiltonian import PhasePoint, select_phasepoint
from .integrators import JitteredLeapfrog, leapfrog_step
from .metrics import DenseEuclideanMetric, DiagEuclideanMetric, \
    cholesky_upper
from .termination import GeneralisedNoUTurn, MULTINOMIAL
from .utils import maxabs, not_ported, rand_exponential, rand_sign, \
    roadmap, trailing_ones, trailing_zeros


# The fused loop reads its exit condition back to the host every this many
# iterations; the iterations run after every chain finished are masked
# no-ops, exactly as in the JAX batch loop.
_CHECK_EVERY = 4


def _check_trajectory(traj):
    if not isinstance(traj.criterion, GeneralisedNoUTurn) or \
            traj.ts_kind != MULTINOMIAL:
        raise NotImplementedError(
            "only the generalised criterion with multinomial sampling is "
            "ported " + roadmap("surface"))


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


def _initial_state(z: PhasePoint, max_depth: int, stack_dtype=None):
    """The loop state of a transition from `z`: its tree fields and the
    checkpoint stacks, ck_r and ck_d in `stack_dtype` (None: θ's dtype)."""
    c, d = z.theta.shape
    n_slots = max(1, max_depth - 1)
    st = _fresh_fields(z, z.energy())
    sd = stack_dtype or z.theta.dtype
    st["ck_r"] = z.theta.new_zeros(c, n_slots + 1, d, dtype=sd)
    st["ck_d"] = z.theta.new_zeros(c, n_slots + 1, d, dtype=sd)
    st["sck_ad"] = z.theta.new_zeros(c, n_slots + 1)
    return st


def _stack_dots(ck, v):
    """dot(ck[c, s], v[c]) for every chain c and slot s: in θ's dtype on
    full-precision stacks; on reduced ones with `v` rounded to the stacks'
    dtype and the result rounded to it, as the JAX check's einsum."""
    if ck.dtype == v.dtype:
        return torch.bmm(ck, v[:, :, None])[:, :, 0]
    return torch.bmm(ck, v.to(ck.dtype)[:, :, None])[:, :, 0].to(v.dtype)


def _start(st, v_draw):
    """Begin a new doubling where the chain is at leaf 0: its direction, the
    tree edge it grows from, and the subtree's fields reset. Returns (v,
    fwd, z_edge, sub), `sub` the subtree fields (`s_*`)."""
    start = st["leaf"] == 0
    v = torch.where(start, v_draw, st["v"])
    fwd = v > 0
    z_edge = _sel(start, _sel(fwd, st["t_zright"], st["t_zleft"]),
                  st["z_edge"])
    sub = dict(
        s_rho=st["s_rho"].masked_fill(start[:, None], 0.0),
        s_w=st["s_w"].masked_fill(start, float("-inf")),
        s_zcand=st["s_zcand"],
        s_sum_alpha=st["s_sum_alpha"].masked_fill(start, 0.0),
        s_n_alpha=st["s_n_alpha"].masked_fill(start, 0),
        s_dh_max=st["s_dh_max"].masked_fill(start, 0.0),
        s_turning=st["s_turning"] & ~start,
        s_diverged=st["s_diverged"] & ~start,
    )
    return v, fwd, z_edge, sub


def _step(h, z_edge, eps_v, h0, delta_max, sub, generator, integ=None):
    """One integrator step from `z_edge` (signed step `eps_v`; `integ`'s
    step, plain leapfrog without one) and the multinomial leaf sampler:
    reservoir update (one uniform draw) and divergence. Returns (z_new,
    vel_new, sub with the leaf added)."""
    c, dtype, dev = h0.shape[0], h0.dtype, h0.device
    z_new = (leapfrog_step(h, z_edge, eps_v) if integ is None
             else integ.step(h, z_edge, eps_v))
    vel_new = h.velocity(z_new.r)
    h_new = z_new.energy()
    dh = h_new - h0
    alpha_leaf = torch.nan_to_num(torch.exp(torch.clamp(-dh, max=0.0)),
                                  nan=0.0)
    lw_leaf = h0 - h_new
    s_w = torch.logaddexp(sub["s_w"], lw_leaf)
    u = torch.rand(c, generator=generator, dtype=dtype, device=dev)
    take = torch.log(u) < lw_leaf - s_w
    diverging = ~(-h0 < delta_max - h_new)
    return z_new, vel_new, dict(
        sub,
        s_w=s_w,
        s_zcand=_sel(take, z_new, sub["s_zcand"]),
        s_rho=sub["s_rho"] + z_new.r,
        s_sum_alpha=sub["s_sum_alpha"] + alpha_leaf,
        s_n_alpha=sub["s_n_alpha"] + 1,
        s_dh_max=maxabs(sub["s_dh_max"], dh),
        s_diverged=sub["s_diverged"] | diverging,
    )


def _span_turn(st, h, i, s_rho, vel_new, max_depth, odd):
    """Whether a U-turn closes one of the aligned subtrees that end at leaf
    `i` (only odd leaves end one; `odd` says which chains are at one)."""
    ck_r, ck_d, sck_ad = st["ck_r"], st["ck_d"], st["sck_ad"]
    n_slots = ck_r.shape[1] - 1
    ks = torch.arange(1, max_depth, dtype=torch.int32, device=i.device)
    a_s = i[:, None] - torch.bitwise_left_shift(torch.ones_like(ks), ks) + 1
    active = odd[:, None] & (ks <= trailing_ones(i)[:, None]) & (a_s >= 0)
    a_safe = torch.clamp(a_s, min=0)
    # (an odd a gives slot -1; such spans are never active, clamp to gather)
    slot_a = torch.where(
        a_safe == 0, n_slots - 1,
        torch.clamp(trailing_zeros(torch.clamp(a_safe, min=1)) - 1,
                    min=0, max=n_slots - 1))                           # (C, K)
    u_a = _stack_dots(ck_r, h.velocity(s_rho)) + sck_ad
    u_b = _stack_dots(ck_d, vel_new)
    srv = torch.sum(s_rho * vel_new, -1)
    turn_slot = (u_a <= 0) | (u_b <= -srv[:, None])                   # (C, S+1)
    turn_k = torch.gather(turn_slot, 1, slot_a.long())
    return torch.any(active & turn_k, 1)


def _store(st, i, z_new, s_rho, vel_new, write):
    """Store leaf `i`'s checkpoint where `write` holds (even leaves), in
    place; the other chains write to the spare slot, which nothing reads."""
    ck_r, ck_d, sck_ad = st["ck_r"], st["ck_d"], st["sck_ad"]
    c, n_slots1, d = ck_r.shape
    n_slots = n_slots1 - 1
    slot_even = torch.where(
        i == 0, n_slots - 1,
        torch.clamp(trailing_zeros(torch.clamp(i, min=1)) - 1,
                    max=n_slots - 1))
    slot_w = torch.where(write, slot_even, n_slots).long()
    idx = slot_w[:, None, None].expand(c, 1, d)
    d_row = z_new.r - s_rho
    ck_r.scatter_(1, idx, z_new.r[:, None].to(ck_r.dtype))
    ck_d.scatter_(1, idx, d_row[:, None].to(ck_d.dtype))
    sck_ad.scatter_(1, slot_w[:, None], torch.sum(d_row * vel_new, -1)[:, None])


def _merge(st, h, max_depth, v, fwd, i, z_new, vel_new, sub, e_mh, act):
    """The end of an iteration whose last leaf is leaf `i` (`z_new`,
    `vel_new`), the subtree's fields `sub` final: is the doubling finished?
    Then merge it into the tree (biased progressive sampling with `e_mh`,
    masked by `act`). Returns the new state without the stacks."""
    n_leaves = torch.bitwise_left_shift(torch.ones_like(i), st["depth"])
    s_turning, s_diverged, s_w = sub["s_turning"], sub["s_diverged"], \
        sub["s_w"]
    sub_done = s_turning | s_diverged
    complete = sub_done | (i >= n_leaves - 1)
    not_term = ~sub_done
    # biased progressive sampling at the top level
    take_top = complete & not_term & (st["t_w"] < s_w + e_mh)
    if act is not None:
        take_top = take_top & act
    # combined tree: the doubling's far edge is z_new; velocities of the old
    # edges are recomputed from their momenta (one product for a dense M⁻¹)
    t_vleft = h.velocity(st["t_zleft"].r)
    t_vright = h.velocity(st["t_zright"].r)
    c_vleft = torch.where(fwd[:, None], t_vleft, vel_new)
    c_vright = torch.where(fwd[:, None], vel_new, t_vright)
    c_rho = st["t_rho"] + sub["s_rho"]
    full_turn = (torch.sum(c_rho * c_vleft, -1) <= 0) | (
        torch.sum(c_rho * c_vright, -1) <= 0)
    depth = st["depth"] + (complete & not_term).to(torch.int32)
    cap = st.get("cap", max_depth)     # a per-chain cap, where one is set
    return dict(
        h0=st["h0"],
        t_zleft=_sel(complete & ~fwd, z_new, st["t_zleft"]),
        t_zright=_sel(complete & fwd, z_new, st["t_zright"]),
        t_rho=_sel(complete, c_rho, st["t_rho"]),
        zcand=_sel(take_top, sub["s_zcand"], st["zcand"]),
        t_w=_sel(complete, torch.logaddexp(st["t_w"], s_w), st["t_w"]),
        sum_alpha=st["sum_alpha"] + sub["s_sum_alpha"] * complete,
        n_alpha=st["n_alpha"] + sub["s_n_alpha"] * complete,
        dh_max=_sel(complete, maxabs(st["dh_max"], sub["s_dh_max"]),
                    st["dh_max"]),
        depth=depth,
        turning=st["turning"] | (complete & (s_turning | full_turn)),
        diverged=st["diverged"] | (complete & s_diverged),
        done=(complete & (sub_done | full_turn)) | (depth >= cap),
        v=v,
        leaf=torch.where(complete, 0, i + 1),
        z_edge=z_new,
        s_rho=sub["s_rho"],
        s_w=s_w.masked_fill(complete, float("-inf")),
        s_zcand=sub["s_zcand"],
        s_sum_alpha=sub["s_sum_alpha"].masked_fill(complete, 0.0),
        s_n_alpha=sub["s_n_alpha"].masked_fill(complete, 0),
        s_dh_max=sub["s_dh_max"].masked_fill(complete, 0.0),
        s_turning=s_turning & ~complete,
        s_diverged=s_diverged & ~complete,
        ck_r=st["ck_r"], ck_d=st["ck_d"], sck_ad=st["sck_ad"],
        **({"cap": cap} if "cap" in st else {}),
    )


def _leaf(st, h, eps, max_depth, delta_max, generator,
          force_directions=None, act=None, integ=None):
    """Advance every chain by one leaf: the body of the iterative NUTS loop
    (single-leaf form of `advancedhmc_tpu/nuts.py` `body`). It draws a
    direction sign, the reservoir's uniform and the merge's exponential,
    one of each for every chain. Chains outside `act` (if given) take no
    candidate and store no checkpoint."""
    c = st["leaf"].shape[0]
    dtype, dev = st["h0"].dtype, st["h0"].device
    i = st["leaf"]
    v_draw = (rand_sign(generator, (c,), dev) if force_directions is None
              else _direction(st, force_directions, max_depth))
    v, fwd, z_edge, sub = _start(st, v_draw)
    z_new, vel_new, sub = _step(h, z_edge, eps * v.to(dtype), st["h0"],
                                delta_max, sub, generator, integ)
    i_even = (i % 2) == 0
    sub["s_turning"] = sub["s_turning"] | _span_turn(
        st, h, i, sub["s_rho"], vel_new, max_depth, ~i_even)
    _store(st, i, z_new, sub["s_rho"], vel_new,
           i_even if act is None else i_even & act)
    e_mh = rand_exponential(generator, (c,), dtype, dev)
    return _merge(st, h, max_depth, v, fwd, i, z_new, vel_new, sub, e_mh,
                  act)


def _direction(st, directions, max_depth):
    """Each chain's direction from a (max_depth,) table of ±1, at its depth."""
    fd = torch.as_tensor(directions, dtype=torch.int32,
                         device=st["depth"].device)
    return fd[torch.clamp(st["depth"], max=max_depth - 1).long()]


def _leaf_pair(st, h, eps, max_depth, delta_max, generator, act=None,
               directions=None, integ=None):
    """Advance every chain by the aligned (even, odd) leaf pair of its
    current doubling, or by the lone leaf of a depth-0 doubling: the
    leaf-pair body (`advancedhmc_tpu/nuts.py` `body_pair`). Every chain is
    at leaf 0 or at an even leaf mid-doubling (a doubling of depth ≥ 1 is
    whole pairs), so the pair never straddles two doublings.

    Leaf A (even) stores the checkpoint; only leaf B (odd) runs the span
    checks, and at most one completion and merge happens. A divergence at
    A, or a depth-0 doubling, ends the pair at A: B is computed and fully
    masked. The draws are those of two `_leaf` calls, in their order, for
    every chain: A's sign, uniform and exponential, then B's (B's sign is
    never used); the merge takes B's exponential when the pair goes on and
    A's when it ends at A. With a table of `directions` (coupled chains)
    no sign is drawn, as in `_leaf`."""
    c = st["leaf"].shape[0]
    dtype, dev = st["h0"].dtype, st["h0"].device
    h0, i_a = st["h0"], st["leaf"]
    v, fwd, z_edge, sub = _start(
        st, rand_sign(generator, (c,), dev) if directions is None
        else _direction(st, directions, max_depth))
    eps_v = eps * v.to(dtype)
    # leaf A (even): its checkpoint; no span ends at an even leaf
    z_a, vel_a, sub_a = _step(h, z_edge, eps_v, h0, delta_max, sub,
                              generator, integ)
    e_a = rand_exponential(generator, (c,), dtype, dev)
    n_leaves = torch.bitwise_left_shift(torch.ones_like(i_a), st["depth"])
    pair_go = ~(sub_a["s_diverged"] | (i_a >= n_leaves - 1))
    _store(st, i_a, z_a, sub_a["s_rho"], vel_a,
           torch.ones_like(pair_go) if act is None else act)
    # leaf B (odd): the span checks
    if directions is None:
        rand_sign(generator, (c,), dev)
    z_b, vel_b, sub_b = _step(h, z_a, eps_v, h0, delta_max, sub_a, generator,
                              integ)
    e_b = rand_exponential(generator, (c,), dtype, dev)
    i_b = i_a + 1
    sub_b["s_turning"] = sub_b["s_turning"] | _span_turn(
        st, h, i_b, sub_b["s_rho"], vel_b, max_depth, pair_go)
    sub = {k: _sel(pair_go, sub_b[k], sub_a[k]) for k in sub_a}
    return _merge(st, h, max_depth, v, fwd, torch.where(pair_go, i_b, i_a),
                  _sel(pair_go, z_b, z_a), _sel(pair_go, vel_b, vel_a), sub,
                  torch.where(pair_go, e_b, e_a), act)


def _stats(zcand: PhasePoint, h0, n_alpha, sum_alpha, dh_max, depth,
           diverged, eps, nom_eps=None):
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
        "nom_step_size": torch.broadcast_to(
            eps if nom_eps is None else nom_eps, diverged.shape),
    }


def nuts_transition(generator, h, traj, z0: PhasePoint,
                    force_directions=None, return_debug=False,
                    coupled_key=None, _pair=False, **options):
    """One NUTS transition of every chain of `z0`; returns (z_next, stats).

    The integrator's current step size is a scalar or one per chain (C,),
    and so is the stats' `step_size` (its nominal one is `nom_step_size`:
    a jittered integrator is jittered before the call); each leaf is one
    `integrator.step`. A per-chain M⁻¹ comes with `h`'s metric. The
    loop runs until every chain's tree is done; a finished chain keeps its
    state and stores no further checkpoint.

    `coupled_key`, a `torch.Generator` on the chains' device, couples the
    chains' doubling directions (the reference's `rand_coupled` mode, the
    JAX function's `coupled_key`): a table of one sign per depth is drawn
    from it once, at the start of the transition, and every chain takes the
    table's sign at its depth, so all chains at one depth go the same way.
    No per-chain sign is drawn then.

    Test hooks: `force_directions` ((max_depth,) array of ±1) overrides the
    per-doubling direction draw (and `coupled_key`); `return_debug` also
    returns the final loop state (tree edges, ρ, log weight, stacks).
    `_pair` runs the leaf-pair body (`_leaf_pair`) after the first
    iteration, which is every chain's lone depth-0 leaf and runs as one
    `_leaf`: so the generator is drawn exactly as with the single-leaf
    body, and the transition gives the same bits, every field and every
    stack slot that a check reads (the spare slot is a write-only sink)."""
    not_ported("nuts_transition", options)
    _check_trajectory(traj)
    if _pair and force_directions is not None:
        raise ValueError("force_directions is unsupported on the leaf-pair "
                         "body; use the single-leaf body (_pair=False)")
    crit = traj.criterion
    max_depth = int(crit.max_depth)
    dev = z0.theta.device
    integ = traj.integrator
    eps = torch.as_tensor(integ.current_step_size, dtype=z0.theta.dtype,
                          device=dev)
    directions = force_directions
    if directions is None and coupled_key is not None:
        directions = rand_sign(coupled_key, (max_depth,), dev)
    st = _initial_state(z0, max_depth, traj.stack_torch_dtype)
    first = True
    while not bool(st["done"].all()):
        running = ~st["done"]     # finished chains keep their state
        if _pair and not first:
            new = _leaf_pair(st, h, eps, max_depth, crit.delta_max,
                             generator, act=running, directions=directions,
                             integ=integ)
        else:
            new = _leaf(st, h, eps, max_depth, crit.delta_max, generator,
                        directions, act=running, integ=integ)
        first = False
        st = {k: v if k.startswith(("ck_", "sck_")) else _sel(running, v, st[k])
              for k, v in new.items()}
    stats = _stats(st["zcand"], st["h0"], st["n_alpha"], st["sum_alpha"],
                   st["dh_max"], st["depth"], st["diverged"], eps,
                   torch.as_tensor(integ.nom_step_size, dtype=eps.dtype,
                                   device=dev))
    if return_debug:
        return st["zcand"], stats, st
    return st["zcand"], stats


_STAT_FIELDS = ("n_steps", "acceptance_rate", "log_density",
                "hamiltonian_energy", "hamiltonian_energy_error",
                "max_hamiltonian_energy_error", "tree_depth",
                "numerical_error", "step_size")


def nuts_transitions_fused(generator, h, traj, z0: PhasePoint,
                           n_transitions: int, refreshment,
                           adapt_cfg=None, adapt_state=None,
                           adapt_flags=None, batched: bool = True,
                           depth_caps=None, pair: bool = False, **options):
    """Run `n_transitions` NUTS transitions per chain inside ONE loop.

    Chains advance through their own transition sequences asynchronously:
    when a chain's transition ends, its candidate is recorded, its momentum
    is refreshed and its next transition starts in the next iteration, while
    other chains are still mid-tree. The loop ends when every chain has
    completed `n_transitions`. Step size and metric are frozen for the call;
    each is shared or per chain, as in `nuts_transition`. A jittered
    integrator draws each chain's step size anew from its nominal one at
    each of its transition boundaries (the first transition runs at the
    integrator's current step size); the momentum is refreshed by
    `refreshment` there.

    Returns (z_final, thetas (C, n_transitions, dim), stats of
    (C, n_transitions)). `z_final` is each chain's last candidate; its
    momentum is stale and is refreshed before any further use.

    Warmup mode (the JAX function's): with `adapt_cfg`, `adapt_state`
    (per-chain AdaptState: ε (C,), the estimator's n (C,)) and
    `adapt_flags` (the flag arrays of `adapt_flags`, at least
    `n_transitions` long), each chain's adaptation step runs inside the
    loop at its own transition boundary, indexed by its own transition
    count (`adapt_step_masked`, given the chain's candidate θ and ∇ℓπ):
    dual averaging, the estimator's push, the Stan window reset, and the
    metric renewal. The chain's next transition runs at its new ε and,
    with an adapted mass matrix, its new M⁻¹: a per-chain diagonal metric
    (Welford variance or nutpie) or a per-chain dense one (Welford
    covariance; its Cholesky factor, which draws the momenta, is refreshed
    only for the chains at a window end, as in JAX). `h` then carries a
    unit, a per-chain diagonal or a per-chain dense metric and `traj` each
    chain's ε. Returns (z_final, thetas, stats, adapt_state_final).

    `depth_caps` ((n_transitions,) ints) caps the tree depth of a chain's
    t-th transition at depth_caps[t], clamped to the criterion's max_depth
    (the stacks are sized for it).

    `pair=True` runs the leaf-pair body (`_leaf_pair`): two leaves an
    iteration, the per-iteration work (stats, records, refresh) once per
    pair. Its transitions follow the same law as the single-leaf body's but
    not the same bits: the chains share one generator, and a chain whose
    transition ends at leaf A starts its next one an iteration later, so
    the streams shift (in the JAX package each chain carries its own key,
    and the two bodies agree bitwise there).
    """
    not_ported("nuts_transitions_fused",
               options if batched else dict(options, batched=batched))
    _check_trajectory(traj)
    crit = traj.criterion
    max_depth = int(crit.max_depth)
    c, d = z0.theta.shape
    dtype, dev = z0.theta.dtype, z0.theta.device
    integ = traj.integrator
    eps = torch.as_tensor(integ.current_step_size, dtype=dtype, device=dev)
    nom = torch.as_tensor(integ.nom_step_size, dtype=dtype, device=dev)
    jittered = isinstance(integ, JitteredLeapfrog)
    if jittered:
        eps = torch.broadcast_to(eps, (c,)).clone()
    n_t = n_transitions
    adaptive = adapt_cfg is not None
    adapt_metric = adaptive and adapt_cfg.uses_mm
    if adaptive:
        from .adaptation import adapt_step_masked

        flags = {k: torch.as_tensor(np.asarray(adapt_flags[k])[:n_t],
                                    device=dev)
                 for k in ("is_adapt", "in_window", "window_end", "is_last")}
        ad = adapt_state
        eps = torch.broadcast_to(eps, (c,)).clone()
        dense = isinstance(h.metric, DenseEuclideanMetric)
        if adapt_metric and not (
                isinstance(h.metric, DiagEuclideanMetric) or dense):
            raise ValueError("in-loop mass-matrix adaptation needs a "
                             "diagonal or a dense metric")

    st = _initial_state(refreshment.refresh(generator, h, z0), max_depth,
                        traj.stack_torch_dtype)
    if depth_caps is not None:
        caps = torch.clamp(torch.as_tensor(np.asarray(depth_caps),
                                           dtype=torch.int32, device=dev),
                           max=max_depth)
        if caps.shape != (n_t,):
            raise ValueError(f"depth_caps must have shape ({n_t},)")
        st["cap"] = caps[0].expand(c).clone()
    t = torch.zeros(c, dtype=torch.int32, device=dev)
    all_done = torch.zeros(c, dtype=torch.bool, device=dev)
    # one spare row: chains that record nothing write there
    out_theta = z0.theta.new_zeros(c, n_t + 1, d)
    out_stats = z0.theta.new_zeros(c, n_t + 1, len(_STAT_FIELDS))
    it = 0
    while True:
        act = ~all_done
        st2 = (_leaf_pair if pair else _leaf)(
            st, h, eps, max_depth, crit.delta_max, generator, act=act,
            integ=integ)
        boundary = st2["done"] & act
        zc = st2["zcand"]
        s = _stats(zc, st2["h0"], st2["n_alpha"], st2["sum_alpha"],
                   st2["dh_max"], st2["depth"], st2["diverged"], eps)
        vals = torch.stack([s[k].to(dtype) for k in _STAT_FIELDS], -1)
        row = torch.where(boundary, t, n_t).long()[:, None, None]
        out_theta.scatter_(1, row.expand(c, 1, d), zc.theta[:, None])
        out_stats.scatter_(1, row.expand(c, 1, len(_STAT_FIELDS)),
                           vals[:, None])
        t_done = t
        t = t + boundary.to(torch.int32)
        all_done = t >= n_t
        reset = boundary & ~all_done

        h_next, nom_next = h, nom
        if adaptive:
            # each finishing chain's adaptation step, at its own count
            idx = torch.clamp(t_done, max=n_t - 1).long()
            flags_t = {k: v[idx] for k, v in flags.items()}
            ad = adapt_step_masked(
                adapt_cfg, ad, zc.theta, zc.grad, s["acceptance_rate"],
                flags_t, boundary)
            nom_next = ad.da.eps
            if adapt_metric and dense:
                # M⁻¹ moves only at a window end: the factor is refreshed
                # there, for the chains that reach one
                new = (reset & flags_t["window_end"])[:, None, None]
                h_next = dataclasses.replace(h, metric=DenseEuclideanMetric(
                    m_inv=torch.where(reset[:, None, None], ad.mm.m_inv,
                                      h.metric.m_inv),
                    chol_u=torch.where(new, cholesky_upper(ad.mm.m_inv),
                                       h.metric.chol_u)))
            elif adapt_metric:
                h_next = dataclasses.replace(h, metric=DiagEuclideanMetric.create(
                    torch.where(reset[:, None], ad.mm.m_inv, h.metric.m_inv)))
        # prepare the next transition of the chains that just finished one
        z_next = refreshment.refresh(generator, h_next, zc)
        if jittered:
            eps = torch.where(reset, integ.with_nom_step_size(nom_next).jitter(
                generator, c).current_step_size, eps)
        elif adaptive:
            eps = torch.where(reset, nom_next, eps)
        fresh = _fresh_fields(z_next, z_next.energy())
        st = {k: _sel(reset, fresh[k], v) if k in fresh else v
              for k, v in st2.items()}
        if depth_caps is not None:
            st["cap"] = torch.where(
                boundary, caps[torch.clamp(t, max=n_t - 1).long()],
                st2["cap"])
        h = h_next
        it += 1
        if it % _CHECK_EVERY == 0 and bool(all_done.all()):
            break

    out = out_stats[:, :n_t]
    stats = {k: out[..., j] for j, k in enumerate(_STAT_FIELDS)}
    for k in ("n_steps", "tree_depth"):
        stats[k] = stats[k].to(torch.int32)
    stats["numerical_error"] = stats["numerical_error"] > 0
    stats["is_accept"] = torch.ones_like(stats["numerical_error"])
    stats["nom_step_size"] = (
        torch.broadcast_to(nom[:, None] if nom.dim() else nom, (c, n_t))
        if jittered else stats["step_size"])
    if adaptive:
        return st["zcand"], out_theta[:, :n_t], stats, ad
    return st["zcand"], out_theta[:, :n_t], stats

"""NUTS: iterative tree doubling over a batch of chains.

PyTorch counterpart of `advancedhmc_tpu/nuts.py`: the classic, generalised
and strict no-U-turn criteria, multinomial and slice sampling, any
Euclidean M⁻¹ (unit, diagonal, dense or rank-update, shared or per
chain), full or partial momentum refreshment, and each leaf one step of
the trajectory's integrator. As in the JAX package the recursive
`build_tree` is flattened into a loop that takes ONE leapfrog step per
iteration, with the doubling bookkeeping done in O(max_depth) masked
arithmetic; here the loop is a Python `while` over the batched state
(chains on the leading axis) instead of a vmapped `lax.while_loop`. The
leaf-pair body (`_leaf_pair`) takes two leapfrog steps an iteration, the
aligned (even, odd) leaf pair of a doubling, and runs the checks, the
checkpoint write and the merge once for both.

Checkpoint stacks (see the JAX module docstring): the even-visit leaf i of
a doubling stores its checkpoint at slot tz(i)−1 (the top slot for i=0);
a U-turn check over the span a..i then needs only dot products with the
stored rows. What a leaf stores depends on the criterion:

* generalised: r_i and d_i = r_i − Σ_{j≤i} r_j, plus the scalar
  dot(d_i, M⁻¹r_i), so that dot(ρ, M⁻¹r_a) = dot(M⁻¹ρ_sub, r_a) +
  dot(d_a, M⁻¹r_a) and dot(ρ, M⁻¹r_i) = dot(ρ_sub, M⁻¹r_i) + dot(d_a,
  M⁻¹r_i), ρ_sub being the running momentum sum of the current doubling;
* classic: r_i and θ_i, plus the scalar dot(θ_i, M⁻¹r_i): the span check
  on Δθ = θ_i − θ_a in tree order is ±(dot(M⁻¹θ_i, r_a) − dot(θ_a,
  M⁻¹r_a)) and ±(dot(θ_i, M⁻¹r_i) − dot(θ_a, M⁻¹r_i));
* strict: r_i and the cumulative sum Σ_{j≤i} r_j (the spans' ρ and the
  half-spans' are differences of these rows), and every odd-visit leaf i
  stores r_i at slot tz(i+1)−1, read back as the mid-boundary of the
  half-span checks of spans of 4 leaves or more.

The stacks are updated in place; they carry one spare slot that the leaves
(and chains) that store nothing write to, so each write is a single scatter
for every chain. They are kept in the trajectory's `stack_dtype` (see
`trajectory.py`).

Velocities: where ∂H∂r depends on r alone (a Euclidean metric, with the
Gaussian or the relativistic kinetic energy) the checks recompute the
velocities they need from stored momenta, applying `h.velocity` to sums
and positions as the JAX package does (ρ·v_a is computed as
dot(velocity(ρ), r_a), classic's as dot(velocity(θ), r_a); for the
relativistic kinetic energy, whose velocity is not linear in r, this is
the JAX package's own rule, not ρ·v_a). Where it reads θ too (the
Riemannian Hamiltonian, `h.theta_dependent_velocity`), the loop carries
velocities instead, as the JAX loop does for such metrics: the tree
edges' (`t_vleft`, `t_vright`), strict's first-leaf one (`s_vfirst`) and a
velocity stack beside each momentum stack (`ck_vel`, `ck_odd_vel`),
written with the leaf's momentum, so the checks take dot(ρ, v_a).

Slice sampling (the reference's SliceTS) draws ℓu = −H₀ − Exp(1) per chain
at the start of a transition; a leaf is acceptable when ℓu ≤ −H, a subtree
weighs its count of acceptable leaves (the root counts 1), the reservoir
takes an acceptable leaf with probability 1/count, the divergence test is
ℓu < Δmax − H, and the top level takes a finished subtree when t_w·u < s_w
(u uniform) and adds the counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import profiling
from .hamiltonian import FullMomentumRefreshment, PhasePoint, \
    select_phasepoint
from .integrators import JitteredLeapfrog, leapfrog_step
from .metrics import DenseEuclideanMetric, DiagEuclideanMetric, \
    cholesky_upper
from .termination import SLICE, ClassicNoUTurn, \
    DynamicTerminationCriterion, StrictGeneralisedNoUTurn
from .utils import all_chains, all_chains_t, as_dtype, max_chains, maxabs, \
    rand_exponential, rand_sign, rand_uniform, trailing_ones, trailing_zeros


# The fused loop reads its exit condition back to the host every this many
# iterations; the iterations run after every chain finished are masked
# no-ops, exactly as in the JAX batch loop.
_CHECK_EVERY = 4


@dataclasses.dataclass(frozen=True)
class _Kind:
    """What a trajectory's criterion and sampler add to the loop:
    `criterion` is "classic", "generalised" or "strict"; `slice` says the
    slice sampler (else multinomial); `carry_vel` that the loop carries
    velocities (see the module docstring)."""

    criterion: str = "generalised"
    slice: bool = False
    carry_vel: bool = False


_GENERALISED = _Kind()


def _kind(traj, h=None):
    crit = traj.criterion
    if not isinstance(crit, DynamicTerminationCriterion):
        raise ValueError(f"NUTS needs a no-U-turn criterion, not "
                         f"{type(crit).__name__}")
    name = ("classic" if isinstance(crit, ClassicNoUTurn) else
            "strict" if isinstance(crit, StrictGeneralisedNoUTurn) else
            "generalised")
    return _Kind(name, traj.ts_kind == SLICE,
                 bool(getattr(h, "theta_dependent_velocity", False)))


def _sel(pred, a, b):
    if not isinstance(a, torch.Tensor):        # a phase point
        return select_phasepoint(pred, a, b)
    return torch.where(pred[:, None] if a.dim() == 2 else pred, a, b)


def _empty_weight(kind):
    """A subtree's weight before its first leaf: log 0, or a count of 0."""
    return 0.0 if kind.slice else float("-inf")


def _fresh_fields(z: PhasePoint, h0, kind=_GENERALISED, generator=None,
                  vel=None):
    """Per-transition tree fields for a transition starting at `z`. The
    checkpoint stacks are not among them: every slot is written before it is
    read within a doubling. Slice sampling draws its level ℓu = −H₀ −
    Exp(1) here, one draw a chain, from `generator`. Where the loop
    carries velocities, `vel` is z's."""
    c = z.theta.shape[0]
    dev = z.theta.device
    zeros = torch.zeros(c, dtype=z.theta.dtype, device=dev)
    izeros = torch.zeros(c, dtype=torch.int32, device=dev)
    false = torch.zeros(c, dtype=torch.bool, device=dev)
    fields = dict(
        h0=h0, t_zleft=z, t_zright=z, t_rho=z.r, zcand=z,
        # the root is the one candidate: log weight 0, or a count of 1
        t_w=zeros + 1.0 if kind.slice else zeros,
        sum_alpha=zeros, n_alpha=izeros, dh_max=zeros, depth=izeros,
        turning=false, diverged=false, done=false, v=izeros + 1, leaf=izeros,
        z_edge=z, s_rho=torch.zeros_like(z.r),
        s_w=torch.full_like(zeros, _empty_weight(kind)), s_zcand=z,
        s_sum_alpha=zeros, s_n_alpha=izeros, s_dh_max=zeros,
        s_turning=false, s_diverged=false,
    )
    if kind.slice:
        fields["lu"] = -h0 - rand_exponential(generator, (c,), h0.dtype, dev)
    if kind.criterion == "strict":
        fields["s_rfirst"] = z.r      # the subtree's first leaf's momentum
    if kind.carry_vel:
        fields["t_vleft"] = fields["t_vright"] = vel
        if kind.criterion == "strict":
            fields["s_vfirst"] = vel
    return fields


def _initial_state(z: PhasePoint, max_depth: int, stack_dtype=None,
                   kind=_GENERALISED, generator=None, h=None):
    """The loop state of a transition from `z`: its tree fields and the
    checkpoint stacks of the criterion in `stack_dtype` (None: θ's dtype),
    with one spare slot (see the module docstring); `h` gives z's
    velocity where the loop carries velocities."""
    c, d = z.theta.shape
    n_slots = max(1, max_depth - 1)
    st = _fresh_fields(z, z.energy(), kind, generator,
                       h.velocity_z(z) if kind.carry_vel else None)
    sd = stack_dtype or z.theta.dtype

    def stack():
        return z.theta.new_zeros(c, n_slots + 1, d, dtype=sd)

    st["ck_r"] = stack()
    if kind.criterion == "generalised":
        st["ck_d"] = stack()
        st["sck_ad"] = z.theta.new_zeros(c, n_slots + 1)
    elif kind.criterion == "classic":
        st["ck_theta"] = stack()
        st["sck_tv"] = z.theta.new_zeros(c, n_slots + 1)
    else:
        st["ck_cum"] = stack()
        st["ck_odd_r"] = stack()
    if kind.carry_vel:
        st["ck_vel"] = stack()
        if kind.criterion == "strict":
            st["ck_odd_vel"] = stack()
    return st


def _stack_dots(ck, v):
    """dot(ck[c, s], v[c]) for every chain c and slot s: in θ's dtype on
    full-precision stacks; on reduced ones with `v` rounded to the stacks'
    dtype and the result rounded to it, as the JAX check's einsum."""
    if ck.dtype == v.dtype:
        return torch.bmm(ck, v[:, :, None])[:, :, 0]
    return torch.bmm(ck, v.to(ck.dtype)[:, :, None])[:, :, 0].to(v.dtype)


def _dot(x, y):
    return torch.sum(x * y, -1)


def _start(st, v_draw, kind=_GENERALISED):
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
        s_w=st["s_w"].masked_fill(start, _empty_weight(kind)),
        s_zcand=st["s_zcand"],
        s_sum_alpha=st["s_sum_alpha"].masked_fill(start, 0.0),
        s_n_alpha=st["s_n_alpha"].masked_fill(start, 0),
        s_dh_max=st["s_dh_max"].masked_fill(start, 0.0),
        s_turning=st["s_turning"] & ~start,
        s_diverged=st["s_diverged"] & ~start,
    )
    return v, fwd, z_edge, sub


def _step(h, z_edge, eps_v, h0, delta_max, sub, generator, integ=None,
          lu=None):
    """One integrator step from `z_edge` (signed step `eps_v`; `integ`'s
    step, plain leapfrog without one) and the leaf sampler: reservoir
    update (one uniform draw) and divergence, multinomial, or slice at the
    level `lu` where one is given. Returns (z_new, vel_new, sub with the
    leaf added)."""
    c, dtype, dev = h0.shape[0], h0.dtype, h0.device
    z_new = (leapfrog_step(h, z_edge, eps_v) if integ is None
             else integ.step(h, z_edge, eps_v))
    vel_new = h.velocity_z(z_new)
    h_new = z_new.energy()
    dh = h_new - h0
    alpha_leaf = torch.nan_to_num(torch.exp(torch.clamp(-dh, max=0.0)),
                                  nan=0.0)
    if lu is None:
        lw_leaf = h0 - h_new
        s_w = torch.logaddexp(sub["s_w"], lw_leaf)
        u = rand_uniform(generator, (c,), dtype, dev)
        take = torch.log(u) < lw_leaf - s_w
        diverging = ~(-h0 < delta_max - h_new)
    else:
        n_leaf = (lu <= -h_new).to(dtype)        # an acceptable leaf counts 1
        s_w = sub["s_w"] + n_leaf
        u = rand_uniform(generator, (c,), dtype, dev)
        take = (s_w * u >= sub["s_w"]) & (n_leaf > 0)
        diverging = ~(lu < delta_max - h_new)
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


def _span_turn(st, h, i, s_rho, vel_new, max_depth, odd, kind=_GENERALISED,
               theta_new=None, v=None):
    """Whether a U-turn closes one of the aligned subtrees that end at leaf
    `i` (only odd leaves end one; `odd` says which chains are at one).
    Classic needs the leaf's position `theta_new` and the direction `v`."""
    ck_r = st["ck_r"]
    c, n_slots1, d = ck_r.shape
    n_slots = n_slots1 - 1
    ks = torch.arange(1, max_depth, dtype=torch.int32, device=i.device)
    a_s = i[:, None] - torch.bitwise_left_shift(torch.ones_like(ks), ks) + 1
    active = odd[:, None] & (ks <= trailing_ones(i)[:, None]) & (a_s >= 0)
    a_safe = torch.clamp(a_s, min=0)
    # (an odd a gives slot -1; such spans are never active, clamp to gather)
    slot_a = torch.where(
        a_safe == 0, n_slots - 1,
        torch.clamp(trailing_zeros(torch.clamp(a_safe, min=1)) - 1,
                    min=0, max=n_slots - 1)).long()                    # (C, K)
    if kind.criterion == "generalised":
        u_a = (_stack_dots(st["ck_vel"], s_rho) if kind.carry_vel
               else _stack_dots(ck_r, h.velocity(s_rho))) + st["sck_ad"]
        u_b = _stack_dots(st["ck_d"], vel_new)
        turn_slot = (u_a <= 0) | (u_b <= -_dot(s_rho, vel_new)[:, None])
        turn_k = torch.gather(turn_slot, 1, slot_a)
    elif kind.criterion == "classic":
        # Δθ in tree order is ±(θ_i − θ_a), the sign the direction's
        vsign = v.to(vel_new.dtype)[:, None]
        th_va = (_stack_dots(st["ck_vel"], theta_new) if kind.carry_vel
                 else _stack_dots(ck_r, h.velocity(theta_new)))
        d_a = vsign * (th_va - st["sck_tv"])
        d_b = vsign * (_dot(theta_new, vel_new)[:, None]
                       - _stack_dots(st["ck_theta"], vel_new))
        turn_k = torch.gather((d_a <= 0) | (d_b <= 0), 1, slot_a)
    else:
        dtype = vel_new.dtype

        def rows(ck, slots):
            return torch.gather(ck, 1, slots[:, :, None].expand(
                c, slots.shape[1], d)).to(dtype)

        r_a, cum_a = rows(ck_r, slot_a), rows(st["ck_cum"], slot_a)
        vel_a = (rows(st["ck_vel"], slot_a) if kind.carry_vel
                 else h.velocity_rows(r_a))
        rho_span = s_rho[:, None] - cum_a + r_a                       # (C, K, D)
        turn_k = (_dot(rho_span, vel_a) <= 0) | (
            _dot(rho_span, vel_new[:, None]) <= 0)
        # the half-spans of span k ≥ 2: a..mid and mid+1..i, mid = a +
        # 2^(k−1) − 1 (odd) and mid + 1 (even) both at slot k − 2
        mid = torch.clamp(ks.long() - 2, min=0)[None].expand(c, -1)
        r_m1, cum_m1 = rows(ck_r, mid), rows(st["ck_cum"], mid)
        r_m = rows(st["ck_odd_r"], mid)
        if kind.carry_vel:
            vel_m1, vel_m = rows(st["ck_vel"], mid), rows(st["ck_odd_vel"],
                                                          mid)
        else:
            vel_m1, vel_m = h.velocity_rows(r_m1), h.velocity_rows(r_m)
        rho_h1 = (cum_m1 - r_m1) - cum_a + r_a
        rho_h2 = s_rho[:, None] - cum_m1 + r_m1
        # in tree order the checks of the two halves are these for a
        # forward doubling, and the same two for a backward one
        x1 = rho_h1 + r_m1
        x2 = r_m + rho_h2
        sub_turn = ((_dot(x1, vel_a) <= 0) | (_dot(x1, vel_m1) <= 0)
                    | (_dot(x2, vel_m) <= 0)
                    | (_dot(x2, vel_new[:, None]) <= 0))
        turn_k = turn_k | (sub_turn & (ks >= 2))
    return torch.any(active & turn_k, 1)


def _scatter_rows(ck, slot, rows):
    c, _, d = ck.shape
    ck.scatter_(1, slot[:, None, None].expand(c, 1, d),
                rows[:, None].to(ck.dtype))


def _store(st, i, z_new, s_rho, vel_new, write, kind=_GENERALISED):
    """Store leaf `i`'s checkpoint where `write` holds (even leaves), in
    place; the other chains write to the spare slot, which nothing reads."""
    n_slots = st["ck_r"].shape[1] - 1
    slot_even = torch.where(
        i == 0, n_slots - 1,
        torch.clamp(trailing_zeros(torch.clamp(i, min=1)) - 1,
                    max=n_slots - 1))
    slot_w = torch.where(write, slot_even, n_slots).long()
    _scatter_rows(st["ck_r"], slot_w, z_new.r)
    if kind.carry_vel:
        _scatter_rows(st["ck_vel"], slot_w, vel_new)
    if kind.criterion == "generalised":
        d_row = z_new.r - s_rho
        _scatter_rows(st["ck_d"], slot_w, d_row)
        st["sck_ad"].scatter_(1, slot_w[:, None], _dot(d_row, vel_new)[:, None])
    elif kind.criterion == "classic":
        _scatter_rows(st["ck_theta"], slot_w, z_new.theta)
        st["sck_tv"].scatter_(1, slot_w[:, None],
                              _dot(z_new.theta, vel_new)[:, None])
    else:
        _scatter_rows(st["ck_cum"], slot_w, s_rho)


def _store_odd(st, i, r, write, vel=None):
    """Strict: store the momentum `r` of the odd leaf `i` (and its velocity
    `vel`, where the loop carries velocities) at slot tz(i+1)−1 where
    `write` holds, in place (the spare slot elsewhere)."""
    n_slots = st["ck_odd_r"].shape[1] - 1
    slot_odd = torch.clamp(trailing_zeros(i + 1) - 1, min=0, max=n_slots - 1)
    slot_w = torch.where(write, slot_odd, n_slots).long()
    _scatter_rows(st["ck_odd_r"], slot_w, r)
    if vel is not None:
        _scatter_rows(st["ck_odd_vel"], slot_w, vel)


def _merge(st, h, max_depth, v, fwd, i, z_new, vel_new, sub, e_mh, act,
           kind=_GENERALISED):
    """The end of an iteration whose last leaf is leaf `i` (`z_new`,
    `vel_new`), the subtree's fields `sub` final: is the doubling finished?
    Then merge it into the tree (biased progressive sampling with `e_mh`,
    an exponential, or a uniform for slice sampling, masked by `act`).
    Returns the new state; the stacks are the same tensors."""
    n_leaves = torch.bitwise_left_shift(torch.ones_like(i), st["depth"])
    s_turning, s_diverged, s_w = sub["s_turning"], sub["s_diverged"], \
        sub["s_w"]
    sub_done = s_turning | s_diverged
    complete = sub_done | (i >= n_leaves - 1)
    not_term = ~sub_done
    # biased progressive sampling at the top level
    if kind.slice:
        take_top = complete & not_term & (st["t_w"] * e_mh < s_w)
        c_w = st["t_w"] + s_w
    else:
        take_top = complete & not_term & (st["t_w"] < s_w + e_mh)
        c_w = torch.logaddexp(st["t_w"], s_w)
    if act is not None:
        take_top = take_top & act
    # combined tree: the doubling's far edge is z_new; velocities of the old
    # edges are carried, or recomputed from their momenta (one product for
    # a dense M⁻¹)
    if kind.carry_vel:
        t_vleft, t_vright = st["t_vleft"], st["t_vright"]
    else:
        t_vleft = h.velocity(st["t_zleft"].r)
        t_vright = h.velocity(st["t_zright"].r)
    c_vleft = torch.where(fwd[:, None], t_vleft, vel_new)
    c_vright = torch.where(fwd[:, None], vel_new, t_vright)
    c_rho = st["t_rho"] + sub["s_rho"]
    if kind.criterion == "classic":
        d_theta = torch.where(fwd[:, None], z_new.theta - st["t_zleft"].theta,
                              st["t_zright"].theta - z_new.theta)
        full_turn = (_dot(d_theta, c_vleft) <= 0) | (
            _dot(d_theta, c_vright) <= 0)
    else:
        full_turn = (_dot(c_rho, c_vleft) <= 0) | (_dot(c_rho, c_vright) <= 0)
    if kind.criterion == "strict":
        # the checks across the old tree and the subtree: each joins one
        # tree's ρ to the other's edge next to it, in tree order
        s_rfirst = sub["s_rfirst"]
        s_vfirst = (sub["s_vfirst"] if kind.carry_vel
                    else h.velocity(s_rfirst))
        near_r = torch.where(fwd[:, None], st["t_zright"].r, st["t_zleft"].r)
        near_v = torch.where(fwd[:, None], t_vright, t_vleft)
        far_v = torch.where(fwd[:, None], t_vleft, t_vright)
        x_a = st["t_rho"] + s_rfirst
        x_b = near_r + sub["s_rho"]
        full_turn = (full_turn | (_dot(x_a, far_v) <= 0)
                     | (_dot(x_a, s_vfirst) <= 0) | (_dot(x_b, near_v) <= 0)
                     | (_dot(x_b, vel_new) <= 0))
    depth = st["depth"] + (complete & not_term).to(torch.int32)
    cap = st.get("cap", max_depth)     # a per-chain cap, where one is set
    out = dict(
        h0=st["h0"],
        t_zleft=_sel(complete & ~fwd, z_new, st["t_zleft"]),
        t_zright=_sel(complete & fwd, z_new, st["t_zright"]),
        t_rho=_sel(complete, c_rho, st["t_rho"]),
        zcand=_sel(take_top, sub["s_zcand"], st["zcand"]),
        t_w=_sel(complete, c_w, st["t_w"]),
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
        s_w=s_w.masked_fill(complete, _empty_weight(kind)),
        s_zcand=sub["s_zcand"],
        s_sum_alpha=sub["s_sum_alpha"].masked_fill(complete, 0.0),
        s_n_alpha=sub["s_n_alpha"].masked_fill(complete, 0),
        s_dh_max=sub["s_dh_max"].masked_fill(complete, 0.0),
        s_turning=s_turning & ~complete,
        s_diverged=s_diverged & ~complete,
    )
    if kind.criterion == "strict":
        out["s_rfirst"] = sub["s_rfirst"]
    if kind.carry_vel:
        out["t_vleft"] = _sel(complete, c_vleft, st["t_vleft"])
        out["t_vright"] = _sel(complete, c_vright, st["t_vright"])
        if kind.criterion == "strict":
            out["s_vfirst"] = sub["s_vfirst"]
    for k, val in st.items():       # the level, the cap and the stacks
        if k not in out and not k.startswith("s_"):
            out[k] = val
    return out


def _merge_draw(generator, c, dtype, dev, kind):
    """The top-level merge's draw: Exp(1), or a uniform for slice."""
    if kind.slice:
        return rand_uniform(generator, (c,), dtype, dev)
    return rand_exponential(generator, (c,), dtype, dev)


def _leaf(st, h, eps, max_depth, delta_max, generator,
          force_directions=None, act=None, integ=None, kind=_GENERALISED):
    """Advance every chain by one leaf: the body of the iterative NUTS loop
    (single-leaf form of `advancedhmc_tpu/nuts.py` `body`). It draws, for
    every chain and in this order, a direction sign, the reservoir's
    uniform and the merge's draw (an exponential; a uniform for slice
    sampling). Chains outside `act` (if given) take no candidate and store
    no checkpoint."""
    c = st["leaf"].shape[0]
    dtype, dev = st["h0"].dtype, st["h0"].device
    i = st["leaf"]
    v_draw = (rand_sign(generator, (c,), dev) if force_directions is None
              else _direction(st, force_directions, max_depth))
    v, fwd, z_edge, sub = _start(st, v_draw, kind)
    z_new, vel_new, sub = _step(h, z_edge, eps * v.to(dtype), st["h0"],
                                delta_max, sub, generator, integ,
                                st.get("lu"))
    strict = kind.criterion == "strict"
    if strict:
        sub["s_rfirst"] = torch.where((i == 0)[:, None], z_new.r,
                                      st["s_rfirst"])
        if kind.carry_vel:
            sub["s_vfirst"] = torch.where((i == 0)[:, None], vel_new,
                                          st["s_vfirst"])
    i_even = (i % 2) == 0
    sub["s_turning"] = sub["s_turning"] | _span_turn(
        st, h, i, sub["s_rho"], vel_new, max_depth, ~i_even, kind,
        z_new.theta, v)
    even = i_even if act is None else i_even & act
    _store(st, i, z_new, sub["s_rho"], vel_new, even, kind)
    if strict:
        _store_odd(st, i, z_new.r, ~i_even if act is None else ~i_even & act,
                   vel_new if kind.carry_vel else None)
    e_mh = _merge_draw(generator, c, dtype, dev, kind)
    return _merge(st, h, max_depth, v, fwd, i, z_new, vel_new, sub, e_mh,
                  act, kind)


def _direction(st, directions, max_depth):
    """Each chain's direction from a (max_depth,) table of ±1, at its depth."""
    fd = torch.as_tensor(directions, dtype=torch.int32,
                         device=st["depth"].device)
    return fd[torch.clamp(st["depth"], max=max_depth - 1).long()]


def _leaf_pair(st, h, eps, max_depth, delta_max, generator, act=None,
               directions=None, integ=None, kind=_GENERALISED):
    """Advance every chain by the aligned (even, odd) leaf pair of its
    current doubling, or by the lone leaf of a depth-0 doubling: the
    leaf-pair body (`advancedhmc_tpu/nuts.py` `body_pair`). Every chain is
    at leaf 0 or at an even leaf mid-doubling (a doubling of depth ≥ 1 is
    whole pairs), so the pair never straddles two doublings.

    Leaf A (even) stores the checkpoint (classic's θ with it); only leaf B
    (odd) runs the span checks and, for the strict criterion, stores the
    odd-leaf checkpoint; at most one completion and merge happens. A
    divergence at A, or a depth-0 doubling, ends the pair at A: B is
    computed and fully masked (its odd-leaf write too). The draws are those
    of two `_leaf` calls, in their order, for every chain: A's sign,
    uniform and merge draw, then B's (B's sign is never used); the merge
    takes B's draw when the pair goes on and A's when it ends at A. With a
    table of `directions` (coupled chains) no sign is drawn, as in
    `_leaf`."""
    c = st["leaf"].shape[0]
    dtype, dev = st["h0"].dtype, st["h0"].device
    h0, i_a, lu = st["h0"], st["leaf"], st.get("lu")
    v, fwd, z_edge, sub = _start(
        st, rand_sign(generator, (c,), dev) if directions is None
        else _direction(st, directions, max_depth), kind)
    eps_v = eps * v.to(dtype)
    # leaf A (even): its checkpoint; no span ends at an even leaf
    z_a, vel_a, sub_a = _step(h, z_edge, eps_v, h0, delta_max, sub,
                              generator, integ, lu)
    strict = kind.criterion == "strict"
    if strict:
        sub_a["s_rfirst"] = torch.where((i_a == 0)[:, None], z_a.r,
                                        st["s_rfirst"])
        if kind.carry_vel:
            sub_a["s_vfirst"] = torch.where((i_a == 0)[:, None], vel_a,
                                            st["s_vfirst"])
    e_a = _merge_draw(generator, c, dtype, dev, kind)
    n_leaves = torch.bitwise_left_shift(torch.ones_like(i_a), st["depth"])
    pair_go = ~(sub_a["s_diverged"] | (i_a >= n_leaves - 1))
    _store(st, i_a, z_a, sub_a["s_rho"], vel_a,
           torch.ones_like(pair_go) if act is None else act, kind)
    # leaf B (odd): the span checks
    if directions is None:
        rand_sign(generator, (c,), dev)
    z_b, vel_b, sub_b = _step(h, z_a, eps_v, h0, delta_max, sub_a, generator,
                              integ, lu)
    e_b = _merge_draw(generator, c, dtype, dev, kind)
    i_b = i_a + 1
    sub_b["s_turning"] = sub_b["s_turning"] | _span_turn(
        st, h, i_b, sub_b["s_rho"], vel_b, max_depth, pair_go, kind,
        z_b.theta, v)
    if strict:
        _store_odd(st, i_b, z_b.r, pair_go if act is None else pair_go & act,
                   vel_b if kind.carry_vel else None)
    sub = {k: _sel(pair_go, sub_b[k], sub_a[k]) for k in sub_a}
    return _merge(st, h, max_depth, v, fwd, torch.where(pair_go, i_b, i_a),
                  _sel(pair_go, z_b, z_a), _sel(pair_go, vel_b, vel_a), sub,
                  torch.where(pair_go, e_b, e_a), act, kind)


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
                    coupled_key=None, _pair=False):
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

    Every no-U-turn criterion runs, with multinomial or slice sampling; for
    slice sampling the level ℓu is drawn first, one Exp(1) a chain, before
    any leaf's draws.

    Test hooks: `force_directions` ((max_depth,) array of ±1) overrides the
    per-doubling direction draw (and `coupled_key`); `return_debug` also
    returns the final loop state (tree edges, ρ, the weight `t_w`: a log
    weight, or the count of acceptable leaves for slice sampling; its
    level `lu`; the stacks).
    `_pair` runs the leaf-pair body (`_leaf_pair`) after the first
    iteration, which is every chain's lone depth-0 leaf and runs as one
    `_leaf`: so the generator is drawn exactly as with the single-leaf
    body, and the transition gives the same bits, every field and every
    stack slot that a check reads (the spare slot is a write-only sink)."""
    kind = _kind(traj, h)
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
        directions = rand_sign(coupled_key, (max_depth,), dev, chains=False)
    st = _initial_state(z0, max_depth, traj.stack_torch_dtype, kind,
                        generator, h)
    first = True
    while not all_chains(st["done"]):
        running = ~st["done"]     # finished chains keep their state
        if _pair and not first:
            new = _leaf_pair(st, h, eps, max_depth, crit.delta_max,
                             generator, act=running, directions=directions,
                             integ=integ, kind=kind)
        else:
            new = _leaf(st, h, eps, max_depth, crit.delta_max, generator,
                        directions, act=running, integ=integ, kind=kind)
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
                           adapt_flags=None, unroll: int = 1,
                           out_dtype=None, batched: bool = True,
                           metric_batch=None, eps_batch=None,
                           stage_slots: int = 0, t_min=None,
                           pack_carry: str = "", depth_caps=None,
                           pair: bool = False):
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
    `refreshment` there, and for slice sampling the level ℓu is drawn
    anew from the refreshed energy (refresh, level, then jitter).

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

    Ragged mode (`t_min`, 1 ≤ t_min < n_transitions; the draw phase on the
    single-leaf body with full refreshment): the loop runs until every
    chain has completed at least `t_min` transitions, and a chain that
    gets there early keeps sampling, up to `n_transitions`. Returns
    (z_final, thetas, stats, counts (C,)): chain c's draws and stats are
    rows [0, counts[c]), zero past them (`is_accept` false, `nom_step_size`
    0), and `z_final` is each chain's last completed candidate (a tree in
    flight when the loop stops is dropped). The loop reads its exit back
    every `_CHECK_EVERY` iterations; the iterations after every chain
    reached `t_min` are masked no-ops, so the counts follow the stopping
    rule exactly, and each chain's rows are those of the rectangular run
    from the same generator state.

    The JAX function's layout options, each with its meaning and its
    errors; none changes a value. `unroll` runs `unroll` times
    `_CHECK_EVERY` iterations between two read-backs of the exit (JAX:
    loop bodies a while-loop iteration; the port's loop has one layout, so
    it takes `unroll` in batched mode too). `stage_slots` (JAX: record
    the draws into a small stage flushed into the output every NS
    iterations) is taken with the JAX function's checks and changes
    nothing: the port's loop scatters each finished transition straight
    into the full output buffer, which it allocates in any case, so a
    stage would save no memory and only add launches. `out_dtype` stores
    the draw buffer in that dtype (e.g. bfloat16); the draws come back
    rounded through it, in θ's dtype. `pack_carry` ("fc"
    or "cf") packs the JAX loop's scalar carry into one array; the port's
    loop has no carry to pack, so it is taken, with the JAX function's
    checks, and changes nothing. `metric_batch` (a per-chain metric) and
    `eps_batch` ((C,) nominal step sizes) give each chain its own M⁻¹ and
    ε, as `h` and `traj` may carry them already. `batched=False` is the
    JAX function's one-chain call: `z0` (and a warmup's `adapt_state`)
    without the chain axis, outputs without it.
    """
    if not batched:
        if eps_batch is not None:
            raise ValueError("eps_batch requires batched mode")
        out = nuts_transitions_fused(
            generator, h, traj, _map_tree(lambda x: x[None], z0),
            n_transitions, refreshment, adapt_cfg,
            None if adapt_state is None else _map_tree(
                lambda x: x[None], adapt_state), adapt_flags, unroll,
            out_dtype, True, metric_batch, None, stage_slots, t_min,
            pack_carry, depth_caps, pair)
        return tuple(_map_tree(lambda x: x[0], o) for o in out)
    kind = _kind(traj, h)
    if kind.carry_vel:
        raise ValueError("the fused loop runs on a Euclidean metric; "
                         "Riemannian NUTS runs `nuts_transition`")
    crit = traj.criterion
    max_depth = int(crit.max_depth)
    c, d = z0.theta.shape
    dtype, dev = z0.theta.dtype, z0.theta.device
    if metric_batch is not None:
        h = dataclasses.replace(h, metric=metric_batch)
    integ = traj.integrator
    if eps_batch is not None:
        integ = integ.with_nom_step_size(
            torch.as_tensor(eps_batch, dtype=dtype, device=dev))
    eps = torch.as_tensor(integ.current_step_size, dtype=dtype, device=dev)
    nom = torch.as_tensor(integ.nom_step_size, dtype=dtype, device=dev)
    jittered = isinstance(integ, JitteredLeapfrog)
    if jittered:
        eps = torch.broadcast_to(eps, (c,)).clone()
    n_t = n_transitions
    adaptive = adapt_cfg is not None
    adapt_metric = adaptive and adapt_cfg.uses_mm
    ragged = t_min is not None
    staged = bool(stage_slots and 0 < stage_slots < n_t)
    if pack_carry:
        if staged or ragged:
            raise ValueError(
                "pack_carry cannot be combined with stage_slots or t_min: "
                "the staged/ragged loop layouts would silently take "
                "precedence and the packed path would never run")
        if n_t >= 2 ** 24:
            raise ValueError(
                "pack_carry packs int32 counters into f32 columns, exact "
                f"only below 2**24; n_transitions={n_t} violates that")
    if ragged and (unroll != 1 or staged):
        raise ValueError(
            "variable-draws mode requires the batch-explicit single-loop "
            "layout (batched=True, unroll=1, stage_slots=0)")
    if ragged:
        if not 1 <= int(t_min) < n_t:
            raise ValueError("t_min must satisfy 1 <= t_min < "
                             "n_transitions (a rectangular run takes no "
                             "t_min)")
        if adaptive:
            raise ValueError("the ragged mode is draw-phase only (the "
                             "adaptation schedule is indexed by each "
                             "chain's transition count)")
        if not isinstance(refreshment, FullMomentumRefreshment):
            raise ValueError("the ragged mode needs full momentum "
                             "refreshment (each chain resumes from its last "
                             "completed candidate)")
        if pair:
            raise ValueError("the ragged mode runs on the single-leaf body "
                             "(pair=False)")
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
                        traj.stack_torch_dtype, kind, generator)
    if depth_caps is not None:
        caps = torch.clamp(torch.as_tensor(np.asarray(depth_caps),
                                           dtype=torch.int32, device=dev),
                           max=max_depth)
        if caps.shape != (n_t,):
            raise ValueError(f"depth_caps must have shape ({n_t},)")
        st["cap"] = caps[0].expand(c).clone()
    t = torch.zeros(c, dtype=torch.int32, device=dev)
    all_done = torch.zeros(c, dtype=torch.bool, device=dev)
    if ragged:
        # each chain's last completed candidate, and the device flag that
        # every chain has t_min transitions (then every chain idles)
        z_last = st["zcand"]
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
    # one spare row: chains that record nothing write there
    out_theta = z0.theta.new_zeros(c, n_t + 1, d,
                                   dtype=as_dtype(out_dtype) or dtype)
    out_stats = z0.theta.new_zeros(c, n_t + 1, len(_STAT_FIELDS))
    n_f = len(_STAT_FIELDS)
    check_every = _CHECK_EVERY * unroll
    # the generator's state after each iteration since the last read-back,
    # and whether this rank's chains were all done (ragged: stopped) after
    # it: the loop ends with the generator as it was after the first such
    # iteration, so the masked iterations run past it draw nothing that
    # counts and the stream after the call does not depend on the cadence
    # of the exit's read-back (`unroll`, `_CHECK_EVERY`)
    states = [None] * check_every
    done_at = torch.zeros(check_every, dtype=torch.bool, device=dev)
    it = 0
    while True:
        with profiling.span("ahmc.nuts.leaf_iteration", iteration=True):
            act = ~all_done & ~stopped if ragged else ~all_done
            st2 = (_leaf_pair if pair else _leaf)(
                st, h, eps, max_depth, crit.delta_max, generator, act=act,
                integ=integ, kind=kind)
            boundary = st2["done"] & act
            zc = st2["zcand"]
            s = _stats(zc, st2["h0"], st2["n_alpha"], st2["sum_alpha"],
                       st2["dh_max"], st2["depth"], st2["diverged"], eps)
            vals = torch.stack([s[k].to(dtype) for k in _STAT_FIELDS], -1)
            row = torch.where(boundary, t, n_t).long()[:, None, None]
            out_theta.scatter_(1, row.expand(c, 1, d),
                               zc.theta[:, None].to(out_theta.dtype))
            out_stats.scatter_(1, row.expand(c, 1, n_f), vals[:, None])
            t_done = t
            t = t + boundary.to(torch.int32)
            all_done = t >= n_t
            reset = boundary & ~all_done
            if ragged:
                z_last = select_phasepoint(boundary, zc, z_last)
                stopped = stopped | all_chains_t(t >= t_min)

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
                    h_next = dataclasses.replace(
                        h, metric=DenseEuclideanMetric(
                            m_inv=torch.where(reset[:, None, None],
                                              ad.mm.m_inv, h.metric.m_inv),
                            chol_u=torch.where(new,
                                               cholesky_upper(ad.mm.m_inv),
                                               h.metric.chol_u)))
                elif adapt_metric:
                    h_next = dataclasses.replace(
                        h, metric=DiagEuclideanMetric.create(torch.where(
                            reset[:, None], ad.mm.m_inv, h.metric.m_inv)))
            # prepare the next transition of the chains that just finished one
            z_next = refreshment.refresh(generator, h_next, zc)
            fresh = _fresh_fields(z_next, z_next.energy(), kind, generator)
            if jittered:
                eps = torch.where(
                    reset, integ.with_nom_step_size(nom_next).jitter(
                        generator, c).current_step_size, eps)
            elif adaptive:
                eps = torch.where(reset, nom_next, eps)
            st = {k: _sel(reset, fresh[k], v) if k in fresh else v
                  for k, v in st2.items()}
            if depth_caps is not None:
                st["cap"] = torch.where(
                    boundary, caps[torch.clamp(t, max=n_t - 1).long()],
                    st2["cap"])
            h = h_next
            k = it % check_every
            with profiling.span("ahmc.nuts.rng_state"):
                states[k] = generator.get_state()
            if ragged:
                done_at[k] = stopped
            else:
                torch.all(all_done, 0, out=done_at[k])
            it += 1
            if it % check_every == 0:
                with profiling.span("ahmc.nuts.exit_read"):
                    done = (bool(stopped) if ragged
                            else all_chains(all_done))
                if done:
                    break
    # the first iteration of the window after which every rank was done
    # (`argmax` gives the first True; done stays done)
    generator.set_state(states[int(max_chains(done_at.to(torch.int32)
                                              .argmax()))])

    out = out_stats[:, :n_t]
    stats = {k: out[..., j] for j, k in enumerate(_STAT_FIELDS)}
    for k in ("n_steps", "tree_depth"):
        stats[k] = stats[k].to(torch.int32)
    stats["numerical_error"] = stats["numerical_error"] > 0
    stats["is_accept"] = torch.ones_like(stats["numerical_error"])
    stats["nom_step_size"] = (
        torch.broadcast_to(nom[:, None] if nom.dim() else nom, (c, n_t))
        if jittered else stats["step_size"])
    if ragged:
        valid = torch.arange(n_t, device=dev)[None] < t[:, None]
        stats["is_accept"] = valid
        stats["nom_step_size"] = torch.where(valid, stats["nom_step_size"],
                                             0.0)
    thetas = out_theta[:, :n_t].to(dtype)
    if ragged:
        return z_last, thetas, stats, t
    if adaptive:
        return st["zcand"], thetas, stats, ad
    return st["zcand"], thetas, stats


def _map_tree(fn, tree):
    """`tree` (a phase point, an adaptation state, a tensor, a tuple or a
    dict of them) with `fn` applied to every tensor leaf."""
    from .checkpoint import _flatten

    leaves, rebuild = _flatten(tree)
    return rebuild([fn(x) if isinstance(x, torch.Tensor) else x
                    for _, x in leaves])

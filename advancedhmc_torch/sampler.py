"""Sampling: initial state, the step-by-step and the fused phases, `sample`.

PyTorch counterpart of `advancedhmc_tpu/sampler.py`. At its defaults
`sample` adapts each chain on its own (per-chain Stan adaptation: each chain
has its own ε, diagonal M⁻¹, dual-averaging and Welford state) and runs one
`sample_step` per iteration. `cross_chain=True` shares one adaptation state
over the chain batch (the Welford moments pooled over it). The draws run
step by step or, with `fuse_draws`, through `fused_draw_phase`; a warmup
runs fused with `fuse_warmup`: per chain with the adaptation inside the
fused loop (`fused_warmup_phase`), or cross-chain in blocks
(`fused_warmup_phase_crosschain`), optionally on a sub-pool that
`fanout_warmup_state` fans out, or depth-capped. `fuse_pair` runs the fused
phases on the leaf-pair body, `fuse_chain_chunks` in sequential chain
sub-batches; `thin`, `collect="online"`, `coupled` and the progress display
are the JAX function's. A static trajectory (`FixedNSteps`,
`FixedIntegrationTime`: HMC, HMCDA) runs step by step through
`trajectory.transition_static`, as in JAX, where the fused paths and the
depth caps are for NUTS alone. Randomness comes from one `torch.Generator`
on the sampler's device, passed to each function; the state carries no
key. `SampleResult` exports the draws (`to_inference_dict`, `summary`,
`to_arviz`), named by the target, and `save` writes it to one npz
(`checkpoint.save_result`). `SampleSpec.kinetic` takes the Gaussian or the
relativistic kinetic energy. `mesh` shards the chain axis over one
process per GPU (`parallel`), each rank holding its block of the chains.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from . import profiling
from .adaptation import (
    MM_LOWRANK,
    MM_NUTPIE,
    MM_WELFORD_COV,
    MM_WELFORD_VAR,
    NONE,
    STAN,
    AdaptorConfig,
    AdaptState,
    DualAveragingState,
    adapt_flags,
    adapt_step,
    adapt_step_batch,
    da_update,
)
from .diagnostics import ess_bulk, ess_tail, online_init, online_summary, \
    online_update, rhat, summarize
from .hamiltonian import Hamiltonian, PhasePoint
from .kinetic import GaussianKinetic, RelativisticKinetic
from .metrics import DenseEuclideanMetric, DiagEuclideanMetric, Metric, \
    RankUpdateEuclideanMetric, UnitEuclideanMetric
from .nuts import _STAT_FIELDS, nuts_transition, nuts_transitions_fused
from .stepsize_search import find_good_stepsize, find_good_stepsizes
from .target import LogDensityTarget, leaves_with_names
from .termination import DynamicTerminationCriterion
from .trajectory import HMCKernel, transition_static
from .transforms import constrain
from .utils import chain_block, chain_index, chain_shard, check_generators, \
    current_shard, first_chain, gather_chains, local_chains, resolve_device

_PREFIX = "[advancedhmc_torch]"

@dataclasses.dataclass(frozen=True)
class HMCState:
    """Resumable sampler state: chain-batched phase points, the metric and
    the adaptation state, shared by the chains (cross-chain adaptation) or
    with a leading chain axis (per chain: ε (C,), M⁻¹ (C, dim))."""

    iteration: int
    z: PhasePoint          # leading chain axis (C, ...)
    metric: Metric
    adapt: AdaptState

    @property
    def position(self):
        return self.z.theta

    def with_step_size(self, eps):
        """The state with its current ε set by hand (a `ManualSSAdaptor`
        writing ϵ mid-run): a scalar, or one a chain (C,) where the
        adaptation is per chain."""
        da = self.adapt.da
        new_eps = torch.broadcast_to(torch.as_tensor(
            eps, dtype=da.eps.dtype, device=da.eps.device),
            da.eps.shape).clone()
        return dataclasses.replace(self, adapt=dataclasses.replace(
            self.adapt, da=dataclasses.replace(da, eps=new_eps)))

    def with_position(self, spec: "SampleSpec", theta):
        """The state at new positions `theta (C, dim)`: ℓπ and ∇ℓπ
        recomputed in one batched call (a non-finite ℓπ becomes −Inf), the
        momenta and their cached −K kept."""
        theta = torch.as_tensor(theta, dtype=self.z.theta.dtype,
                                device=self.z.theta.device)
        lp, grad = spec.target.logdensity_and_grad(theta)
        return dataclasses.replace(self, z=dataclasses.replace(
            self.z, theta=theta, grad=grad,
            logdensity=torch.where(torch.isfinite(lp), lp,
                                   float("-inf"))))


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    """Static configuration of a run. `coupled` shares the NUTS doubling
    direction across chains (the reference's `rand_coupled` mode): each
    transition draws one sign per depth from the generator, and every chain
    at that depth takes it (`nuts_transition`'s `coupled_key`). `kinetic`
    is the Gaussian kinetic energy or a `RelativisticKinetic` (with a unit
    or diagonal metric)."""

    target: LogDensityTarget
    kernel: HMCKernel
    adaptor: AdaptorConfig
    cross_chain: bool = False
    kinetic: Union[GaussianKinetic, RelativisticKinetic] = GaussianKinetic()
    coupled: bool = False


def _hamiltonian(spec, state):
    return Hamiltonian(metric=state.metric, target=spec.target,
                       kinetic=spec.kinetic)


def _fields(z):
    return [f.name for f in dataclasses.fields(z)]


def _take_z(z, chains):
    """The phase points of the chains `chains`, of any phase-point class."""
    return type(z)(*(getattr(z, f)[chains] for f in _fields(z)))


def _cat_z(zs):
    return type(zs[0])(*(torch.cat([getattr(z, f) for z in zs])
                         for f in _fields(zs[0])))


def _run_fused(generator, spec, state, n_transitions, pair=False,
               chain_chunks=1, depth_caps=None, **layout):
    """One fused call at the state's frozen ε and M⁻¹, shared or per chain,
    on the leaf-pair body if `pair`, in `chain_chunks` sequential
    sub-batches of the chains (each its own loop, so the chains' streams
    differ from one loop's, in the same law), with the fused loop's
    `layout` options (`unroll`, `out_dtype`, `stage_slots`,
    `pack_carry`); outputs (T, C, ...)."""
    c = state.z.theta.shape[0]
    if c % chain_chunks:
        raise ValueError("chain_chunks must divide the chain count")
    eps = state.adapt.da.eps
    size = c // chain_chunks
    zs, ths, stats = [], [], []
    for lo in range(0, c, size):
        chains = slice(lo, lo + size)
        h = Hamiltonian(metric=state.metric.take(chains), target=spec.target,
                        kinetic=spec.kinetic)
        traj = spec.kernel.trajectory.with_nom_step_size(
            eps[chains] if eps.dim() else eps)
        z, th, st = nuts_transitions_fused(
            generator, h, traj, _take_z(state.z, chains), n_transitions,
            spec.kernel.refreshment, depth_caps=depth_caps, pair=pair,
            **layout)
        zs.append(z)
        ths.append(th.transpose(0, 1))
        stats.append({k: v.transpose(0, 1) for k, v in st.items()})
    if len(zs) == 1:
        return zs[0], ths[0], stats[0]
    return (_cat_z(zs), torch.cat(ths, 1),
            {k: torch.cat([b[k] for b in stats], 1) for k in stats[0]})


def _cat_stats(blocks):
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def _thin_block(ths, stats, thin):
    """Every `thin`-th draw of a (block, C, ...) batch: the kept rows carry
    the kept transition's stats, but `n_steps` summed over the thinned
    block and `numerical_error` OR-ed over it (as the JAX function)."""
    n_keep = ths.shape[0] // thin
    shaped = {k: v.reshape((n_keep, thin) + v.shape[1:])
              for k, v in stats.items()}
    out = {k: v[:, -1] for k, v in shaped.items()}
    out["n_steps"] = torch.sum(shaped["n_steps"], 1, dtype=torch.int32)
    out["numerical_error"] = torch.any(shaped["numerical_error"], 1)
    return ths[thin - 1::thin], out


def _capped(spec, max_depth):
    """`spec` with its NUTS tree depth capped at `max_depth`."""
    traj = spec.kernel.trajectory
    traj = dataclasses.replace(traj, criterion=dataclasses.replace(
        traj.criterion, max_depth=int(max_depth)))
    return dataclasses.replace(
        spec, kernel=dataclasses.replace(spec.kernel, trajectory=traj))


def fanout_warmup_state(spec: SampleSpec, state: HMCState,
                        n_chains: int) -> HMCState:
    """Tile a warmed cross-chain state onto `n_chains` chains.

    The warmed positions (with their cached ℓπ/∇ℓπ/ℓκ) are tiled
    cyclically: chain i takes warm chain i mod W; the shared metric and
    adaptation state are reused. Clones start at identical positions: run a
    short discarded decorrelation phase before collecting draws. Under a
    chain shard the warm pool is sharded too: it is gathered (W × dim, a
    small batch), and each rank keeps its rows of the `n_chains` (global).
    """
    pool = {f: gather_chains(getattr(state.z, f)) for f in _fields(state.z)}
    c0 = pool["theta"].shape[0]
    if not spec.cross_chain:
        raise ValueError("fanout_warmup_state requires cross_chain=True "
                         "(a shared adaptation state)")
    if n_chains < c0:
        raise ValueError(f"n_chains {n_chains} < warmed pool {c0}")
    rows = chain_index(n_chains, pool["theta"].device) % c0
    return dataclasses.replace(state, z=type(state.z)(
        **{f: x[rows] for f, x in pool.items()}))


def fused_draw_phase(generator, spec: SampleSpec, state: HMCState,
                     n_draws: int, fuse: int, *, thin: int = 1,
                     online_om=None, unroll: int = 1, progress_cb=None,
                     experimental=None, chain_chunks: int = 1,
                     pair: bool = False):
    """Post-warmup draws, `fuse` transitions per fused call, adaptation
    frozen, at the state's ε and M⁻¹ (shared, or each chain's own), on the
    leaf-pair body if `pair`, in `chain_chunks` sequential sub-batches of
    the chains. `thin` keeps every thin-th draw (it must divide `fuse`).
    Returns (state, thetas (n_draws // thin, C, dim), stats). With
    `online_om` (an `OnlineMoments`) the draws are folded into it instead
    of stored: (state, None, stats (n_draws, C), online_moments).
    `progress_cb(iteration, stats, metric)` is called after every call.
    `unroll` and `experimental` (an `experimental.Experimental`: the draw
    buffer's dtype, the stage, the packed carry) are the fused loop's
    layout options (`nuts_transitions_fused`); none changes a value but
    `out_dtype`'s rounding of the draws."""
    from .experimental import Experimental

    ex = experimental or Experimental()
    layout = dict(unroll=unroll, out_dtype=ex.out_dtype,
                  stage_slots=ex.stage_slots, pack_carry=ex.pack_carry)
    if n_draws % fuse:
        raise ValueError("fuse must divide the draw count")
    if fuse % thin:
        raise ValueError("thin must divide fuse")
    z, ths, stats, om = state.z, [], [], online_om
    with profiling.span("ahmc.nuts.draw_phase"):
        for _ in range(n_draws // fuse):
            z, th, st = _run_fused(generator, spec,
                                   dataclasses.replace(state, z=z), fuse,
                                   pair, chain_chunks, **layout)
            st["is_adapt"] = torch.zeros_like(st["numerical_error"])
            state = dataclasses.replace(
                state, iteration=state.iteration + fuse, z=z)
            if progress_cb is not None:
                progress_cb(state.iteration,
                            {k: v[-1] for k, v in st.items()}, state.metric)
            if om is not None:
                for x in th:
                    om = online_update(om, x)
            elif thin > 1:
                th, st = _thin_block(th, st, thin)
            if om is None:
                ths.append(th)
            stats.append(st)
    stats = _cat_stats(stats)
    if om is not None:
        return state, None, stats, om
    return state, torch.cat(ths), stats


def fused_warmup_phase(generator, spec: SampleSpec, state: HMCState,
                       n_adapts: int, *, pair: bool = False):
    """Per-chain warmup with the adaptation INSIDE the fused loop: each
    chain adapts on its own window schedule, by its own transition count,
    at its own transition boundaries (`nuts_transitions_fused`'s warmup
    mode), with the fused loop's asynchronous chains: the JAX function's
    reference-exact per-chain semantics. Takes per-chain adaptation and a
    unit, diagonal or dense metric: diagonal with the Welford variance or
    nutpie estimator, dense with the Welford covariance (its Cholesky
    factor refreshed in the loop at window ends), or any of them with no
    mass-matrix adaptation. Returns (state, warm_thetas (n_adapts, C,
    dim), warm_stats)."""
    cfg = spec.adaptor
    if spec.cross_chain:
        raise ValueError("fused_warmup_phase adapts each chain on its own; "
                         "use fused_warmup_phase_crosschain")
    h = _hamiltonian(spec, state)
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    z, ths, stats, ad = nuts_transitions_fused(
        generator, h, traj, state.z, n_adapts, spec.kernel.refreshment,
        adapt_cfg=cfg, adapt_state=state.adapt,
        adapt_flags=adapt_flags(cfg, n_adapts, n_adapts), pair=pair)
    metric = state.metric.renew(ad.mm.m_inv) if cfg.uses_mm else state.metric
    stats = {k: v.transpose(0, 1) for k, v in stats.items()}
    stats["is_adapt"] = torch.ones_like(stats["numerical_error"])
    return (HMCState(iteration=state.iteration + n_adapts, z=z,
                     metric=metric, adapt=ad),
            ths.transpose(0, 1), stats)


def fused_warmup_phase_crosschain(generator, spec: SampleSpec,
                                  state: HMCState, n_adapts: int, block: int,
                                  *, flags=None, depth_caps=None,
                                  pair: bool = False, progress_cb=None,
                                  chain_chunks: int = 1):
    """Cross-chain warmup with `block` transitions per fused call (on the
    leaf-pair body if `pair`, in `chain_chunks` sequential sub-batches).

    Within a block, ε and M⁻¹ stay frozen at the block start. At each block
    boundary the Welford pushes and the Stan window logic are replayed for
    every transition of the block from its recorded positions; dual
    averaging updates once per block (and at a window end or the last
    step) with the block-mean acceptance, as in the JAX package. The flags
    are host arrays, so the replay branches on the host. `depth_caps`
    ((n_adapts,) ints) caps the tree depth of each transition.
    `progress_cb(iteration, stats, metric)` is called after every block.
    Returns (state, warm_thetas (n_adapts, C, dim), warm_stats).
    """
    cfg = spec.adaptor
    if n_adapts % block:
        raise ValueError("block must divide n_adapts")
    if cfg.mm_kind == MM_NUTPIE:
        raise ValueError("the cross-chain fused warmup records positions "
                         "only; the nutpie estimator needs gradients")
    if flags is None:
        flags = adapt_flags(cfg, n_adapts, n_adapts)
    ths, stats = [], []
    for b in range(n_adapts // block):
        caps = (None if depth_caps is None
                else depth_caps[b * block:(b + 1) * block])
        z, th, st = _run_fused(generator, spec, state, block, pair,
                               chain_chunks, caps)
        # the whole batch's positions and acceptance (gathered under a
        # chain shard, so every rank folds in the unsharded batch)
        th_all = gather_chains(th, 1)
        alpha_blk = torch.mean(torch.clamp(
            gather_chains(st["acceptance_rate"], 1), max=1.0))
        da, mm = state.adapt.da, state.adapt.mm
        for t in range(block):
            it = b * block + t
            if not flags["is_adapt"][it]:
                continue
            w_end = bool(flags["window_end"][it])
            is_last = bool(flags["is_last"][it])
            if cfg.uses_da and (t == block - 1 or w_end or is_last):
                da = da_update(cfg.da, da, alpha_blk)
            if cfg.uses_mm:
                if flags["in_window"][it]:
                    mm = mm.push_batch(th_all[t])
                if w_end if cfg.kind == STAN else flags["in_window"][it]:
                    mm = mm.update_estimate()
                if w_end:
                    mm = mm.reset()
            if cfg.uses_da and cfg.kind == STAN and w_end:
                da = da.reset()
            if cfg.uses_da and is_last:
                da = da.finalize()
        metric = state.metric.renew(mm.m_inv) if cfg.uses_mm else state.metric
        state = HMCState(iteration=state.iteration + block, z=z,
                         metric=metric, adapt=AdaptState(da=da, mm=mm))
        st["is_adapt"] = torch.ones_like(st["numerical_error"])
        if progress_cb is not None:
            progress_cb(state.iteration, {k: v[-1] for k, v in st.items()},
                        state.metric)
        ths.append(th)
        stats.append(st)
    return state, torch.cat(ths), _cat_stats(stats)


def _transition(generator, spec: SampleSpec, state: HMCState):
    """Jitter, momentum refresh, then one transition of every chain at its
    ε and M⁻¹: NUTS for a dynamic criterion, `transition_static` for a
    static one (the JAX package's `_one_chain_transition`, vmapped). A
    jittered integrator draws one ε per chain; plain `Leapfrog` draws
    nothing. Coupled chains draw their shared directions (NUTS) or split
    (static) from the same generator (`SampleSpec`)."""
    h = _hamiltonian(spec, state)
    traj = spec.kernel.trajectory
    integ = traj.integrator.with_nom_step_size(state.adapt.da.eps).jitter(
        generator, state.z.theta.shape[0])
    traj = dataclasses.replace(traj, integrator=integ)
    z = spec.kernel.refreshment.refresh(generator, h, state.z)
    coupled = generator if spec.coupled else None
    if isinstance(traj.criterion, DynamicTerminationCriterion):
        return nuts_transition(generator, h, traj, z, coupled_key=coupled)
    return transition_static(generator, h, traj, z, coupled_key=coupled)


def sample_step(generator, spec: SampleSpec, state: HMCState, flags):
    """One transition of every chain, then one adaptation step: shared
    (`adapt_step_batch`) or each chain's own (`adapt_step`). `flags` holds
    this iteration's adaptation flags as booleans; the metric is renewed
    from the estimate at every adaptation step. Returns (state, stats of
    (C,)), the stats with `is_adapt`."""
    cfg = spec.adaptor
    z, stats = _transition(generator, spec, state)
    step = adapt_step_batch if spec.cross_chain else adapt_step
    adapt = step(cfg, state.adapt, z.theta, z.grad, stats["acceptance_rate"],
                 flags)
    metric = state.metric
    if cfg.uses_mm and flags["is_adapt"]:
        metric = metric.renew(adapt.mm.m_inv)
    stats["is_adapt"] = torch.full_like(stats["numerical_error"],
                                        flags["is_adapt"])
    return HMCState(iteration=state.iteration + 1, z=z, metric=metric,
                    adapt=adapt), stats


# the integer and boolean stats of a transition; the others take θ's dtype
_STAT_DTYPES = {"n_steps": torch.int32, "tree_depth": torch.int32,
                "is_accept": torch.bool, "numerical_error": torch.bool,
                "is_adapt": torch.bool}
_STATS = _STAT_FIELDS + ("is_accept", "nom_step_size", "is_adapt")
# a static transition's: no tree
_STATIC_STATS = tuple(k for k in _STATS if k not in (
    "max_hamiltonian_energy_error", "tree_depth"))


def _rows(n, c, theta, draws=True, keys=_STATS):
    """Buffers for `n` rows of `c` chains of θ's width and dtype: θ (n, c,
    dim), or None without `draws`, and each stat of `keys` (n, c)."""
    return theta.new_empty((n, c, theta.shape[-1])) if draws else None, {
        k: theta.new_empty((n, c), dtype=_STAT_DTYPES.get(k, theta.dtype))
        for k in keys}


def _part(rows, lo, hi):
    """Rows lo..hi-1 of `rows`, as views."""
    return (None if rows[0] is None else rows[0][lo:hi],
            {k: v[lo:hi] for k, v in rows[1].items()})


def _fill(rows, thetas, stats):
    """Copy a phase's θ (where `rows` keep them) and stats into `rows` (as
    many rows)."""
    if rows[0] is not None:
        rows[0].copy_(thetas)
    for k, v in rows[1].items():
        v.copy_(stats[k])


def _step_loop(generator, spec, state, flags, lo, hi, rows=None, thin=1,
               om=None, progress_cb=None):
    """`sample_step` at the run's iterations lo..hi-1 (`flags` are the
    run's `adapt_flags`). Every `thin`-th iteration writes its θ (where
    `rows` keep them) and stats into the next row of `rows` (if given),
    with `n_steps` summed and `numerical_error` OR-ed over its thinned
    block; `om` (an `OnlineMoments`) folds in every iteration's θ;
    `progress_cb(iteration, stats, metric)` sees every iteration. Returns
    (state, om)."""
    n_steps = diverged = None
    for i, t in enumerate(range(lo, hi)):
        state, st = sample_step(generator, spec, state,
                                {k: bool(v[t]) for k, v in flags.items()})
        if om is not None:
            om = online_update(om, state.z.theta)
        if progress_cb is not None:
            progress_cb(state.iteration, st, state.metric)
        if thin > 1:
            n_steps = st["n_steps"] if n_steps is None \
                else n_steps + st["n_steps"]
            diverged = st["numerical_error"] if diverged is None \
                else diverged | st["numerical_error"]
            if (i + 1) % thin:
                continue
            st = dict(st, n_steps=n_steps, numerical_error=diverged)
            n_steps = diverged = None
        if rows is not None:
            row = i // thin
            if rows[0] is not None:
                rows[0][row] = state.z.theta
            for k, v in st.items():
                rows[1][k][row] = v
    return state, om


def init_state(generator, spec: SampleSpec, metric: Metric, init_theta,
               init_eps=None, n_chains: Optional[int] = None,
               init_mass_matrix: str = "identity", device=None) -> HMCState:
    """Initial batched state on `device` (None means CUDA).

    `init_mass_matrix="gradient"` seeds the diagonal M⁻¹ from the gradient
    at the initial positions, M⁻¹_j = 1/mean|∇_j ℓπ|. Without `init_eps` the
    step size comes from the search `find_good_stepsize`: per chain, each
    from its own position (`find_good_stepsizes`), or on the first chain for
    cross-chain adaptation. Per chain, a scalar or (C,) `init_eps` seeds
    each chain's dual averaging and the metric is repeated for each chain;
    cross-chain adaptation takes a scalar.
    """
    device = resolve_device(device)
    theta = torch.as_tensor(init_theta, device=device)
    if theta.dim() == 1:
        theta = theta[None].expand(n_chains or 1, -1)
    theta = theta.contiguous()
    c, dtype = theta.shape[0], theta.dtype

    if init_mass_matrix == "gradient":
        if not isinstance(metric, DiagEuclideanMetric):
            raise ValueError(
                "init_mass_matrix='gradient' requires a diagonal metric")
        _, grads = spec.target.logdensity_and_grad(theta)
        g = torch.mean(torch.abs(gather_chains(grads)), 0)
        metric = DiagEuclideanMetric.create(
            (1.0 / torch.clamp(g, 1e-3, 1e6)).to(dtype))
    elif init_mass_matrix != "identity":
        raise ValueError(f"unknown init_mass_matrix {init_mass_matrix!r}")

    if spec.adaptor.uses_mm and spec.adaptor.mm_kind == MM_LOWRANK:
        # the estimator renews (a_diag, b, d) at rank mm_rank: the metric
        # carries that rank (a rank-0 identity is upgraded to it)
        if not isinstance(metric, RankUpdateEuclideanMetric):
            raise ValueError(
                "mm_kind='lowrank' adapts a RankUpdateEuclideanMetric; got "
                f"{type(metric).__name__}")
        k = min(spec.adaptor.mm_rank, metric.dim)
        if metric.rank != k:
            if metric.rank != 0:
                raise ValueError(
                    f"metric rank {metric.rank} != adaptor mm_rank {k}; "
                    "pass make_metric('rank_update', dim, rank=mm_rank) or "
                    "a rank-0 identity (auto-upgraded)")
            metric = RankUpdateEuclideanMetric.identity(
                metric.dim, dtype=metric.dtype, device=metric.device, rank=k)

    h = Hamiltonian(metric=metric, target=spec.target, kinetic=spec.kinetic)
    if init_eps is not None:
        eps0 = torch.as_tensor(init_eps, dtype=dtype, device=device)
    elif spec.cross_chain:
        eps0 = _search_first_chain(generator, h, theta)
    else:
        eps0 = find_good_stepsizes(generator, h, theta)
    z = h.init_phasepoint(generator, theta)
    if not spec.cross_chain:
        eps0 = torch.broadcast_to(eps0, (c,)).clone()
        metric = metric.per_chain(c)
    elif eps0.dim() != 0:
        raise ValueError("cross-chain adaptation shares one dual-averaging "
                         "state; init_eps must be a scalar")
    return HMCState(iteration=0, z=z, metric=metric,
                    adapt=AdaptState.init(spec.adaptor, spec.target.dim,
                                          eps0, dtype))


@dataclasses.dataclass
class SampleResult:
    """Draws + per-transition statistics + final state.

    With `collect="online"` the draws are not stored: `thetas` is None and
    `online` carries the storage-free summary (n, per-chain mean and
    variance, pooled bulk ESS) of `diagnostics.online_summary`. `timings`
    holds the wall seconds of each phase ("init_s", "warmup_s" — warmup,
    fan-out and decorrelation — and "draws_s"), each ending in a device
    synchronise. `target` is the sampled target (`sample` and
    `sample_chees` set it): the exports name parameters from its `unravel`
    (`target_from_pytree`) or its `names` and `transforms`
    (`transforms.transformed_target`). `save` writes it to one npz
    (`checkpoint.save_result`; `timings` and `target` are not saved)."""

    thetas: Optional[torch.Tensor]         # (n_kept, n_chains, dim) or None
    stats: Dict[str, torch.Tensor]         # each (n_kept, n_chains)
    warmup_stats: Optional[Dict[str, torch.Tensor]]
    final_state: HMCState
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    online: Optional[Dict[str, torch.Tensor]] = None
    target: Optional[Any] = None

    @property
    def n_chains(self):
        if self.thetas is not None:
            return self.thetas.shape[1]
        return self.final_state.z.theta.shape[0]

    def _named_posterior(self, flat, constrained: bool):
        """Flat draws (chain, draw, dim), a numpy array, split into named
        variables: one a leaf of a pytree target with the leaf's shape,
        one a block of a transformed target mapped to the constrained
        space (`constrained`), else "theta"."""
        tgt = self.target
        if constrained:
            transforms = getattr(tgt, "transforms", None)
            if transforms is None:
                raise ValueError(
                    "constrained=True requires a target built by "
                    "transforms.transformed_target")
            names = getattr(tgt, "names", None) or [
                f"x{i}" for i in range(len(transforms))]
            blocks = constrain(transforms, torch.from_numpy(flat))
            return {n: b.numpy() for n, b in zip(names, blocks)}
        unravel = getattr(tgt, "unravel", None)
        if unravel is None:
            return {"theta": flat}
        example = unravel(torch.zeros(tgt.dim, dtype=torch.float64))
        post, off = {}, 0
        for name, leaf in leaves_with_names(example):
            size = leaf.numel()
            post[name or "theta"] = flat[..., off:off + size].reshape(
                flat.shape[:2] + tuple(leaf.shape))
            off += size
        return post

    def to_inference_dict(self, constrained: bool = False):
        """ArviZ's layout as numpy arrays: `posterior`, each variable
        (chain, draw, *shape), named as `_named_posterior` names them, and
        `sample_stats` (lp, diverging, acceptance_rate, energy, tree_depth,
        n_steps, step_size), each (chain, draw)."""
        if self.thetas is None:
            raise ValueError("draws were not stored (collect='online')")
        flat = np.moveaxis(self.thetas.detach().cpu().numpy(), 0, 1)
        posterior = self._named_posterior(flat, constrained)
        sample_stats = {
            new: np.moveaxis(self.stats[old].detach().cpu().numpy(), 0, 1)
            for old, new in _ARVIZ_STATS.items() if old in self.stats}
        return {"posterior": posterior, "sample_stats": sample_stats}

    def summary(self, constrained: bool = False, verbose: bool = True):
        """A posterior table by parameter: mean, sd, 5 % and 95 %
        quantiles, bulk and tail ESS and rank-normalised split-R̂ (the
        pooled draws' quantiles by linear interpolation); returns {name:
        {stat: value or array of the variable's shape}}, prints the table
        when `verbose`, and warns when one parameter's bulk ESS is under
        0.2 of the median."""
        d = self.to_inference_dict(constrained=constrained)
        out, rows = {}, []
        for name, arr in d["posterior"].items():
            c, n = arr.shape[:2]
            flat = np.asarray(arr).reshape(c, n, -1)     # (chain, draw, k)
            x = torch.from_numpy(np.moveaxis(flat, 0, 1))
            stats = {
                "mean": flat.mean((0, 1)),
                "sd": flat.std((0, 1)),
                "q5": np.quantile(flat, 0.05, axis=(0, 1)),
                "q95": np.quantile(flat, 0.95, axis=(0, 1)),
                "ess_bulk": ess_bulk(x).numpy(),
                "ess_tail": ess_tail(x).numpy(),
                "rhat": rhat(x).numpy(),
            }
            shape = arr.shape[2:]
            out[name] = {k: v.reshape(shape) if shape else v[0]
                         for k, v in stats.items()}
            for j in range(flat.shape[-1]):
                label = name if flat.shape[-1] == 1 else f"{name}[{j}]"
                rows.append((label,) + tuple(float(stats[k][j]) for k in (
                    "mean", "sd", "q5", "q95", "ess_bulk", "ess_tail",
                    "rhat")))
        if verbose:
            hdr = ("parameter", "mean", "sd", "5%", "95%", "ess_bulk",
                   "ess_tail", "rhat")
            w = max(9, max(len(r[0]) for r in rows))
            print(f"{hdr[0]:<{w}} " + " ".join(f"{h:>9}" for h in hdr[1:]))
            for r in rows:
                print(f"{r[0]:<{w}} "
                      + " ".join(f"{v:9.3g}" for v in r[1:-3])
                      + f" {r[-3]:9.0f} {r[-2]:9.0f} {r[-1]:9.3f}")
        if len(rows) >= 2:
            ess = np.asarray([r[5] for r in rows], dtype=float)
            med = float(np.median(ess))
            if med > 0 and float(ess.min()) / med < 0.2:
                worst = rows[int(np.argmin(ess))][0]
                warnings.warn(
                    f"min/median bulk-ESS ratio {ess.min() / med:.2f} < 0.2 "
                    f"(slowest: {worst!r}): one dimension mixes far slower "
                    "than the rest. If this is intrinsic geometry (not lack "
                    "of draws), consider reparameterising, a dense/"
                    "rank_update metric, or ChEES-HMC (`sample_chees`).")
        return out

    def to_arviz(self, constrained: bool = False):
        """An `arviz.InferenceData` of `to_inference_dict`, where arviz is
        installed (it is optional)."""
        try:
            import arviz as az
        except ImportError as e:
            raise ImportError(
                "arviz is not installed; use to_inference_dict() for the "
                "plain-dict export") from e
        d = self.to_inference_dict(constrained=constrained)
        return az.from_dict(posterior=d["posterior"],
                            sample_stats=d["sample_stats"])

    def save(self, path: str) -> None:
        """Persist draws/stats/summaries/final state to one npz (see
        `checkpoint.save_result` / `load_result`)."""
        from .checkpoint import save_result

        save_result(path, self)


# the stats `to_inference_dict` exports, under ArviZ's names
_ARVIZ_STATS = {"log_density": "lp", "numerical_error": "diverging",
                "acceptance_rate": "acceptance_rate",
                "hamiltonian_energy": "energy", "tree_depth": "tree_depth",
                "n_steps": "n_steps", "step_size": "step_size"}


def _synchronize(device=None):
    """Wait for the work queued on `device` (None: on the current card, if
    CUDA has started): CUDA runs asynchronously, so a clock read without it
    times the launches, not the work."""
    if (device.type == "cuda" if device is not None
            else torch.cuda.is_initialized()):
        torch.cuda.synchronize(device)


def depth_cap_schedule(n_adapts: int, cap_frac: float, cap_frac2=None,
                       round_to: int = 1, eps_research: bool = False):
    """The depth-capped warmup's switch points (n_cap, n_cap2): the first
    n_cap warmup iterations run capped, then (3-phase, with `cap_frac2`)
    the cap is kept up to n_cap2; the rest runs at full depth. Both are
    rounded down to multiples of `round_to` (the fused block), as the JAX
    function computes them, with its checks."""
    n_cap = int(n_adapts * cap_frac) // round_to * round_to
    n_cap = max(round_to, min(n_cap, n_adapts))
    if eps_research and n_cap >= n_adapts:
        raise ValueError(
            "warmup_eps_research needs a full-depth phase after the switch "
            "(warmup_cap_frac < 1); the dual-averaging re-anchor transient "
            "must be absorbed before finalize")
    if cap_frac2 is None:
        return n_cap, n_cap
    if cap_frac2 <= cap_frac:
        raise ValueError("warmup_cap_frac2 must exceed warmup_cap_frac (it "
                         "is the end of the extended capped phase)")
    n_cap2 = int(n_adapts * cap_frac2) // round_to * round_to
    n_cap2 = max(n_cap, min(n_cap2, n_adapts))
    if n_cap2 >= n_adapts:
        raise ValueError("warmup_cap_frac2 must leave a full-depth tail "
                         "(< 1) so dual averaging finalizes on full "
                         "trajectories")
    return n_cap, n_cap2


def _search_first_chain(generator, h, theta):
    """The step-size search from the first chain of the whole batch: under
    a chain shard every rank runs it alike on the first rank's first row
    (a replicated search, its draws unsharded)."""
    theta0 = first_chain(theta)
    with chain_shard(None):
        return find_good_stepsize(generator, h, theta0)


def _eps_reanchor(generator, spec, state):
    """Re-run the initial step-size search on the window-adapted metric
    (from the first chain) and re-anchor dual averaging there."""
    eps = _search_first_chain(generator, _hamiltonian(spec, state),
                              state.z.theta)
    return dataclasses.replace(state, adapt=dataclasses.replace(
        state.adapt, da=DualAveragingState.init(eps)))


def _progress_printer(n_adapts, n_samples, every=None, printing=True):
    """`progress_cb(iteration, stats, metric)` printing one line of the
    live display (phase, acceptance, step size, divergence, tree depth,
    log density, energy and the M⁻¹ diagonal's range, as the JAX
    function's); with `every`, only at iterations that are multiples of
    it. A line reads the stats back to the host; nothing else does. Under
    a chain shard every rank calls it (the line's stats and a per-chain
    M⁻¹ are gathered) and only a `printing` one prints."""

    def cb(iteration, stats, metric):
        if every is not None and iteration % every:
            return
        stats = {k: gather_chains(v) for k, v in stats.items()}
        mi = getattr(metric, "m_inv", None)
        if isinstance(mi, torch.Tensor) and mi.dim() > (
                2 if isinstance(metric, DenseEuclideanMetric) else 1):
            mi = gather_chains(mi)
        if not printing:
            return
        phase = "warmup" if iteration <= n_adapts else "sample"
        parts = [f"{_PREFIX} {phase} {iteration}/{n_samples}"]
        for key, label, fmt in (
                ("acceptance_rate", "accept", ".3f"),
                ("step_size", "eps", ".2e"), ("numerical_error", "div", ".3f"),
                ("tree_depth", "depth", ".1f"), ("log_density", "logp", ".4g"),
                ("hamiltonian_energy", "E", ".4g")):
            if key not in stats:
                continue
            v = float(torch.mean(stats[key].to(torch.float64)))
            parts.append(f"{label} {v:{fmt}}")
        if isinstance(metric, DenseEuclideanMetric):
            mi = torch.diagonal(mi, dim1=-2, dim2=-1)
        if mi is not None:
            parts.append(f"M⁻¹ [{float(mi.min()):.2g}..{float(mi.max()):.2g}]"
                         f" μ {float(mi.mean()):.2g}")
        print(" | ".join(parts), flush=True)

    return cb


def sample(
    generator,
    target: LogDensityTarget,
    kernel: HMCKernel,
    metric: Metric,
    init_theta,
    n_samples: int,
    n_adapts: Optional[int] = None,
    adaptor: AdaptorConfig = AdaptorConfig(kind=NONE),
    init_eps=None,
    n_chains: Optional[int] = None,
    init_mass_matrix: str = "identity",
    cross_chain: bool = False,
    coupled: bool = False,
    fuse_draws: int = 0,
    fuse_chain_chunks: int = 1,
    fuse_pair: bool = False,
    fuse_warmup: bool = False,
    fuse_warmup_block: int = 8,
    thin: int = 1,
    collect: str = "draws",
    online_lags: int = 16,
    drop_warmup: bool = False,
    collect_warmup_stats: bool = True,
    mesh=None,
    progress: bool = False,
    progress_every: int = 100,
    verbose: bool = False,
    warmup_depth_cap: Optional[int] = None,
    warmup_cap_frac: float = 0.75,
    warmup_eps_research: bool = False,
    warmup_cap_frac2: Optional[float] = None,
    warmup_chains: int = 0,
    fanout_decorrelate: int = 32,
    device=None,
) -> SampleResult:
    """Sample `n_samples` iterations per chain (the first `n_adapts` adapt;
    None means min(n_samples // 10, 1000)), on `device` (None means CUDA;
    pass "cpu" explicitly for the CPU).

    The paths and options follow the JAX function's. At the defaults each
    chain adapts on its own and every iteration is one `sample_step`. A
    static criterion (`HMC`, `HMCDA`) runs every iteration so, through
    `transition_static`: the fused paths and the depth caps are NUTS's.
    `cross_chain=True` shares the adaptation. `fuse_warmup=True` runs the
    warmup fused: per chain (`fused_warmup_phase`: a diagonal metric with
    the Welford-variance or nutpie estimator, a dense one with the Welford
    covariance, or a unit, diagonal or dense one without mass-matrix
    adaptation), or cross-chain in blocks of `fuse_warmup_block` dividing
    `n_adapts` (not with nutpie, whose estimator needs the gradients the
    blocks do not record: it warms step by step).
    `fuse_draws > 1` dividing the draw count (and divisible by `thin`) runs
    the draws fused; `fuse_chain_chunks` splits each fused call's chains
    into that many sequential sub-batches; `fuse_pair` runs the fused
    phases on the leaf-pair body. `coupled` shares the doubling directions
    across chains and turns the fused paths off. `thin` keeps every
    thin-th draw; `collect="online"` stores no draws and returns the
    online summary (`online_lags` lags) in `SampleResult.online`; both
    need `drop_warmup` when there is a warmup. `drop_warmup` returns the
    warmup's stats apart (unless `collect_warmup_stats=False`) and no
    warmup draws. `warmup_chains = W < n_chains` (cross-chain,
    `drop_warmup=True`) warms the first W chains, fans the warmed state
    out to all chains and runs `fanout_decorrelate` discarded transitions
    before the draws. `warmup_depth_cap` (cross-chain, with the fused
    warmup or `drop_warmup`) caps the tree depth for the first
    `warmup_cap_frac` of the warmup, then (`warmup_eps_research`)
    re-anchors dual averaging on a new step-size search, and with
    `warmup_cap_frac2` keeps the cap up to that fraction
    (`depth_cap_schedule`). `progress` prints a line every `progress_every`
    iterations (after every call on the fused paths); `verbose` notes a
    requested fused path that does not run and prints the end-of-run
    report (`diagnostics.summarize`).

    `mesh` (`parallel.mesh_of_all_devices()`: one process per GPU under
    `torch.distributed`) shards the chain axis: every rank calls `sample`
    with the same arguments and a generator in the same state (checked),
    holds its block of the chains (the chain count, and the warmup pool's,
    must divide over the ranks) and draws their variates at the global
    shape (`utils`); the loop exits and the cross-chain reductions are
    global. The draws, ε and M⁻¹ are the unsharded run's, bit for bit
    where the target's value+grad gives each chain the same bits at either
    batch size. Every rank's result holds all chains' draws and stats
    (gathered in rank order); `final_state` stays sharded. Only rank 0
    prints. `fuse_chain_chunks > 1` chunks each rank's block, which
    samples the same law with other streams than the unsharded chunks.
    """
    if mesh is not None:
        from .parallel.mesh import chain_shard_of

        args = {k: v for k, v in locals().items()
                if k not in ("generator", "mesh", "chain_shard_of")}
        with chain_shard(chain_shard_of(mesh)):
            check_generators(generator)
            return sample(generator, **args)
    shard = current_shard()
    rank0 = shard is None or shard.rank == 0
    if n_adapts is None:
        n_adapts = min(n_samples // 10, 1000)
    if adaptor.kind == NONE:
        n_adapts = 0
        if drop_warmup:
            raise ValueError("cannot drop warmup without adaptation")
    n_draw = n_samples - n_adapts
    online = collect == "online"
    if collect not in ("draws", "online"):
        raise ValueError("collect must be 'draws' or 'online'")
    if thin > 1:
        if online:
            raise ValueError("thin > 1 is redundant with collect='online'")
        if n_adapts > 0 and not drop_warmup:
            raise ValueError("thin > 1 requires drop_warmup=True "
                             "(warmup draws are never thinned)")
        if n_draw % thin:
            raise ValueError("thin must divide the number of draw steps")
    if online and n_adapts > 0 and not drop_warmup:
        raise ValueError("collect='online' requires drop_warmup=True")
    dynamic = isinstance(kernel.trajectory.criterion,
                         DynamicTerminationCriterion)
    use_fused = (fuse_draws > 1 and dynamic and not coupled and n_draw > 0
                 and n_draw % fuse_draws == 0 and fuse_draws % thin == 0)
    use_fused_warmup = fuse_warmup and dynamic and not coupled \
        and not cross_chain and n_adapts > 0 and (
            (adaptor.uses_mm and isinstance(metric, DiagEuclideanMetric)
             and adaptor.mm_kind in (MM_WELFORD_VAR, MM_NUTPIE))
            or (adaptor.uses_mm and isinstance(metric, DenseEuclideanMetric)
                and adaptor.mm_kind == MM_WELFORD_COV)
            or (not adaptor.uses_mm and isinstance(
                metric, (DiagEuclideanMetric, UnitEuclideanMetric,
                         DenseEuclideanMetric))))
    use_fused_warmup_cc = (fuse_warmup and dynamic and not coupled
                           and cross_chain and n_adapts > 0
                           and adaptor.mm_kind != MM_NUTPIE
                           and n_adapts % fuse_warmup_block == 0)
    use_depth_cap = (warmup_depth_cap is not None and dynamic and cross_chain
                     and n_adapts > 0
                     and warmup_depth_cap
                     < kernel.trajectory.criterion.max_depth
                     and (use_fused_warmup_cc
                          or (drop_warmup and not use_fused_warmup)))
    if use_depth_cap:
        n_cap, n_cap2 = depth_cap_schedule(
            n_adapts, warmup_cap_frac, warmup_cap_frac2,
            fuse_warmup_block if use_fused_warmup_cc else 1,
            warmup_eps_research)
    elif warmup_cap_frac2 is not None:
        raise ValueError(
            "warmup_cap_frac2 requires an active depth-capped warmup "
            "(warmup_depth_cap < max_depth with cross-chain dynamic "
            "adaptation); without it the 3-phase schedule would be "
            "silently ignored")
    else:
        n_cap = n_cap2 = 0

    device = resolve_device(device)
    spec = SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                      cross_chain=cross_chain, coupled=coupled)
    spec_capped = _capped(spec, warmup_depth_cap) if use_depth_cap else spec
    init_theta = torch.as_tensor(init_theta, device=device)
    n_total = (init_theta.shape[0] if init_theta.dim() > 1
               else (n_chains or 1))
    n_local = local_chains(n_total)       # this rank's chains (all of them)
    use_fanout = 0 < warmup_chains < n_total and n_adapts > 0
    if use_fanout and not cross_chain:
        raise ValueError(
            "warmup_chains requires cross_chain=True (the fanned-out pool "
            "reuses the shared adaptation state)")
    if use_fanout and not drop_warmup:
        raise ValueError(
            "warmup_chains requires drop_warmup=True (warmup draws have the "
            "warmup pool's chain axis)")
    if use_fanout and init_theta.dim() > 1:
        init_theta, n_chains = init_theta[:warmup_chains], None
    elif use_fanout:
        n_chains = warmup_chains
    if init_theta.dim() > 1:
        init_theta = chain_block(init_theta)
    elif n_chains is not None:
        n_chains = local_chains(n_chains)
    if verbose and rank0:
        if fuse_warmup and n_adapts > 0 and not (
                use_fused_warmup or use_fused_warmup_cc):
            print(f"{_PREFIX} note: fuse_warmup requested but the "
                  "configuration is unsupported (coupling/metric/adaptor/"
                  "block) — using the step-by-step warmup")
        if fuse_draws > 1 and n_draw > 0 and not use_fused:
            print(f"{_PREFIX} note: fuse_draws requested but unused "
                  "(requires uncoupled chains, fuse_draws | draw count and "
                  "thin | fuse_draws) — using the step-by-step draws")
        if warmup_depth_cap is not None and not use_depth_cap:
            print(f"{_PREFIX} note: warmup_depth_cap requested but "
                  "unsupported here (requires cross-chain adaptation, a cap "
                  "below max_depth, and either the fused cross-chain warmup "
                  "or drop_warmup) — running the standard warmup")
    step_cb = (_progress_printer(n_adapts, n_samples, progress_every, rank0)
               if progress else None)
    fused_cb = (_progress_printer(n_adapts, n_samples, None, rank0)
                if progress else None)

    timings = {}
    t0 = time.perf_counter()
    state = init_state(generator, spec, metric, init_theta, init_eps,
                       n_chains, init_mass_matrix, device)
    _synchronize(device)
    timings["init_s"] = time.perf_counter() - t0

    # the rows the run returns, on every chain: the warmup's unless it is
    # dropped (a fanned-out warmup is), then the draws' (thinned; θ only
    # when draws are collected)
    keep = 0 if drop_warmup else n_adapts
    keys = _STATS if dynamic else _STATIC_STATS
    rows = _rows(keep + n_draw // thin, n_local, state.z.theta,
                 draws=not online, keys=keys)
    flags = adapt_flags(adaptor, n_adapts, n_samples)
    t0 = time.perf_counter()
    # the warmup's segments (lo, hi, spec): capped before n_cap2, with the
    # ε re-anchor at n_cap
    bounds = sorted({0, n_cap, n_cap2, n_adapts}) if use_depth_cap \
        else [0, n_adapts]
    segments = [(lo, hi, spec_capped if hi <= n_cap2 else spec)
                for lo, hi in zip(bounds[:-1], bounds[1:])]
    warm_rows = None
    if drop_warmup and collect_warmup_stats and n_adapts > 0:
        warm_rows = _rows(n_adapts, state.z.theta.shape[0], state.z.theta,
                          draws=False, keys=keys)
    warm_out = warm_rows if drop_warmup else _part(rows, 0, n_adapts)
    if use_fused_warmup:
        state, th, st = fused_warmup_phase(generator, spec, state, n_adapts,
                                           pair=fuse_pair)
        if warm_out is not None:
            _fill(warm_out, th, st)
    elif n_adapts > 0:
        for lo, hi, spec_w in segments:
            if warmup_eps_research and use_depth_cap and lo == n_cap \
                    and n_cap < n_adapts:
                state = _eps_reanchor(generator, spec, state)
            out = None if warm_out is None else _part(warm_out, lo, hi)
            if use_fused_warmup_cc:
                state, th, st = fused_warmup_phase_crosschain(
                    generator, spec_w, state, hi - lo, fuse_warmup_block,
                    flags={k: v[lo:hi] for k, v in flags.items()},
                    pair=fuse_pair, progress_cb=fused_cb,
                    chain_chunks=fuse_chain_chunks)
                if out is not None:
                    _fill(out, th, st)
            else:
                state, _ = _step_loop(generator, spec_w, state, flags, lo, hi,
                                      out, progress_cb=step_cb)
    if use_fanout:
        state = fanout_warmup_state(spec, state, n_total)
        if fanout_decorrelate > 0 and dynamic and not coupled:
            state, _, _ = fused_draw_phase(
                generator, spec, state, fanout_decorrelate,
                fanout_decorrelate, chain_chunks=fuse_chain_chunks,
                pair=fuse_pair)
        elif fanout_decorrelate > 0:
            off = {k: [False] for k in flags}
            for _ in range(fanout_decorrelate):
                state, _ = _step_loop(generator, spec, state, off, 0, 1)
    _synchronize(device)
    timings["warmup_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    draws = _part(rows, keep, keep + n_draw // thin)
    om = (online_init(n_local, target.dim, online_lags, state.z.theta.dtype,
                      device) if online else None)
    if use_fused:
        out = fused_draw_phase(generator, spec, state, n_draw, fuse_draws,
                               thin=thin, online_om=om, progress_cb=fused_cb,
                               chain_chunks=fuse_chain_chunks, pair=fuse_pair)
        state, th, st = out[:3]
        om = out[3] if online else None
        _fill(draws, th, st)
    else:
        state, om = _step_loop(generator, spec, state, flags, n_adapts,
                               n_samples, draws, thin, om, step_cb)
    _synchronize(device)
    timings["draws_s"] = time.perf_counter() - t0
    if shard is not None:
        # every rank's result holds all chains, in rank order
        rows = _gather_rows(rows)
        warm_rows = None if warm_rows is None else _gather_rows(warm_rows)
        om = None if om is None else dataclasses.replace(
            om, mean=gather_chains(om.mean), m2=gather_chains(om.m2),
            lag_buf=gather_chains(om.lag_buf, 1),
            lag_acc=gather_chains(om.lag_acc, 1))
    result = SampleResult(
        thetas=rows[0], stats=rows[1],
        warmup_stats=None if warm_rows is None else warm_rows[1],
        final_state=state, timings=timings,
        online=None if om is None else online_summary(om), target=target)
    if verbose and rank0:
        summarize(result, verbose=True)
    return result


def _gather_rows(rows):
    """`rows` (see `_rows`) with their chain axis gathered from every
    rank."""
    return (None if rows[0] is None else gather_chains(rows[0], 1),
            {k: gather_chains(v, 1) for k, v in rows[1].items()})

"""Sampling: initial state, the step-by-step and the fused phases, `sample`.

PyTorch counterpart of `advancedhmc_tpu/sampler.py`. At its defaults
`sample` adapts each chain on its own (per-chain Stan adaptation: each chain
has its own ε, diagonal M⁻¹, dual-averaging and Welford state) and runs one
`sample_step` per iteration. `cross_chain=True` shares one adaptation state
over the chain batch (the Welford moments pooled over it). The draws run
step by step or, with `fuse_draws`, through `fused_draw_phase`; a
cross-chain warmup runs in fused blocks with `fuse_warmup`
(`fused_warmup_phase_crosschain`), optionally on a sub-pool that
`fanout_warmup_state` fans out; `fuse_pair` runs the fused phases on the
leaf-pair body. Randomness comes from one `torch.Generator` on the
sampler's device, passed to each function; the state carries no key. The
per-chain fused warmup and the thinned, online, coupled and mesh paths are
not ported; each raises, naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from .adaptation import (
    MM_NUTPIE,
    MM_WELFORD_VAR,
    NONE,
    STAN,
    AdaptorConfig,
    AdaptState,
    adapt_flags,
    adapt_step,
    adapt_step_batch,
    da_update,
)
from .hamiltonian import Hamiltonian, PhasePoint
from .kinetic import GaussianKinetic
from .metrics import DiagEuclideanMetric, Metric, UnitEuclideanMetric
from .nuts import _STAT_FIELDS, nuts_transition, nuts_transitions_fused
from .stepsize_search import find_good_stepsize, find_good_stepsizes
from .target import LogDensityTarget
from .trajectory import HMCKernel
from .utils import not_ported, resolve_device, roadmap

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


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    """Static configuration of a run."""

    target: LogDensityTarget
    kernel: HMCKernel
    adaptor: AdaptorConfig
    cross_chain: bool = False
    kinetic: GaussianKinetic = GaussianKinetic()
    coupled: bool = False

    def __post_init__(self):
        if self.coupled:
            raise NotImplementedError(
                "coupled trajectory randomness is not ported yet "
                + roadmap("options"))


def _hamiltonian(spec, state):
    return Hamiltonian(metric=state.metric, target=spec.target,
                       kinetic=spec.kinetic)


def _run_fused(generator, spec, state, n_transitions, pair=False):
    """One fused call at the state's frozen ε and M⁻¹, shared or per chain,
    on the leaf-pair body if `pair`; outputs (T, C, ...)."""
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    z, ths, stats = nuts_transitions_fused(
        generator, _hamiltonian(spec, state), traj, state.z, n_transitions,
        spec.kernel.refreshment, pair=pair)
    return z, ths.transpose(0, 1), {k: v.transpose(0, 1)
                                    for k, v in stats.items()}


def _cat_stats(blocks):
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def fanout_warmup_state(spec: SampleSpec, state: HMCState,
                        n_chains: int) -> HMCState:
    """Tile a warmed cross-chain state onto `n_chains` chains.

    The warmed positions (with their cached ℓπ/∇ℓπ/ℓκ) are tiled
    cyclically; the shared metric and adaptation state are reused. Clones
    start at identical positions: run a short discarded decorrelation phase
    before collecting draws.
    """
    c0 = state.z.theta.shape[0]
    if not spec.cross_chain:
        raise ValueError("fanout_warmup_state requires cross_chain=True "
                         "(a shared adaptation state)")
    if n_chains < c0:
        raise ValueError(f"n_chains {n_chains} < warmed pool {c0}")
    reps = -(-n_chains // c0)

    def tile(x):
        return torch.cat([x] * reps)[:n_chains]

    z = state.z
    return dataclasses.replace(state, z=PhasePoint(
        theta=tile(z.theta), r=tile(z.r), logdensity=tile(z.logdensity),
        grad=tile(z.grad), neg_k=tile(z.neg_k)))


def fused_draw_phase(generator, spec: SampleSpec, state: HMCState,
                     n_draws: int, fuse: int, pair: bool = False, **options):
    """Post-warmup draws, `fuse` transitions per fused call, adaptation
    frozen, at the state's ε and M⁻¹ (shared, or each chain's own), on the
    leaf-pair body if `pair`. Returns (state, thetas (n_draws, C, dim),
    stats (n_draws, C))."""
    not_ported("fused_draw_phase", options)
    if n_draws % fuse:
        raise ValueError("fuse must divide the draw count")
    z, ths, stats = state.z, [], []
    for _ in range(n_draws // fuse):
        z, th, st = _run_fused(generator, spec,
                               dataclasses.replace(state, z=z), fuse, pair)
        ths.append(th)
        stats.append(st)
    stats = _cat_stats(stats)
    stats["is_adapt"] = torch.zeros_like(stats["numerical_error"])
    state = dataclasses.replace(state, iteration=state.iteration + n_draws,
                                z=z)
    return state, torch.cat(ths), stats


def fused_warmup_phase_crosschain(generator, spec: SampleSpec,
                                  state: HMCState, n_adapts: int, block: int,
                                  flags=None, pair: bool = False, **options):
    """Cross-chain warmup with `block` transitions per fused call (on the
    leaf-pair body if `pair`).

    Within a block, ε and M⁻¹ stay frozen at the block start. At each block
    boundary the Welford pushes and the Stan window logic are replayed for
    every transition of the block from its recorded positions; dual
    averaging updates once per block (and at a window end or the last
    step) with the block-mean acceptance, as in the JAX package. The flags
    are host arrays, so the replay branches on the host.
    Returns (state, warm_thetas (n_adapts, C, dim), warm_stats).
    """
    not_ported("fused_warmup_phase_crosschain", options)
    cfg = spec.adaptor
    if n_adapts % block:
        raise ValueError("block must divide n_adapts")
    if flags is None:
        flags = adapt_flags(cfg, n_adapts, n_adapts)
    ths, stats = [], []
    for b in range(n_adapts // block):
        z, th, st = _run_fused(generator, spec, state, block, pair)
        alpha_blk = torch.mean(torch.clamp(st["acceptance_rate"], max=1.0))
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
                    mm = mm.push_batch(th[t])
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
        ths.append(th)
        stats.append(st)
    return state, torch.cat(ths), _cat_stats(stats)


def _transition(generator, spec: SampleSpec, state: HMCState):
    """Momentum refresh, then one NUTS transition of every chain at its ε
    and M⁻¹: the JAX package's `_one_chain_transition`, vmapped (the plain
    `Leapfrog` draws no jitter; a static trajectory is refused by
    `nuts_transition`)."""
    h = _hamiltonian(spec, state)
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    z = spec.kernel.refreshment.refresh(generator, h, state.z)
    return nuts_transition(generator, h, traj, z)


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


def _rows(n, c, theta):
    """Buffers for `n` iterations of `c` chains of θ's width and dtype:
    θ (n, c, dim) and each stat (n, c)."""
    return theta.new_empty((n, c, theta.shape[-1])), {
        k: theta.new_empty((n, c), dtype=_STAT_DTYPES.get(k, theta.dtype))
        for k in _STATS}


def _part(rows, lo, hi):
    """Rows lo..hi-1 of `rows`, as views."""
    return rows[0][lo:hi], {k: v[lo:hi] for k, v in rows[1].items()}


def _fill(rows, thetas, stats):
    """Copy a phase's θ and stats into `rows` (as many rows)."""
    rows[0].copy_(thetas)
    for k, v in rows[1].items():
        v.copy_(stats[k])


def _step_loop(generator, spec, state, flags, lo, hi, rows):
    """`sample_step` at the run's iterations lo..hi-1 (`flags` are the
    run's `adapt_flags`), iteration lo + i writing its θ and stats into row
    i of `rows`. Returns the state."""
    for i, t in enumerate(range(lo, hi)):
        state, st = sample_step(generator, spec, state,
                                {k: bool(v[t]) for k, v in flags.items()})
        rows[0][i] = state.z.theta
        for k, v in st.items():
            rows[1][k][i] = v
    return state


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
        g = torch.mean(torch.abs(grads), 0)
        metric = DiagEuclideanMetric.create(
            (1.0 / torch.clamp(g, 1e-3, 1e6)).to(dtype))
    elif init_mass_matrix != "identity":
        raise ValueError(f"unknown init_mass_matrix {init_mass_matrix!r}")

    h = Hamiltonian(metric=metric, target=spec.target, kinetic=spec.kinetic)
    if init_eps is not None:
        eps0 = torch.as_tensor(init_eps, dtype=dtype, device=device)
    elif spec.cross_chain:
        eps0 = find_good_stepsize(generator, h, theta[0])
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

    `timings` holds the wall seconds of each phase ("init_s", "warmup_s"
    — warmup, fan-out and decorrelation — and "draws_s"), each ending in a
    device synchronise."""

    thetas: torch.Tensor                   # (n_kept, n_chains, dim)
    stats: Dict[str, torch.Tensor]         # each (n_kept, n_chains)
    warmup_stats: Optional[Dict[str, torch.Tensor]]
    final_state: HMCState
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    fuse_draws: int = 0,
    fuse_warmup: bool = False,
    fuse_warmup_block: int = 8,
    drop_warmup: bool = False,
    warmup_chains: int = 0,
    fanout_decorrelate: int = 32,
    fuse_pair: bool = False,
    device=None,
    **options,
) -> SampleResult:
    """Sample `n_samples` iterations per chain (the first `n_adapts` adapt;
    None means min(n_samples // 10, 1000)), on `device` (None means CUDA;
    pass "cpu" explicitly for the CPU).

    The paths follow the JAX function's. At the defaults each chain adapts
    on its own and every iteration is one `sample_step`. `cross_chain=True`
    shares the adaptation; with `fuse_warmup=True` and `fuse_warmup_block`
    dividing `n_adapts` its warmup runs in fused blocks. `fuse_draws > 1`
    dividing the draw count runs the draws fused. `drop_warmup` returns the
    warmup's stats apart and no warmup draws. `warmup_chains = W <
    n_chains` (cross-chain, `drop_warmup=True`) warms the first W chains,
    fans the warmed state out to all chains and runs `fanout_decorrelate`
    discarded transitions before the draws. `fuse_pair` runs the fused
    warmup blocks, the decorrelation and the fused draws on the leaf-pair
    body. The JAX function's other options raise, as does the per-chain
    fused warmup (`fuse_warmup=True` without `cross_chain`).
    """
    not_ported("sample", options)
    if n_adapts is None:
        n_adapts = min(n_samples // 10, 1000)
    if adaptor.kind == NONE:
        n_adapts = 0
        if drop_warmup:
            raise ValueError("cannot drop warmup without adaptation")
    n_draw = n_samples - n_adapts
    use_fused = fuse_draws > 1 and n_draw > 0 and n_draw % fuse_draws == 0
    use_fused_warmup_cc = (fuse_warmup and cross_chain and n_adapts > 0
                           and adaptor.mm_kind != MM_NUTPIE
                           and n_adapts % fuse_warmup_block == 0)
    # the JAX package runs `fused_warmup_phase` here, which is not ported
    if fuse_warmup and not cross_chain and n_adapts > 0 and (
            (adaptor.uses_mm and isinstance(metric, DiagEuclideanMetric)
             and adaptor.mm_kind in (MM_WELFORD_VAR, MM_NUTPIE))
            or (not adaptor.uses_mm and isinstance(
                metric, (DiagEuclideanMetric, UnitEuclideanMetric)))):
        raise NotImplementedError(
            "the per-chain fused warmup (fuse_warmup=True with per-chain "
            "adaptation) is not ported yet " + roadmap("options"))

    device = resolve_device(device)
    spec = SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                      cross_chain=cross_chain)
    init_theta = torch.as_tensor(init_theta, device=device)
    n_total = (init_theta.shape[0] if init_theta.dim() > 1
               else (n_chains or 1))
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

    timings = {}
    t0 = time.perf_counter()
    state = init_state(generator, spec, metric, init_theta, init_eps,
                       n_chains, init_mass_matrix, device)
    _synchronize(device)
    timings["init_s"] = time.perf_counter() - t0

    # the rows the run returns, on every chain: the warmup's unless it is
    # dropped (a fanned-out warmup is), then the draws'
    keep = 0 if drop_warmup else n_adapts
    rows = _rows(keep + n_draw, n_total, state.z.theta)
    flags = adapt_flags(adaptor, n_adapts, n_samples)
    t0 = time.perf_counter()
    warm_stats = None
    if use_fused_warmup_cc:
        state, th, st = fused_warmup_phase_crosschain(
            generator, spec, state, n_adapts, fuse_warmup_block,
            pair=fuse_pair)
        if drop_warmup:
            warm_stats = st
        else:
            _fill(_part(rows, 0, n_adapts), th, st)
    elif n_adapts > 0:
        warm = (_part(rows, 0, n_adapts) if keep else
                _rows(n_adapts, state.z.theta.shape[0], state.z.theta))
        state = _step_loop(generator, spec, state, flags, 0, n_adapts, warm)
        if drop_warmup:
            warm_stats = warm[1]
    if use_fanout:
        state = fanout_warmup_state(spec, state, n_total)
        if fanout_decorrelate > 0:
            state, _, _ = fused_draw_phase(generator, spec, state,
                                           fanout_decorrelate,
                                           fanout_decorrelate, fuse_pair)
    _synchronize(device)
    timings["warmup_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    draws = _part(rows, keep, keep + n_draw)
    if use_fused:
        state, th, st = fused_draw_phase(generator, spec, state, n_draw,
                                         fuse_draws, fuse_pair)
        _fill(draws, th, st)
    else:
        state = _step_loop(generator, spec, state, flags, n_adapts,
                           n_samples, draws)
    _synchronize(device)
    timings["draws_s"] = time.perf_counter() - t0
    return SampleResult(thetas=rows[0], stats=rows[1],
                        warmup_stats=warm_stats, final_state=state,
                        timings=timings)

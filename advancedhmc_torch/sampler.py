"""Sampling: initial state, cross-chain fused warmup, fan-out, fused draws.

PyTorch counterpart of the main path of `advancedhmc_tpu/sampler.py`:
`init_state` → `fused_warmup_phase_crosschain` → `fanout_warmup_state` →
`fused_draw_phase`, driven by `sample`. Randomness comes from one
`torch.Generator` on the sampler's device, passed to each function; the
state carries no key. Adaptation is cross-chain (one shared step size and
diagonal M⁻¹, the Welford moments pooled over the chain batch); the
per-chain, scan-loop, online and mesh paths are ROADMAP.md section 1,
item 11.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from .adaptation import (
    NONE,
    STAN,
    AdaptorConfig,
    AdaptState,
    adapt_flags,
    da_update,
)
from .hamiltonian import Hamiltonian, PhasePoint
from .kinetic import GaussianKinetic
from .metrics import DiagEuclideanMetric, Metric
from .nuts import nuts_transitions_fused
from .stepsize_search import find_good_stepsize
from .target import LogDensityTarget
from .trajectory import HMCKernel
from .utils import resolve_device

_LATER = "(ROADMAP.md section 1, item 11)"


def _no_options(fn, options):
    if options:
        raise NotImplementedError(
            f"{fn} options {sorted(options)} are not ported yet " + _LATER)


@dataclasses.dataclass(frozen=True)
class HMCState:
    """Resumable sampler state: chain-batched phase points, the shared
    metric and the shared adaptation state."""

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
        if not self.cross_chain:
            raise NotImplementedError(
                "per-chain adaptation is not ported yet; use "
                "cross_chain=True " + _LATER)
        if self.coupled:
            raise NotImplementedError(
                "coupled trajectory randomness is not ported yet " + _LATER)


def _hamiltonian(spec, state):
    return Hamiltonian(metric=state.metric, target=spec.target,
                       kinetic=spec.kinetic)


def _run_fused(generator, spec, state, n_transitions):
    """One fused call at the state's frozen ε and M⁻¹; outputs (T, C, ...)."""
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    z, ths, stats = nuts_transitions_fused(
        generator, _hamiltonian(spec, state), traj, state.z, n_transitions,
        spec.kernel.refreshment)
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
                     n_draws: int, fuse: int, **options):
    """Post-warmup draws, `fuse` transitions per fused call, adaptation
    frozen. Returns (state, thetas (n_draws, C, dim), stats (n_draws, C))."""
    _no_options("fused_draw_phase", options)
    if n_draws % fuse:
        raise ValueError("fuse must divide the draw count")
    z, ths, stats = state.z, [], []
    for _ in range(n_draws // fuse):
        z, th, st = _run_fused(generator, spec,
                               dataclasses.replace(state, z=z), fuse)
        ths.append(th)
        stats.append(st)
    stats = _cat_stats(stats)
    stats["is_adapt"] = torch.zeros_like(stats["numerical_error"])
    state = dataclasses.replace(state, iteration=state.iteration + n_draws,
                                z=z)
    return state, torch.cat(ths), stats


def fused_warmup_phase_crosschain(generator, spec: SampleSpec,
                                  state: HMCState, n_adapts: int, block: int,
                                  flags=None, **options):
    """Cross-chain warmup with `block` transitions per fused call.

    Within a block, ε and M⁻¹ stay frozen at the block start. At each block
    boundary the Welford pushes and the Stan window logic are replayed for
    every transition of the block from its recorded positions; dual
    averaging updates once per block (and at a window end or the last
    step) with the block-mean acceptance, as in the JAX package. The flags
    are host arrays, so the replay branches on the host.
    Returns (state, warm_thetas (n_adapts, C, dim), warm_stats).
    """
    _no_options("fused_warmup_phase_crosschain", options)
    cfg = spec.adaptor
    if n_adapts % block:
        raise ValueError("block must divide n_adapts")
    if flags is None:
        flags = adapt_flags(cfg, n_adapts, n_adapts)
    ths, stats = [], []
    for b in range(n_adapts // block):
        z, th, st = _run_fused(generator, spec, state, block)
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


def init_state(generator, spec: SampleSpec, metric: Metric, init_theta,
               init_eps=None, n_chains: Optional[int] = None,
               init_mass_matrix: str = "identity", device=None) -> HMCState:
    """Initial batched state on `device` (None means CUDA).

    `init_mass_matrix="gradient"` seeds the diagonal M⁻¹ from the gradient
    at the initial positions, M⁻¹_j = 1/mean|∇_j ℓπ|. Without `init_eps` the
    step size comes from `find_good_stepsize` on the first chain.
    """
    device = resolve_device(device)
    theta = torch.as_tensor(init_theta, device=device)
    if theta.dim() == 1:
        theta = theta[None].expand(n_chains or 1, -1)
    theta = theta.contiguous()
    dtype = theta.dtype

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
    if init_eps is None:
        eps0 = find_good_stepsize(generator, h, theta[0])
    else:
        eps0 = torch.as_tensor(init_eps, dtype=dtype, device=device)
        if eps0.dim() != 0:
            raise ValueError("cross-chain adaptation shares one dual-"
                             "averaging state; init_eps must be a scalar")
    return HMCState(iteration=0, z=h.init_phasepoint(generator, theta),
                    metric=metric,
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
    device=None,
    **options,
) -> SampleResult:
    """Sample `n_samples` iterations per chain (the first `n_adapts` adapt).

    The ported path: cross-chain adaptation (`cross_chain=True`) with the
    fused warmup (`fuse_warmup=True`, `fuse_warmup_block` dividing
    `n_adapts`) and fused draws (`fuse_draws > 1` dividing the draw count).
    `warmup_chains = W < n_chains` warms the first W chains, fans the warmed
    state out to all chains and runs `fanout_decorrelate` discarded
    transitions before the draws (requires `drop_warmup=True`). Runs on
    `device` (None means CUDA; pass "cpu" explicitly for the CPU).
    """
    _no_options("sample", options)
    if not cross_chain:
        raise NotImplementedError("per-chain adaptation is not ported yet; "
                                  "use cross_chain=True " + _LATER)
    if n_adapts is None:
        n_adapts = min(n_samples // 10, 1000)
    if adaptor.kind == NONE:
        n_adapts = 0
        if drop_warmup:
            raise ValueError("cannot drop warmup without adaptation")
    n_draw = n_samples - n_adapts
    if fuse_draws <= 1 or n_draw <= 0 or n_draw % fuse_draws:
        raise NotImplementedError(
            "only fused draws are ported (fuse_draws > 1 dividing the draw "
            "count) " + _LATER)
    if n_adapts > 0 and (not fuse_warmup or n_adapts % fuse_warmup_block):
        raise NotImplementedError(
            "only the fused cross-chain warmup is ported (fuse_warmup=True, "
            "fuse_warmup_block dividing n_adapts) " + _LATER)

    device = resolve_device(device)
    spec = SampleSpec(target=target, kernel=kernel, adaptor=adaptor,
                      cross_chain=True)
    init_theta = torch.as_tensor(init_theta, device=device)
    n_total = (init_theta.shape[0] if init_theta.dim() > 1
               else (n_chains or 1))
    use_fanout = 0 < warmup_chains < n_total and n_adapts > 0
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

    t0 = time.perf_counter()
    warm_thetas = warm_stats = None
    if n_adapts > 0:
        state, warm_thetas, warm_stats = fused_warmup_phase_crosschain(
            generator, spec, state, n_adapts, fuse_warmup_block)
    if use_fanout:
        state = fanout_warmup_state(spec, state, n_total)
        if fanout_decorrelate > 0:
            state, _, _ = fused_draw_phase(generator, spec, state,
                                           fanout_decorrelate,
                                           fanout_decorrelate)
    _synchronize(device)
    timings["warmup_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, thetas, stats = fused_draw_phase(generator, spec, state, n_draw,
                                            fuse_draws)
    _synchronize(device)
    timings["draws_s"] = time.perf_counter() - t0

    if n_adapts > 0 and not drop_warmup:
        thetas = torch.cat([warm_thetas, thetas])
        stats = {k: torch.cat([warm_stats[k].to(v.dtype), v])
                 for k, v in stats.items()}
        warm_stats = None
    return SampleResult(thetas=thetas, stats=stats, warmup_stats=warm_stats,
                        final_state=state, timings=timings)

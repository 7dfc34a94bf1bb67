"""ChEES-HMC: jittered fixed-length HMC with trajectory-length adaptation
(Hoffman, Radul & Sountsov 2021).

Counterpart of `advancedhmc_tpu/chees.py`. Every chain runs the same number
of leapfrog steps at each iteration, n = clip(ceil(τ/ϵ), 1, max_steps) with
τ = u·T shared by the chains, so the host reads n once per transition and
runs a Python loop of n steps over the whole batch: one batched value+grad
a step (on the logistic in float32 on CUDA, one launch of the kernel K1),
no masking. The step size follows dual averaging (default δ = 0.651) and
the mass matrix Stan's windowed cross-chain Welford schedule, through the
port's `adapt_step_batch`; T follows `adaptation.chees.chees_update`.

Randomness: a transition draws the momenta (C, D), then the MH uniforms
(C,), from one `torch.Generator`, in that order, whether it adapts or not;
so the draws-only step (`make_chees_draw_step`) gives the bits of the full
step (`make_chees_step`) at `is_adapt` False. `chees_transition_core` is
the transition given those draws.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import profiling
from .adaptation import AdaptorConfig, AdaptState, adapt_flags, \
    adapt_step_batch
from .adaptation.chees import CheesConfig, CheesState, chees_update, \
    halton_sequence
from .adaptation.stepsize import DualAveragingConfig
from .hamiltonian import Hamiltonian
from .metrics import Metric, make_metric
from .sampler import SampleResult, _synchronize
from .stepsize_search import find_good_stepsize
from .utils import rand_uniform, resolve_device


def _num_steps(eps, tau, max_steps: int) -> int:
    """n = clip(ceil(τ/ϵ), 1, max_steps), computed in θ's dtype and read to
    the host (a NaN quotient gives 1, as the JAX conversion of NaN to int32
    gives 0 before the clip). The read is the transition's one wait for
    the device."""
    with profiling.span("ahmc.chees.num_steps"):
        q = torch.nan_to_num(torch.ceil(tau / eps), nan=0.0)
        return int(torch.clamp(q, 1, max_steps))


def chees_transition(generator, target, metric, eps, tau, max_steps, theta,
                     lp, grad):
    """One jittered-HMC transition of the whole chain batch: draws the
    momenta, then the MH uniforms, and runs `chees_transition_core`."""
    c = theta.shape[0]
    with profiling.span("ahmc.chees.draw_randoms"):
        r0 = metric.rand_momentum(generator, c)
        u = rand_uniform(generator, (c,), theta.dtype, theta.device)
    return chees_transition_core(target, metric, eps, tau, max_steps, theta,
                                 lp, grad, r0, u)


def chees_transition_core(target, metric, eps, tau, max_steps, theta, lp,
                          grad, r0, u):
    """The transition given the momenta `r0 (C, D)` and the MH uniforms
    `u (C,)`: n leapfrog steps at the shared `eps` (the half kick folded as
    n full kicks less a trailing half), then accept where u < α.

    Returns ((θ, ℓπ, ∇ℓπ) accepted, (θ′, v′, α) of the proposal, stats of
    (C,))."""
    c = theta.shape[0]
    n = _num_steps(eps, tau, max_steps)
    profiling.note("n", n)
    with profiling.span("ahmc.chees.kick"):
        r = r0 + 0.5 * eps * grad
    theta1, lp1, grad1 = theta, lp, grad
    for _ in range(n):
        with profiling.span("ahmc.chees.drift"):
            theta1 = theta1 + eps * metric.velocity(r)
        lp1, grad1 = target.logdensity_and_grad(theta1)
        with profiling.span("ahmc.chees.kick"):
            r = r + eps * grad1
    with profiling.span("ahmc.chees.kick"):
        r1 = r - 0.5 * eps * grad1

    with profiling.span("ahmc.chees.accept"):
        h0 = -(lp + metric.neg_kinetic_energy(r0))
        neg_inf = torch.full_like(lp, float("-inf"))
        lp1c = torch.where(torch.isfinite(lp1), lp1, neg_inf)
        neg_k1 = metric.neg_kinetic_energy(r1)
        h1 = -(lp1c + torch.where(torch.isfinite(neg_k1), neg_k1, neg_inf))
        dh = h1 - h0
        alpha = torch.nan_to_num(torch.exp(torch.clamp(-dh, max=0.0)),
                                 nan=0.0)
        accept = u < alpha

        v_prop = metric.velocity(r1)
        theta_new = torch.where(accept[:, None], theta1, theta)
        lp_new = torch.where(accept, lp1c, lp)
        grad_new = torch.where(accept[:, None], grad1, grad)
        stats = {
            "n_steps": torch.full((c,), n, dtype=torch.int32,
                                  device=lp.device),
            "is_accept": accept,
            "acceptance_rate": alpha,
            "log_density": lp_new,
            "hamiltonian_energy": torch.where(accept, h1, h0),
            "hamiltonian_energy_error": torch.where(accept, dh, 0.0),
            "numerical_error": ~torch.isfinite(h1),
            "step_size": torch.broadcast_to(eps, (c,)),
            "trajectory_length": torch.broadcast_to(tau, (c,)),
        }
    return (theta_new, lp_new, grad_new), (theta1, v_prop, alpha), stats


def chees_tau_sweep(n_total: int, n_adapts: int, boost: float = 8.0,
                    frac: float = 0.5) -> np.ndarray:
    """A warmup τ-schedule: an (n_total,) multiplier on the adapted mean
    trajectory length, decaying geometrically from `boost` to 1 over the
    first `frac` of the warmup and 1 after (`sample_chees(...,
    t_schedule=...)`)."""
    sched = np.ones(n_total)
    n_sweep = max(1, int(n_adapts * frac))
    sched[:n_sweep] = boost ** (1.0 - np.arange(n_sweep) / n_sweep)
    return sched


def make_chees_step(target, cfg: AdaptorConfig, chees: CheesConfig,
                    max_steps: int):
    """The per-iteration step shared by `sample_chees` and chunked loops:
    `step(generator, carry, flags, u, s=None) -> (carry, (θ, stats))`.

    carry = (θ, ℓπ, ∇ℓπ, metric, AdaptState, CheesState); `flags` is one
    iteration's adaptation flags as Python booleans; `u` the iteration's
    Halton jitter (0-d tensor); `s` an optional τ multiplier (warmup only:
    forced to 1 on draw iterations). In an adaptation iteration it runs, in
    order: `chees_update` on the proposal (accepted or not),
    `adapt_step_batch` on the accepted state and the metric's renewal; a
    draw iteration runs at the finalized T, exp(log_t_avg)."""

    def step(generator, carry, flags, u, s=None):
        with profiling.span("ahmc.chees.step", iteration=True):
            theta, lp, grad, metric, adapt, cs = carry
            is_adapt = bool(flags["is_adapt"])
            t_mean = (cs.trajectory_length if is_adapt
                      else torch.exp(cs.log_t_avg))
            tau = u * t_mean
            if is_adapt and s is not None:
                tau = tau * s
            (theta_n, lp_n, grad_n), (theta_p, v_p, alpha), stats = \
                chees_transition(generator, target, metric, adapt.da.eps,
                                 tau, max_steps, theta, lp, grad)
            with profiling.span("ahmc.chees.adapt"):
                if is_adapt:
                    cs = chees_update(chees, cs, theta, theta_p, v_p, alpha,
                                      tau)
                adapt = adapt_step_batch(cfg, adapt, theta_n, grad_n, alpha,
                                         flags)
                if cfg.uses_mm and is_adapt:
                    metric = metric.renew(adapt.mm.m_inv)
            stats["is_adapt"] = torch.full_like(stats["is_accept"], is_adapt)
            stats["nom_step_size"] = stats["step_size"]
            return ((theta_n, lp_n, grad_n, metric, adapt, cs),
                    (theta_n, stats))

    return step


def make_chees_draw_step(target, max_steps: int):
    """The draws-only step: the transition alone, adaptation left out.
    `step(generator, carry, u) -> (carry, (θ, stats))` with carry = (θ, ℓπ,
    ∇ℓπ, metric, ϵ, T). Its draws are bitwise those of the full step with
    `is_adapt` False (the same draws from the generator, the same
    transition)."""

    def step(generator, carry, u):
        with profiling.span("ahmc.chees.step", iteration=True):
            theta, lp, grad, metric, eps, t_mean = carry
            (theta_n, lp_n, grad_n), _, stats = chees_transition(
                generator, target, metric, eps, u * t_mean, max_steps, theta,
                lp, grad)
            stats["is_adapt"] = torch.zeros_like(stats["is_accept"])
            stats["nom_step_size"] = stats["step_size"]
        return (theta_n, lp_n, grad_n, metric, eps, t_mean), (theta_n, stats)

    return step


def draw_carry(carry):
    """The draws-only step's carry from the full step's: the dual-averaging
    ϵ and the finalized T."""
    theta, lp, grad, metric, adapt, cs = carry
    return theta, lp, grad, metric, adapt.da.eps, torch.exp(cs.log_t_avg)


def sample_chees(generator, target, init_theta, n_samples: int,
                 n_adapts: int, metric: Optional[Metric] = None,
                 init_eps=None, init_t: float = 1.0,
                 chees: CheesConfig = CheesConfig(),
                 da: DualAveragingConfig = DualAveragingConfig(delta=0.651),
                 mm_kind: str = "welford_var", max_steps: int = 1024,
                 drop_warmup: bool = False, t_schedule=None,
                 device=None) -> SampleResult:
    """ChEES-HMC over a chain batch `init_theta (C, D)` on `device` (None
    means CUDA), `n_samples` iterations of which the first `n_adapts`
    adapt. The criterion centres on cross-chain means: use many chains.

    Returns a `SampleResult`; its `final_state` is the step's carry (θ, ℓπ,
    ∇ℓπ, metric, AdaptState, CheesState). `stats["trajectory_length"]`
    holds each iteration's τ (u·T). `t_schedule` ((n_samples,)
    multipliers, or "sweep" for `chees_tau_sweep`) scales τ in warmup
    iterations only. Without `init_eps` the step size comes from
    `find_good_stepsize` on the first chain."""
    device = resolve_device(device)
    theta = torch.as_tensor(init_theta, device=device)
    if theta.dim() == 1:
        raise ValueError("ChEES needs a chain batch: init_theta (C, D)")
    if chees.avg_start is None:
        chees = dataclasses.replace(chees, avg_start=n_adapts // 2)
    n_chains, dim = theta.shape
    dtype = theta.dtype
    if metric is None:
        metric = make_metric("diagonal", dim, dtype=dtype, device=device)
    cfg = AdaptorConfig(kind="stan", mm_kind=mm_kind, da=da)

    t0 = time.perf_counter()
    if init_eps is None:
        eps0 = find_good_stepsize(generator, Hamiltonian(metric=metric,
                                                         target=target),
                                  theta[0])
    else:
        eps0 = torch.as_tensor(init_eps, dtype=dtype, device=device)
    lp, grad = target.logdensity_and_grad(theta)
    lp = torch.where(torch.isfinite(lp), lp, float("-inf"))
    adapt = AdaptState.init(cfg, dim, eps0, dtype)
    carry = (theta, lp, grad, metric, adapt,
             CheesState.init(init_t, dtype, device))
    flags = adapt_flags(cfg, n_adapts, n_samples)
    u_all = torch.as_tensor(halton_sequence(n_samples), dtype=dtype,
                            device=device)
    sched = None
    if t_schedule is not None:
        if isinstance(t_schedule, str):
            if t_schedule != "sweep":
                raise ValueError(f"unknown t_schedule {t_schedule!r}")
            t_schedule = chees_tau_sweep(n_samples, n_adapts)
        sched = torch.as_tensor(np.asarray(t_schedule), dtype=dtype,
                                device=device)
        if sched.shape != (n_samples,):
            raise ValueError("t_schedule must have one multiplier per "
                             "iteration")
    step = make_chees_step(target, cfg, chees, max_steps)
    thetas = theta.new_empty((n_samples, n_chains, dim))
    stats = None
    timings = {}
    for i in range(n_samples):
        if i == n_adapts:
            _synchronize(device)
            timings["warmup_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        carry, (th, st) = step(generator, carry,
                               {k: bool(v[i]) for k, v in flags.items()},
                               u_all[i], None if sched is None else sched[i])
        if stats is None:
            stats = {k: v.new_empty((n_samples, n_chains))
                     for k, v in st.items()}
        thetas[i] = th
        for k, v in st.items():
            stats[k][i] = v
    _synchronize(device)
    timings["draws_s" if n_samples > n_adapts else "warmup_s"] = \
        time.perf_counter() - t0

    warmup_stats = None
    if drop_warmup and n_adapts > 0:
        warmup_stats = {k: v[:n_adapts] for k, v in stats.items()}
        thetas = thetas[n_adapts:]
        stats = {k: v[n_adapts:] for k, v in stats.items()}
    return SampleResult(thetas=thetas, stats=stats,
                        warmup_stats=warmup_stats, final_state=carry,
                        timings=timings, target=target)

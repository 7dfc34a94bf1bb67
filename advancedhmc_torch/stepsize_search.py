"""Initial step-size search (Stan-style heuristic).

Counterpart of `advancedhmc_tpu/stepsize_search.py:18`: double/halve ϵ until
the one-step MH accept ratio crosses 1/2, then bisect until the log accept
ratio lies in [2·log(1/2), log(3/4)]. The search runs on a batch of chains,
each with its own ϵ, bracket and exit flags, as the JAX search vmapped over
chains does: a chain whose loop has ended keeps its state while the others
go on, and the host reads back one flag per trial step for all chains.
"""

from __future__ import annotations

import math

import torch

from .hamiltonian import Hamiltonian
from .integrators import leapfrog_step
from .utils import any_chain


def find_good_stepsize(generator, h: Hamiltonian, theta,
                       initial_step_size=0.1, max_n_iters: int = 100):
    """Search a leapfrog step size from `theta (dim,)`; returns a 0-d tensor."""
    z = h.init_phasepoint(generator, theta[None])
    return _search(h, z, initial_step_size, max_n_iters)[0]


def find_good_stepsizes(generator, h: Hamiltonian, theta,
                        initial_step_size=0.1, max_n_iters: int = 100):
    """Search each chain's step size from its own row of `theta (C, dim)`,
    with fresh momenta; returns a (C,) tensor."""
    return _search(h, h.init_phasepoint(generator, theta), initial_step_size,
                   max_n_iters)


def _search(h, z, initial_step_size, max_n_iters):
    """The search from the phase points `z` (C chains); returns (C,) ϵ."""
    dtype, device = z.theta.dtype, z.theta.device
    # thresholds rounded to the working dtype, as the JAX search compares
    log_a_cross = float(torch.tensor(math.log(0.5), dtype=dtype))
    log_a_min = 2 * log_a_cross
    log_a_max = float(torch.tensor(math.log(0.75), dtype=dtype))
    h0 = z.energy()

    def delta_h(eps):
        return h0 - leapfrog_step(h, z, eps).energy()

    eps = torch.full_like(h0, initial_step_size)
    too_high = delta_h(eps) > log_a_cross   # step too small → grow

    # crossing: double (halve) until the accept ratio crosses 1/2
    eps_prev = eps
    crossed = torch.zeros_like(too_high)
    for _ in range(max_n_iters):
        run = ~crossed
        if not any_chain(run):
            break
        eps_new = torch.where(too_high, 2.0 * eps, 0.5 * eps)
        crossed = crossed | (too_high != (delta_h(eps_new) > log_a_cross))
        eps, eps_prev = (torch.where(run, eps_new, eps),
                         torch.where(run, eps, eps_prev))
    lo, hi = torch.minimum(eps, eps_prev), torch.maximum(eps, eps_prev)

    # bisection until the log accept ratio lies in [log_a_min, log_a_max]
    best = lo
    found = torch.zeros_like(crossed)
    for _ in range(max_n_iters):
        run = ~found
        if not any_chain(run):
            break
        mid = 0.5 * (lo + hi)
        dh = delta_h(mid)
        ok = (dh <= log_a_max) & (dh >= log_a_min)
        hi = torch.where(run & (dh < log_a_min), mid, hi)
        lo = torch.where(run & (dh > log_a_max), mid, lo)
        best = torch.where(run & ok, mid, best)
        found = found | (run & ok)
    return torch.where(found, best, lo)

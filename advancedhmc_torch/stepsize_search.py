"""Initial step-size search (Stan-style heuristic).

Counterpart of `advancedhmc_tpu/stepsize_search.py:18`: double/halve ϵ until
the one-step MH accept ratio crosses 1/2, then bisect until the log accept
ratio lies in [2·log(1/2), log(3/4)]. It runs on one chain with a host loop;
each trial step reads one energy back to the host.
"""

from __future__ import annotations

import math

import torch

from .hamiltonian import Hamiltonian
from .integrators import leapfrog_step


def find_good_stepsize(generator, h: Hamiltonian, theta,
                       initial_step_size=0.1, max_n_iters: int = 100):
    """Search a leapfrog step size from `theta (dim,)`; returns a 0-d tensor."""
    z = h.init_phasepoint(generator, theta[None])
    return _search(h, z, initial_step_size, max_n_iters)


def _search(h, z, initial_step_size, max_n_iters):
    """The search from the phase point `z` (one chain)."""
    dtype, device = z.theta.dtype, z.theta.device
    # thresholds rounded to the working dtype, as the JAX search compares
    log_a_cross = float(torch.tensor(math.log(0.5), dtype=dtype))
    log_a_min = 2 * log_a_cross
    log_a_max = float(torch.tensor(math.log(0.75), dtype=dtype))
    h0 = z.energy()

    def delta_h(eps):
        return float((h0 - leapfrog_step(h, z, eps).energy())[0])

    eps0 = torch.tensor(initial_step_size, dtype=dtype, device=device)
    too_high = delta_h(eps0) > log_a_cross   # step too small → grow

    eps, eps_prev, crossed = eps0, eps0, False
    for _ in range(max_n_iters):
        if crossed:
            break
        eps_new = 2.0 * eps if too_high else 0.5 * eps
        crossed = too_high != (delta_h(eps_new) > log_a_cross)
        eps, eps_prev = eps_new, eps
    lo, hi = torch.minimum(eps, eps_prev), torch.maximum(eps, eps_prev)

    best = lo
    for _ in range(max_n_iters):
        mid = 0.5 * (lo + hi)
        dh = delta_h(mid)
        lo, hi = (mid if dh > log_a_max else lo), (mid if dh < log_a_min
                                                   else hi)
        if log_a_min <= dh <= log_a_max:
            return mid
    return lo

"""The comparison that decides a run's `correct`.

Every number is worked out here from what the timed path produced, against
the plain float64 reference of the configuration (`Reference`), and held to
its limit from the workload file:

- `lp_gap`, `grad_gap`: at every chain's final state of the window, the
  log density and gradient that the program carried (computed by its
  value+grad, K1 on the card, at a state its sampler visited) against the
  reference's at the same θ: max over chains of |ℓ − ℓ_ref| / (1 + |ℓ_ref|)
  and of ‖∇ − ∇_ref‖₂ / ‖∇_ref‖₂.
- `stein_mean_z`, `stein_scale_z`: the window's post-warmup draws of the
  ESS subsample against the posterior of the reference's density, by the
  Stein identities E[∂_j log π] = 0 and E[θ_j ∂_j log π] = −1, which hold
  for every coordinate of a density on Rᵈ that decays in its tails. Each is
  the largest over coordinates of |mean| / (sd / √ESS), with the ESS of the
  series by the frozen estimator. The gradient is the reference's own, so
  a sampler that draws from another law (a wrong integrator, energy, tree
  or adaptation, chains that never reached the posterior) reads high.
- `stuck_share`: the share of the subsample's chains whose first and last
  draw in the window are the same point; a chain that never moves over
  hundreds of transitions is a sampler that does not advance it.

- `leapfrog_gap`, `energy_gap`, `select_gap`: one more draw iteration
  after the window, through the same entry from the window's final state,
  keeps θ, ℓ and ∇ of each of its value+grad calls for a sample of chains
  (`check_step`), and the reference follows it step by step from the
  program's ε and M⁻¹, which are the program's own state. Between three
  successive positions a leapfrog step gives
  q₊ − 2q + q₋ = ε² M⁻¹ ∇log π(q) whatever the momentum; `leapfrog_gap` is
  the worst chain-step's ‖q₊ − 2q + q₋ − ε² M⁻¹ ∇_ref‖ over ‖ε² M⁻¹ ∇_ref‖.
  The momenta at the two ends follow from the positions and the
  reference's gradient (r₀ = M(q₁ − q₀)/ε − ε∇_ref(q₀)/2, and at the far end
  the same with the sign of the half kick turned), and the kinetic energy
  ½ rᵀM⁻¹r of the end the program kept is held against the program's (its
  Hamiltonian less its ℓ): `energy_gap` is the worst chain's
  |K − K_ref| / (1 + K_ref). `select_gap` is the largest difference between
  the state the program kept and the one its `is_accept` names (the
  proposal's or the start's θ, ℓ, ∇): the MH step keeps one of them
  bitwise, so its limit is 0. A chain whose trajectory left the finite
  numbers is left out of the first two and counted.

A number that is not finite fails its limit. Only the numbers that the
workload file gives a limit are compared: a number that neither the cell's
lower-precision control nor a fault it can have moves has no upper reading
to set a limit from (`stuck_share`'s is the fault of a step that leaves
half of the chains or all of them unmoved, 0.5 and 1 by construction). The
others are returned beside them, to be printed.
"""

from __future__ import annotations

import torch

from .ess import _ess_block


def _final_gaps(ref, theta, lp, grad):
    lp_r, g_r = ref.value_and_grad(theta)
    lp_p = lp.to(torch.float64)
    g_p = grad.to(torch.float64)
    lp_gap = torch.max(torch.abs(lp_p - lp_r) / (1.0 + torch.abs(lp_r)))
    grad_gap = torch.max(torch.linalg.vector_norm(g_p - g_r, dim=1)
                         / torch.linalg.vector_norm(g_r, dim=1))
    return float(lp_gap), float(grad_gap)


def _stein_z(ref, draws, max_bytes: float = 4e9):
    """(max_j |z| of E[∂_j log π], max_j |z| of E[θ_j ∂_j log π] + 1) over
    draws (T, m, dim)."""
    t, m, d = draws.shape
    flat = draws.reshape(t * m, d)
    grads = torch.empty_like(draws)
    gflat = grads.view(t * m, d)
    rows = max(1, int(max_bytes // (8 * 4 * d)))
    for lo in range(0, t * m, rows):
        gflat[lo:lo + rows] = ref.value_and_grad(flat[lo:lo + rows])[1].to(
            grads.dtype)
    del gflat
    step = max(1, min(d, int(max_bytes // (8 * 8 * 2 * t * m))))
    z_mean, z_scale = [], []
    for lo in range(0, d, step):
        g = grads[:, :, lo:lo + step].to(torch.float64)
        for series, out in ((g, z_mean), (
                draws[:, :, lo:lo + step].to(torch.float64) * g + 1.0,
                z_scale)):
            ess = _ess_block(series)
            mean = series.mean((0, 1))
            sd = series.reshape(t * m, -1).std(0)
            out.append(torch.abs(mean) / (sd / torch.sqrt(ess)))
        del g
    del grads
    return (float(torch.max(torch.cat(z_mean))),
            float(torch.max(torch.cat(z_scale))))


def _worst(x):
    """The largest of `x`, NaN where it is empty (every chain left out)."""
    return float(x.max()) if x.numel() else float("nan")


def _step_gaps(ref, step):
    """The leapfrog, energy and selection numbers of a followed draw step
    (`check_step`: θ, ℓ, ∇ (L + 1, k, ·) from the start through each of the
    L value+grad calls, the kept state, ε, the diagonal M⁻¹ (d,),
    `is_accept`, the program's Hamiltonian and acceptance, for k chains)."""
    q = step["theta"].to(torch.float64)
    n_pos, k, d = q.shape
    g = ref.value_and_grad(q.reshape(n_pos * k, d))[1].reshape(n_pos, k, d)
    eps = float(step["eps"])
    m_inv = step["m_inv"].to(torch.float64)
    finite = torch.isfinite(q).all(-1).all(0) & torch.isfinite(g).all(-1) \
        .all(0) & torch.isfinite(step["lp"]).all(0)
    out = {"check_chains": k, "check_steps": n_pos - 1,
           "check_chains_left_out": int((~finite).sum())}
    if n_pos > 2:
        kick = eps * eps * m_inv * g[1:-1]
        resid = q[2:] - 2.0 * q[1:-1] + q[:-2] - kick
        ratio = (torch.linalg.vector_norm(resid, dim=-1)
                 / torch.linalg.vector_norm(kick, dim=-1))
        out["leapfrog_gap"] = _worst(ratio[:, finite])
    else:
        out["leapfrog_gap"] = float("nan")
    r0 = (q[1] - q[0]) / (eps * m_inv) - 0.5 * eps * g[0]
    r1 = (q[-1] - q[-2]) / (eps * m_inv) + 0.5 * eps * g[-1]
    acc = step["accept"].to(torch.bool)
    r = torch.where(acc[:, None], r1, r0)
    k_ref = 0.5 * torch.sum(r * r * m_inv, -1)
    k_prog = (step["energy"].to(torch.float64)
              + step["kept"][1].to(torch.float64))
    out["energy_gap"] = _worst(
        (torch.abs(k_prog - k_ref) / (1.0 + k_ref))[finite])
    sel = [torch.where(acc.view(-1, *([1] * (a.dim() - 2))), a[-1], a[0])
           for a in (step["theta"], step["lp"], step["grad"])]
    out["select_gap"] = max(
        float(torch.nan_to_num(torch.abs(a.to(torch.float64)
                                         - b.to(torch.float64)),
                               nan=float("inf")).max())
        for a, b in zip(step["kept"], sel))
    alpha = step["alpha"].to(torch.float64)
    out["accept_z"] = float(
        (acc.to(torch.float64).sum() - alpha.sum())
        / torch.sqrt(torch.clamp((alpha * (1 - alpha)).sum(), min=1e-12)))
    return out


def compare(ref, final, draws, limits: dict, step):
    """({name: (value, limit)} of the compared numbers, {name: value} of the
    others) for `final` = (θ, ℓ, ∇) of every chain at the window's close,
    `draws` (T, m, dim), the subsample's post-warmup draws of the window,
    and `step`, the record of the draw step followed after it."""
    theta, lp, grad = final
    lp_gap, grad_gap = _final_gaps(ref, theta, lp, grad)
    values = {"lp_gap": lp_gap, "grad_gap": grad_gap}
    values["stein_mean_z"], values["stein_scale_z"] = _stein_z(ref, draws)
    values["stuck_share"] = float(
        (draws[0] == draws[-1]).all(-1).to(torch.float64).mean())
    values.update(_step_gaps(ref, step))
    # the adaptation's M⁻¹ against the draws' variance: (min, median, max)
    # over coordinates
    var = draws.to(torch.float64).reshape(-1, draws.shape[-1]).var(0)
    ratio = step["m_inv"].to(torch.float64) / var
    values["m_inv_over_draws_var"] = [
        float(ratio.min()), float(ratio.median()), float(ratio.max())]
    return ({k: (v, float(limits[k])) for k, v in values.items()
             if k in limits},
            {k: v for k, v in values.items() if k not in limits})


def passed(checks: dict) -> bool:
    """True where every value is finite and at most its limit (a NaN
    compares false and fails)."""
    return all(v <= lim for v, lim in checks.values())

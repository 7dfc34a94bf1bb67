"""Hierarchical Bayesian logistic regression, the sampler's main-path target.

PyTorch counterpart of `advancedhmc_tpu/models/logistic.py` (the same
fixed-seed synthetic design and the same model):

    log σ ~ N(0, 1),   β_j ~ N(0, σ²),   y_i ~ Bernoulli(logit⁻¹(x_iᵀ β))

θ = (log σ, β₁..β_p), dim = p + 1. The batched value+grad dispatches
before the call, as the JAX model's `fused=True` gate does: a float32 θ on
CUDA (`ops.fused_logistic.kernel_route`) is one call of the CUDA kernel K1
with the prior folded in (`prior=True`), at any p (above p = 128 its wide
path, over the design laid out once per target); any other θ (the CPU,
float64) the prior in torch plus the analytic likelihood, the counterpart
of the JAX model's `logdensity_and_grad`.

The JAX model's reduced-precision switches are here too. `x_dtype=
"bfloat16"` (or "float16") stores the design rounded to that dtype (from
the float64 data, as the JAX model does) and rounds β to it in both
products and the residual before the gradient's, with float32 (at least
the model's dtype) sums: the perturbed posterior is then sampled exactly.
`resid_dtype` rounds the residual alone (then to the design's dtype). The
prior takes the unrounded θ. On CUDA K1 runs the same rounding (its
modes, `ops.fused_logistic.mode_of`); a design and a residual in two
different reduced dtypes, which K1 has no mode for, raise there.

`hierarchical_logistic_nc` is its non-centred form, θ = (log σ, β̃) with
β = σ·β̃, and `german_credit_logistic` the model at German credit's shape
(1000 rows, 24 features). `hierarchical_logistic_block` is the model in
the block form of the NUTS megakernel K2 (`ops/fused_nuts_kernel.py`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .. import profiling
from ..ops.fused_logistic import fused_logistic_value_grad, \
    hierarchical_prior, kernel_route, mode_of
from ..target import BlockTarget, LogDensityTarget
from ..utils import reduced_dtype, resolve_device, round_to


@lru_cache(maxsize=None)
def _synthetic_data(n: int, p: int, seed: int = 0):
    """Copy of the JAX package's generator; tests hold the two bit-equal."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    x = (x - x.mean(0)) / x.std(0)
    beta_true = rng.normal(size=(p,)) * 0.5
    logits = x @ beta_true
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    return x, y


def _prior(theta, p):
    """Log prior of (log σ, β) and its gradient, batched
    (`ops.fused_logistic.hierarchical_prior`)."""
    with profiling.span("ahmc.target.prior"):
        return hierarchical_prior(theta, p)


def _loglik(y, logits):
    return torch.sum(
        y * logits - torch.logaddexp(logits, torch.zeros_like(logits)), -1)


def hierarchical_logistic(n: int = 1000, p: int = 24, seed: int = 0,
                          dtype=torch.float32, resid_dtype=None, x_dtype=None,
                          device=None) -> LogDensityTarget:
    """The hierarchical logistic target on `device` (None means CUDA), with
    the design in `x_dtype` and the residual in `resid_dtype` (None,
    "bfloat16" or "float16")."""
    xd = reduced_dtype(x_dtype, "x_dtype")
    rd = reduced_dtype(resid_dtype, "resid_dtype")
    device = resolve_device(device)
    x_np, y_np = _synthetic_data(n, p, seed)
    # rounded on the host, from float64 as the JAX model rounds it
    x = round_to(torch.as_tensor(x_np), xd).to(dtype)
    x = x.to(device).contiguous()
    y = torch.as_tensor(y_np, dtype=dtype, device=device)
    mode = mode_of(xd, rd)
    # K1 with the prior folded in: the whole value+grad on the card
    fused = None if mode is None else fused_logistic_value_grad(
        x, y, mode, prior=True)

    def logdensity(theta):
        return _prior(theta, p)[0] + _loglik(y, round_to(theta[:, 1:], xd)
                                             @ x.T)

    def logdensity_and_grad(theta):
        with profiling.span("ahmc.target.value_grad"):
            if kernel_route(theta):
                if fused is None:
                    raise ValueError(
                        f"K1 has no mode for x_dtype={xd} with "
                        f"resid_dtype={rd} (a residual rounded twice)")
                return fused(theta)
            lp_pri, g_pri = _prior(theta, p)
            logits = round_to(theta[:, 1:], xd) @ x.T
            resid = round_to(round_to(y - torch.sigmoid(logits), rd), xd)
            g_beta = resid @ x
            return lp_pri + _loglik(y, logits), g_pri + F.pad(g_beta, (1, 0))

    return LogDensityTarget(logdensity, p + 1, logdensity_and_grad)


def hierarchical_logistic_nc(n: int = 1000, p: int = 24, seed: int = 0,
                             dtype=torch.float32,
                             device=None) -> LogDensityTarget:
    """The non-centred hierarchy on `device` (None means CUDA): the same
    posterior and data, θ = (log σ, β̃) with β = σ·β̃, β̃ ~ N(0, I), log σ ~
    N(0, 1). Counterpart of the JAX function of the same name.

    On the card (`kernel_route`) the likelihood goes through K1, exactly:
    the logits x·β = σ·(x·β̃) are those of the centred model at θ' = (log
    σ, σ·β̃), so K1 at θ' gives lp and g_β = resid·x, and then ∇β̃ = σ·g_β
    − β̃ and ∂/∂log σ = −log σ + g_β·β. Elsewhere the analytic value+grad
    of the JAX model."""
    device = resolve_device(device)
    x_np, y_np = _synthetic_data(n, p, seed)
    x = torch.as_tensor(x_np, dtype=dtype, device=device).contiguous()
    y = torch.as_tensor(y_np, dtype=dtype, device=device)
    likelihood = fused_logistic_value_grad(x, y)

    def prior(theta):
        ls, bt = theta[:, 0], theta[:, 1:]
        return -0.5 * ls * ls - 0.5 * torch.sum(bt * bt, -1)

    def logdensity(theta):
        logits = torch.exp(theta[:, :1]) * (theta[:, 1:] @ x.T)
        return prior(theta) + _loglik(y, logits)

    def logdensity_and_grad(theta):
        with profiling.span("ahmc.target.value_grad"):
            ls, bt = theta[:, :1], theta[:, 1:]
            s = torch.exp(ls)
            if kernel_route(theta):
                beta = s * bt
                lp_lik, g = likelihood(torch.cat([ls, beta], 1))
                g_beta = g[:, 1:]
                grad_ls = -ls + torch.sum(g_beta * beta, -1, keepdim=True)
            else:
                logits = s * (bt @ x.T)
                lp_lik = _loglik(y, logits)
                resid = y - torch.sigmoid(logits)
                # ∂logits/∂log σ = logits; ∂logits/∂β̃ = σ·x
                grad_ls = -ls + torch.sum(resid * logits, -1, keepdim=True)
                g_beta = resid @ x
            return (prior(theta) + lp_lik,
                    torch.cat([grad_ls, s * g_beta - bt], 1))

    return LogDensityTarget(logdensity, p + 1, logdensity_and_grad)


def german_credit_logistic(dtype=torch.float32,
                           device=None) -> LogDensityTarget:
    """The hierarchical logistic at German credit's shape (synthetic data,
    1000 rows × 24 features, 25 parameters) on `device` (None means CUDA):
    on the card K1's narrow instances."""
    return hierarchical_logistic(n=1000, p=24, seed=0, dtype=dtype,
                                 device=device)


def hierarchical_logistic_block(n: int = 1000, p: int = 24, seed: int = 0,
                                d_pad: int = 128, device=None):
    """Block form of the model for the NUTS megakernel, on `device` (None
    means CUDA); counterpart of the JAX function of the same name.

    Returns `(target, (xt, y))`: `target(theta (B, d_pad), xt, y)` gives
    ((B, 1) logp, (B, d_pad) grad); xt (d_pad, n) float32 has row 0 zero
    (the slot of log σ) and rows p+1.. zero, y is (1, n). Its "logistic"
    kind is compiled into K2's CUDA kernel."""
    device = resolve_device(device)
    x_np, y_np = _synthetic_data(n, p, seed)
    xt = np.zeros((d_pad, n), np.float32)
    xt[1:p + 1, :] = x_np.T
    y = y_np.astype(np.float32)[None, :]

    def fn(th, xt_m, y_m):
        log_sigma = th[:, :1]                               # (B, 1)
        inv_s2 = torch.exp(-2.0 * log_sigma)
        logits = th @ xt_m                                   # (B, n)
        sig = torch.sigmoid(logits)
        loglik = torch.sum(
            y_m * logits - torch.logaddexp(torch.zeros_like(logits), logits),
            1, keepdim=True)
        beta_sq = torch.sum(th * th, 1, keepdim=True) - log_sigma ** 2
        lp = (-0.5 * log_sigma ** 2
              - 0.5 * beta_sq * inv_s2 - p * log_sigma + loglik)
        resid = y_m - sig                                    # (B, n)
        grad_data = resid @ xt_m.T                           # (B, d_pad)
        grad_beta_prior = -th * inv_s2     # right for the β columns
        grad_ls = -log_sigma + beta_sq * inv_s2 - p
        col0 = torch.arange(th.shape[1], device=th.device) == 0
        grad_prior = torch.where(col0, grad_ls, grad_beta_prior)
        return lp, grad_data + grad_prior

    return BlockTarget("logistic", fn, p=p), (
        torch.as_tensor(xt, device=device), torch.as_tensor(y, device=device))

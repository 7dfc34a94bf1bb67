"""Plain float64 reference of the hierarchical logistic regression.

    log σ ~ N(0, 1),   β_j ~ N(0, σ²),   y_i ~ Bernoulli(logit⁻¹(x_iᵀ β))

θ = (log σ, β₁..β_p). The log density is the log joint with the constant
terms left out, (p + 1)·½·log 2π among them, as the program leaves them out;
a comparison of values rests on that convention. The data come from this
file's own copy of the synthetic generator that the program documents (a
standardised normal design and labels drawn from β_true ~ N(0, ¼)), from
the configuration's data seed, so that the reference takes nothing that
the program made. Plain torch in float64; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def synthetic_data(n: int, p: int, seed: int = 0):
    """Design (n, p) and labels (n,) in float64 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    x = (x - x.mean(0)) / x.std(0)
    beta_true = rng.normal(size=(p,)) * 0.5
    logits = x @ beta_true
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float64)
    return x, y


class Reference:
    """The configuration's log density and gradient in float64 on `device`,
    taken in blocks of `block` rows of θ so that large batches fit."""

    def __init__(self, cfg: dict, device, block: int = 16384):
        x, y = synthetic_data(cfg["n_rows"], cfg["n_features"],
                              cfg["data_seed"])
        self.p = cfg["n_features"]
        self.x = torch.as_tensor(x, dtype=torch.float64, device=device)
        self.y = torch.as_tensor(y, dtype=torch.float64, device=device)
        self.block = block

    def _value_and_grad(self, theta):
        theta = theta.to(device=self.x.device, dtype=torch.float64)
        ls, beta = theta[:, 0], theta[:, 1:]
        inv_s2 = torch.exp(-2.0 * ls)
        bsq = torch.sum(beta * beta, -1)
        logits = beta @ self.x.T
        loglik = torch.sum(self.y * logits
                           - torch.logaddexp(logits, torch.zeros_like(logits)),
                           -1)
        lp = -0.5 * ls * ls - 0.5 * bsq * inv_s2 - self.p * ls + loglik
        g_ls = -ls + bsq * inv_s2 - self.p
        g_beta = -beta * inv_s2[:, None] + (self.y - torch.sigmoid(logits)) \
            @ self.x
        return lp, torch.cat([g_ls[:, None], g_beta], 1)

    def value_and_grad(self, theta):
        """(lp (C,), grad (C, p + 1)) in float64 for θ (C, p + 1)."""
        lps, grads = [], []
        for lo in range(0, theta.shape[0], self.block):
            lp, g = self._value_and_grad(theta[lo:lo + self.block])
            lps.append(lp)
            grads.append(g)
        return torch.cat(lps), torch.cat(grads)

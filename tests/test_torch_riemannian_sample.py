"""The Riemannian tier's sampling loops in the port (`tests/
test_riemannian.py`'s statistical tests, in float64): SoftAbs RMHMC
transitions and `sample_rmhmc` on the banana posterior, Riemannian NUTS
through `sample_rmhmc` on a 2-D correlated Gaussian (identity map on its
constant metric, and SoftAbs), and `sample_rmhmc`'s criteria and device.
`test_torch_riemannian.py` holds the pieces to the JAX package.
"""

import numpy as np
import pytest
import torch

import advancedhmc_torch as ah
from advancedhmc_torch import riemannian as rt

torch.set_num_threads(2)


def _np(x):
    return x.detach().cpu().numpy()


def test_rmhmc_banana_smoke():
    """SoftAbs RMHMC transitions on the banana posterior, driven by hand as
    the JAX test drives them: finite draws, healthy acceptance."""
    target = ah.banana(device="cpu")
    h = rt.RiemannianHamiltonian(
        metric=rt.DenseRiemannianMetric.from_hessian(target,
                                                     rt.SoftAbsMap(1.0)),
        target=target)
    integ = rt.GeneralizedLeapfrog(
        step_size=torch.tensor(0.1, dtype=torch.float64), n_fp=6)
    gen = torch.Generator().manual_seed(4)
    z = h.init_phasepoint(gen, torch.zeros(4, 2, dtype=torch.float64))
    n_accept, draws = 0, []
    for _ in range(15):
        z = h.phasepoint(z.theta, h.rand_momentum(gen, z.theta))
        z, stats = rt.transition_rmhmc(gen, h, integ, 8, z)
        n_accept += int(stats["is_accept"].sum())
        draws.append(_np(z.theta))
    assert np.isfinite(np.stack(draws)).all()
    assert n_accept > 20          # of 60, as the JAX test's one chain × 60


def test_sample_rmhmc_banana():
    """The one-call loop with step-size dual averaging on the banana
    posterior (the JAX test's settings, cut to 60 iterations): shapes,
    finite draws, acceptance after the warmup, ε finalised."""
    thetas, stats, (z, da) = rt.sample_rmhmc(
        torch.Generator().manual_seed(10), ah.banana(device="cpu"),
        torch.zeros(2, dtype=torch.float64), n_samples=60, n_leapfrog=6,
        step_size=0.2, n_fp=5, map_cfg=rt.SoftAbsMap(1.0), n_adapts=20,
        n_chains=4, device="cpu")
    assert thetas.shape == (60, 4, 2)
    assert stats["acceptance_rate"].shape == (60, 4)
    assert torch.isfinite(thetas).all()
    assert float(stats["acceptance_rate"][20:].mean()) > 0.5
    assert torch.equal(da.eps, torch.exp(da.x_bar))
    assert torch.equal(z.theta, thetas[-1])


@pytest.mark.parametrize("map_name", ["identity", "softabs"])
def test_riemannian_nuts_posterior_mean(map_name):
    """Riemannian NUTS through `sample_rmhmc` recovers the mean of a 2-D
    correlated Gaussian (the JAX test's gate and tolerances; its 8 chains ×
    250 iterations, 100 adapting, here 32 chains × 100, 40 adapting: more
    draws kept, in fewer iterations of the host's loop)."""
    a = torch.tensor([[1.5, 0.4], [0.4, 0.8]], dtype=torch.float64)
    mean = torch.tensor([0.6, -0.3], dtype=torch.float64)

    def logp(x):
        d = x - mean
        return -0.5 * torch.einsum("ca,ab,cb->c", d, a, d)

    target = ah.LogDensityTarget(logp, 2)
    if map_name == "identity":
        metric = rt.DenseRiemannianMetric(
            size=2, g_fn=lambda t: a.expand(t.shape[0], 2, 2),
            dg_fn=lambda t: torch.zeros(t.shape[0], 2, 2, 2,
                                        dtype=t.dtype),
            map=rt.IdentityMap())
    else:
        metric = rt.DenseRiemannianMetric.from_hessian(target,
                                                       rt.SoftAbsMap(20.0))
    thetas, stats, _ = rt.sample_rmhmc(
        torch.Generator().manual_seed(0), target,
        torch.zeros(32, 2, dtype=torch.float64), n_samples=100, n_adapts=40,
        step_size=0.3, metric=metric,
        criterion=ah.GeneralisedNoUTurn(max_depth=5), device="cpu")
    post = _np(thetas[40:]).reshape(-1, 2)
    np.testing.assert_allclose(post.mean(0), _np(mean), atol=0.12)
    assert float(stats["acceptance_rate"][40:].mean()) > 0.6
    assert int(stats["tree_depth"].max()) >= 1


def test_sample_rmhmc_criteria_and_device():
    """A `FixedNSteps` criterion sets the static path's step count, any
    other static criterion raises, and the default device is CUDA."""
    target = ah.banana(device="cpu")
    th0 = torch.zeros(2, 2, dtype=torch.float64)
    _, st, _ = rt.sample_rmhmc(torch.Generator(), target, th0, 2,
                               criterion=ah.FixedNSteps(3),
                               map_cfg=rt.SoftAbsMap(1.0), device="cpu")
    assert (st["n_steps"] == 3).all()
    with pytest.raises(ValueError, match="FixedNSteps"):
        rt.sample_rmhmc(torch.Generator(), target, th0, 2,
                        criterion=ah.FixedIntegrationTime(1.0),
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.sample_rmhmc(torch.Generator(), target, th0, 2)

"""The port's reduced-precision switches against the JAX package.

* The model's `x_dtype` and `resid_dtype` ("bfloat16"): value and gradient
  against JAX `hierarchical_logistic` with the same switch, in float64 (the
  roundings are the same; only the sums' order differs: 1e-10), at p ≤ 128
  and p > 128.
* K1's bfloat16 mode: its plain twin against the JAX Pallas kernel in
  interpret mode (which always computes on bfloat16 θ, x and residuals)
  in float32: 1e-5 of the largest magnitude for the float32 sums in
  another order, plus on the gradient what the residual's rounding can
  move where a residual lies near a bfloat16 rounding midpoint
  (`rounding_reference`); and the layout and the C interface of the mode.
* The trajectory's `stack_dtype` ("bfloat16"): `nuts_transition` under
  `force_directions` against JAX's, from the same phase points and
  trajectory (`convert`): the integer outputs exactly, the floats to 1e-10,
  and the bfloat16 stacks bit for bit.
"""

import collections
import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import advancedhmc_tpu as aj
from advancedhmc_tpu.models.logistic import (
    hierarchical_logistic as jax_logistic,
)
from advancedhmc_tpu.ops.fused_logistic import (
    fused_logistic_value_grad as pallas_k1,
)

import advancedhmc_torch as ah
from advancedhmc_torch import convert
from advancedhmc_torch.models.logistic import _synthetic_data
from advancedhmc_torch.ops import fused_logistic as k1

torch.set_num_threads(2)

N = 200
CSRC = Path(k1.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("p", [9, 150])
@pytest.mark.parametrize("switch", ["x_dtype", "resid_dtype"])
def test_model_switch_matches_jax(p, switch):
    kw = {switch: "bfloat16"}
    th = 0.1 * np.random.default_rng(p).normal(size=(6, p + 1))
    tj = jax_logistic(n=N, p=p, dtype=jnp.float64, **kw)
    lp_j, g_j = jax.vmap(tj.logdensity_and_grad)(jnp.asarray(th))
    ld_j = jax.vmap(tj.logdensity)(jnp.asarray(th))
    tt = ah.hierarchical_logistic(n=N, p=p, dtype=torch.float64,
                                  device="cpu", **kw)
    lp_t, g_t = tt.logdensity_and_grad(torch.as_tensor(th))
    ld_t = tt.logdensity(torch.as_tensor(th))
    for a, b in ((lp_t, lp_j), (g_t, g_j), (ld_t, ld_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)
    # the switch changes the function: against the float64 model
    lp_0, g_0 = ah.hierarchical_logistic(
        n=N, p=p, dtype=torch.float64, device="cpu").logdensity_and_grad(
        torch.as_tensor(th))
    assert float((g_t - g_0).abs().max()) > 1e-6


@pytest.mark.parametrize("p", [9, 150])
def test_k1_bf16_plain_twin_matches_pallas_interpret(p):
    x_np, y_np = _synthetic_data(N, p)
    th = 0.3 * np.random.default_rng(p + 1).normal(size=(8, p + 1))
    apply = pallas_k1(jnp.asarray(x_np, jnp.float32),
                      jnp.asarray(y_np, jnp.float32), interpret=True)
    lp_j, g_j = apply(jnp.asarray(th, jnp.float32))
    theta = torch.as_tensor(th, dtype=torch.float32)
    x = torch.as_tensor(x_np, dtype=torch.float32)
    y = torch.as_tensor(y_np, dtype=torch.float32)
    lp_t, g_t = k1.logistic_value_grad(theta, x, y, mode=k1.MODE_BF16)
    _, g_r, allow, _ = k1.rounding_reference(theta, x, y, k1.MODE_BF16)
    tol = 1e-5 * float(g_r.abs().max())
    diff = (g_t.double() - torch.as_tensor(np.asarray(g_j),
                                           dtype=torch.float64)).abs()
    assert bool((diff <= tol + allow).all()), float((diff - allow).max())
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5,
                               atol=1e-5 * float(np.abs(lp_j).max()))
    # the mode is not the float32 function
    _, g_f = k1.logistic_value_grad(theta, x, y)
    assert float((g_f - g_t).abs().max()) > 10 * tol


@pytest.mark.parametrize("mode", [k1.MODE_BF16, k1.MODE_RESID_BF16])
def test_rounding_reference_covers_the_float32_twin(mode):
    """The float32 plain twin of each mode lies within K1's gate of the
    mode's float64 function, the allowance covering the residual roundings
    that float32 logits can flip; chains with no residual near a midpoint
    get none."""
    x_np, y_np = _synthetic_data(1000, 99)
    x = torch.as_tensor(x_np, dtype=torch.float32)
    y = torch.as_tensor(y_np, dtype=torch.float32)
    theta = 0.3 * torch.randn(64, 100, generator=torch.Generator()
                              .manual_seed(mode), dtype=torch.float32)
    lp_p, g_p = k1.plain_logistic_value_grad(theta, x, y, mode)
    lp_r, g_r, allow, n_near = k1.rounding_reference(theta, x, y, mode)
    diff = (g_p.double() - g_r).abs()
    assert bool((diff <= 1e-4 * g_r.abs().max() + allow).all())
    assert float((lp_p.double() - lp_r).abs().max()) <= 1e-4 * float(
        lp_r.abs().max())
    assert 0 < n_near < 0.05 * 64 * 1000
    assert bool((allow[:, 0] == 0).all())
    _, _, none, zero = k1.rounding_reference(theta, x, y, k1.MODE_F32)
    assert zero == 0 and not bool(none.any())


def test_k1_bf16_wide_layout():
    """In the bfloat16 mode the wide path's design is x rounded to bfloat16
    in the hi plane (exact in TF32) and a zero lo plane; the float32 mode's
    planes are untouched."""
    x = torch.as_tensor(_synthetic_data(45, 140)[0], dtype=torch.float32)
    planes, t_planes = k1.wide_layout(x, k1.MODE_BF16)
    assert torch.equal(planes[0, :45, 1:141],
                       x.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(k1.tf32_round(planes[0]), planes[0])
    assert not bool(planes[1].any())
    assert torch.equal(t_planes, planes.transpose(1, 2))
    f_planes, _ = k1.wide_layout(x)
    assert torch.equal(f_planes[0] + f_planes[1], torch.nn.functional.pad(
        x, (1, f_planes.shape[2] - 141, 0, f_planes.shape[1] - 45)))


def test_k1_mode_numbers_and_c_interface():
    """The wrapper's modes and links are the kernels' (`enum Mode` and
    `enum Link` of the tile header), the mode reaches the C entry after n,
    then the prior's flag, the link and its offset, and the ctypes argument
    list has as many entries as the C signature."""
    tile = (CSRC / "logistic_tile.cuh").read_text()
    enum = dict(re.findall(r"(k\w+) = (\d)", re.search(
        r"enum Mode : int \{([^}]*)\}", tile).group(1)))
    assert enum == {"kF32": str(k1.MODE_F32), "kBf16": str(k1.MODE_BF16),
                    "kResidBf16": str(k1.MODE_RESID_BF16),
                    "kF16": str(k1.MODE_F16),
                    "kResidF16": str(k1.MODE_RESID_F16)}
    links = dict(re.findall(r"(k\w+) = (\d)", re.search(
        r"enum Link : int \{([^}]*)\}", tile).group(1)))
    assert links == {"kLogistic": str(k1.LINKS["logistic"]),
                     "kPoisson": str(k1.LINKS["poisson"])}
    src = (CSRC / "fused_logistic.cu").read_text()
    for name, n_args in (("fused_logistic_value_grad_f32", 16),
                         ("fused_logistic_launch_shape", 6),
                         ("fused_logistic_wide_shape", 5)):
        sig = re.search(rf"\b(?:int|void) {name}\(([^)]*)\)", src).group(1)
        params = [a.strip() for a in sig.split(",")]
        assert len(params) == n_args, (name, params)
    sig = re.search(r"int fused_logistic_value_grad_f32\(([^)]*)\)",
                    src).group(1)
    assert [a.split()[-1] for a in sig.split(",")][7:12] == [
        "n", "mode", "prior", "link", "offset"]
    assert [a.split()[0] for a in sig.split(",")][10:12] == ["int", "float"]
    # the wrapper's argument types, set on a stand-in for the library
    fns = collections.defaultdict(lambda: SimpleNamespace(argtypes=None))
    lib = type("Lib", (), {"__getattr__": lambda _, name: fns[name]})()
    argtypes = k1._kernel(lib).argtypes
    assert len(argtypes) == 16
    assert argtypes[10:12] == [ctypes.c_int, ctypes.c_float]
    assert k1.mode_of(torch.bfloat16, None) == k1.MODE_BF16
    assert k1.mode_of(torch.bfloat16, torch.bfloat16) == k1.MODE_BF16
    assert k1.mode_of(None, torch.bfloat16) == k1.MODE_RESID_BF16
    assert k1.mode_of(None, None) == k1.MODE_F32


def _targets(name, dim):
    if name == "std":
        return (lambda x: -0.5 * jnp.sum(x ** 2),
                lambda x: -0.5 * torch.sum(x ** 2, -1))
    prec = np.eye(dim) + 0.5 * np.ones((dim, dim))
    pj, pt = jnp.asarray(prec), torch.as_tensor(prec)
    return (lambda x: -0.5 * x @ pj @ x,
            lambda x: -0.5 * torch.sum((x @ pt) * x, -1))


@pytest.mark.parametrize("tname,dim,eps,max_depth,seed,precision", [
    ("std", 5, 0.45, 6, 0, None),
    ("corr", 8, 0.3, 7, 1, "highest"),
    ("std", 3, 0.9, 6, 2, None),
])
def test_bf16_stacks_match_jax_under_forced_directions(
        tname, dim, eps, max_depth, seed, precision):
    lp_j, lp_t = _targets(tname, dim)
    m_inv = np.linspace(0.5, 2.0, dim)
    hj = aj.Hamiltonian(metric=aj.DiagEuclideanMetric.create(
        jnp.asarray(m_inv)), target=aj.LogDensityTarget(lp_j, dim))
    ht = ah.Hamiltonian(metric=convert.diag_metric(m_inv, "cpu"),
                        target=ah.LogDensityTarget(lp_t, dim))
    traj_j = aj.Trajectory(aj.Leapfrog(step_size=jnp.asarray(eps)),
                           aj.GeneralisedNoUTurn(max_depth=max_depth),
                           "multinomial", stack_dtype="bfloat16",
                           uturn_precision=precision)
    traj_t = convert.trajectory(traj_j, "cpu")
    assert traj_t.stack_torch_dtype == torch.bfloat16
    rng = np.random.default_rng(seed)
    directions = rng.choice([-1, 1], size=max_depth)
    c = 12
    zj = jax.vmap(hj.phasepoint)(jnp.asarray(rng.normal(size=(c, dim))),
                                 jnp.asarray(rng.normal(size=(c, dim))))
    _, st_j, dbg_j = jax.vmap(lambda z: aj.nuts_transition(
        jax.random.PRNGKey(0), hj, traj_j, z, force_directions=directions,
        return_debug=True))(zj)
    _, st_t, dbg_t = ah.nuts_transition(
        torch.Generator().manual_seed(0), ht, traj_t,
        convert.phasepoint(zj, "cpu"), force_directions=directions,
        return_debug=True)
    for k in ("n_steps", "tree_depth", "numerical_error"):
        assert np.array_equal(st_t[k].numpy(), np.asarray(st_j[k])), k
    for k in ("acceptance_rate", "max_hamiltonian_energy_error"):
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dbg_t["t_rho"].numpy(),
                               np.asarray(dbg_j["t_rho"]), rtol=1e-10,
                               atol=1e-12)
    n_slots = max(1, max_depth - 1)
    for kt, kj in (("ck_r", "ck_r"), ("ck_d", "ck_cum")):
        assert dbg_t[kt].dtype == torch.bfloat16
        got = dbg_t[kt][:, :n_slots].to(torch.float64).numpy()
        want = np.asarray(dbg_j[kj]).astype(np.float64)
        assert np.array_equal(got, want), kt
    # at these settings the bfloat16 stacks make the float64 stacks'
    # decisions: the same trees
    _, st_f = ah.nuts_transition(
        torch.Generator().manual_seed(0), ht,
        ah.Trajectory(traj_t.integrator, traj_t.criterion),
        convert.phasepoint(zj, "cpu"), force_directions=directions)
    for k in ("n_steps", "tree_depth", "numerical_error"):
        assert torch.equal(st_f[k], st_t[k]), k


def test_uturn_precision_values():
    lf = ah.Leapfrog(step_size=torch.tensor(0.1))
    for prec in (None, "default", "high", "highest", "HIGHEST"):
        ah.Trajectory(lf, ah.GeneralisedNoUTurn(), uturn_precision=prec)
    with pytest.raises(ValueError, match="uturn_precision"):
        ah.Trajectory(lf, ah.GeneralisedNoUTurn(), uturn_precision="best")
    assert ah.Trajectory(lf, ah.GeneralisedNoUTurn()).stack_torch_dtype \
        is None

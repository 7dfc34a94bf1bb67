"""K3: fused multi-step leapfrog for diagonal-Gaussian targets, in CUDA.

Replaces the Pallas kernel `advancedhmc_tpu/ops/fused_leapfrog.py:33`
(`_kernel`; wrapper `fused_gaussian_leapfrog` :60): `n_steps` of
kick-drift-kick for every chain of a diagonal Gaussian (∇ℓπ = −prec ⊙ θ)
with a diagonal M⁻¹ and a fixed step size, returning θ′, r′ and the
potential ½Σ prec·θ² and kinetic ½Σ m_inv·r² energies per chain — the
"vectorized chains" regime of many chains of a small state.

The kernel (`csrc/fused_leapfrog.cu`) gives each lane one dim index: a
warp's lanes cover 32 dims of a chain (the chain in chunks of 32) or whole
chains of fewer dims, and a lane holds that dim of E chains, so its
elements share a = ε·m_inv and b = ε·prec and every lane's elements exist
(`launch_shape`: E from C·D). Their L steps run in registers with the
half-kicks of consecutive steps merged into full kicks: two FMAs an
element and step, θ′ and r′ written once. Each chain's energies are summed
by warp shuffles (and, for D > 256, across the warps that split the chain)
in a fixed order, so two calls give the same bits. It is bound by the
float32 rate at L = 100 (about 4·C·D·L operations against 16·C·D bytes).

`fused_gaussian_leapfrog` dispatches on the device of θ: a CPU tensor
takes `reference_gaussian_leapfrog`, the plain PyTorch loop; a CUDA tensor
launches the kernel (one launch a call) or raises.
`fused_gaussian_leapfrog.launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_LIB = "fused_leapfrog"


def reference_gaussian_leapfrog(theta, r, prec, m_inv, eps, n_steps: int):
    """The same function in plain PyTorch: a loop of elementwise ops."""
    g = -prec * theta
    th, rr = theta, r
    for _ in range(n_steps):
        rr = rr + 0.5 * eps * g
        th = th + eps * (m_inv * rr)
        g = -prec * th
        rr = rr + 0.5 * eps * g
    pot = 0.5 * torch.sum(prec * th * th, -1)
    kin = 0.5 * torch.sum(m_inv * rr * rr, -1)
    return th, rr, pot, kin


def _kernel(lib):
    fn = lib.fused_leapfrog_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        lib.fused_leapfrog_launch_shape.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.fused_leapfrog_launch_shape.restype = ctypes.c_int
        lib.fused_leapfrog_error_string.argtypes = [ctypes.c_int]
        lib.fused_leapfrog_error_string.restype = ctypes.c_char_p
    return fn


def _raise(lib, what, err):
    raise RuntimeError(f"fused_leapfrog {what} failed: "
                       + lib.fused_leapfrog_error_string(err).decode())


# what `launch_shape` reports: rows a task (E, the elements a lane holds),
# whole chains a row, warps a task, threads a block, blocks
SHAPE_FIELDS = ("rows_per_task", "chains_per_row", "warps_per_task",
                "threads_per_block", "blocks")


def launch_shape(n_chains, dim):
    """The kernel's launch for (n_chains, dim) on the current card, a dict
    of SHAPE_FIELDS."""
    lib = _build.load(_LIB)
    _kernel(lib)
    out = (ctypes.c_int * len(SHAPE_FIELDS))()
    err = lib.fused_leapfrog_launch_shape(n_chains, dim, out)
    if err != 0:
        _raise(lib, "launch shape", err)
    return dict(zip(SHAPE_FIELDS, out))


def _check_inputs(theta, r, prec, m_inv):
    for name, t in (("theta", theta), ("r", r), ("prec", prec),
                    ("m_inv", m_inv)):
        if not t.is_cuda or t.device != theta.device:
            raise ValueError(f"{name} must be on {theta.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if theta.dim() != 2 or r.shape != theta.shape or \
            prec.shape != theta.shape[1:] or m_inv.shape != theta.shape[1:]:
        raise ValueError(f"shapes theta {tuple(theta.shape)}, r "
                         f"{tuple(r.shape)}, prec {tuple(prec.shape)}, m_inv "
                         f"{tuple(m_inv.shape)} do not fit (C, D), (C, D), "
                         "(D,), (D,)")


def fused_gaussian_leapfrog(theta, r, prec, m_inv, eps, n_steps: int):
    """`n_steps` leapfrog steps of every chain: theta, r (C, D); prec, m_inv
    (D,); eps a scalar. Returns (θ′, r′, potential (C,), kinetic (C,))."""
    if theta.device.type == "cpu":
        return reference_gaussian_leapfrog(theta, r, prec, m_inv, eps, n_steps)
    _check_inputs(theta, r, prec, m_inv)
    lib = _build.load(_LIB)
    fn = _kernel(lib)
    c, d = theta.shape
    th_out = torch.empty_like(theta)
    r_out = torch.empty_like(r)
    pot = torch.empty(c, dtype=torch.float32, device=theta.device)
    kin = torch.empty(c, dtype=torch.float32, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    err = fn(theta.data_ptr(), r.data_ptr(), prec.data_ptr(),
             m_inv.data_ptr(), float(eps), int(n_steps), c, d,
             th_out.data_ptr(), r_out.data_ptr(), pot.data_ptr(),
             kin.data_ptr(), stream)
    if err != 0:
        _raise(lib, "kernel launch", err)
    fused_gaussian_leapfrog.launches += 1
    return th_out, r_out, pot, kin


fused_gaussian_leapfrog.launches = 0

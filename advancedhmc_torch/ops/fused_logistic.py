"""K1: one-pass logistic likelihood value and gradient, in CUDA for Hopper.

Replaces the Pallas kernel `advancedhmc_tpu/ops/fused_logistic.py:36`
(`_kernel`; wrapper `fused_logistic_value_grad` :53). For θ (C, dim) with
β = θ[:, 1:] (column 0, the hierarchical log σ, is not in the likelihood),
it returns

    loglik[c] = Σ_j y_j·logit_cj − softplus(logit_cj),   logit = β·xᵀ
    grad[c]   = (0, Σ_j (y_j − σ(logit_cj))·x_j)

The kernel (`csrc/fused_logistic.cu`, its warp tile in
`csrc/logistic_tile.cuh`) runs both products on the tensor cores at float32
accuracy (3xTF32: each operand split into two TF32 parts, three products
summed in float32), so it is bound by 3·4·C·p·n operations at the TF32 rate.
Like the TPU kernel it keeps the (C, n) logits out of device memory: a
block owns 64 chains, streams the observations through shared memory in
tiles of 32 rows and carries the logits in registers from the first product
to the residuals of the second. For small C the rows are split across the
blocks of a cluster, whose partial sums are added in a fixed order: no
atomics, so identical inputs give identical bits. Inputs and sums are
float32 (the TPU kernel's bfloat16 inputs were a TPU default).

The kernel takes any p, as the TPU kernel does. Up to p = 128 a chain's
gradient stays in registers (the narrow instances); a wider p goes to the
wide variant in the same source, which cuts the columns into chunks of 128
and the rows into panels of 128, keeps a panel's logits and residuals in
shared memory between its two products, and sums a chunk's partials across
the cluster in rank order.

`logistic_value_grad` dispatches on the device of θ: a CPU tensor takes the
plain PyTorch version below, a CUDA tensor launches the kernel or raises.
`logistic_value_grad.launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_LIB = "fused_logistic"


def kernel_route(theta):
    """Whether `theta` is the kernel's to compute: a float32 CUDA tensor,
    as the TPU kernel takes any float32 θ, of any width. Callers with
    another path of their own (float64, the CPU) dispatch on this before
    the call."""
    return theta.is_cuda and theta.dtype == torch.float32


def plain_logistic_value_grad(theta, x, y):
    """The same function in plain PyTorch: two matmuls and elementwise ops."""
    logits = theta[:, 1:] @ x.T                                # (C, n)
    loglik = torch.sum(
        y * logits - torch.logaddexp(logits, torch.zeros_like(logits)), -1)
    g = (y - torch.sigmoid(logits)) @ x                        # (C, p)
    return loglik, torch.cat([torch.zeros_like(g[:, :1]), g], 1)


def _kernel(lib):
    fn = lib.fused_logistic_value_grad_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_logistic_smem_bytes.argtypes = [ctypes.c_int]
        lib.fused_logistic_smem_bytes.restype = ctypes.c_size_t
        lib.fused_logistic_launch_shape.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.fused_logistic_launch_shape.restype = None
        lib.fused_logistic_error_string.argtypes = [ctypes.c_int]
        lib.fused_logistic_error_string.restype = ctypes.c_char_p
    return fn


def _check_inputs(theta, x, y):
    for name, t in (("theta", theta), ("x", x), ("y", y)):
        if not t.is_cuda or t.device != theta.device:
            raise ValueError(f"{name} must be on {theta.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, p = x.shape
    if theta.dim() != 2 or theta.shape[1] != p + 1 or y.shape != (n,):
        raise ValueError(f"shapes theta {tuple(theta.shape)}, x {(n, p)}, "
                         f"y {tuple(y.shape)} do not fit (C, p+1), (n, p), "
                         "(n,)")


def logistic_value_grad(theta, x, y):
    """Likelihood part of the hierarchical logistic: `theta (C, dim)`,
    `x (n, dim - 1)`, `y (n,)` → `(loglik (C,), grad (C, dim))`."""
    if theta.device.type == "cpu":
        return plain_logistic_value_grad(theta, x, y)
    _check_inputs(theta, x, y)
    lib = _build.load(_LIB)
    fn = _kernel(lib)
    c, dim = theta.shape
    loglik = torch.empty(c, dtype=torch.float32, device=theta.device)
    grad = torch.empty(c, dim, dtype=torch.float32, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    err = fn(theta.data_ptr(), x.data_ptr(), y.data_ptr(), loglik.data_ptr(),
             grad.data_ptr(), c, dim, x.shape[0], stream)
    if err != 0:
        raise RuntimeError("fused_logistic kernel launch failed: "
                           + lib.fused_logistic_error_string(err).decode())
    logistic_value_grad.launches += 1
    return loglik, grad


logistic_value_grad.launches = 0


def fused_logistic_value_grad(x, y):
    """Build `apply(thetas (C, dim)) -> (loglik (C,), grad (C, dim))` over the
    (n, p) design matrix `x` and (n,) 0/1 responses `y` (dim = p + 1, the
    gradient's component 0 is 0; the caller adds the prior), as the JAX
    function of the same name does. The data stays on its device in its own
    dtype; the kernel is chosen by the device of `thetas` at each call."""
    x = x.contiguous()
    y = y.to(x.dtype).contiguous()

    def apply(thetas):
        return logistic_value_grad(thetas, x, y)

    return apply

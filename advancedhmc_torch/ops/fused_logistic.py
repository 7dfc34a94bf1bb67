"""K1: one-pass logistic likelihood value and gradient, in CUDA for Hopper.

Replaces the Pallas kernel `advancedhmc_tpu/ops/fused_logistic.py:36`
(`_kernel`; wrapper `fused_logistic_value_grad` :53). For θ (C, dim) with
β = θ[:, 1:] (column 0, the hierarchical log σ, is not in the likelihood),
it returns

    loglik[c] = Σ_j y_j·logit_cj − softplus(logit_cj),   logit = β·xᵀ
    grad[c]   = (0, Σ_j (y_j − σ(logit_cj))·x_j)

The kernel (`csrc/fused_logistic.cu`) is bound by the float32 rate of the
CUDA cores: 4·C·p·n flops against (C·(dim + 1) + n·dim) floats moved, some
4000 flops per byte at the sampler's shapes. Like the TPU kernel it keeps
the (C, n) logits out of device memory: a block owns 32 chains, walks the
observations in shared-memory tiles of 64 rows and folds each tile's
residuals into register accumulators of the gradient. Inputs and sums are
float32 (the TPU kernel's bfloat16 inputs were a TPU default).

`logistic_value_grad` dispatches on the device of θ: a CPU tensor takes the
plain PyTorch version below, a CUDA tensor launches the kernel or raises.
`logistic_value_grad.launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_LIB = "fused_logistic"
_MAX_SMEM = 232448          # bytes of shared memory a Hopper block can use


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
    if lib.fused_logistic_smem_bytes(dim) > _MAX_SMEM:
        raise NotImplementedError(
            f"K1 stages whole rows of x in shared memory; dim {dim} exceeds "
            "it (a column-tiled variant is ROADMAP.md section 2 work)")
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

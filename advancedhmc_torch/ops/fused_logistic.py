"""K1: one-pass logistic likelihood value and gradient, in CUDA for Hopper.

Replaces the Pallas kernel `advancedhmc_tpu/ops/fused_logistic.py:36`
(`_kernel`; wrapper `fused_logistic_value_grad` :53). For θ (C, dim) with
β = θ[:, 1:] (column 0, the hierarchical log σ, is not in the likelihood),
it returns

    loglik[c] = Σ_j y_j·logit_cj − softplus(logit_cj),   logit = β·xᵀ
    grad[c]   = (0, Σ_j (y_j − σ(logit_cj))·x_j)

Both products run on the tensor cores at float32 accuracy (3xTF32: each
operand split into two TF32 parts, three products summed in float32), so
the kernels are bound by 3·4·C·p·n operations at the TF32 rate. Inputs and
sums are float32 (the TPU kernel's bfloat16 inputs were a TPU default), and
every sum is taken in a fixed order (no atomics), so identical inputs give
identical bits.

Up to p = 128 a narrow instance (`csrc/fused_logistic.cu`, its warp tile in
`csrc/logistic_tile.cuh`) keeps the (C, n) logits out of device memory, as
the TPU kernel does: a block owns 64 chains, streams the observations
through shared memory and carries the logits in registers from the first
product to the residuals of the second; for small C the rows are split
across a cluster whose partials are added in rank order.

A wider p takes the wide path: both products as pipelined `wgmma` GEMMs in
two launches (stage A's logits, lp partials and residuals; stage B's
gradient and lp). Their B operands, fed by TMA, are the design laid out
once per model by `wide_layout`: x and xᵀ padded to the K tile, with a zero
column for θ's column 0, split into TF32 hi and lo planes, as the JAX
function pads and transposes its design once
(`advancedhmc_tpu/ops/fused_logistic.py:62-70`). Their A operands (θ, the
residuals) stay float32 and are split in registers, after shared memory.
`fused_logistic_value_grad` prepares the design (planes and their TMA
maps, `WideDesign`) at its first CUDA call and again only after x is
written in place; `logistic_value_grad` called with a raw x and no
`design` prepares one for the call.

Modes, the JAX model's reduced-precision switches: MODE_F32 is the above.
MODE_BF16 (`x_dtype="bfloat16"`) rounds θ, x and the residual to bfloat16,
products exact, sums in float32: what the JAX model computes with a bf16
design, and what the Pallas kernel always computes (it casts θ and the
residual to bfloat16). A bfloat16 value is exact in TF32, so the kernels
run one TF32 product where MODE_F32 runs three (no lo passes); the narrow
instances round θ and x where they load them, the wide path's design is
laid out rounded (its lo plane zero). MODE_RESID_BF16 (`resid_dtype=
"bfloat16"` on a float32 design) rounds the residual alone. MODE_F16 and
MODE_RESID_F16 are the same with float16 (`x_dtype`, `resid_dtype`
"float16"): a float16 value has at most 11 significant bits, so TF32
holds it exactly too. On the card a mode runs its own kernel instances;
there is no route to the plain version.

The hierarchical prior (`hierarchical_prior`: log σ ~ N(0, 1), β ~ N(0,
σ² I) at p = dim − 1, at θ's column 0 and the unrounded β) is an option
of every call: with `prior=True` the kernels add its value and gradient
inside the same launches (the narrow instances where they write the
outputs, the wide path's stage A summing Σβ² from the θ tiles it streams
and stage B's epilogue adding the terms), so the hierarchical model's
value+grad on the card is K1 alone. `prior=False`, the default, keeps the
likelihood alone, the Pallas kernel's contract ("the caller adds the
prior").

`logistic_value_grad` dispatches on the device of θ: a CPU tensor takes the
plain PyTorch version below, a CUDA tensor launches the kernels or raises.
On the card, `logistic_value_grad.calls` counts its value+grad calls and
`logistic_value_grad.launches` the kernels they launched, as the library
reports them: one a call up to p = 128, two (the two GEMMs) above, in every
mode; `.bf16_calls` and `.bf16_launches` count those of MODE_BF16 apart,
`.f16_calls` and `.f16_launches` those of MODE_F16. Each launch runs inside
an `ahmc.k1` span (`profiling.span`) that notes its chain count and, as
"prior", the prior's p (0 without it).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .. import profiling
from ..utils import round_to

_LIB = "fused_logistic"
# the modes, numbered as the C interface numbers them (logistic_tile.cuh)
MODE_F32, MODE_BF16, MODE_RESID_BF16, MODE_F16, MODE_RESID_F16 = range(5)
# each mode's (operand dtype, residual dtype): None keeps float32
_ROUNDING = {MODE_F32: (None, None),
             MODE_BF16: (torch.bfloat16, torch.bfloat16),
             MODE_RESID_BF16: (None, torch.bfloat16),
             MODE_F16: (torch.float16, torch.float16),
             MODE_RESID_F16: (None, torch.float16)}


def mode_of(x_dtype, resid_dtype):
    """K1's mode for the model's switches (torch dtypes or None), or None
    where K1 has none: a reduced design rounds the residual to its dtype
    too, as the JAX model casts it to the design's dtype for the
    gradient's product, so a design and a residual in two different
    reduced dtypes (rounded twice) have no mode."""
    if x_dtype is not None and resid_dtype not in (None, x_dtype):
        return None
    for mode, rounding in _ROUNDING.items():
        if rounding == (x_dtype, resid_dtype or x_dtype):
            return mode
    raise ValueError(f"no K1 mode for x_dtype={x_dtype}, "
                     f"resid_dtype={resid_dtype}")


def kernel_route(theta):
    """Whether `theta` is the kernel's to compute: a float32 CUDA tensor,
    as the TPU kernel takes any float32 θ, of any width. Callers with
    another path of their own (float64, the CPU) dispatch on this before
    the call."""
    return theta.is_cuda and theta.dtype == torch.float32


def hierarchical_prior(theta, p):
    """Log prior of θ = (log σ, β₁..β_p) under log σ ~ N(0, 1), β ~ N(0,
    σ² I), and its gradient, batched: `(lp (C,), grad (C, p + 1))`. The
    kernels' `prior` computes the same terms (`prior_of` in
    csrc/fused_logistic.cu)."""
    ls = theta[:, 0]
    beta = theta[:, 1:]
    inv_s2 = torch.exp(-2.0 * ls)
    bsq = torch.sum(beta * beta, -1)
    lp = -0.5 * ls * ls - 0.5 * bsq * inv_s2 - p * ls
    g0 = -ls + bsq * inv_s2 - p
    return lp, torch.cat([g0[:, None], -beta * inv_s2[:, None]], 1)


def plain_logistic_value_grad(theta, x, y, mode=MODE_F32, prior=False):
    """The same function in plain PyTorch: two matmuls and elementwise ops,
    with the mode's operands rounded to bfloat16 or float16 (the products
    of rounded operands are exact in θ's dtype), plus the unrounded θ's
    `hierarchical_prior` where `prior` is on."""
    od, rd = _ROUNDING[mode]
    beta, x = round_to(theta[:, 1:], od), round_to(x, od)
    logits = beta @ x.T                                        # (C, n)
    loglik = torch.sum(
        y * logits - torch.logaddexp(logits, torch.zeros_like(logits)), -1)
    resid = round_to(y - torch.sigmoid(logits), rd)
    g = resid @ x                                              # (C, p)
    grad = torch.cat([torch.zeros_like(g[:, :1]), g], 1)
    if prior:
        lp_pri, g_pri = hierarchical_prior(theta, theta.shape[-1] - 1)
        return lp_pri + loglik, g_pri + grad
    return loglik, grad


def rounding_reference(theta, x, y, mode, logit_slack=2.0 ** -14):
    """The function of `mode` in float64 (its roundings, exact sums), and
    how far a float32 evaluation of it can lie from that through the
    residual's rounding alone. Float32 sums of the logits in another order
    move a logit by far less than `logit_slack`, so a residual y − σ(l) by
    less than `logit_slack`·σ(l)(1 − σ(l)) (and its own float32 rounding);
    where that reaches a bfloat16 rounding midpoint, the residual can round
    to its other neighbour, one step of the mode's residual dtype away
    (bfloat16 or float16), and move the gradient by that step times |x|.
    Returns (loglik, grad, allowance (C, dim), residuals near a midpoint);
    the allowance is zero in MODE_F32 and for every chain with no residual
    near a midpoint."""
    th, x, y = theta.double(), x.double(), y.double()
    lp, g = plain_logistic_value_grad(th, x, y, mode)
    if mode == MODE_F32:
        return lp, g, torch.zeros_like(g), 0
    od, rd = _ROUNDING[mode]
    xr = round_to(x, od)
    sig = torch.sigmoid(round_to(th[:, 1:], od) @ xr.T)
    r = y - sig
    slack = logit_slack * sig * (1.0 - sig) + 2.0 ** -22 * r.abs()
    rb = r.to(rd)
    bits = rb.view(torch.int16)
    near_mid, step = None, None
    for nb in ((bits + 1).view(rd), (bits - 1).view(rd)):
        gap = (nb.double() - rb.double()).abs()
        dist = (r - 0.5 * (nb.double() + rb.double())).abs()
        ok = torch.isfinite(gap) & (dist <= slack)
        near_mid = ok if near_mid is None else near_mid | ok
        add = torch.where(ok, gap, 0.0)
        step = add if step is None else torch.maximum(step, add)
    allowance = step @ xr.abs()
    allowance = torch.cat([torch.zeros_like(allowance[:, :1]), allowance], 1)
    return lp, g, allowance, int(near_mid.sum())


def _kernel(lib):
    fn = lib.fused_logistic_value_grad_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.fused_logistic_smem_bytes.argtypes = [ctypes.c_int]
        lib.fused_logistic_smem_bytes.restype = ctypes.c_size_t
        lib.fused_logistic_launch_shape.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.fused_logistic_launch_shape.restype = None
        lib.fused_logistic_wide_shape.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.fused_logistic_wide_shape.restype = ctypes.c_int
        lib.fused_logistic_wide_design_bytes.argtypes = []
        lib.fused_logistic_wide_design_bytes.restype = ctypes.c_size_t
        lib.fused_logistic_wide_scratch_floats.argtypes = [ctypes.c_int] * 2
        lib.fused_logistic_wide_scratch_floats.restype = ctypes.c_size_t
        lib.fused_logistic_wide_prepare.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 4
        lib.fused_logistic_wide_prepare.restype = ctypes.c_int
        lib.fused_logistic_error_string.argtypes = [ctypes.c_int]
        lib.fused_logistic_error_string.restype = ctypes.c_char_p
    return fn


def _raise(lib, what, err):
    raise RuntimeError(f"fused_logistic {what} failed: "
                       + lib.fused_logistic_error_string(err).decode())


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


# ---- the wide path's design, laid out once per model
# The narrow instances' widest p (8 · kMaxKSteps in csrc/fused_logistic.cu);
# a wider p takes the wide path.
NARROW_MAX_P = 128
# The wide path's K tile (kBK): x and xᵀ are padded to multiples of it.
WIDE_K_TILE = 32


def _round_up(v, to):
    return -(-v // to) * to


def tf32_round(v):
    """float32 `v` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: the bits of `cvt.rna.tf32.f32`, in the integer operations of
    the kernels' `to_tf32`."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def wide_layout(x, mode=MODE_F32):
    """x (n, p) float32 laid out for the wide path: `(planes, t_planes)`.
    `planes` (2, n_pad, k_pad) holds the TF32 part hi and the float32
    remainder lo = x − hi (so hi + lo == x exactly) of [0 | x]: column 0 is
    zero (θ's column 0, log σ, drops out of the logits and gradient), as
    are the rows past n and the columns past dim = p + 1. In MODE_BF16
    (MODE_F16), hi is x rounded to bfloat16 (float16), exact in TF32, and
    lo is zero. `t_planes` (2,
    k_pad, n_pad) is its transpose, the K-major operand of the gradient's
    product. n_pad and k_pad are n (at least 1) and dim rounded up to
    WIDE_K_TILE, so every row is 16-byte aligned for TMA."""
    n, p = x.shape
    padded = x.new_zeros(_round_up(max(n, 1), WIDE_K_TILE),
                         _round_up(p + 1, WIDE_K_TILE))
    padded[:n, 1:p + 1] = x
    od = _ROUNDING[mode][0]
    if od is not None:
        hi = round_to(padded, od)
        planes = torch.stack([hi, torch.zeros_like(hi)])
    else:
        hi = tf32_round(padded)
        planes = torch.stack([hi, padded - hi])
    return planes, planes.transpose(1, 2).contiguous()


class WideDesign:
    """A float32 CUDA design x (n, p), p > NARROW_MAX_P, prepared for the
    wide path in `mode`: the planes of `wide_layout` and their TMA maps,
    which the library encodes once into `maps` (the planes must outlive the
    maps: the object holds both). `WideDesign.builds` counts the designs
    prepared."""

    builds = 0

    def __init__(self, x, mode=MODE_F32):
        lib = _build.load(_LIB)
        _kernel(lib)
        self.n, p = x.shape
        self.dim = p + 1
        self.mode = mode
        self.planes, self.t_planes = wide_layout(x, mode)
        self.maps = ctypes.create_string_buffer(
            lib.fused_logistic_wide_design_bytes())
        err = lib.fused_logistic_wide_prepare(
            ctypes.addressof(self.maps), self.planes.data_ptr(),
            self.t_planes.data_ptr(), self.n, self.dim,
            self.planes.shape[1], self.planes.shape[2])
        if err != 0:
            _raise(lib, "design preparation", err)
        WideDesign.builds += 1


# the fields of fused_logistic_wide_shape, in its order
WIDE_SHAPE_FIELDS = (
    "stage_a_blocks", "stage_a_ranks", "stage_b_blocks", "stage_b_ranks",
    "blocks_per_sm", "smem_bytes_per_block", "threads_per_block",
    "chain_tiles", "stage_a_column_tiles", "stage_b_column_tiles")


def wide_launch_shape(n_chains, dim, n, mode=MODE_F32):
    """The wide path's launches for a call's shape and mode on the current
    card: a dict of WIDE_SHAPE_FIELDS (blocks and split-K ranks a cluster
    of each launch, blocks per SM, shared memory and threads a block,
    tiles)."""
    lib = _build.load(_LIB)
    _kernel(lib)
    out = (ctypes.c_int * len(WIDE_SHAPE_FIELDS))()
    err = lib.fused_logistic_wide_shape(n_chains, dim, n, mode, out)
    if err != 0:
        _raise(lib, "launch shape", err)
    return dict(zip(WIDE_SHAPE_FIELDS, out))


def logistic_value_grad(theta, x, y, design=None, mode=MODE_F32,
                        prior=False):
    """Likelihood part of the hierarchical logistic: `theta (C, dim)`,
    `x (n, dim - 1)`, `y (n,)` → `(loglik (C,), grad (C, dim))`, in `mode`;
    with `prior=True` the whole model's, `hierarchical_prior` at p =
    dim − 1 included. Above p = NARROW_MAX_P a CUDA call takes x's prepared
    `design` (a WideDesign of this x in this mode), prepared here for the
    call when not given. Each call on the card counts one in `.calls` and
    its kernels in `.launches` (and, in MODE_BF16, in `.bf16_calls` and
    `.bf16_launches`; in MODE_F16, in `.f16_calls` and `.f16_launches`)."""
    if theta.device.type == "cpu":
        return plain_logistic_value_grad(theta, x, y, mode, prior)
    _check_inputs(theta, x, y)
    lib = _build.load(_LIB)
    fn = _kernel(lib)
    (c, dim), n = theta.shape, x.shape[0]
    scratch = None
    if dim - 1 > NARROW_MAX_P:
        if design is None:
            design = WideDesign(x, mode)
        if design.mode != mode:
            raise ValueError(f"the design was laid out for mode "
                             f"{design.mode}, the call is in mode {mode}")
        scratch = torch.empty(lib.fused_logistic_wide_scratch_floats(c, n),
                              dtype=torch.float32, device=theta.device)
    loglik = torch.empty(c, dtype=torch.float32, device=theta.device)
    grad = torch.empty(c, dim, dtype=torch.float32, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    launched = ctypes.c_int(0)
    with profiling.span("ahmc.k1"):
        profiling.note("chains", c)
        profiling.note("prior", dim - 1 if prior else 0)
        err = fn(theta.data_ptr(), x.data_ptr(), y.data_ptr(),
                 loglik.data_ptr(), grad.data_ptr(), c, dim, n, mode,
                 int(bool(prior)),
                 None if scratch is None else ctypes.addressof(design.maps),
                 None if scratch is None else scratch.data_ptr(), stream,
                 ctypes.byref(launched))
    if err != 0:
        _raise(lib, "kernel launch", err)
    logistic_value_grad.calls += 1
    logistic_value_grad.launches += launched.value
    if mode == MODE_BF16:
        logistic_value_grad.bf16_calls += 1
        logistic_value_grad.bf16_launches += launched.value
    elif mode == MODE_F16:
        logistic_value_grad.f16_calls += 1
        logistic_value_grad.f16_launches += launched.value
    return loglik, grad


logistic_value_grad.calls = 0
logistic_value_grad.launches = 0
logistic_value_grad.bf16_calls = 0
logistic_value_grad.bf16_launches = 0
logistic_value_grad.f16_calls = 0
logistic_value_grad.f16_launches = 0


def fused_logistic_value_grad(x, y, mode=MODE_F32, prior=False):
    """Build `apply(thetas (C, dim)) -> (loglik (C,), grad (C, dim))` over the
    (n, p) design matrix `x` and (n,) 0/1 responses `y` (dim = p + 1;
    without `prior` the gradient's component 0 is 0 and the caller adds the
    prior, as with the JAX function of the same name; with `prior=True` the
    kernels add `hierarchical_prior`), in `mode`. The data stays on
    its device in its own dtype; the kernel is chosen by the device of
    `thetas` at each call. Above p = NARROW_MAX_P the design is prepared
    for the wide path at the first call on the card (`apply.design`), and
    again only once x has been written in place (its version counter
    moved), so that every route reads the x of the moment."""
    x = x.contiguous()
    y = y.to(x.dtype).contiguous()

    def apply(thetas):
        if (thetas.is_cuda and x.shape[1] > NARROW_MAX_P
                and (apply.design is None or apply.version != x._version)):
            _check_inputs(thetas, x, y)
            apply.design, apply.version = WideDesign(x, mode), x._version
        return logistic_value_grad(thetas, x, y, apply.design, mode, prior)

    apply.design = apply.version = None
    return apply

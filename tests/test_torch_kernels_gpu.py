"""Kernels of the port on the card, against their plain PyTorch versions.

These tests need a CUDA card and skip without one. The module imports no
JAX, so that on the card it runs without the JAX package:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import pytest
import torch

from advancedhmc_torch.models.logistic import _synthetic_data
from advancedhmc_torch.ops import fused_logistic as k1


@pytest.mark.gpu
def test_k1_kernel_matches_plain_on_card():
    """K1 on the card against its plain version (float32, summation order
    differs: 1e-4 of the largest magnitude)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _synthetic_data(1000, 99)
    xt = torch.as_tensor(x, dtype=torch.float32, device="cuda")
    yt = torch.as_tensor(y, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c in (4096, 13, 1):
        th = 0.3 * torch.randn(c, 100, generator=gen, device="cuda")
        before = k1.logistic_value_grad.launches
        lp, g = k1.logistic_value_grad(th, xt, yt)
        assert k1.logistic_value_grad.launches == before + 1
        lp_p, g_p = k1.plain_logistic_value_grad(th, xt, yt)
        torch.cuda.synchronize()
        assert float((g - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())
        assert float((lp - lp_p).abs().max()) <= 1e-4 * float(
            lp_p.abs().max())

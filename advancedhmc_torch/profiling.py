"""Tracing / profiling helpers (counterpart of
`advancedhmc_tpu/profiling.py`).

`trace` times a sampling region, or records it with `torch.profiler` (CPU
and CUDA activities) and writes a Chrome trace; `throughput_report` gives
leapfrog steps/s and ESS/s per device from a `SampleResult`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


def _synchronize():
    """Wait for the work queued on the card: CUDA runs asynchronously, so a
    clock read without it times the launches, not the work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile a sampling region: `with profiling.trace("prof"): ...`
    writes `prof/trace.json` (a Chrome trace: chrome://tracing or
    Perfetto). Without a logdir, just times the region. Prints the
    region's wall either way."""
    _synchronize()
    t0 = time.time()
    if logdir is not None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield prof
            _synchronize()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    else:
        yield None
    _synchronize()
    dt = time.time() - t0
    print(f"[advancedhmc_torch] traced region: {dt:.3f}s"
          + (f" (trace in {logdir})" if logdir else ""))


def throughput_report(result, wall_seconds: float, n_chips: int = 1):
    """Throughput of a SampleResult: leapfrog steps/s/device and
    ESS/s/device (the median bulk ESS over dimensions), the JAX function's
    five keys computed the same way."""
    from .diagnostics import effective_sample_size

    n_steps = result.stats["n_steps"].detach().cpu().numpy().astype(
        np.float64)
    total_leapfrogs = float(n_steps.sum())
    ess = effective_sample_size(result.thetas).detach().cpu().numpy()
    return {
        "leapfrog_steps_per_s_per_chip":
            total_leapfrogs / wall_seconds / n_chips,
        "ess_per_s_per_chip": float(np.median(ess)) / wall_seconds / n_chips,
        "total_leapfrog_steps": total_leapfrogs,
        "median_ess": float(np.median(ess)),
        "wall_seconds": wall_seconds,
    }

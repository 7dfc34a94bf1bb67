"""Tracing / profiling helpers (counterpart of
`advancedhmc_tpu/profiling.py`).

`trace` times a sampling region, or records it with `torch.profiler` (CPU
and CUDA activities) and writes a Chrome trace; `throughput_report` gives
leapfrog steps/s and ESS/s per device from a `SampleResult`.

`span(name)` marks a layer boundary inside the port (names start with
`ahmc.`): the ChEES transition's parts (`chees`), the target's value+grad
and prior (`models.logistic`), the K1 launch (`ops.fused_logistic`) and the
NUTS draw loop (`sampler.fused_draw_phase`, `nuts`). Spans are off by
default; then a span is one test of a module flag and one shared no-op
context. `enable_spans(True)` records each span's name, host clock at
enter and exit (`time.perf_counter_ns`), parent and iteration id in memory,
and `spans()` reads them out. `trace(logdir)` turns them on for its region
and writes them into its Chrome trace, on the device trace's clock
(`trace_events`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"
SPAN_CATEGORY = "ahmc"
_CAPACITY = 1 << 16      # records preallocated, and the step they grow by

_on = False
_records = [None] * _CAPACITY
_count = 0
_open = []               # the open spans, innermost last
_last_iteration = -1
_offset_ns = 0           # time.time_ns() − time.perf_counter_ns()


class _NoSpan:
    """The span handed out while spans are off: shared, does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NO_SPAN = _NoSpan()


class _Span:
    """One recorded span; its own record once closed."""

    __slots__ = ("name", "start", "end", "parent", "iteration", "attrs")

    def __init__(self, name, iteration):
        self.name, self.end, self.attrs = name, None, None
        self.iteration = iteration

    def __enter__(self):
        global _count, _last_iteration
        self.parent = _open[-1] if _open else None
        if self.iteration:
            _last_iteration += 1
            self.iteration = _last_iteration
        else:
            self.iteration = (-1 if self.parent is None
                              else self.parent.iteration)
        if _count == len(_records):
            _records.extend([None] * _CAPACITY)
        _records[_count] = self
        _open.append(self)
        _count += 1
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end = time.perf_counter_ns()
        _open.pop()


def span(name: str, iteration: bool = False):
    """Context manager marking one pass through a layer boundary. With
    `iteration`, the span starts a new iteration id, which every span
    opened inside it shares (other spans take their parent's, or -1).
    While spans are off it returns one shared no-op context."""
    if not _on:
        return _NO_SPAN
    return _Span(name, iteration)


def note(key: str, value) -> None:
    """Attach `key = value` to the innermost open span (a value known only
    once the span is open, such as a transition's step count); nothing
    while spans are off or none is open."""
    if _on and _open:
        rec = _open[-1]
        if rec.attrs is None:
            rec.attrs = {}
        rec.attrs[key] = value


def enable_spans(on: bool = True) -> None:
    """Turn span recording on or off. Turning it on takes the offset from
    the span clock to the wall clock, which places spans on a Chrome
    trace's timeline (`trace_events`)."""
    global _on, _offset_ns
    if on and not _on:
        _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = bool(on)


def spans() -> list:
    """The spans recorded since the last call, in the order they opened,
    and clears them: dicts of `name`, `start_ns` and `end_ns`
    (`time.perf_counter_ns`; `end_ns` None for a span still open),
    `parent` (the index of the enclosing span in this list; None at the
    top, or where the enclosing span was read out before), `iteration` and
    `attrs` (from `note`)."""
    global _records, _count
    recs = _records[:_count]
    index = {id(rec): i for i, rec in enumerate(recs)}
    out = [{"name": rec.name, "start_ns": rec.start, "end_ns": rec.end,
            "parent": (None if rec.parent is None
                       else index.get(id(rec.parent))),
            "iteration": rec.iteration, "attrs": rec.attrs or {}}
           for rec in recs]
    _records, _count = [None] * _CAPACITY, 0
    return out


def trace_ts_us(t_ns: int, base_ns: int) -> float:
    """A span clock reading as a Chrome trace's `ts`: torch's traces give
    the wall clock (CLOCK_REALTIME) in µs less the trace's
    `baseTimeNanoseconds`."""
    return (t_ns + _offset_ns - base_ns) / 1e3


def trace_events(records, base_ns: int) -> list:
    """Closed spans from `spans()` as Chrome trace complete events (`ph`
    "X", `cat` "ahmc", a track of their own in this process), on the clock
    of a trace whose `baseTimeNanoseconds` is `base_ns`; `args` hold the
    span's index, parent, iteration and attributes."""
    pid = os.getpid()
    return [{"ph": "X", "cat": SPAN_CATEGORY, "name": r["name"],
             "pid": pid, "tid": 0,
             "ts": trace_ts_us(r["start_ns"], base_ns),
             "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
             "args": {"index": i, "parent": r["parent"],
                      "iteration": r["iteration"], **r["attrs"]}}
            for i, r in enumerate(records) if r["end_ns"] is not None]


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile a sampling region: `with profiling.trace("prof"): ...`
    writes `prof/trace.json` (a Chrome trace: chrome://tracing or
    Perfetto), with the port's spans as events of category "ahmc": spans
    are on for the region, and at its end every span recorded so far is
    read out (`spans`) into the trace. Without a logdir, just times the
    region. Prints the region's wall either way."""
    from .sampler import _synchronize

    _synchronize()
    t0 = time.time()
    if logdir is not None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        was_on = _on
        enable_spans(True)
        try:
            with profile(activities=activities) as prof:
                yield prof
                _synchronize()
        finally:
            records = spans()
            enable_spans(was_on)
        path = os.path.join(logdir, TRACE_FILE)
        prof.export_chrome_trace(path)
        with open(path) as f:
            chrome = json.load(f)
        chrome["traceEvents"] += trace_events(
            records, int(chrome.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(chrome, f)
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

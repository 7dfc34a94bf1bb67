"""Spans, counters and the device trace that the benchmark records from its
own files, around its calls into the program (on with `--trace 1` only).

- A wrapper on the target's `logdensity_and_grad` counts its calls by
  chain count and opens a `torch.profiler.record_function` span,
  `hmcbench.value_grad`, around each.
- `span(name)` opens a `record_function` span around a call into a layer.
- `stretches(step)` profiles one stretch of the job's steady work twice
  in a row: with CUDA activity only (no CPU-op recording to inflate the
  wall), for the device's busy time and idle share; then with CPU and
  CUDA activity, for the device time of the kernels launched inside the
  value+grad spans and for the breakdown. Each trace is written under the
  temporary directory, read, and deleted.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import tempfile
import time

VALUE_GRAD = "hmcbench.value_grad"
STRETCH = "hmcbench.stretch"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
NAME = 200      # characters of a kernel's name kept in the breakdown


def _events(trace: dict):
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "ts" in e and "dur" in e]


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_busy_s(trace: dict) -> float:
    """Seconds in which a kernel, copy or memset ran on the device: the
    union of their intervals."""
    ivs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in _events(trace) if e.get("cat") in _DEVICE_CATS]
    return sum(e - s for s, e in _union(ivs)) * 1e-6


class _OpenSpans:
    """The innermost benchmark span open at each of a rising sequence of
    times: a sweep over the host's spans, which nest, sorted by start."""

    def __init__(self, spans):
        self.spans, self.next, self.stack = spans, 0, []

    def at(self, t):
        while self.next < len(self.spans) and self.spans[self.next][0] <= t:
            self.stack.append(self.spans[self.next])
            self.next += 1
        while self.stack and self.stack[-1][1] <= t:
            self.stack.pop()
        # a span that closed under one still open is not innermost
        for s, e, name in reversed(self.stack):
            if s <= t < e:
                return name
        return None


def read_cpu_cuda(trace: dict) -> dict:
    """From a CPU+CUDA trace of one stretch: the device seconds of the
    kernels launched inside `hmcbench.value_grad` spans, the device seconds
    of every operation by name, and the device's idle seconds inside the
    stretch by the innermost benchmark span open on the host when each gap
    began."""
    events = _events(trace)
    # by start, the outer of two spans that open together first
    user = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("hmcbench.")),
                  key=lambda s: (s[0], -s[1]))
    vg = [(s, e) for s, e, n in user if n == VALUE_GRAD]
    vg_starts = [s for s, _ in vg]
    inside = set()
    for e in events:
        if e.get("cat") not in _LAUNCH_CATS:
            continue
        t = float(e["ts"])
        i = bisect.bisect_right(vg_starts, t) - 1
        if i >= 0 and t < vg[i][1]:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                inside.add(corr)
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    vg_device_s = sum(float(e["dur"]) for e in device
                      if e.get("args", {}).get("correlation") in inside) * 1e-6
    by_name = collections.Counter()
    for e in device:
        by_name[str(e.get("name", "?"))] += float(e["dur"]) * 1e-6
    idle = collections.Counter()
    outer = [(s, e) for s, e, n in user if n == STRETCH]
    if outer:
        s0, s1 = outer[0]
        t, open_at = s0, _OpenSpans(user)
        for s, e in _union((float(d["ts"]), float(d["ts"]) + float(d["dur"]))
                           for d in device):
            if e <= s0 or s >= s1:
                continue
            if s > t:
                idle[open_at.at(t) or STRETCH] += (s - t) * 1e-6
            t = max(t, e)
        if s1 > t:
            idle[open_at.at(t) or STRETCH] += (s1 - t) * 1e-6
    return {"value_grad_device_s": vg_device_s,
            "value_grad_launches": len(inside),
            "device_ops": [[n[:NAME], s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)]}


def _profiled(activities, step):
    """Run `step` (which ends in a synchronise) under the profiler; returns
    (the Chrome trace as a dict, the host wall of the step)."""
    import torch
    from torch.profiler import profile, record_function

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(STRETCH):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return trace, wall


class Tracer:
    """The benchmark's spans and counters; all of them no-ops when off."""

    def __init__(self, on: bool):
        self.on = on
        self.calls = collections.Counter()   # value+grad calls by chains
        self.stretch = None

    def wrap_target(self, target):
        """`target` with its value+grad calls counted and spanned."""
        if not self.on:
            return target
        from torch.profiler import record_function

        value_and_grad, calls = target.logdensity_and_grad, self.calls

        def counted(theta):
            calls[int(theta.shape[0])] += 1
            with record_function(VALUE_GRAD):
                return value_and_grad(theta)

        return dataclasses.replace(target, logdensity_and_grad=counted)

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(f"hmcbench.{name}")

    def stretches(self, step):
        """Profile `step` (one stretch of steady work, ending in a
        synchronise) once with CUDA activity only and once more with CPU
        and CUDA activity; keeps both readings in `self.stretch`."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity

        trace, wall = _profiled([ProfilerActivity.CUDA], step)
        out = {"busy_s": device_busy_s(trace), "window_s": wall}
        del trace
        before = collections.Counter(self.calls)
        trace, wall = _profiled([ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], step)
        out.update(read_cpu_cuda(trace))
        out["cpu_cuda_window_s"] = wall
        out["value_grad_calls"] = dict(self.calls - before)
        self.stretch = out

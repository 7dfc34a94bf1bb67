"""The program's own spans (`advancedhmc_torch.profiling.span`, names
`ahmc.*`) joined to a device trace of the same stretch of work.

- `program_pass(step)` runs `step` (a stretch of steady work ending in a
  synchronise) under the profiler with CUDA activity only and the
  program's spans on, puts the spans on the trace's clock and joins them.
  A program without spans (no `profiling.enable_spans`) gives None.
- `join(trace, window)` places each kernel, copy or memset on the
  innermost program span open on the host when its launch ran (matched by
  the launch event's `correlation`), and each device idle gap inside the
  window on the innermost program span open when the gap began (`outside`
  where none was). Totals are kept per span name both for the innermost
  span (`self_*`) and for every enclosing span (a name counted once where
  spans of one name nest).
- `readings(rec)` computes, from a run's record whose `stretch` holds the
  joined pass under `program`, the per-layer readings of the program's
  layers: K1's own roofline, the prior's device time a value+grad call,
  the leapfrog updates' roofline, and the shares of `idle_share` that
  begin in the read of n and in the target's value+grad.
"""

from __future__ import annotations

import collections
import time

from hmcbench import roofline
from hmcbench.trace import _DEVICE_CATS, _LAUNCH_CATS, _events, \
    _OpenSpans, _profiled, _union

PREFIX = "ahmc."
CATEGORY = "ahmc"
OUTSIDE = "outside"
K1 = "ahmc.k1"
VALUE_GRAD = "ahmc.target.value_grad"
NUM_STEPS = "ahmc.chees.num_steps"
DRIFT = "ahmc.chees.drift"
KICK = "ahmc.chees.kick"


def span_events(records, offset_ns: int, base_ns: int) -> list:
    """The program's span records (`profiling.spans()`: host clock
    `time.perf_counter_ns`) as Chrome complete events of category "ahmc" on
    a trace's clock: `offset_ns` takes the span clock to the wall clock,
    and a torch trace's `ts` is the wall clock in µs less its
    `baseTimeNanoseconds`."""
    return [{"ph": "X", "cat": CATEGORY, "name": r["name"], "pid": 0,
             "tid": 0, "ts": (r["start_ns"] + offset_ns - base_ns) / 1e3,
             "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
             "args": {"index": i, "parent": r["parent"],
                      "iteration": r["iteration"], **r["attrs"]}}
            for i, r in enumerate(records) if r["end_ns"] is not None]


def _end(e):
    return float(e["ts"]) + float(e["dur"])


def _sweep(spans):
    """A sweep giving the innermost span open at rising times."""
    return _OpenSpans(sorted(((float(e["ts"]), _end(e), e) for e in spans),
                             key=lambda s: (s[0], -s[1])))


def join(trace: dict, window=None) -> dict:
    """Device time and idle time by program span, from a Chrome trace that
    holds the device's operations, their launch events and the program's
    spans (category "ahmc", `args.index` and `args.parent`). `window` is
    the stretch's (start, end) in the trace's µs; by default the extent of
    the spans. Seconds throughout; `calls` counts spans by name and
    `k1_calls` the `ahmc.k1` spans by the chain count they note."""
    events = _events(trace)
    spans = [e for e in events if e.get("cat") == CATEGORY
             and str(e.get("name", "")).startswith(PREFIX)]
    by_index = {e["args"]["index"]: e for e in spans}

    def names(span):
        """The span's name and those of the spans that enclose it, once."""
        out = []
        while span is not None:
            if span["name"] not in out:
                out.append(span["name"])
            span = by_index.get(span["args"].get("parent"))
        return out

    calls = collections.Counter(e["name"] for e in spans)
    k1_calls = collections.Counter(e["args"].get("chains") for e in spans
                                   if e["name"] == K1)
    launches = sorted((float(e["ts"]), e["args"]["correlation"])
                      for e in events if e.get("cat") in _LAUNCH_CATS
                      and "correlation" in e.get("args", {}))
    placed, sweep = {}, _sweep(spans)
    for t, corr in launches:
        placed[corr] = sweep.at(t)
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    self_dev, dev = collections.Counter(), collections.Counter()
    for e in device:
        s = placed.get(e.get("args", {}).get("correlation"))
        dur = float(e["dur"]) * 1e-6
        self_dev[s["name"] if s else OUTSIDE] += dur
        for n in (names(s) if s else [OUTSIDE]):
            dev[n] += dur

    if window is None:
        window = ((min(float(e["ts"]) for e in spans),
                   max(_end(e) for e in spans)) if spans else (0.0, 0.0))
    w0, w1 = window
    gaps, t = [], w0
    for s, e in _union((float(d["ts"]), _end(d)) for d in device):
        if e <= w0 or s >= w1:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    self_idle, idle, sweep = (collections.Counter(), collections.Counter(),
                              _sweep(spans))
    for g0, g1 in gaps:
        s = sweep.at(g0)
        self_idle[s["name"] if s else OUTSIDE] += (g1 - g0) * 1e-6
        for n in (names(s) if s else [OUTSIDE]):
            idle[n] += (g1 - g0) * 1e-6
    return {"calls": dict(calls), "k1_calls": dict(k1_calls),
            "launches": len(launches),
            "device_s": dict(dev), "self_device_s": dict(self_dev),
            "idle_s": dict(idle), "self_idle_s": dict(self_idle),
            "idle_total_s": sum(g1 - g0 for g0, g1 in gaps) * 1e-6,
            "window_trace_s": (w1 - w0) * 1e-6}


def program_pass(step):
    """Run `step` under the profiler with CUDA activity only and the
    program's spans on (off again after); returns `join` of the pass over
    the host's reads of the wall clock around `step`, with the spans'
    count and the pass's wall, or None where the program has no spans."""
    from torch.profiler import ProfilerActivity

    from advancedhmc_torch import profiling

    if not hasattr(profiling, "enable_spans"):
        return None
    wall_ns = []

    def timed():
        wall_ns.append(time.time_ns())
        step()
        wall_ns.append(time.time_ns())

    profiling.spans()
    offset_ns = time.time_ns() - time.perf_counter_ns()
    profiling.enable_spans(True)
    try:
        trace, wall = _profiled([ProfilerActivity.CUDA], timed)
    finally:
        records = profiling.spans()
        profiling.enable_spans(False)
    base = int(trace.get("baseTimeNanoseconds", 0))
    trace["traceEvents"] += span_events(records, offset_ns, base)
    out = join(trace, ((wall_ns[0] - base) / 1e3, (wall_ns[1] - base) / 1e3))
    out.update(spans=len(records), window_s=wall)
    return out


def update_bytes(chains: int, dim: int) -> float:
    """Bytes of one leapfrog step's state updates at the least: θ, r and ∇
    read, θ and r written, float32 (C, D) each."""
    return 5.0 * 4 * chains * dim


def readings(rec) -> dict:
    """The five readings of the joined pass (`rec["stretch"]["program"]`),
    each None where the program recorded nothing to read: a name without
    spans reads None, never 0."""
    from hmcbench.run import HERE, load_module

    st = rec.get("stretch") or {}
    prog, cfg = st.get("program"), rec["config"]
    out = dict.fromkeys(("k1_kernel_roofline", "prior_us_per_call",
                         "update_roofline", "sync_idle_share",
                         "target_idle_share"))
    if not prog:
        return out
    calls, dev = prog["calls"], prog["device_s"]
    if calls.get(K1) and dev.get(K1, 0) > 0:
        least = sum(n * roofline.least_time_s(int(c), cfg["n_rows"],
                                              cfg["n_features"],
                                              cfg["design_dtype"])
                    for c, n in prog["k1_calls"].items())
        out["k1_kernel_roofline"] = 100.0 * least / dev[K1]
    if calls.get(VALUE_GRAD):
        out["prior_us_per_call"] = 1e6 * (dev.get(VALUE_GRAD, 0.0)
                                          - dev.get(K1, 0.0)) \
            / calls[VALUE_GRAD]
    upd = dev.get(DRIFT, 0.0) + dev.get(KICK, 0.0)
    if calls.get(DRIFT) and upd > 0:
        out["update_roofline"] = 100.0 * calls[DRIFT] * update_bytes(
            rec["traffic"]["chains"], cfg["n_features"] + 1) \
            / roofline.PEAK_BYTES_PER_S / upd
    share = load_module(HERE / "metrics" / "idle_share.py").read(rec)
    if share is not None and prog["idle_total_s"] > 0:
        for key, name in (("sync_idle_share", NUM_STEPS),
                          ("target_idle_share", VALUE_GRAD)):
            if calls.get(name):
                out[key] = share * prog["idle_s"].get(name, 0.0) \
                    / prog["idle_total_s"]
    return out

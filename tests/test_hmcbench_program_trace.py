"""The benchmark's join of the program's spans to a device trace
(`hmcbench/program_trace.py`) and the readings it gives, on a hand-built
Chrome trace: kernels go to the span open when they were launched, idle
gaps to the span open when they began, and a name without spans reads
None."""

from __future__ import annotations

import pytest

from hmcbench import program_trace as pt
from hmcbench import roofline

CFG = {"n_rows": 1000, "n_features": 99, "design_dtype": "float32"}
CHAINS = 1024


def _span(index, name, ts, end, parent=None, **attrs):
    return {"ph": "X", "cat": "ahmc", "name": name, "ts": ts,
            "dur": end - ts, "pid": 0, "tid": 0,
            "args": {"index": index, "parent": parent, "iteration": 0,
                     **attrs}}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 0.5, "args": {"correlation": corr}}


def _op(corr, ts, end, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "ts": ts,
            "dur": end - ts, "args": {"correlation": corr}}


def _trace(with_k1=True):
    """One ChEES iteration of the program's spans (µs), its launches and
    the device's operations; the window is (0, 130)."""
    spans = [_span(0, "ahmc.chees.step", 0, 100),
             _span(1, "ahmc.chees.num_steps", 5, 20, 0),
             _span(2, "ahmc.chees.kick", 20, 22, 0),
             _span(3, "ahmc.chees.drift", 22, 25, 0),
             _span(4, "ahmc.target.value_grad", 25, 60, 0),
             _span(5, "ahmc.target.prior", 26, 35, 4),
             _span(6, "ahmc.k1", 36, 40, 4, chains=CHAINS),
             _span(7, "ahmc.chees.kick", 60, 62, 0),
             _span(8, "ahmc.chees.accept", 62, 80, 0)]
    if not with_k1:
        spans = [s for s in spans if s["name"] != "ahmc.k1"]
    launches = [_launch(1, 3), _launch(2, 21), _launch(3, 23),
                _launch(4, 30), _launch(5, 37), _launch(6, 61),
                _launch(7, 90), _launch(8, 120)]
    ops = [_op(1, 4, 6), _op(2, 21, 24), _op(3, 24, 26), _op(4, 30, 32),
           _op(5, 41, 70),                   # K1 runs after its span closed
           _op(6, 70, 72), _op(7, 90, 95, "gpu_memcpy"), _op(8, 121, 125)]
    return {"traceEvents": spans + launches + ops,
            "baseTimeNanoseconds": 0}


def test_kernels_go_to_the_span_of_their_launch():
    j = pt.join(_trace(), (0.0, 130.0))
    us = {k: v * 1e6 for k, v in j["self_device_s"].items()}
    assert us["ahmc.k1"] == pytest.approx(29)      # ran under kick/accept
    assert us["ahmc.chees.kick"] == pytest.approx(5)
    assert us["ahmc.chees.drift"] == pytest.approx(2)
    assert us["ahmc.target.prior"] == pytest.approx(2)
    assert us["ahmc.chees.step"] == pytest.approx(2 + 5)
    assert us[pt.OUTSIDE] == pytest.approx(4)
    inc = {k: v * 1e6 for k, v in j["device_s"].items()}
    assert inc["ahmc.target.value_grad"] == pytest.approx(31)
    assert inc["ahmc.chees.step"] == pytest.approx(45)
    assert j["calls"]["ahmc.chees.kick"] == 2
    assert j["k1_calls"] == {CHAINS: 1}
    assert j["launches"] == 8


def test_idle_gaps_go_to_the_span_open_when_they_began():
    j = pt.join(_trace(), (0.0, 130.0))
    own = {k: v * 1e6 for k, v in j["self_idle_s"].items()}
    assert own == pytest.approx({"ahmc.chees.step": 4 + 26,
                                 "ahmc.chees.num_steps": 15,
                                 "ahmc.target.prior": 4 + 9,
                                 "ahmc.chees.accept": 18, pt.OUTSIDE: 5})
    assert j["idle_s"]["ahmc.target.value_grad"] * 1e6 == pytest.approx(13)
    assert j["idle_total_s"] * 1e6 == pytest.approx(81)
    assert sum(j["self_idle_s"].values()) == pytest.approx(
        j["idle_total_s"])


def _rec(trace, busy=0.8, unprofiled=1.0):
    return {"config": CFG, "traffic": {"chains": CHAINS},
            "stretch_unprofiled_s": unprofiled,
            "stretch": {"busy_s": busy,
                        "program": pt.join(trace, (0.0, 130.0))}}


def test_the_readings():
    r = pt.readings(_rec(_trace()))
    least = roofline.least_time_s(CHAINS, 1000, 99, "float32")
    assert r["k1_kernel_roofline"] == pytest.approx(100 * least / 29e-6)
    assert r["prior_us_per_call"] == pytest.approx(2.0)
    assert r["update_roofline"] == pytest.approx(
        100 * 5 * 4 * CHAINS * 100 / roofline.PEAK_BYTES_PER_S / 7e-6)
    assert r["sync_idle_share"] == pytest.approx(20 * 15 / 81)
    assert r["target_idle_share"] == pytest.approx(20 * 13 / 81)


def test_the_idle_shares_of_every_span_and_outside_sum_to_idle_share():
    rec = _rec(_trace(), busy=0.7)
    prog = rec["stretch"]["program"]
    idle_share = 100 * (1 - 0.7)
    parts = [idle_share * s / prog["idle_total_s"]
             for s in prog["self_idle_s"].values()]
    assert sum(parts) == pytest.approx(idle_share)


def test_no_k1_span_reads_none_not_zero():
    r = pt.readings(_rec(_trace(with_k1=False)))
    assert r["k1_kernel_roofline"] is None
    assert r["prior_us_per_call"] is not None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from advancedhmc_torch import profiling

    monkeypatch.delattr(profiling, "enable_spans")
    assert pt.program_pass(lambda: None) is None
    rec = _rec(_trace())
    rec["stretch"].pop("program")
    assert set(pt.readings(rec).values()) == {None}
    rec.pop("stretch")
    assert set(pt.readings(rec).values()) == {None}


def test_program_records_become_trace_events():
    recs = [{"name": "ahmc.a", "start_ns": 5_000, "end_ns": 9_000,
             "parent": None, "iteration": 0, "attrs": {"n": 3}},
            {"name": "ahmc.b", "start_ns": 6_000, "end_ns": None,
             "parent": 0, "iteration": 0, "attrs": {}}]
    ev = pt.span_events(recs, offset_ns=1_000, base_ns=2_000)
    assert len(ev) == 1                      # the open span is left out
    assert ev[0]["ts"] == pytest.approx(4.0)
    assert ev[0]["dur"] == pytest.approx(4.0)
    assert ev[0]["args"] == {"index": 0, "parent": None, "iteration": 0,
                             "n": 3}

"""The port's span recorder (`advancedhmc_torch.profiling.span`): off by
default at the cost of one flag test, nested records with parents and
iteration ids when on, the spans of one ChEES draw step on the CPU, the
clock that places spans on a torch Chrome trace, and `trace` writing them
into its trace."""

import json
import statistics
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import advancedhmc_torch as ah
from advancedhmc_torch import profiling


@pytest.fixture(autouse=True)
def spans_off():
    profiling.enable_spans(False)
    profiling.spans()
    yield
    profiling.enable_spans(False)
    profiling.spans()


def test_off_records_nothing_and_shares_one_context():
    a, b = profiling.span("ahmc.a"), profiling.span("ahmc.b", iteration=True)
    assert a is b
    with a:
        with profiling.span("ahmc.c"):
            profiling.note("n", 3)
    assert profiling.spans() == []


def test_on_spans_nest_with_parents_and_iterations():
    profiling.enable_spans(True)
    with profiling.span("ahmc.outer"):
        for _ in range(2):
            with profiling.span("ahmc.it", iteration=True):
                with profiling.span("ahmc.leaf"):
                    profiling.note("chains", 8)
                profiling.note("n", 1)
    with profiling.span("ahmc.after"):
        pass
    recs = profiling.spans()
    assert [r["name"] for r in recs] == ["ahmc.outer", "ahmc.it", "ahmc.leaf",
                                         "ahmc.it", "ahmc.leaf", "ahmc.after"]
    assert [r["parent"] for r in recs] == [None, 0, 1, 0, 3, None]
    it = [r["iteration"] for r in recs]
    assert it[0] == it[5] == -1
    assert it[1] == it[2] and it[3] == it[4] and it[3] == it[1] + 1
    assert recs[2]["attrs"] == {"chains": 8} and recs[1]["attrs"] == {"n": 1}
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
    for r in recs[1:5]:
        p = recs[r["parent"]]
        assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
    assert profiling.spans() == []       # read out and cleared


def test_spans_grow_past_the_preallocated_records():
    profiling.enable_spans(True)
    n = profiling._CAPACITY + 5
    for _ in range(n):
        with profiling.span("ahmc.x"):
            pass
    assert len(profiling.spans()) == n


def test_a_chees_draw_step_on_the_cpu():
    target = ah.hierarchical_logistic(n=200, p=9, dtype=torch.float64,
                                      device="cpu")
    c, dim = 16, target.dim
    gen = torch.Generator().manual_seed(0)
    theta = 0.1 * torch.randn(c, dim, generator=gen, dtype=torch.float64)
    lp, grad = target.logdensity_and_grad(theta)
    metric = ah.DiagEuclideanMetric.create(torch.ones(dim,
                                                      dtype=torch.float64))
    carry = (theta, lp, grad, metric,
             torch.tensor(0.05, dtype=torch.float64),
             torch.tensor(0.4, dtype=torch.float64))
    step = ah.make_chees_draw_step(target, 64)
    profiling.enable_spans(True)
    _, (_, st) = step(gen, carry, torch.tensor(0.6, dtype=torch.float64))
    recs = profiling.spans()
    n = int(st["n_steps"][0])
    count = {k: sum(r["name"] == k for r in recs)
             for k in {r["name"] for r in recs}}
    assert n == 5
    assert count["ahmc.chees.step"] == 1
    assert count["ahmc.chees.num_steps"] == 1
    assert count["ahmc.chees.draw_randoms"] == 1
    assert count["ahmc.chees.accept"] == 1
    assert count["ahmc.chees.drift"] == n
    assert count["ahmc.target.value_grad"] == n
    assert count["ahmc.target.prior"] == n
    assert count["ahmc.chees.kick"] == n + 2
    assert "ahmc.k1" not in count            # the CPU route does not reach K1
    top = recs[0]
    assert top["name"] == "ahmc.chees.step" and top["parent"] is None
    assert top["attrs"] == {"n": n} and top["iteration"] >= 0
    assert all(r["iteration"] == top["iteration"] for r in recs)
    assert all(r["parent"] is not None for r in recs[1:])


def test_spans_land_on_the_trace_clock(tmp_path):
    """Each span encloses the record_function marker opened inside it,
    within 100 µs at each end, once its times are converted through the
    trace's baseTimeNanoseconds (a few µs of clock error allowed on the
    enclosing side)."""
    x = torch.ones(1000)
    profiling.enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(12):
            with profiling.span("ahmc.clock"):
                x.sum()
                with record_function(f"marker{i}"):
                    x.sum()
                x.sum()
    recs = profiling.spans()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    chrome = json.loads(path.read_text())
    base = int(chrome["baseTimeNanoseconds"])
    marks = {e["name"]: e for e in chrome["traceEvents"]
             if str(e.get("name", "")).startswith("marker")}
    lead, lag = [], []
    for i, r in enumerate(recs[2:], 2):      # the first two warm up
        m = marks[f"marker{i}"]
        s = profiling.trace_ts_us(r["start_ns"], base)
        e = profiling.trace_ts_us(r["end_ns"], base)
        lead.append(m["ts"] - s)
        lag.append(e - (m["ts"] + m["dur"]))
    assert min(lead) > -20 and min(lag) > -20, (lead, lag)
    assert statistics.median(lead) < 100 and statistics.median(lag) < 100, \
        (lead, lag)


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    target = ah.hierarchical_logistic(n=50, p=4, dtype=torch.float64,
                                      device="cpu")
    theta = torch.zeros(4, target.dim, dtype=torch.float64)
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            target.logdensity_and_grad(theta)
    chrome = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    ours = [e for e in chrome["traceEvents"] if e.get("cat") == "ahmc"]
    names = [e["name"] for e in ours]
    assert names.count("ahmc.target.value_grad") == 3
    assert names.count("ahmc.target.prior") == 3
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ours)
    # the region turned spans on for itself only
    assert profiling.span("ahmc.x") is profiling.span("ahmc.y")
    assert profiling.spans() == []
    # each prior span lies inside its value+grad span
    vg = [e for e in ours if e["name"] == "ahmc.target.value_grad"]
    for e in ours:
        if e["name"] == "ahmc.target.prior":
            p = ours[[o["args"]["index"] for o in ours].index(
                e["args"]["parent"])]
            assert p in vg
            assert p["ts"] <= e["ts"] + 1e-3
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3


def test_spans_off_cost_little():
    """While off, a span is one flag test and a shared context: well under
    a few microseconds on any host (a ChEES draw step opens about 40)."""
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("ahmc.x"):
            pass
    per = (time.perf_counter() - t0) / n
    assert per < 5e-6, per


def test_read_out_inside_an_open_span():
    profiling.enable_spans(True)
    with profiling.span("ahmc.outer", iteration=True):
        with profiling.span("ahmc.first"):
            pass
        first = profiling.spans()
        with profiling.span("ahmc.second"):
            pass
    second = profiling.spans()
    assert [r["name"] for r in first] == ["ahmc.outer", "ahmc.first"]
    assert first[0]["end_ns"] is None and first[1]["parent"] == 0
    assert [r["name"] for r in second] == ["ahmc.second"]
    assert second[0]["parent"] is None
    assert second[0]["iteration"] == first[0]["iteration"]


@pytest.mark.gpu
@pytest.mark.parametrize("p", [99, 999])
def test_k1_kernels_land_on_k1_spans_on_the_card(p):
    """On the card, under a CUDA-activity-only trace, the spans put on the
    trace's clock hold every K1 launch: all of K1's kernel time is placed
    on `ahmc.k1`, one span a call, narrow and wide; the centred model's
    value+grad launches nothing else (K1 computes its prior)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hmcbench import program_trace
    from advancedhmc_torch.ops.fused_logistic import logistic_value_grad

    target = ah.hierarchical_logistic(n=1000, p=p, device="cuda")
    theta = 0.1 * torch.randn(4096, p + 1, device="cuda")
    target.logdensity_and_grad(theta)           # build and lay out once
    torch.cuda.synchronize()
    calls = logistic_value_grad.calls

    def step():
        for _ in range(8):
            target.logdensity_and_grad(theta)
        torch.cuda.synchronize()

    j = program_trace.program_pass(step)
    assert logistic_value_grad.calls - calls == 8
    assert j["calls"]["ahmc.k1"] == 8 == j["k1_calls"][4096]
    assert j["launches"] > 0
    k1 = j["self_device_s"]["ahmc.k1"]
    # value+grad launches K1 alone, so its device time is K1's; a K1 launch
    # put outside its span by a clock error would land on value+grad's own
    # time or outside every span
    assert k1 > 0
    assert j["device_s"]["ahmc.target.value_grad"] == pytest.approx(k1)
    assert j["self_device_s"].get("ahmc.target.value_grad", 0.0) == 0.0
    assert j["self_device_s"].get(program_trace.OUTSIDE, 0.0) < 0.1 * k1


@pytest.mark.gpu
def test_lgcp_k1_kernels_land_on_poisson_k1_spans_on_the_card():
    """The log-Gaussian Cox process's K1 kernels (the wide path at 4096
    cells) land on `ahmc.k1` spans, one a value+grad, each noting the
    Poisson link; the non-centred chain rule's few operations around it
    take less device time than K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hmcbench import program_trace

    target = ah.log_gaussian_cox(side=64, device="cuda")
    theta = 0.1 * torch.randn(2048, target.dim, device="cuda")
    target.logdensity_and_grad(theta)           # build and lay out once
    torch.cuda.synchronize()
    profiling.enable_spans(True)
    try:
        target.logdensity_and_grad(theta)
        notes = [r["attrs"] for r in profiling.spans()
                 if r["name"] == "ahmc.k1"]
    finally:
        profiling.enable_spans(False)
    assert notes == [{"chains": 2048, "prior": 0, "link": "poisson"}]

    def step():
        for _ in range(4):
            target.logdensity_and_grad(theta)
        torch.cuda.synchronize()

    j = program_trace.program_pass(step)
    assert j["calls"]["ahmc.k1"] == 4 == j["k1_calls"][2048]
    k1 = j["self_device_s"]["ahmc.k1"]
    assert k1 > 0
    assert j["device_s"]["ahmc.target.value_grad"] - k1 < k1
    assert j["self_device_s"].get(program_trace.OUTSIDE, 0.0) < 0.1 * k1

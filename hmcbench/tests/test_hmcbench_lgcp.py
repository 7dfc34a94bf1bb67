"""The cell lgcp64.chees at a tiny size on the CPU (a 6 × 6 grid, 64 chains),
past the harness's look for a card: sound, it passes the comparison; in
the configuration's bfloat16 control, or with the model's answer altered
where it is produced, `grad_gap` fails. And the arithmetic of
`cox_k1_roofline` at a shape worked by hand."""

from __future__ import annotations

import dataclasses

import pytest

import advancedhmc_torch as ah
from hmcbench import roofline_cox, run

CELL = "lgcp64.chees"
SIDE = 6
TINY_CONFIG = {"n_rows": SIDE * SIDE, "n_features": SIDE * SIDE,
               "program_args": {"side": SIDE, "seed": 0}}
TINY_TRAFFIC = {"chains": 64, "n_warmup": 64, "chunk": 64, "ess_chains": 32,
                "init_buffer": 18, "term_buffer": 12, "window_size": 6}
SEED = 2 ** 31 + 17
# at this size a few chains can sit still through the window's few dozen
# draws; half of the chains left out reads 0.5
TINY_STUCK_LIMIT = 0.25


def _run(control=False):
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    limits = {**run.Cell.find(bench, CELL).traffic["limits"],
              "stuck_share": TINY_STUCK_LIMIT}
    return run.run_cell(bench, CELL, SEED, 0.0, False, device="cpu",
                        control=control, log=lambda *a, **k: None,
                        overrides={"config": TINY_CONFIG,
                                   "traffic": {**TINY_TRAFFIC,
                                               "limits": limits}})


def _fails(out, name):
    c = out["checks"][name]
    return not c["value"] <= c["limit"]


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_bfloat16_control_fails_grad_gap():
    out = _run(control=True)
    assert not out["correct"]
    assert _fails(out, "grad_gap"), out["checks"]


def test_altered_answer_fails_grad_gap(monkeypatch):
    real = ah.log_gaussian_cox

    def log_gaussian_cox(*a, **kw):
        target = real(*a, **kw)
        vg = target.logdensity_and_grad

        def altered(theta):
            lp, g = vg(theta)
            return lp, g * 1.01
        return dataclasses.replace(target, logdensity_and_grad=altered)

    monkeypatch.setattr(ah, "log_gaussian_cox", log_gaussian_cox)
    out = _run()
    assert not out["correct"]
    assert _fails(out, "grad_gap"), out["checks"]


def test_cox_roofline_arithmetic_on_a_hand_worked_shape():
    """2 chains over 3 cells: the triangle's 6 entries, two products of
    2·C·6 FLOPs each; bytes 6·4 + y 12 + θ 2·4·4 in, ∇ 2·4·4 and ℓ 2·4
    out."""
    assert roofline_cox.value_grad_flops(2, 3) == 48
    assert roofline_cox.value_grad_bytes(2, 3) == 24 + 12 + 32 + 32 + 8
    assert roofline_cox.value_grad_bytes(2, 3, "bfloat16") == 12 + 84
    # the cell's shape is bound by its FLOPs at the TF32 peak
    c, n = 2048, 4096
    assert roofline_cox.least_time_s(c, n) == pytest.approx(
        2 * c * n * (n + 1) / 495e12)
    # one chain is bound by the factor's bytes
    assert roofline_cox.least_time_s(1, n) == pytest.approx(
        roofline_cox.value_grad_bytes(1, n) / 3.35e12)
    reader = run.load_module(run.ROOT / "hmcbench" / "metrics"
                             / "cox_k1_roofline.py")
    assert reader.read({"stretch": None, "config": {}}) is None
    rec = {"config": {"n_rows": n, "design_dtype": "float32"},
           "stretch": {"value_grad_device_s": 0.01,
                       "value_grad_calls": {c: 5, 1: 2}}}
    least = 5 * roofline_cox.least_time_s(c, n) + 2 * \
        roofline_cox.least_time_s(1, n)
    assert reader.read(rec) == pytest.approx(100 * least / 0.01)

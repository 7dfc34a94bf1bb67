"""The harness's own pieces on the CPU: discovery by name, the reference
against the program's float64 route, the frozen ESS, the roofline
arithmetic, the trace reader and the check for JAX."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hmcbench import roofline, run, trace
from hmcbench.reference import ess
from hmcbench.reference.hierarchical_logistic import Reference, \
    synthetic_data

HMCBENCH = Path(run.__file__).resolve().parent


def _bench():
    return run.load_json(run.ROOT / "BENCHMARK.json")


# ------------------------------------------------------------ discovery
def test_every_cell_config_job_and_metric_has_its_file():
    bench = _bench()
    for w in bench["workloads"]:
        cell = run.Cell.find(bench, w["name"])
        assert (HMCBENCH / "jobs" / f"{cell.traffic['job']}.py").is_file()
        assert (HMCBENCH / "reference"
                / f"{cell.config['model']}.py").is_file()
        for m in cell.end_to_end + cell.per_layer:
            assert callable(run.load_module(
                HMCBENCH / "metrics" / f"{m['name']}.py").read)
    for c in bench["configs"]:
        assert (run.ROOT / c["file"]).is_file()


def test_new_config_cell_and_metric_files_are_found_without_an_edit(
        tmp_path):
    (tmp_path / "hmcbench" / "configs").mkdir(parents=True)
    (tmp_path / "hmcbench" / "workloads").mkdir()
    (tmp_path / "hmcbench" / "metrics").mkdir()
    (tmp_path / "hmcbench" / "configs" / "new.json").write_text(
        json.dumps({"model": "m", "n_rows": 3}))
    (tmp_path / "hmcbench" / "workloads" / "new.job.json").write_text(
        json.dumps({"job": "chees", "chains": 8}))
    (tmp_path / "hmcbench" / "metrics" / "twice.draws.py").write_text(
        "def read(rec):\n    return 2 * rec['draws']\n")
    bench = {"workloads": [{"name": "new.job", "config": "new"}],
             "end_to_end": [{"name": "setup_s"},
                            {"name": "only_elsewhere",
                             "workloads": ["other"]}],
             "per_layer": [{"name": "twice.draws",
                            "workloads": ["new.job"]}]}
    cell = run.Cell.find(bench, "new.job", tmp_path)
    assert cell.config["n_rows"] == 3 and cell.traffic["chains"] == 8
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    reader = run.load_module(tmp_path / "hmcbench" / "metrics"
                             / "twice.draws.py")
    assert reader.read({"draws": 5}) == 10
    with pytest.raises(KeyError):
        run.Cell.find(bench, "missing", tmp_path)


def test_metric_readers_return_nothing_where_nothing_was_read():
    rec = {"stretch": None, "config": {}}
    for name in ("k1_roofline", "idle_share"):
        assert run.load_module(
            HMCBENCH / "metrics" / f"{name}.py").read(rec) is None


# ------------------------------------------------------------ reference
def test_reference_data_is_the_programs_synthetic_data():
    from advancedhmc_torch.models.logistic import _synthetic_data

    for n, p in ((50, 4), (1000, 99)):
        x, y = synthetic_data(n, p, 0)
        x2, y2 = _synthetic_data(n, p, 0)
        assert np.array_equal(x, x2) and np.array_equal(y, y2)


def test_reference_matches_the_programs_float64_route():
    import advancedhmc_torch as ah

    cfg = {"n_rows": 60, "n_features": 7, "data_seed": 0}
    target = ah.hierarchical_logistic(n=60, p=7, seed=0,
                                      dtype=torch.float64, device="cpu")
    theta = torch.as_tensor(np.random.default_rng(1).normal(
        size=(33, 8)) * 0.3)
    lp, g = target.logdensity_and_grad(theta)
    ref = Reference(cfg, "cpu", block=5)
    lp_r, g_r = ref.value_and_grad(theta)
    assert torch.allclose(lp, lp_r, rtol=1e-12, atol=1e-10)
    assert torch.allclose(g, g_r, rtol=1e-12, atol=1e-10)
    # the gradient is the derivative of the value
    t = theta[:1].clone().requires_grad_(True)
    lp_t, = ref.value_and_grad(t)[0]
    lp_t.backward()
    assert torch.allclose(t.grad[0], g_r[0], rtol=1e-9, atol=1e-9)


def test_frozen_ess_is_the_programs_over_any_parameter_blocks():
    from advancedhmc_torch.diagnostics import effective_sample_size

    x = torch.as_tensor(np.random.default_rng(2).normal(size=(64, 6, 5)))
    x = torch.cumsum(x, 0) * 0.1 + x     # autocorrelated
    want = effective_sample_size(x)
    for max_bytes in (1.0, 1e12):
        got = ess.effective_sample_size(x, max_bytes=max_bytes)
        assert torch.allclose(got, want, rtol=1e-12)


def test_stein_identities_hold_for_exact_draws_and_fail_for_shifted():
    from hmcbench.reference.check import _stein_z

    class Gauss:
        def value_and_grad(self, theta):
            th = theta.to(torch.float64)
            return -0.5 * (th * th).sum(1), -th

    draws = torch.as_tensor(np.random.default_rng(3).normal(
        size=(200, 16, 3)), dtype=torch.float32)
    z_mean, z_scale = _stein_z(Gauss(), draws)
    assert z_mean < 5 and z_scale < 5
    assert _stein_z(Gauss(), draws + 0.3)[0] > 10
    assert _stein_z(Gauss(), draws * 1.3)[1] > 10


def test_chees_jobs_halton_points_are_the_programs():
    import advancedhmc_torch as ah

    halton = run.load_module(HMCBENCH / "jobs" / "chees.py").halton
    want = ah.halton_sequence(300)
    assert np.array_equal(halton(0, 300), want)
    assert np.array_equal(halton(256, 300), want[256:])


# ------------------------------------------------------------ roofline
def test_roofline_arithmetic_on_hand_computed_shapes():
    # one chain, 10 rows, 3 features: 4·1·10·3 FLOPs; bytes: design 120,
    # y 40, θ 16 in, ∇ 16 and ℓ 4 out
    assert roofline.value_grad_flops(1, 10, 3) == 120
    assert roofline.value_grad_bytes(1, 10, 3) == 120 + 40 + 16 + 16 + 4
    assert roofline.value_grad_bytes(1, 10, 3, "bfloat16") == 60 + 40 + 36
    # 32768 chains × 1000 rows × 99 features: compute-bound on TF32
    c, n, p = 32768, 1000, 99
    flops = 4 * c * n * p
    bytes_ = 4 * n * p + 4 * n + 4 * c * 100 * 2 + 4 * c
    assert roofline.least_time_s(c, n, p) == pytest.approx(
        max(flops / 495e12, bytes_ / 3.35e12))
    assert roofline.least_time_s(c, n, p) == pytest.approx(flops / 495e12)
    # one chain: the design's bytes bound it
    assert roofline.least_time_s(1, n, p) == pytest.approx(
        roofline.value_grad_bytes(1, n, p) / 3.35e12)


# ------------------------------------------------------------ trace
def test_trace_reader_on_a_hand_made_trace():
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("user_annotation", trace.STRETCH, 0, 100),
        x("user_annotation", "hmcbench.draw_call", 1, 99),
        x("user_annotation", trace.VALUE_GRAD, 10, 10),
        x("cuda_runtime", "cudaLaunchKernel", 12, 1, 1),
        x("cuda_runtime", "cudaLaunchKernel", 30, 1, 2),
        x("kernel", "k1", 20, 30, 1),
        x("kernel", "axpy", 40, 20, 2),
        x("gpu_memcpy", "copy", 90, 5, 3),
    ]
    out = trace.read_cpu_cuda({"traceEvents": events})
    assert out["value_grad_device_s"] == pytest.approx(30e-6)
    assert out["value_grad_launches"] == 1
    assert out["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    # idle: 0–20 (begun while the stretch alone was open), 60–90 and
    # 95–100 (begun in the draw call, the value+grad span closed at 20)
    idle = dict(out["idle_gaps"])
    assert idle["hmcbench.draw_call"] == pytest.approx(35e-6)
    assert idle[trace.STRETCH] == pytest.approx(20e-6)
    assert trace.device_busy_s({"traceEvents": events}) == pytest.approx(
        45e-6)


# ------------------------------------------------------------ no JAX
def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules({"advancedhmc_torch": 1,
                                  "advancedhmc_torch.ops": 1,
                                  "jaxtyping": 1, "flaxen": 1}) == []
    assert run.forbidden_modules({"advancedhmc_tpu.sampler": 1,
                                  "jax.numpy": 1, "jaxlib": 1,
                                  "flax.linen": 1}) == [
        "advancedhmc_tpu", "flax", "jax", "jaxlib"]


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in HMCBENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (HMCBENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                for mod in mods:
                    assert not (mod or "").startswith("advancedhmc"), path


@pytest.mark.gpu
def test_a_short_cell_runs_correct_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(_bench(), "hlr100.chees", 7, 1.0, False,
                       log=lambda *a, **k: None,
                       overrides={"traffic": {"chunk": 16}})
    assert out["device"]["platform"] == "gpu"
    for name in ("lp_gap", "grad_gap", "stuck_share"):
        c = out["checks"][name]
        assert c["value"] <= c["limit"], out["checks"]

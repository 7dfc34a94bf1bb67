"""The port's profiling helpers (`advancedhmc_torch.profiling`) against
the JAX package's: `throughput_report` on the same draws and step counts
to 1e-12, and `trace` timing a region or writing a Chrome trace of it."""

import json
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from advancedhmc_tpu import profiling as prof_j

import advancedhmc_torch as ah
from advancedhmc_torch import profiling as prof_t


@pytest.mark.parametrize("n_chips", [1, 4])
def test_throughput_report_matches_jax(n_chips):
    rng = np.random.default_rng(0)
    th = np.cumsum(rng.normal(size=(200, 6, 5)), 0) * 0.1 + rng.normal(
        size=(200, 6, 5))
    n_steps = rng.integers(1, 64, size=(200, 6)).astype(np.int32)
    res_j = types.SimpleNamespace(thetas=jnp.asarray(th),
                                  stats={"n_steps": jnp.asarray(n_steps)})
    res_t = ah.SampleResult(thetas=torch.as_tensor(th),
                            stats={"n_steps": torch.as_tensor(n_steps)},
                            warmup_stats=None, final_state=None)
    rep_j = prof_j.throughput_report(res_j, 2.5, n_chips)
    rep_t = prof_t.throughput_report(res_t, 2.5, n_chips)
    assert set(rep_t) == set(rep_j)
    for k, v in rep_j.items():
        np.testing.assert_allclose(rep_t[k], float(v), rtol=1e-12,
                                   err_msg=k)
    assert rep_t["total_leapfrog_steps"] == float(n_steps.sum())


def test_trace_times_a_region(capsys):
    with prof_t.trace() as p:
        torch.ones(8).sum()
    assert p is None
    out = capsys.readouterr().out
    assert out.startswith("[advancedhmc_torch] traced region: ")
    assert "trace in" not in out


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    logdir = tmp_path / "prof"
    a = torch.randn(64, 64)
    with prof_t.trace(str(logdir)):
        (a @ a).sum()
    out = capsys.readouterr().out
    assert f"(trace in {logdir})" in out
    events = json.loads((logdir / prof_t.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::mm" in names

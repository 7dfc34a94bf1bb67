"""A whole run of each cell at a tiny size on the CPU, past the harness's look
for a card: sound, it passes the comparison; with the timed path broken
underneath (a step that returns its state unchanged, half of the chains
left out, the value+grad's answer altered where it is produced, M⁻¹ left
out of the leapfrog's position update, the kinetic energy mis-scaled) or in
the configuration's lower-precision control (the design in bfloat16),
`correct` comes out false. The planted faults run at each cell's own size
on the card too."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import advancedhmc_torch as ah
from hmcbench import run

TINY_CONFIG = {"n_rows": 60, "n_features": 4,
               "program_args": {"n": 60, "p": 4, "seed": 0}}
# Stan's windows cut to the tiny warmup, so that M⁻¹ is adapted
TINY_WINDOWS = {"init_buffer": 18, "term_buffer": 12, "window_size": 6}
TINY_TRAFFIC = {
    "hlr100.chees": {"chains": 64, "n_warmup": 64, "chunk": 64,
                     "ess_chains": 32, **TINY_WINDOWS},
    "hlr1000.chees": {"chains": 64, "n_warmup": 64, "chunk": 64,
                      "ess_chains": 32, **TINY_WINDOWS},
}
CHEES_CELLS = ("hlr100.chees", "hlr1000.chees")
SEED = 2 ** 31 + 11
# At this size a chain in the funnel of log σ can sit still for the few
# dozen draws of the window (a sound run reads up to 0.07 here); half of
# the chains left out reads 0.5, a frozen state 1.
TINY_STUCK_LIMIT = 0.25
GAPS = ("lp_gap", "grad_gap", "leapfrog_gap", "energy_gap",
        "select_gap")


def _bench():
    return run.load_json(run.ROOT / "BENCHMARK.json")


def _run(cell, control=False):
    bench = _bench()
    limits = {**run.Cell.find(bench, cell).traffic["limits"],
              "stuck_share": TINY_STUCK_LIMIT}
    return run.run_cell(bench, cell, SEED, 0.0, False, device="cpu",
                        control=control, log=lambda *a, **k: None,
                        overrides={"config": TINY_CONFIG,
                                   "traffic": {**TINY_TRAFFIC[cell],
                                               "limits": limits}})



def _value(out, name):
    return out["checks"][name]["value"]


def _fails(out, name):
    c = out["checks"][name]
    return not c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CHEES_CELLS)
def test_sound_run_passes_the_gaps_and_moves_every_chain(cell):
    out = _run(cell)
    assert out["device"]["platform"] == "cpu"
    for name in GAPS:
        assert not _fails(out, name), out["checks"]
    assert not _fails(out, "stuck_share"), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CHEES_CELLS)
def test_bfloat16_control_fails(cell):
    out = _run(cell, control=True)
    assert not out["correct"]
    assert _fails(out, "grad_gap"), out["checks"]


def _frozen_chees(real):
    def make_chees_draw_step(target, max_steps):
        step = real(target, max_steps)

        def frozen(gen, carry, u):
            _, (_, st) = step(gen, carry, u)
            return carry, (carry[0], st)
        return frozen
    return make_chees_draw_step


def _half_chees(real):
    def make_chees_draw_step(target, max_steps):
        step = real(target, max_steps)

        def half(gen, carry, u):
            new, (_, st) = step(gen, carry, u)
            left = torch.arange(carry[0].shape[0]) % 2 == 1
            mixed = tuple(torch.where(left.view(-1, *([1] * (a.dim() - 1))),
                                      b, a)
                          for a, b in zip(new[:3], carry[:3]))
            return mixed + tuple(new[3:]), (mixed[0], st)
        return half
    return make_chees_draw_step


def _altered(real):
    def hierarchical_logistic(*a, **kw):
        target = real(*a, **kw)
        vg = target.logdensity_and_grad

        def altered(theta):
            lp, g = vg(theta)
            return lp, g * 1.01
        return dataclasses.replace(target, logdensity_and_grad=altered)
    return hierarchical_logistic


def _faulty_metric(metric, **methods):
    """`metric` as an instance of a subclass with `methods` replaced."""
    cls = type("Faulty" + type(metric).__name__, (type(metric),), methods)
    return cls(**{f.name: getattr(metric, f.name)
                  for f in dataclasses.fields(metric)})


def _metric_fault(**methods):
    """A breaker of `make_chees_draw_step` whose steps integrate with the
    carried metric's `methods` replaced (the carry keeps the sound one)."""
    def breaker(real):
        def make_chees_draw_step(target, max_steps):
            step = real(target, max_steps)

            def faulty(gen, carry, u):
                metric = carry[3]
                new, out = step(gen, carry[:3] + (_faulty_metric(
                    metric, **methods),) + carry[4:], u)
                return new[:3] + (metric,) + new[4:], out
            return faulty
        return make_chees_draw_step
    return breaker


def _velocity_without_m_inv(self, r):
    return r


def _kinetic_mis_scaled(self, r):
    return 0.9 * (-0.5) * torch.sum(r * r * self.m_inv, -1)


# the integrator's faults, planted in the draw step of a ChEES cell
INTEGRATOR_FAULTS = {
    "M⁻¹ left out of the position update": (
        _metric_fault(velocity=_velocity_without_m_inv), "leapfrog_gap"),
    "kinetic energy mis-scaled": (
        _metric_fault(neg_kinetic_energy=_kinetic_mis_scaled),
        "energy_gap"),
}

FAULTS = {}
for _cell in CHEES_CELLS:
    FAULTS.update({
        (_cell, "state unchanged"): ("make_chees_draw_step", _frozen_chees,
                                     "stuck_share"),
        (_cell, "half the chains left out"): (
            "make_chees_draw_step", _half_chees, "stuck_share"),
        (_cell, "answer altered"): ("hierarchical_logistic", _altered,
                                    "grad_gap"),
        **{(_cell, name): ("make_chees_draw_step", breaker, number)
           for name, (breaker, number) in INTEGRATOR_FAULTS.items()}})


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    attr, breaker, number = FAULTS[cell, fault]
    monkeypatch.setattr(ah, attr, breaker(getattr(ah, attr)))
    out = _run(cell)
    assert not out["correct"]
    assert _fails(out, number), out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CHEES_CELLS)
@pytest.mark.parametrize("fault", sorted(INTEGRATOR_FAULTS))
def test_integrator_fault_at_the_cells_size_is_not_correct_on_card(
        monkeypatch, capsys, cell, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    breaker, number = INTEGRATOR_FAULTS[fault]
    monkeypatch.setattr(ah, "make_chees_draw_step",
                        breaker(ah.make_chees_draw_step))
    logs = []
    out = run.run_cell(_bench(), cell, SEED, 1.0, False,
                       log=lambda *a, **k: logs.append(a[0]))
    with capsys.disabled():
        print(f"\n{cell} / {fault}: {out['checks']}\n{logs[0]}")
    assert not out["correct"]
    assert _fails(out, number), out["checks"]

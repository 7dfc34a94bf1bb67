"""Collection modes kept beside the main draw path.

PyTorch counterpart of `advancedhmc_tpu/experimental.py`.
`fused_draw_phase_ragged` collects a variable number of draws a chain in
one fused call (`nuts_transitions_fused`'s ragged mode): every chain
completes at least `t_min` transitions, and a chain that gets there early
keeps sampling, up to `t_max`, where the rectangular loop would idle it.
The JAX package measured it slower than the rectangular default on its
TPU; the port keeps it for its own measurement.

`Experimental` holds the JAX package's layout knobs of the fused loop
(`out_dtype`, `stage_slots`, `pack_carry`), which `fused_draw_phase` takes
(`experimental=`): see `nuts_transitions_fused` for what each does in the
port: `stage_slots` and `pack_carry` are taken with JAX's checks and
change nothing. None changes a value, but `out_dtype` rounds the draws.
"""

from __future__ import annotations

import dataclasses

from .hamiltonian import FullMomentumRefreshment, Hamiltonian
from .metrics import DenseEuclideanMetric, DiagEuclideanMetric, \
    UnitEuclideanMetric
from .nuts import nuts_transitions_fused
from .termination import DynamicTerminationCriterion


@dataclasses.dataclass(frozen=True)
class Experimental:
    """Opt-in layout knobs of `fused_draw_phase` (see the module doc).
    Combinations that would shadow each other raise in
    `nuts_transitions_fused` (pack_carry with stage_slots)."""

    out_dtype: object = None
    stage_slots: int = 0
    pack_carry: str = ""


def fused_draw_phase_ragged(generator, spec, state, t_max: int, t_min: int,
                            out_dtype=None):
    """One fused call collecting a variable number of draws a chain (the
    draw phase: ε and M⁻¹ frozen, shared or each chain's own).

    Every chain completes at least `t_min` transitions; a chain that gets
    there early keeps sampling, up to `t_max`. The call lasts as long as a
    rectangular `t_min`-transition call (the slowest chain sets it), and
    the time the rectangular loop's early chains would idle becomes extra
    draws.

    Returns (state, thetas (C, t_max, dim), counts (C,), stats): chain c's
    draws are rows [0, counts[c]), and each stat is (C, t_max), zero past
    the count. Pool statistics weighted by `counts` (a chain's count
    follows the size of its trees, so the raw buffer over-weights the
    regions of small trees); `diagnostics.effective_sample_size_ragged` is
    the matching ESS. The state resumes each chain from its last completed
    draw, and its `iteration` advances by `t_min`. `out_dtype` stores the
    draw buffer in that dtype (the draws come back rounded through it).
    """
    per_chain = not spec.cross_chain
    if not 1 <= t_min < t_max:
        raise ValueError("need 1 <= t_min < t_max")
    if not isinstance(spec.kernel.refreshment, FullMomentumRefreshment):
        raise ValueError("variable-draws collection requires full momentum "
                         "refreshment")
    if not isinstance(spec.kernel.trajectory.criterion,
                      DynamicTerminationCriterion):
        raise ValueError("variable-draws collection requires a dynamic "
                         "(NUTS) termination criterion")
    if per_chain and not isinstance(state.metric, (
            DiagEuclideanMetric, UnitEuclideanMetric, DenseEuclideanMetric)):
        raise ValueError("per-chain variable-draws collection supports "
                         "unit/diag/dense metrics (batch-explicit loop)")
    if spec.coupled:
        raise ValueError("variable-draws collection is incompatible with "
                         "coupled chains (chains desync by construction)")
    h = Hamiltonian(metric=state.metric, target=spec.target,
                    kinetic=spec.kinetic)
    traj = spec.kernel.trajectory.with_nom_step_size(state.adapt.da.eps)
    z, thetas, stats, counts = nuts_transitions_fused(
        generator, h, traj, state.z, t_max, spec.kernel.refreshment,
        out_dtype=out_dtype, t_min=t_min)
    stats["is_adapt"] = stats["numerical_error"].new_zeros(
        stats["numerical_error"].shape)
    return (dataclasses.replace(state, iteration=state.iteration + t_min,
                                z=z),
            thetas, counts, stats)

"""Kinetic energy configurations (counterpart of `advancedhmc_tpu/kinetic.py`).

A config selects the kinetic energy's code path in `Hamiltonian`: the
Gaussian one, or the relativistic one with a unit or diagonal metric.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GaussianKinetic:
    """K(r) = ½ rᵀ M⁻¹ r — the default kinetic energy."""


@dataclasses.dataclass(frozen=True)
class RelativisticKinetic:
    """Relativistic kinetic energy K(r) = m c² sqrt(rᵀM⁻¹r/(m²c²) + 1),
    with a unit or diagonal metric (shared or per chain)."""

    m: float
    c: float

"""Kinetic energy configurations (counterpart of `advancedhmc_tpu/kinetic.py`).

Only the Gaussian kinetic energy is ported; `RelativisticKinetic` is
queued under ROADMAP.md's "The rest of the surface".
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GaussianKinetic:
    """K(r) = ½ rᵀ M⁻¹ r — the default kinetic energy."""

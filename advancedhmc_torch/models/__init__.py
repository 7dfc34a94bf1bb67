"""Target models (counterpart of `advancedhmc_tpu/models`); the hierarchical
logistic is ported, the rest is ROADMAP.md section 1, item 11."""

from .logistic import hierarchical_logistic

__all__ = ["hierarchical_logistic"]

"""Target models (counterpart of `advancedhmc_tpu/models`): the hierarchical
logistic, its block form and the diagonal Gaussians in block form for the
NUTS megakernel; the rest is queued under ROADMAP.md's "The rest of the
surface"."""

from .gaussian import mvn_diag_block, std_gaussian_block
from .logistic import hierarchical_logistic, hierarchical_logistic_block

__all__ = ["hierarchical_logistic", "hierarchical_logistic_block",
           "mvn_diag_block", "std_gaussian_block"]

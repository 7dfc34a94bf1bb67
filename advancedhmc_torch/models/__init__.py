"""Target models (counterpart of `advancedhmc_tpu/models`): the hierarchical
logistic and its block form, the Gaussians (batched, and the diagonal ones
in block form for the NUTS megakernel) and Neal's funnel; the rest is
queued under ROADMAP.md's "The rest of the surface"."""

from .funnel import funnel_nc_to_centered, neal_funnel, neal_funnel_nc
from .gaussian import correlated_gaussian, mvn_diag, mvn_diag_block, \
    std_gaussian, std_gaussian_block
from .logistic import hierarchical_logistic, hierarchical_logistic_block

__all__ = ["correlated_gaussian", "funnel_nc_to_centered",
           "hierarchical_logistic", "hierarchical_logistic_block",
           "mvn_diag", "mvn_diag_block", "neal_funnel", "neal_funnel_nc",
           "std_gaussian", "std_gaussian_block"]

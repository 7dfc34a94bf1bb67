"""Target models (counterpart of `advancedhmc_tpu/models`): the Gaussians
(batched, and the diagonal ones in block form for the NUTS megakernel),
Neal's funnel, the hierarchical logistic (centred, its block form,
non-centred, German-credit-shaped), banana, eight schools, gdemo, the
Gaussian mixtures, the spiral, and the declarative distributions
(`dists`, `target_of`, `joint_target`, `gdemo_declarative`)."""

from . import dists
from .banana import banana
from .dists import gdemo_declarative, joint_target, target_of
from .eight_schools import eight_schools
from .funnel import funnel_nc_to_centered, neal_funnel, neal_funnel_nc
from .gaussian import correlated_gaussian, mvn_diag, mvn_diag_block, \
    std_gaussian, std_gaussian_block
from .gdemo import GDEMO_MEAN, gdemo
from .logistic import german_credit_logistic, hierarchical_logistic, \
    hierarchical_logistic_block, hierarchical_logistic_nc
from .mixtures import gaussian_mixture, two_gaussian_mixtures_2d
from .spiral import spiral

__all__ = ["GDEMO_MEAN", "banana", "correlated_gaussian", "dists",
           "eight_schools", "funnel_nc_to_centered", "gaussian_mixture",
           "gdemo", "gdemo_declarative", "german_credit_logistic",
           "hierarchical_logistic", "hierarchical_logistic_block",
           "hierarchical_logistic_nc", "joint_target", "mvn_diag",
           "mvn_diag_block", "neal_funnel", "neal_funnel_nc", "spiral",
           "std_gaussian", "std_gaussian_block", "target_of",
           "two_gaussian_mixtures_2d"]

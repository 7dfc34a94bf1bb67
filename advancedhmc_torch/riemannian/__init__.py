"""Riemannian HMC (SoftAbs), the generalised leapfrog, Riemannian NUTS and
the relativistic momentum (counterpart of `advancedhmc_tpu/riemannian/`)."""

from .hamiltonian import RiemannianHamiltonian, RiemannianPhasePoint
from .integrator import GeneralizedLeapfrog, generalized_leapfrog_step, \
    transition_rmhmc
from .metric import DenseRiemannianMetric, IdentityMap, SoftAbsMap, softabs
from .relativistic import rand_momentum_relativistic
from .sampler import sample_rmhmc

__all__ = [
    "DenseRiemannianMetric",
    "IdentityMap",
    "SoftAbsMap",
    "softabs",
    "RiemannianHamiltonian",
    "RiemannianPhasePoint",
    "GeneralizedLeapfrog",
    "generalized_leapfrog_step",
    "transition_rmhmc",
    "rand_momentum_relativistic",
    "sample_rmhmc",
]

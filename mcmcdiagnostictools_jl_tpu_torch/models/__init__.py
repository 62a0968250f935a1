"""The R* classifier, the distribution of probabilistic R* and the HMC
test-data sampler (counterparts of the JAX package's ``models/``)."""

from .gbt import GBTClassifier, GBTState, ShardedGBTClassifier, deterministic
from .poisson_binomial import ScaledPoissonBinomial
from .hmc import HMCTrace, cauchy_logpdf, eight_schools_logpdf, hmc_sample

__all__ = ["GBTClassifier", "GBTState", "ShardedGBTClassifier",
           "deterministic", "ScaledPoissonBinomial", "HMCTrace", "hmc_sample",
           "cauchy_logpdf", "eight_schools_logpdf"]

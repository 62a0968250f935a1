"""The R* classifier and the distribution of probabilistic R*
(counterparts of the JAX package's ``models/``; its HMC sampler and a
test-data generator have none)."""

from .gbt import GBTClassifier, GBTState, ShardedGBTClassifier, deterministic
from .poisson_binomial import ScaledPoissonBinomial

__all__ = ["GBTClassifier", "GBTState", "ShardedGBTClassifier",
           "deterministic", "ScaledPoissonBinomial"]

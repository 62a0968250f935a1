"""The R* classifier and the distribution of probabilistic R*
(counterparts of the JAX package's ``models/``; its HMC sampler, a test-data
generator, and ``ShardedGBTClassifier``, which waits for ``parallel/``, have
none)."""

from .gbt import GBTClassifier, GBTState, deterministic
from .poisson_binomial import ScaledPoissonBinomial

__all__ = ["GBTClassifier", "GBTState", "deterministic", "ScaledPoissonBinomial"]

"""R* classifier-based convergence diagnostic (Lambert & Vehtari 2020),
counterpart of the JAX package's ``diagnostics/rstar.py``.

Mirrors the reference rstar.jl pipeline (src/rstar.jl:22-64): split chain ids
-> stratified shuffled train/test split -> classifier fit -> R* from the test
predictions. The classifier seam is a duck-typed protocol with the port's
histogram GBT (``models.gbt``) as the default:

- ``classifier.fit(X, y, num_classes, verbosity) -> state``
- ``classifier.predict(state, X) -> labels``            (deterministic R*)
- ``classifier.predict_proba(state, X) -> (n, K)``      (probabilistic R*)
- ``classifier.probabilistic: bool`` selects the algorithm.

``X`` is a tensor of rows on the sample's device, ``y`` host integer codes.
Deterministic classifiers return the scalar ``R* = nclasses * accuracy``
(algorithm 1, src/rstar.jl:236-246); probabilistic classifiers return the
scaled Poisson-binomial distribution of R* (algorithm 2,
src/rstar.jl:249-265).

Input forms supported (src/rstar.jl:215-233): N-d array
``(draws, chains[, params...])``, 2-d matrix + explicit ``chain_indices``
(ragged chains allowed), or a 1-d vector (single chain). The rows are built
on the sample's device; the chain ids, the split and the class relabelling
stay on the host, drawing from ``rng`` exactly as the JAX package does, so a
seed gives both packages the same train/test split.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import to_numpy, to_tensor
from ..models.gbt import GBTClassifier
from ..models.poisson_binomial import ScaledPoissonBinomial
from ..utils.indices import shuffle_split_stratified, split_chain_indices


def rstar(
    classifier,
    samples,
    chain_indices=None,
    *,
    subset: float = 0.7,
    split_chains: int = 2,
    verbosity: int = 0,
    rng=None,
    device=None,
):
    """R* of ``samples`` with ``classifier``.

    Pass ``classifier=None`` for the default GBT. Returns a float for
    deterministic classifiers or a :class:`ScaledPoissonBinomial` for
    probabilistic ones. ``rng`` seeds the train/test shuffle (NumPy
    Generator or seed). A tensor is computed where it lives; other input
    goes to ``device`` (default: the card).
    """
    if classifier is None:
        classifier = GBTClassifier()
    if not 0 < subset < 1:
        raise ValueError("`subset` must be a number in (0, 1)")
    rng = np.random.default_rng(rng)

    rows, y = _as_rows(samples, chain_indices, device)
    if len(rows) != len(y):
        raise ValueError("samples and chain_indices must have matching lengths")

    ysplit = split_chain_indices(y, split_chains)
    train_ids, test_ids = shuffle_split_stratified(rng, ysplit, subset)
    if not (0 < len(train_ids) < len(y)):
        raise ValueError("training and test data subsets must not be empty")

    # relabel split-chain ids to contiguous classes 0..K-1
    classes, y_codes = np.unique(ysplit, return_inverse=True)
    nclasses = len(classes)

    def take(ids):
        return rows[torch.as_tensor(ids, device=rows.device)]

    state = classifier.fit(take(train_ids), y_codes[train_ids], nclasses,
                           verbosity=verbosity)
    ytest = y_codes[test_ids]
    xtest = take(test_ids)

    if getattr(classifier, "probabilistic", False):
        if hasattr(classifier, "predict_true_proba"):
            # streaming path: the (ntest, K) probability matrix is never
            # materialized (many-chain regime, BASELINE config 5)
            p_true = np.asarray(
                to_numpy(classifier.predict_true_proba(state, xtest, ytest)),
                dtype=np.float64,
            )
            if p_true.shape != ytest.shape:
                raise ValueError(
                    "predict_true_proba must return one probability per "
                    "test row"
                )
        else:
            proba = np.asarray(
                to_numpy(classifier.predict_proba(state, xtest)),
                dtype=np.float64,
            )
            if proba.shape != (len(ytest), nclasses):
                raise ValueError(
                    f"predict_proba must return shape (ntest, nclasses)="
                    f"{(len(ytest), nclasses)}, got {proba.shape}"
                )
            p_true = proba[np.arange(len(ytest)), ytest]
        # clip tiny negative / >1 float noise
        p_true = np.clip(p_true, 0.0, 1.0)
        return ScaledPoissonBinomial(p_true, nclasses / len(ytest))

    pred = np.asarray(to_numpy(classifier.predict(state, xtest)))
    if pred.shape != ytest.shape:
        raise ValueError("predict must return one label per test row")
    return float(nclasses * np.mean(pred == ytest))


def _as_rows(samples, chain_indices, device):
    """Normalize input forms to (rows tensor, host chain ids)."""
    # tabular inputs (pandas DataFrame / anything exposing to_numpy, or a
    # dict of column vectors): the reference's Tables.jl seam
    # (src/rstar.jl:109-110)
    if hasattr(samples, "to_numpy"):
        samples = samples.to_numpy()
    elif isinstance(samples, dict):
        samples = np.column_stack([np.asarray(v) for v in samples.values()])
        if chain_indices is None:
            raise ValueError("tabular samples require explicit chain_indices")
    x = to_tensor(samples, device)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    if chain_indices is not None:
        if x.ndim == 1:
            x = x[:, None]
        if x.ndim != 2:
            raise ValueError(
                "with explicit chain_indices, samples must be a matrix whose "
                "rows are draws"
            )
        return x, np.asarray(chain_indices)
    if x.ndim == 1:
        return x[:, None], np.ones(len(x), dtype=np.int64)
    ndraws, nchains = x.shape[0], x.shape[1]
    rows = x.reshape(ndraws, nchains, -1).permute(1, 0, 2).reshape(
        ndraws * nchains, -1
    )
    # rows grouped by chain with draws in order (the reference's
    # `repeat(axes(x, 2); inner=size(x, 1))` labeling, src/rstar.jl:215-218)
    y = np.repeat(np.arange(1, nchains + 1), ndraws)
    return rows, y

"""Histogram gradient-boosted trees for the R* diagnostic (counterpart of the
JAX package's ``models/gbt.py``).

A multiclass softmax GBT of the same design as the JAX package's:

- quantile-binned features (``n_bins`` per feature),
- **shared-structure multi-output trees**: one tree per boosting round whose
  structure is shared by all classes and whose leaves carry K-dimensional
  logit updates; the split gain is the per-class gain summed over classes,
- **one-hot histograms**: the (node, bin) one-hot of each feature, ``(n,
  F * nodes * bins)`` float32, contracted against the stacked
  gradient/hessian matrix ``(n, 2K)`` in one matrix product a level (the
  contraction the JAX package computes; rows cut into blocks through
  ``torch.bmm`` were slower on the H100, ``benchmarks/gbt_contract.py``).
  Float32 products run in full float32: TF32 stays off (PyTorch's default),
- trees grown level by level (oblivious layout), every node of a level
  split at once.

The rounds are a Python loop and the levels are unrolled; nothing inside
them reads a value back to the host: the split argmax, the routing and the
leaf values stay tensors on the rows' device. A fit runs where its rows
are: a CUDA tensor on the card, a CPU tensor on the host, other input on the
card.

Many classes (the many-chain regime, ``_chunk_width``) take the
class-chunked path ``_fit_gbt_bigk`` / ``_predict_stats_bigk``, which never
holds the ``(n, K)`` logits. Its spans are labelled for the profiler:
``gbt.logits`` (the products of the leaf history with the leaf values) and
``gbt.hist`` (the histogram contractions).

``ShardedGBTClassifier`` is the data-parallel fit over the ranks of a
``torch.distributed`` process group: both fits take a ``reduce`` hook that
sums each level's histograms and the leaf sums across the ranks (the
identity on one device).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from ..convert import to_tensor


class GBTState(NamedTuple):
    split_feature: torch.Tensor  # (rounds, inner_nodes) int64
    split_bin: torch.Tensor  # (rounds, inner_nodes) int64
    leaf_value: torch.Tensor  # (rounds, leaves, K) float32
    bin_edges: torch.Tensor  # (features, n_bins-1) float32 quantile edges
    num_classes: int


@dataclass(frozen=True)
class GBTClassifier:
    """Histogram GBT classifier implementing the R* classifier protocol.

    ``fit(X, y, num_classes) -> state``; ``predict_proba(state, X) -> (n, K)``;
    ``predict(state, X) -> labels``. ``probabilistic`` selects which R*
    algorithm applies (1: deterministic, 2: Poisson-binomial distribution).
    ``X`` is a tensor (computed where it lives) or an array (put on the
    card); every output is a tensor on ``X``'s device.
    """

    n_rounds: int = 100
    learning_rate: float = 0.1
    max_depth: int = 3
    n_bins: int = 64
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    probabilistic: bool = True
    # class-chunked streaming mode for the many-chain regime: 0 = auto
    # (engage when materializing the (n, 2K) gradient matrix would exceed
    # ~600 MB), -1 = never, else the chunk width in classes
    class_chunk: int = 0

    def _chunk_width(self, n: int, num_classes: int) -> int:
        """Class-chunk width for the streaming path; 0 = dense path."""
        if self.class_chunk == -1:
            return 0
        if self.class_chunk > 0:
            return min(self.class_chunk, num_classes)
        return 256 if n * num_classes > 150_000_000 else 0

    def _rows(self, x) -> torch.Tensor:
        return to_tensor(x).to(torch.float32)

    def fit(self, x, y, num_classes: int, verbosity: int = 0) -> GBTState:
        x = self._rows(x)
        y = torch.as_tensor(y, device=x.device).to(torch.int64)
        edges = _quantile_bin_edges(x, self.n_bins)
        sf, sb, lv = self._fit_binned(_bin_features(x, edges), y, num_classes)
        if verbosity > 0:
            print(
                f"{type(self).__name__}: fitted {self.n_rounds} multi-output "
                f"trees ({num_classes} classes, depth {self.max_depth})"
            )
        return GBTState(sf, sb, lv, edges, num_classes)

    def _fit_binned(self, binned, y, num_classes: int, n: int | None = None,
                    **sharded):
        """The dense or the class-chunked fit of binned rows ``(n, F)``,
        chosen for ``n`` rows in all (default: these); ``sharded``: a
        sharded fit's row weights ``w`` and ``reduce``."""
        kc = self._chunk_width(binned.shape[0] if n is None else n,
                               num_classes)
        opts = dict(num_classes=num_classes, n_rounds=self.n_rounds,
                    learning_rate=self.learning_rate,
                    max_depth=self.max_depth, n_bins=self.n_bins,
                    reg_lambda=self.reg_lambda,
                    min_child_weight=self.min_child_weight, **sharded)
        if kc:
            return _fit_gbt_bigk(binned, y, class_chunk=kc, **opts)
        return _fit_gbt(binned, y, **opts)

    def predict_logits(self, state: GBTState, x):
        binned = _bin_features(self._rows(x), state.bin_edges)
        return _predict_logits(binned, state.split_feature, state.split_bin,
                               state.leaf_value, self.max_depth)

    def predict_proba(self, state: GBTState, x):
        return torch.softmax(self.predict_logits(state, x), dim=-1)

    def predict(self, state: GBTState, x):
        binned = _bin_features(self._rows(x), state.bin_edges)
        kc = self._chunk_width(binned.shape[0], state.num_classes)
        if kc:
            pred, _ = _predict_stats_bigk(
                binned, state.split_feature, state.split_bin,
                state.leaf_value,
                torch.zeros(binned.shape[0], dtype=torch.int64,
                            device=binned.device),
                self.max_depth, kc,
            )
            return pred
        return torch.argmax(
            _predict_logits(binned, state.split_feature, state.split_bin,
                            state.leaf_value, self.max_depth), dim=-1)

    def predict_true_proba(self, state: GBTState, x, y):
        """Per-row softmax probability of the true class ``y``: the only
        quantity the probabilistic R* needs (src/rstar.jl:249-265); streams
        over class chunks so the (n, K) probability matrix is never
        materialized at many-chain scale."""
        binned = _bin_features(self._rows(x), state.bin_edges)
        y = torch.as_tensor(y, device=binned.device).to(torch.int64)
        kc = self._chunk_width(binned.shape[0], state.num_classes)
        if kc:
            _, p_true = _predict_stats_bigk(
                binned, state.split_feature, state.split_bin,
                state.leaf_value, y, self.max_depth, kc,
            )
            return p_true
        proba = torch.softmax(
            _predict_logits(binned, state.split_feature, state.split_bin,
                            state.leaf_value, self.max_depth), dim=-1)
        return proba.gather(1, y[:, None])[:, 0]


def deterministic(classifier: GBTClassifier) -> GBTClassifier:
    """Mode-predicting version (the reference's ``Pipeline(...; predict_mode)``
    construction, src/rstar.jl:198-209)."""
    return replace(classifier, probabilistic=False)


@dataclass(frozen=True)
class ShardedGBTClassifier(GBTClassifier):
    """Data-parallel GBT fit over the ranks of a process group (``group``;
    default: every rank of the started one), BASELINE.md config 5's scale.

    Every rank calls ``fit`` with the full training sample. The bin edges
    come from all of it; the rows are dealt to the ranks in contiguous
    blocks, the last padded with zero-weight rows; each level's
    gradient/hessian histograms and the leaf sums are one SUM all-reduce of
    the ranks' partial sums, after which split selection runs the same on
    every rank. The fitted forest is replicated, and equals the
    single-device fit up to the order of the float32 sums. Prediction is
    local, as ``GBTClassifier``'s.
    """

    group: object = None

    def _fit_binned(self, binned, y, num_classes: int):
        """This rank's block of the binned rows, weighted, fitted with every
        row reduction all-reduced over the group."""
        group = self.group
        nranks, rank = dist.get_world_size(group), dist.get_rank(group)
        n = binned.shape[0]
        n_loc = -(-n // nranks)
        r0, r1 = min(rank * n_loc, n), min((rank + 1) * n_loc, n)
        pad = n_loc - (r1 - r0)
        w = torch.ones(n_loc, dtype=torch.float32, device=binned.device)
        binned, y = binned[r0:r1], y[r0:r1]
        if pad:
            w[n_loc - pad:] = 0.0
            binned = torch.cat([binned, binned.new_zeros((pad, binned.shape[1]))])
            y = torch.cat([y, y.new_zeros(pad)])

        def reduce(t):
            t = t.contiguous()
            dist.all_reduce(t, group=group)
            return t

        return super()._fit_binned(binned, y, num_classes, n, w=w,
                                   reduce=reduce)


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


def _quantile_bin_edges(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(F, n_bins-1) per-feature quantile edges from the training data:
    ``jnp.quantile``'s linear interpolation between order statistics (one
    sort of the columns; ``torch.quantile`` refuses inputs above 2^24
    elements), weights in float64, a column holding a NaN all NaN."""
    n = x.shape[0]
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1] * (n - 1)
    low = np.clip(np.floor(qs), 0, n - 1).astype(np.int64)
    high = np.clip(np.ceil(qs), 0, n - 1).astype(np.int64)
    w_high = torch.as_tensor(qs - np.floor(qs), device=x.device)[:, None]
    xs = torch.sort(x, dim=0).values.to(torch.float64)
    lo_v = xs[torch.as_tensor(low, device=x.device)]
    hi_v = xs[torch.as_tensor(high, device=x.device)]
    edges = lo_v * (1.0 - w_high) + hi_v * w_high  # (n_bins-1, F)
    edges = torch.where(torch.isnan(x).any(0), torch.nan, edges)
    return edges.T.contiguous().to(torch.float32)


# rows a block of ``_bin_features`` compares at once, against every edge
_BIN_BLOCK_ELEMS = 1 << 26


def _bin_features(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Digitize features into [0, n_bins): the count of edges strictly
    below ``x`` (so a NaN gets bin 0, as in the JAX package)."""
    n, nf = x.shape
    out = torch.empty((n, nf), dtype=torch.int64, device=x.device)
    step = max(1, _BIN_BLOCK_ELEMS // max(1, nf * edges.shape[1]))
    for r0 in range(0, n, step):
        out[r0:r0 + step] = (x[r0:r0 + step, :, None] > edges[None]).sum(2)
    return out


# ---------------------------------------------------------------------------
# histograms, gains and splits (shared by both fits)
# ---------------------------------------------------------------------------

# bytes a one-hot feature chunk may take
_ONEHOT_BYTES = 256 * 1024 * 1024


def _onehot_chunks(binned: torch.Tensor, node: torch.Tensor, n_nodes: int,
                   n_bins: int):
    """The level's (node, bin) one-hot, feature chunk by feature chunk:
    yields (n, features * n_nodes * n_bins) float32 chunks, each under
    ``_ONEHOT_BYTES`` (one feature at least)."""
    n, nfeat = binned.shape
    cols = n_nodes * n_bins
    max_feats = max(1, _ONEHOT_BYTES // (4 * n * cols))
    for f0 in range(0, nfeat, max_feats):
        f1 = min(f0 + max_feats, nfeat)
        seg = (node[:, None] * n_bins + binned[:, f0:f1]
               + torch.arange(f1 - f0, device=binned.device) * cols)
        oh = torch.zeros((n, (f1 - f0) * cols), dtype=torch.float32,
                         device=binned.device)
        yield oh.scatter_(1, seg, 1.0)


def _level_hist(chunks, gh: torch.Tensor, nfeat: int, n_nodes: int,
                n_bins: int) -> torch.Tensor:
    """(node, feature, bin) sums of the stacked ``gh`` (n, 2K) over the
    one-hot ``chunks`` of ``_onehot_chunks``: (n_nodes, F, n_bins, 2K)."""
    with record_function("gbt.hist"):
        parts = [oh.T @ gh for oh in chunks]
    hists = parts[0] if len(parts) == 1 else torch.cat(parts, 0)
    return hists.reshape(nfeat, n_nodes, n_bins, gh.shape[1]).transpose(0, 1)


def _split_gains(hist: torch.Tensor, k: int, reg_lambda: float):
    """Multi-output gain of a split after each bin, summed over the classes,
    and the left / right hessian sums: three (n_nodes, F, n_bins) tensors
    from a level's histograms (n_nodes, F, n_bins, 2k)."""
    gl = torch.cumsum(hist[..., :k], dim=2)  # left sums at split bin b
    hl = torch.cumsum(hist[..., k:], dim=2)
    gtot = gl[:, :, -1:, :]
    htot = hl[:, :, -1:, :]
    gr = gtot - gl
    hr = htot - hl
    gain = (gl**2 / (hl + reg_lambda) + gr**2 / (hr + reg_lambda)
            - gtot**2 / (htot + reg_lambda)).sum(3)
    return gain, hl.sum(3), hr.sum(3)


def _best_split(gain, hl_sum, hr_sum, n_bins: int, min_child_weight: float):
    """Each node's split ``(feature, bin)``: the first largest valid gain
    over (F, n_bins-1) (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does); a node with no positive gain gets the degenerate
    split ``bin = n_bins - 1`` that sends everything left."""
    n_nodes = gain.shape[0]
    valid = (hl_sum >= min_child_weight) & (hr_sum >= min_child_weight)
    gain = torch.where(valid, gain, -torch.inf)[:, :, :-1]
    flat_gain = gain.reshape(n_nodes, -1)
    best = torch.argmax(flat_gain, dim=1)
    best_gain = flat_gain.gather(1, best[:, None])[:, 0]
    bf = best // (n_bins - 1)
    bb = best % (n_bins - 1)
    usable = torch.isfinite(best_gain) & (best_gain > 0)
    return bf, torch.where(usable, bb, n_bins - 1)


def _one_hot(idx: torch.Tensor, width: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` (``F.one_hot`` checks its input's range
    on the host, which would stop the card's queue once a round)."""
    return (idx[..., None] == torch.arange(width, device=idx.device)).to(
        torch.float32)


def _route(binned, node, bf, bb):
    """Each row's node one level down: right where its bin of the node's
    split feature is above the split bin."""
    xf = binned.gather(1, bf[node][:, None])[:, 0]
    return node * 2 + (xf > bb[node]).to(torch.int64)


# ---------------------------------------------------------------------------
# dense fit
# ---------------------------------------------------------------------------


def _identity(t):
    return t


def _fit_gbt(binned, y, *, num_classes, n_rounds, learning_rate, max_depth,
             n_bins, reg_lambda, min_child_weight, w=None, reduce=_identity):
    """The dense fit (the JAX package's ``_fit_gbt_core``):
    ``(split_feature, split_bin, leaf_value)``. ``w``: (n,) row weights (0
    for padding rows); ``reduce``: sums a row reduction across the ranks of
    a sharded fit (the identity on one device)."""
    n, nfeat = binned.shape
    dev = binned.device
    inner, leaves, k = 2**max_depth - 1, 2**max_depth, num_classes
    onehot_y = _one_hot(y, k)
    logits = torch.zeros((n, k), dtype=torch.float32, device=dev)
    sf = torch.zeros((n_rounds, inner), dtype=torch.int64, device=dev)
    sb = torch.zeros((n_rounds, inner), dtype=torch.int64, device=dev)
    lv = torch.zeros((n_rounds, leaves, k), dtype=torch.float32, device=dev)
    for r in range(n_rounds):
        p = torch.softmax(logits, dim=1)
        gh = torch.cat([p - onehot_y, p * (1.0 - p)], dim=1)  # (n, 2K)
        if w is not None:
            gh = gh * w[:, None]
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        for depth in range(max_depth):
            n_nodes, off = 2**depth, 2**depth - 1
            hist = reduce(_level_hist(
                _onehot_chunks(binned, node, n_nodes, n_bins), gh, nfeat,
                n_nodes, n_bins))
            bf, bb = _best_split(*_split_gains(hist, k, reg_lambda), n_bins,
                                 min_child_weight)
            sf[r, off:off + n_nodes] = bf
            sb[r, off:off + n_nodes] = bb
            node = _route(binned, node, bf, bb)
        # K-dim leaf values from the final node assignment
        sums = reduce(_one_hot(node, leaves).T @ gh)
        lv[r] = -learning_rate * sums[:, :k] / (sums[:, k:] + reg_lambda)
        logits += lv[r][node]
    return sf, sb, lv


# ---------------------------------------------------------------------------
# class-chunked streaming fit: the many-chain regime (K ~ 2e4 classes)
# ---------------------------------------------------------------------------
#
# At BASELINE config-5 scale (1e4 chains -> 2e4 split-chain classes, ~7e5
# training rows) the dense fit would hold the (n, 2K) gradient matrix and the
# (n, K) logits: O(100 GB). The streaming fit holds neither:
#
# - the forest state is the pair (OH, LV): OH (n, rounds*leaves) float32 is
#   the one-hot of each row's leaf in every past round, LV (rounds*leaves,
#   Kpad) the leaf logit updates. Any class chunk of the logits is one
#   product ``OH @ LV[:, c0:c0+kc]``: exact sums of float32 leaf values
#   (the JAX package keeps OH in bf16, exact for 0/1, and multiplies it
#   against float32 values in float32),
# - per round: one pass over the chunks accumulates the softmax normalizer
#   Z, then each level accumulates split gains chunk by chunk against the
#   level's one-hot (built once a level), and a final pass writes the leaf
#   values,
# - memory: O(n*rounds*leaves + n*F*nodes*bins + n*kc) instead of O(n*K).
#
# Numerics match the dense path up to the unshifted exp (logits are clipped
# to +-50, safe in float32 for K <= ~1e6 classes).


def _fit_gbt_bigk(binned, y, *, num_classes, n_rounds, learning_rate,
                  max_depth, n_bins, reg_lambda, min_child_weight,
                  class_chunk, w=None, reduce=_identity):
    n, nfeat = binned.shape
    dev = binned.device
    inner, leaves, k, kc = 2**max_depth - 1, 2**max_depth, num_classes, class_chunk
    nch = -(-k // kc)
    rl = n_rounds * leaves
    oh_hist = torch.zeros((n, rl), dtype=torch.float32, device=dev)
    lv_all = torch.zeros((rl, nch * kc), dtype=torch.float32, device=dev)
    sf = torch.zeros((n_rounds, inner), dtype=torch.int64, device=dev)
    sb = torch.zeros((n_rounds, inner), dtype=torch.int64, device=dev)
    y_chunk, y_col = y // kc, (y % kc)[:, None]  # each row's class chunk, column

    def exp_chunk(c0):
        """exp of the clipped logits of classes c0..c0+kc (unshifted: they
        lie in [-50, 50]), 0 for the padding past class k."""
        with record_function("gbt.logits"):
            e = oh_hist @ lv_all[:, c0:c0 + kc]
        e = e.clamp_(-50.0, 50.0).exp_()
        if c0 + kc > k:
            e[:, k - c0:] = 0.0
        return e

    def gh_chunk(zinv, c0):
        """The chunk's stacked ``[p - onehot(y), p * (1 - p)]`` (n, 2kc),
        written in place into one buffer (the same float32 operations as
        the dense fit's, in fewer passes over the card's memory)."""
        gh = torch.empty((n, 2 * kc), dtype=torch.float32, device=dev)
        p, h = gh[:, :kc], gh[:, kc:]
        torch.mul(exp_chunk(c0), zinv[:, None], out=p)
        torch.mul(p, -1.0, out=h).add_(1.0).mul_(p)  # (1 - p) * p
        mine = (y_chunk == c0 // kc).to(torch.float32)[:, None]
        p.scatter_add_(1, y_col, -mine)  # g = p - 1 at the row's own class
        return gh if w is None else gh.mul_(w[:, None])

    for r in range(n_rounds):
        z = torch.zeros(n, dtype=torch.float32, device=dev)
        for i in range(nch):
            z += exp_chunk(i * kc).sum(1)
        zinv = 1.0 / z

        node = torch.zeros(n, dtype=torch.int64, device=dev)
        for depth in range(max_depth):
            n_nodes, off = 2**depth, 2**depth - 1
            chunks = list(_onehot_chunks(binned, node, n_nodes, n_bins))
            gain = torch.zeros((n_nodes, nfeat, n_bins), dtype=torch.float32,
                               device=dev)
            hl_sum, hr_sum = torch.zeros_like(gain), torch.zeros_like(gain)
            for i in range(nch):
                hist = reduce(_level_hist(chunks, gh_chunk(zinv, i * kc),
                                          nfeat, n_nodes, n_bins))
                gc, hlc, hrc = _split_gains(hist, kc, reg_lambda)
                gain += gc
                hl_sum += hlc
                hr_sum += hrc
            del chunks
            bf, bb = _best_split(gain, hl_sum, hr_sum, n_bins,
                                 min_child_weight)
            sf[r, off:off + n_nodes] = bf
            sb[r, off:off + n_nodes] = bb
            node = _route(binned, node, bf, bb)

        leaf_oh = _one_hot(node, leaves)
        lv_blk = torch.zeros((leaves, nch * kc), dtype=torch.float32,
                             device=dev)
        for i in range(nch):
            c0 = i * kc
            sums = reduce(leaf_oh.T @ gh_chunk(zinv, c0))
            lv_blk[:, c0:c0 + kc] = (-learning_rate * sums[:, :kc]
                                     / (sums[:, kc:] + reg_lambda))
        lv_all[r * leaves:(r + 1) * leaves] = lv_blk
        oh_hist[:, r * leaves:(r + 1) * leaves] = leaf_oh
    lv = lv_all.reshape(n_rounds, leaves, nch * kc)[:, :, :k].contiguous()
    return sf, sb, lv


def _route_all(binned, split_feature, split_bin, max_depth):
    """Each row's leaf in every round: (rounds, n) int64."""
    nodes = []
    for sf, sb in zip(split_feature, split_bin):
        node = torch.zeros(binned.shape[0], dtype=torch.int64,
                           device=binned.device)
        for depth in range(max_depth):
            off = 2**depth - 1
            node = _route(binned, node, sf[off:2 * off + 1], sb[off:2 * off + 1])
        nodes.append(node)
    return torch.stack(nodes)


def _predict_stats_bigk(binned, split_feature, split_bin, leaf_value, y,
                        max_depth: int, class_chunk: int):
    """Streaming prediction stats: ``(argmax label, P(true class y))``.

    Online logsumexp + running argmax over class chunks: never materializes
    the (n, K) logit/probability matrix.
    """
    n = binned.shape[0]
    n_rounds, leaves, k = leaf_value.shape
    kc = class_chunk
    nch = -(-k // kc)
    rl = n_rounds * leaves
    dev = binned.device
    nodes = _route_all(binned, split_feature, split_bin, max_depth)
    oh_hist = _one_hot(nodes, leaves).permute(1, 0, 2).reshape(n, rl)
    lv_flat = F.pad(leaf_value.reshape(rl, k), (0, nch * kc - k))
    karange = torch.arange(kc, device=dev)

    m = torch.full((n,), -torch.inf, dtype=torch.float32, device=dev)
    s = torch.zeros(n, dtype=torch.float32, device=dev)
    best_val = m.clone()
    best_idx = torch.zeros(n, dtype=torch.int64, device=dev)
    tl = torch.zeros(n, dtype=torch.float32, device=dev)
    for i in range(nch):
        c0 = i * kc
        with record_function("gbt.logits"):
            lg = oh_hist @ lv_flat[:, c0:c0 + kc]
        lg = lg.clamp_(-50.0, 50.0)
        km = (c0 + karange) < k
        lgm = torch.where(km[None, :], lg, -torch.inf)
        cmax, carg = lgm.amax(1), torch.argmax(lgm, 1)
        new_m = torch.maximum(m, cmax)
        s = s * torch.exp(m - new_m) + torch.where(
            km[None, :], torch.exp(lg - new_m[:, None]), 0.0).sum(1)
        upd = cmax > best_val
        best_val = torch.where(upd, cmax, best_val)
        best_idx = torch.where(upd, carg + c0, best_idx)
        in_chunk = (y >= c0) & (y < c0 + kc)
        ysel = (y - c0).clamp(0, kc - 1)
        tl = torch.where(in_chunk, lg.gather(1, ysel[:, None])[:, 0], tl)
        m = new_m
    return best_idx, torch.exp(tl - m) / s


def _predict_logits(binned, split_feature, split_bin, leaf_value,
                    max_depth: int):
    nodes = _route_all(binned, split_feature, split_bin, max_depth)
    logits = torch.zeros((binned.shape[0], leaf_value.shape[-1]),
                         dtype=torch.float32, device=binned.device)
    for lv, node in zip(leaf_value, nodes):
        logits += lv[node]
    return logits

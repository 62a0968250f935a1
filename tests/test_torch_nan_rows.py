"""NaN poisoning of the exact rank mode whatever end of a sorted row its
NaNs sort to.

The CPU's ``torch.sort`` puts every NaN last; the card's radix sort orders
floats by their bits, so a NaN with the sign bit set (``-np.nan``, the
host's ``inf - inf``) sorts first there. Here, on the CPU:

- ``ops.ranknorm._nan_rows`` on presorted rows with NaNs first, last, both
  and none;
- ``discretediag``'s category codes: the NaNs of a column, whatever
  their sign bits, are one category, the last;
- the exact calls (``ess_rhat(kind="rank")`` with each ``fold_impl``,
  ``ess`` of the median and mad kinds, ``mcse`` of a quantile) under a
  ``torch.sort`` that orders floats as the card's radix sort does (by the
  bits, through cub's key transform): a column of sign-bit NaNs and a
  column with one sign-bit NaN among numbers come out NaN, and every other
  column equals, bit for bit, the same sample's with ``+nan`` in those
  columns under the CPU's own sort.
"""

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch.ops import ranknorm as rn
from torch_parity import t

_TORCH_SORT = torch.sort


def radix_order_sort(x, dim=-1, descending=False, stable=False, *,
                     out=None):
    """``torch.sort`` as the card's radix sort orders floats: by cub's key
    transform of the bits (a negative float's bits all flipped, any other's
    sign bit), as a signed integer: ``bits ^ maxint`` for a set sign bit,
    else ``bits``. A sign-bit NaN sorts before ``-inf``, any other NaN
    after ``+inf``. Ascending and stable; other dtypes as ``torch.sort``."""
    if out is not None or descending or not x.is_floating_point():
        return _TORCH_SORT(x, dim=dim, descending=descending, stable=stable,
                           out=out)
    ibits = {torch.float32: torch.int32, torch.float64: torch.int64}[x.dtype]
    bits = x.contiguous().view(ibits)
    key = torch.where(bits < 0, bits ^ torch.iinfo(ibits).max, bits)
    idx = torch.argsort(key, dim=dim, stable=True)
    return torch.return_types.sort((x.gather(dim, idx), idx))


def test_radix_order_sort_puts_sign_bit_nans_first():
    x = torch.tensor([1.0, -np.nan, np.inf, np.nan, -np.inf, -0.0, 0.0])
    assert np.signbit(x[1].numpy()) and not np.signbit(x[3].numpy())
    v, i = radix_order_sort(x)
    assert i.tolist() == [1, 4, 5, 6, 0, 2, 3]
    assert torch.equal(_TORCH_SORT(x).indices[-2:].sort().values,
                       torch.tensor([1, 3]))  # the CPU: every NaN last


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nan_rows_reads_both_ends(dtype):
    nan, neg = float("nan"), -float("nan")
    rows = torch.tensor([
        [neg, neg, 1.0, 2.0],  # the card's order for sign-bit NaNs
        [1.0, 2.0, nan, nan],  # the CPU's order
        [neg, 1.0, 2.0, nan],  # both kinds on the card
        [neg, neg, neg, neg],
        [-np.inf, 1.0, 2.0, np.inf],
        [3.0, 3.0, 3.0, 3.0],
    ], dtype=dtype)
    assert rn._nan_rows(rows).tolist() == [True, True, True, True, False,
                                            False]
    assert torch.equal(rn._nan_rows(rows), rn._has_nan_cols(rows.t()))


def _sample(nan_value):
    """(400, 4, 5) float64 AR-ish sample: column 1 all ``nan_value``,
    column 3 one ``nan_value`` among numbers, the rest finite."""
    rng = np.random.default_rng(21)
    x = np.cumsum(rng.standard_normal((400, 4, 5)), axis=0) * 0.1
    x[:, :, 1] = nan_value
    x[123, 2, 3] = nan_value
    return t(x)


CALLS = [
    ("ess_rhat", dict(kind="rank", fold_impl="sort")),
    ("ess_rhat", dict(kind="rank", fold_impl="merge")),
    ("ess_rhat", dict(kind="tail", fold_impl="merge")),
    ("ess", dict(kind="median")),
    ("ess", dict(kind="mad")),
    ("mcse", dict(kind=mtt.Quantile(0.25))),
]


@pytest.mark.parametrize("fn,kw", CALLS, ids=lambda v: str(v))
def test_sign_bit_nan_columns_are_poisoned_in_card_order(monkeypatch, fn,
                                                         kw):
    neg = _sample(-np.nan)
    assert np.signbit(neg[0, 0, 1].numpy())
    want = getattr(mtt, fn)(_sample(np.nan), **kw)
    monkeypatch.setattr(torch, "sort", radix_order_sort)
    got = getattr(mtt, fn)(neg, **kw)
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        assert bool(torch.isnan(g[[1, 3]]).all())
        assert bool(torch.isfinite(g[[0, 2, 4]]).all())
        assert torch.equal(g[[0, 2, 4]], w[[0, 2, 4]])


def test_discrete_codes_keep_one_nan_category_in_card_order(monkeypatch):
    from mcmcdiagnostictools_jl_tpu_torch.diagnostics import discretediag

    x = torch.tensor([[2.0, 1.0], [np.nan, 1.0], [0.0, -np.nan],
                      [-np.nan, 3.0], [2.0, np.nan]])
    want = discretediag._integer_codes_batched(x)
    assert want[1].tolist() == [3, 3]
    monkeypatch.setattr(torch, "sort", radix_order_sort)
    got = discretediag._integer_codes_batched(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

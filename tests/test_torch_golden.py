"""Golden-vector parity of the port: the cases of ``tests/test_golden.py``
through ``mcmcdiagnostictools_jl_tpu_torch`` on the CPU at float64, against
the stored vectors of ``tests/golden/golden.json`` (a literal transcription
of the reference Julia source, a separate oracle from ``tests/ref_impl.py``
and from the JAX package).

Tolerance: BASELINE.md's parity bound, 1e-6, relative to ``max(1, |want|)``
(relative for large ESS values, absolute near 1 for R-hat); NaN masks equal.
Kinds use the reference's default direct ``AutocovMethod``; the FFT and BDA
estimators are pinned by the per-method basic-kind vectors.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch.convert import to_numpy

TOL = 1e-6
_GOLD = Path(__file__).resolve().parent / "golden" / "golden.json"
_DIRECT = mtt.AutocovMethod()
_METHODS = {"direct": _DIRECT, "fft": mtt.FFTAutocovMethod(),
            "bda": mtt.BDAAutocovMethod()}
_KINDS = ["rank", "bulk", "tail", "basic"]


@pytest.fixture(scope="module")
def gold():
    return json.loads(_GOLD.read_text())


def _x(case):
    return np.asarray(case["x"], dtype=np.float64)


def assert_golden(got, want, label):
    got = np.asarray(to_numpy(got), dtype=np.float64).reshape(-1)
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=label)
    mask = ~np.isnan(want)
    denom = np.maximum(1.0, np.abs(want[mask]))
    assert np.max(np.abs(got[mask] - want[mask]) / denom) < TOL, label


class TestESSRhatGolden:
    # scale-mismatched chains: the tail kinds must flag what bulk misses
    # (reference test/ess_rhat.jl:337-364); no basic vector is stored for it
    @pytest.mark.parametrize("case_name,kind", [
        (case, kind) for case in ("iid_1000x4x8", "ar1_1001x3x5",
                                  "scalemix_600x4x3")
        for kind in _KINDS if (case, kind) != ("scalemix_600x4x3", "basic")])
    def test_ess_rhat_kinds(self, gold, case_name, kind):
        c = gold[case_name]
        r = mtt.ess_rhat(_x(c), kind=kind, autocov_method=_DIRECT)
        assert_golden(r.ess, c[f"ess_rhat_{kind}_ess"], f"{case_name} ess {kind}")
        assert_golden(r.rhat, c[f"ess_rhat_{kind}_rhat"],
                      f"{case_name} rhat {kind}")

    @pytest.mark.parametrize("method", ["fft", "direct", "bda"])
    def test_basic_per_method(self, gold, method):
        c = gold["iid_1000x4x8"]
        r = mtt.ess_rhat(_x(c), kind="basic", autocov_method=_METHODS[method])
        assert_golden(r.ess, c[f"ess_basic_{method}"], f"basic ess {method}")
        assert_golden(r.rhat, c[f"rhat_basic_{method}"], f"basic rhat {method}")

    @pytest.mark.parametrize("kind", ["mean", "median", "std", "mad"])
    def test_ess_estimators(self, gold, kind):
        c = gold["iid_1000x4x8"]
        got = mtt.ess(_x(c), kind=kind, autocov_method=_DIRECT)
        assert_golden(got, c[f"ess_{kind}"], f"ess {kind}")

    def test_ess_quantile(self, gold):
        c = gold["iid_1000x4x8"]
        got = mtt.ess(_x(c), kind=mtt.Quantile(0.25), autocov_method=_DIRECT)
        assert_golden(got, c["ess_quantile_0.25"], "ess quantile 0.25")

    def test_ess_tail_relative(self, gold):
        c = gold["iid_1000x4x8"]
        got = mtt.ess(_x(c), kind="tail", relative=True, autocov_method=_DIRECT)
        assert_golden(got, c["ess_tail_relative"], "relative tail ess")

    @pytest.mark.parametrize("kind", _KINDS)
    def test_rhat_kinds(self, gold, kind):
        c = gold["iid_1000x4x8"]
        assert_golden(mtt.rhat(_x(c), kind=kind), c[f"rhat_{kind}"],
                      f"rhat {kind}")

    def test_odd_draws_split3(self, gold):
        """split_chains=3 on 1001 draws exercises the remainder-discard rule."""
        c = gold["ar1_1001x3x5"]
        got = mtt.ess(_x(c), kind="basic", split_chains=3,
                      autocov_method=_DIRECT)
        assert_golden(got, c["ess_basic_split3"], "basic ess split3")
        assert_golden(mtt.rhat(_x(c), kind="rank", split_chains=3),
                      c["rhat_rank_split3"], "rank rhat split3")

    def test_ar1_direct(self, gold):
        c = gold["ar1_1001x3x5"]
        got = mtt.ess(_x(c), kind="basic", autocov_method=_DIRECT)
        assert_golden(got, c["ess_basic_direct"], "ar1 direct basic ess")

    def test_small_2d_scalar(self, gold):
        c = gold["small_11x2"]
        r = mtt.ess_rhat(_x(c), kind="rank", autocov_method=_DIRECT)
        assert isinstance(r.ess, float) and isinstance(r.rhat, float)
        assert_golden(r.ess, c["ess_rhat_rank_ess"], "small rank ess")
        assert_golden(r.rhat, c["ess_rhat_rank_rhat"], "small rank rhat")
        rb = mtt.ess_rhat(_x(c), kind="basic", autocov_method=_DIRECT)
        assert_golden(rb.ess, c["ess_basic_direct"], "small basic ess")
        assert_golden(rb.rhat, c["rhat_basic"], "small basic rhat")


class TestMCSEGolden:
    @pytest.mark.parametrize("kind,key", [
        ("mean", "mcse_mean"), ("std", "mcse_std"), ("median", "mcse_median"),
        (mtt.Quantile(0.25), "mcse_quantile_0.25")])
    def test_kinds(self, gold, kind, key):
        c = gold["iid_1000x4x8"]
        got = mtt.mcse(_x(c), kind=kind, autocov_method=_DIRECT)
        assert_golden(got, c[key], key)

    def test_sbm(self, gold):
        c = gold["iid_1000x4x8"]
        got = mtt.mcse(_x(c), kind=lambda v: v.mean())
        assert_golden(got, c["mcse_sbm_mean"], "mcse sbm mean")

    @pytest.mark.parametrize("kind,key", [
        (mtt.Quantile(0.1), "mcse_quantile_0.1"), ("mean", "mcse_mean")])
    def test_ar1(self, gold, kind, key):
        c = gold["ar1_1001x3x5"]
        got = mtt.mcse(_x(c), kind=kind, autocov_method=_DIRECT)
        assert_golden(got, c[key], "ar1 " + key)


class TestNestedGolden:
    @pytest.mark.parametrize("kind", _KINDS)
    def test_kinds(self, gold, kind):
        c = gold["nested_500x8x6"]
        got = mtt.rhat_nested(_x(c), np.asarray(c["ids"]), kind=kind)
        assert_golden(got, c[f"rhat_nested_{kind}"], f"nested {kind}")

    def test_basic_split1(self, gold):
        c = gold["nested_500x8x6"]
        got = mtt.rhat_nested(_x(c), np.asarray(c["ids"]), kind="basic",
                              split_chains=1)
        assert_golden(got, c["rhat_nested_basic_split1"], "nested basic split1")

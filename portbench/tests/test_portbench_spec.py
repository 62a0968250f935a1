"""BENCHMARK.json and the files it names: every cell's configuration, mix,
limits and metric readers are found by name, and the file keeps to the
benchmark's contract."""

from __future__ import annotations

import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = spec.config(BENCH, w["config"])
    mix = spec.mix(w["traffic"])
    limits = spec.limits(cell)
    assert {c["name"] for c in mix["checks"]} == set(limits)
    for c in mix["checks"]:
        assert callable(spec.reference(c["reference"]))
    assert callable(spec.reference(mix["control"]))
    assert cfg["draws"] * cfg["chains"] * cfg["params"] * 4 == cfg["bytes"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.metric_reader(metric).read)


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert set(m["workloads"]) <= set(CELLS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in spec.metrics_for(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(BENCH, cell, "per_layer")


def test_metrics_for_reads_the_workloads_key():
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert [m["name"] for m in spec.metrics_for(bench, "x", "per_layer")] == ["a", "b"]
    assert [m["name"] for m in spec.metrics_for(bench, "y", "per_layer")] == ["a"]


class _Port:
    """A stand-in port whose one function returns each parameter's mean."""

    calls = 0

    @classmethod
    def means(cls, x):
        cls.calls += 1
        return x.mean((0, 1))


@pytest.mark.parametrize("param_slice, calls", [(None, 1), (2, 3), (5, 1), (1, 5)])
def test_a_call_in_parameter_slices_joins_its_outputs(param_slice, calls):
    import torch

    from portbench import traffic

    config = {"draws": 6, "chains": 3, "params": 5}
    mix = {"calls": [{"fn": "means", "outputs": ["m"], "param_slice": param_slice}]}
    x = torch.arange(90, dtype=torch.float64).reshape(6, 3, 5)
    _Port.calls = 0
    out = traffic.build_pass(mix, config, x, _Port)()
    assert _Port.calls == calls == traffic.calls_a_pass(mix, config)
    assert out["m"].tolist() == x.mean((0, 1)).tolist()

"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the root of the checkout) lists the cells and the
metrics; a cell's configuration is the file that its entry names, its
traffic ``mixes/<traffic>.json``, its limits ``limits/<cell>.json`` and each
metric a reader ``metrics/<metric>.py`` with ``read(ctx) -> float | None``.
A new cell, configuration or metric is new files and entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(traffic: str) -> dict:
    return _json(HERE / "mixes" / f"{traffic}.json")


def limits(cell_name: str) -> dict:
    return _json(HERE / "limits" / f"{cell_name}.json")


def metrics_for(bench: dict, cell_name: str, group: str) -> list[dict]:
    """The entries of ``bench[group]`` (``end_to_end`` or ``per_layer``)
    that this cell reports: those with no ``workloads`` key, and those that
    list it."""
    return [m for m in bench[group]
            if cell_name in m.get("workloads", [cell_name])]


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(qualname: str):
    """``reference/<module>.py``'s function, by ``"<module>.<function>"``."""
    module, fn = qualname.rsplit(".", 1)
    mod = importlib.import_module(f"portbench.reference.{module}")
    return getattr(mod, fn)

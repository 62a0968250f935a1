"""No module of the JAX side runs in a benchmark process: the names are
compared whole, and a child process that cannot import JAX or the JAX
package runs a cell through the harness."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import forbidden
from portbench.spec import ROOT


@pytest.mark.parametrize("modules, found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["mcmcdiagnostictools_jl_tpu", "mcmcdiagnostictools_jl_tpu.ops"],
     ["mcmcdiagnostictools_jl_tpu"]),
    (["mcmcdiagnostictools_jl_tpu_torch", "mcmcdiagnostictools_jl_tpu_torch.ops",
      "jaxtyping", "portbench.run"], []),
])
def test_names_are_compared_whole(modules, found):
    assert forbidden.loaded(modules) == found


_CHILD = r"""
import json, sys, time
for name in ("jax", "jaxlib", "flax", "mcmcdiagnostictools_jl_tpu"):
    sys.modules[name] = None
import mcmcdiagnostictools_jl_tpu_torch as mtt
from portbench import calibrate, forbidden, run, spec
from portbench.tests.conftest import small_config
bench = spec.load_benchmark()
cell = sys.argv[1]
out = run.run_cell(bench, cell, seed=5, seconds=0.1, traced=False, device="cpu",
                   port=mtt, t0=time.perf_counter(), config=small_config(bench, cell))
for name in ("jax", "jaxlib", "flax", "mcmcdiagnostictools_jl_tpu"):
    del sys.modules[name]
print(json.dumps({"correct": out["correct"], "loaded": forbidden.loaded()}))
"""


@pytest.mark.parametrize("cell", ["batched_c4.exact", "many_chains_c5.nested"])
def test_a_run_loads_nothing_of_jax(cell):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _CHILD, cell], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "loaded": []}


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "mcmcdiagnostictools_jl_tpu" not in text, path.name


def test_a_tree_without_the_port_prints_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: exit non-zero, no
    result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "batched_c4.exact",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""

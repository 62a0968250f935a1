"""The port stands alone: every module of ``mcmcdiagnostictools_jl_tpu_torch``
and ``chip_smoke.py`` imports in a process where ``jax`` and the JAX package
cannot be imported (``sys.modules[name] = None`` makes any import of them
raise). One child process imports them all; each module is one case."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = "mcmcdiagnostictools_jl_tpu_torch"


def _modules() -> list[str]:
    """Every module of the port, by its files (nothing is imported here),
    and ``chip_smoke``."""
    names = []
    for path in sorted((ROOT / PKG).rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names + ["chip_smoke"]


_CHILD = r"""
import importlib, json, sys
sys.modules["jax"] = None
sys.modules["mcmcdiagnostictools_jl_tpu"] = None
errors = {}
for name in sys.argv[1:]:
    try:
        importlib.import_module(name)
        errors[name] = None
    except Exception as exc:  # reported by the test of that module
        errors[name] = repr(exc)
print(json.dumps(errors))
"""


@pytest.fixture(scope="module")
def import_errors() -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _CHILD, *_modules()],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_is_listed():
    names = _modules()
    assert PKG in names and f"{PKG}.kernels.tiedrank" in names
    assert len(names) == len(set(names))


@pytest.mark.parametrize("name", _modules())
def test_imports_without_jax(import_errors, name):
    assert name in import_errors
    assert import_errors[name] is None, import_errors[name]

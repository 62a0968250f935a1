"""The port's profiling hooks (``utils/profiling.py``) on the CPU: ``trace``
writes a TensorBoard trace of its block into the directory it is given, and
an ``annotate`` region shows up by name among the profiler's events."""

import json

import torch

import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch.utils import profiling


def test_trace_writes_a_file_and_annotate_names_a_region(tmp_path):
    x = torch.randn((200, 4, 3), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("mdt.test_region"):
            mtt.ess_rhat(x)
    names = {e.name for e in prof.events()}
    assert "mdt.test_region" in names
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "mdt.test_region" for e in events)


def test_hooks_are_the_utils_names():
    assert mtt.utils.trace is profiling.trace
    assert mtt.utils.annotate is profiling.annotate

"""Shared pieces of the benchmark's tests: each cell at a size the host runs
in a second, and a fixture that finds the card or skips."""

from __future__ import annotations

import pytest

from portbench import spec


def small_config(bench: dict, cell_name: str) -> dict:
    """The cell's configuration with its scale cut for a CPU test: the same
    profile, dtype and keys, a few parameters and fewer draws and chains,
    still enough of them that the port's float32 reads well inside the
    cell's limits and the control (bfloat16) outside them."""
    cfg = dict(spec.config(bench, spec.cell(bench, cell_name)["config"]))
    prof = dict(cfg["profile"])
    if "superchains" in cfg:
        cfg.update(draws=100, chains=400, params=4, superchains=20)
        prof["offset"] = dict(prof["offset"], chains=[0, 20])
    else:
        cfg.update(draws=1000, chains=16, params=4)
        prof["offset"] = dict(prof["offset"], chains=[0, 2])
    cfg["profile"] = prof
    return cfg


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"

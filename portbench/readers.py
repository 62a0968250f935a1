"""Helpers the metric readers share: device time by kernel name, and the
card's peaks (``peaks.json``, by the name ``torch.cuda.get_device_name``
gives)."""

from __future__ import annotations

import json
from pathlib import Path

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def matching(ctx, names) -> list:
    """The traced device operations whose name contains one of ``names``."""
    if ctx.trace is None:
        return []
    return [e for e in ctx.trace.device if any(n in e[0] for n in names)]


def device_s(events) -> float:
    return sum(b - a for _, a, b in events) / 1e6


def device_ms_per_pass(ctx, names):
    """Device ms a pass of the operations named, or None where none ran."""
    ev = matching(ctx, names)
    return device_s(ev) * 1e3 / ctx.trace.passes if ev else None


def peaks(ctx):
    """The card's peak rates, or None for a card the table lacks."""
    with open(_PEAKS) as f:
        return json.load(f).get(ctx.device_kind)

"""The comparison that decides ``correct``.

Every pass's outputs (on the host once the window has closed) are held to
the plain references of the mix's ``checks``, computed once from the same
sample after the program's state is freed. A check's number is the widest
gap over the passes and the parameters: ``rel`` ``|a - b| / |b|``, ``abs``
``|a - b|``; a NaN where the reference has a number, or a number where it
has NaN, is an infinite gap. Its limit comes from ``limits/<cell>.json``.
The mix's ``launches`` say which of the port's kernels every call of every
pass must go through (``each_call``: a pass launches it at least as often as
it calls the port) and which no pass may launch (``never``), read from the
port's own launch counters around each pass of the window.
"""

from __future__ import annotations

import math

import numpy as np

from . import spec


def gap(a: np.ndarray, b: np.ndarray, kind: str) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    if (nan_a != nan_b).any():
        return math.inf
    ok = ~nan_b
    d = np.abs(a[ok] - b[ok])
    if kind == "rel":
        d = d / np.abs(b[ok])
    return float(d.max()) if d.size else 0.0


def references(mix: dict, sample, config: dict) -> dict:
    """``{reference name: {field: numpy}}`` of every reference the checks
    name, each computed once, in float64."""
    names = {c["reference"] for c in mix["checks"]}
    return {n: spec.reference(n)(sample, config) for n in names}


def gaps_of_pass(mix: dict, out: dict, refs: dict) -> dict:
    return {c["name"]: gap(out[c["output"]], refs[c["reference"]][c["field"]],
                           c["gap"])
            for c in mix["checks"]}


def judge(mix: dict, limits: dict, results: list[dict], refs: dict,
          launches: list[dict] | None, calls: int = 1):
    """``(correct, failed passes, checks)``; ``checks`` maps each short
    name to ``{"value", "limit"}`` (a launch check ``{"value", "limit",
    "at_least"}``). ``launches`` holds each pass's ``{kernel: launches}``,
    ``calls`` the calls of the port a pass makes; None (a run on the host,
    where no kernel exists) leaves the launch rules out."""
    checks, failed = {}, 0
    for out in results:
        g = gaps_of_pass(mix, out, refs)
        if any(not v <= limits[k]["limit"] for k, v in g.items()):
            failed += 1
        for k, v in g.items():
            prev = checks.get(k, {"value": 0.0})["value"]
            checks[k] = {"value": max(prev, v), "limit": limits[k]["limit"]}
    if not results:
        failed = 1
    correct = failed == 0
    rules = {} if launches is None else mix.get("launches", {})
    for k in rules.get("each_call", []):
        least = min((p.get(k, 0) for p in launches), default=0)
        checks[f"{k}_least_a_pass"] = {"value": least, "limit": calls,
                                       "at_least": True}
        correct &= least >= calls
    for k in rules.get("never", []):
        total = sum(p.get(k, 0) for p in launches)
        checks[f"{k}_launches"] = {"value": total, "limit": 0}
        correct &= total == 0
    return bool(correct), failed, checks


def lines(checks: dict) -> list[str]:
    out = []
    for k, c in checks.items():
        op = ">=" if c.get("at_least") else "<="
        out.append(f"check {k}: {c['value']!r} (limit {op} {c['limit']!r})")
    return out

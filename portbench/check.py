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

In a world of ranks (``world.py``) rank 0's outputs are held to the
references, computed on rank 0 from the global sample's parameter blocks
gathered from every rank; the launch rules hold on every rank's passes; and
``ranks_agree`` counts the output values of every other rank that differ
from rank 0's bit for bit, or are missing: its limit is 0.
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
          launches: list[dict] | None, calls: int = 1,
          bad_passes=frozenset()):
    """``(correct, failed passes, checks)``; ``checks`` maps each short
    name to ``{"value", "limit"}`` (a launch check ``{"value", "limit",
    "at_least"}``). ``launches`` holds each pass's ``{kernel: launches}``,
    ``calls`` the calls of the port a pass makes; None (a run on the host,
    where no kernel exists) leaves the launch rules out. ``bad_passes``:
    the indices of passes found wrong elsewhere, counted failed."""
    checks, failed = {}, 0
    for i, out in enumerate(results):
        g = gaps_of_pass(mix, out, refs)
        if i in bad_passes or any(not v <= limits[k]["limit"] for k, v in g.items()):
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


def _values_differ(a, b) -> int:
    """Values of ``a`` and ``b`` that differ bit for bit (all of them where
    one is missing or the two differ in type or shape)."""
    if a is None or b is None:
        return int(np.size(a if b is None else b))
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return max(a.size, b.size)
    bits_a = a.reshape(a.size, 1).view(np.uint8)
    bits_b = b.reshape(b.size, 1).view(np.uint8)
    return int((bits_a != bits_b).any(axis=1).sum())


def disagreement(results_by_rank: list[list[dict]]) -> tuple[int, set]:
    """``(values, passes)``: the output values of ranks 1.. that differ from
    rank 0's bit for bit or are missing, and the passes that hold one."""
    base, n, bad = results_by_rank[0], 0, set()
    for res in results_by_rank[1:]:
        for i in range(max(len(base), len(res))):
            mine = res[i] if i < len(res) else {}
            ref = base[i] if i < len(base) else {}
            d = sum(_values_differ(ref.get(k), mine.get(k))
                    for k in ref.keys() | mine.keys())
            if d:
                n += d
                bad.add(i)
    return n, bad


def lines(checks: dict) -> list[str]:
    out = []
    for k, c in checks.items():
        op = ">=" if c.get("at_least") else "<="
        out.append(f"check {k}: {c['value']!r} (limit {op} {c['limit']!r})")
    return out

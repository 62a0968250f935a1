"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed from the start of this module to the first timed pass):
imports, the CUDA context, the port's kernel library (built on the first run
of a checkout into the port's ``_build/``, loaded from there after), the
sample made on the card from ``--seed``, and warm-up passes with the cell's
own shapes. Then a closed loop of passes for ``--seconds`` (``--trace 0``:
the end-to-end metrics), or ``trace.TRACE_PASSES`` passes under the
profiler (``--trace 1``: the per-layer metrics and the breakdown). Once the
window has closed and the peak memory is read, the program's state is freed
and every pass's outputs are compared with the plain reference
(``check.py``). The last lines on standard error give each number compared
beside its limit; the last line on standard output is the result, a JSON
object whose last key, ``checks``, repeats them.

A cell whose mix names the argument kind ``"mesh"`` runs as a world of
``chips`` ranks, one process a card, which this process starts, watches and
reads (``world.py``); every other cell runs here, in this one process.

Exits 2 without a result when there is no card, too few cards, or no port
to run; 3 when a module of the JAX side was loaded; in a world, non-zero
when a rank failed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from . import check, forbidden, spec, trace, traffic  # noqa: E402
from .sample import make_sample  # noqa: E402

PORT = "mcmcdiagnostictools_jl_tpu_torch"
WARMUP_PASSES = 2


@dataclass
class RunContext:
    """What a metric's reader may read (``metrics/<name>.py``). In a world
    of ranks every field is rank 0's, but the peak: the largest over the
    cards."""

    config: dict
    device_kind: str
    setup_s: float
    passes: int
    pass_s: list          # seconds of each pass, call to results on the host
    window_s: float       # the whole window, first call to last result
    launches: dict        # the port's kernel launches over the window
    peak_above_sample_bytes: int
    trace: trace.Trace | None = None
    calls_a_pass: int = 1  # calls of the port a pass makes (parameter slices)

    @property
    def values_per_pass(self) -> int:
        c = self.config
        return c["draws"] * c["chains"] * c["params"]


def measure(one_pass, seconds: float):
    """Back-to-back passes until ``seconds`` have gone by: ``(results,
    seconds of each pass, window seconds)``."""
    results, pass_s = [], []
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        results.append(one_pass())
        now = time.perf_counter()
        pass_s.append(now - t)
        if now - start >= seconds:
            return results, pass_s, now - start


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def counting(one_pass, port):
    """``(pass, launches)``: ``one_pass`` that also appends the port's kernel
    launches of each pass, as ``{kernel: count}``, to the list
    ``launches``."""
    launches = []

    def counted():
        before = port.kernels.launch_counts()
        out = one_pass()
        after = port.kernels.launch_counts()
        launches.append({k: after[k] - before.get(k, 0) for k in after})
        return out

    return counted, launches


def _libraries(port) -> set:
    """The shared libraries in the port's build cache (``_build/`` in its
    package), so that a run can tell whether it built one."""
    return set(Path(port.__file__).resolve().parent.glob("_build/**/*.so"))


def read_metrics(bench: dict, cell_name: str, ctx: RunContext,
                 traced: bool) -> dict:
    """The cell's metrics of the run's group that a reader finds."""
    group = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, cell_name, group):
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


@dataclass
class Prepared:
    """A cell's program, set up and warmed up, and what its set-up read."""

    x: torch.Tensor       # the sample (in a world, this rank's block)
    one_pass: object      # one pass of the mix over ``x``
    timed: object         # ``one_pass`` counting its launches into ``per_pass``
    per_pass: list
    parts: dict           # the set-up's parts, the result's ``setup``
    peak_setup: int
    resident: int         # bytes allocated on the card before the window

    def free(self) -> None:
        """Drop the program's state, so that the reference runs beside the
        sample alone."""
        self.one_pass = self.timed = None
        gc.collect()
        if self.x.is_cuda:
            torch.cuda.empty_cache()


def prepare(make_x, mix: dict, config: dict, port, t0: float,
            mesh=None) -> Prepared:
    """Make the sample (``make_x()``), build the mix's pass over it and warm
    it up, reading the set-up's parts and the peak of set-up."""
    libraries = _libraries(port)
    t_start = time.perf_counter()
    x = make_x()
    cuda = x.is_cuda
    if cuda:
        torch.cuda.synchronize()
    t_sample = time.perf_counter()
    one_pass = traffic.build_pass(mix, config, x, port, mesh=mesh)
    for _ in range(WARMUP_PASSES):
        one_pass()
    t_warm = time.perf_counter()
    built = bool(_libraries(port) - libraries)
    parts = {"to_the_cell_s": t_start - t0, "sample_s": t_sample - t_start,
             "warmup_s": t_warm - t_sample, "library_built_here": built}
    print(f"setup: {t_start - t0:.3f} s to the cell, sample {t_sample - t_start:.3f} s, "
          f"{WARMUP_PASSES} warm-up passes {t_warm - t_sample:.3f} s"
          f"{' (the kernel library built in them)' if built else ''}",
          file=sys.stderr)
    peak_setup = 0
    if cuda:
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() if cuda else 0
    timed, per_pass = counting(one_pass, port)
    return Prepared(x, one_pass, timed, per_pass, parts, peak_setup, resident)


@dataclass
class Window:
    """What the measured window gave."""

    results: list         # each pass's outputs
    pass_s: list          # seconds of each pass; empty in a traced run
    window_s: float
    trace: trace.Trace | None


def run_window(timed, traced: bool, seconds: float, loop=measure) -> Window:
    """``trace.TRACE_PASSES`` passes under the profiler, or ``loop(timed,
    seconds)``'s passes."""
    if traced:
        tr, results = trace.run_traced(timed)
        return Window(results, [], (tr.window[1] - tr.window[0]) / 1e6, tr)
    return Window(*loop(timed, seconds), None)


def context(config: dict, cuda: bool, setup_s: float, win: Window,
            per_pass: list, above: int, calls: int) -> RunContext:
    return RunContext(
        config=config, device_kind=torch.cuda.get_device_name() if cuda else "cpu",
        setup_s=setup_s, passes=len(win.results), pass_s=win.pass_s,
        window_s=win.window_s,
        launches={k: sum(p[k] for p in per_pass) for k in per_pass[0]},
        peak_above_sample_bytes=above, trace=win.trace, calls_a_pass=calls)


def assemble(judged: tuple, win: Window, ctx: RunContext, metrics: dict, *,
             cuda: bool, count: int, peak: int, busy_s: float | None,
             parts: dict) -> dict:
    """The result line's object from ``check.judge``'s ``(correct, failed,
    checks)``; ``checks`` its last key."""
    correct, failed, checks = judged
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": ctx.device_kind, "count": count, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(win.results), "failed": failed,
           "metrics": metrics, "device": dev}
    if win.trace is not None:
        dev["busy_s"] = busy_s
        dev["window_s"] = win.window_s
        out["breakdown"] = trace.breakdown(win.trace)
    out["setup"] = parts
    out["checks"] = checks
    return out


def run_cell(bench: dict, cell_name: str, *, seed: int, seconds: float,
             traced: bool, device, port, t0: float, config: dict | None = None):
    """Set up, measure and judge one cell; returns the result dict (``checks``
    its last key). ``config`` replaces the cell's configuration (the CPU
    tests run a cell at a small size)."""
    cell = spec.cell(bench, cell_name)
    config = config or spec.config(bench, cell["config"])
    mix, limits = spec.mix(cell["traffic"]), spec.limits(cell_name)
    cuda = _cuda(device)

    prep = prepare(lambda: make_sample(config, seed, device), mix, config,
                   port, t0)
    setup_s = time.perf_counter() - t0
    win = run_window(prep.timed, traced, seconds)
    calls = traffic.calls_a_pass(mix, config)
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = context(config, cuda, setup_s, win, prep.per_pass,
                  peak_window - prep.resident, calls)
    metrics = read_metrics(bench, cell_name, ctx, traced)

    # the program's state goes before the reference runs beside the sample
    prep.free()
    refs = check.references(mix, prep.x, config)
    judged = check.judge(mix, limits, win.results, refs,
                         prep.per_pass if cuda else None, calls)
    busy_s = trace.busy_us(win.trace) / 1e6 if win.trace else None
    return assemble(judged, win, ctx, metrics, cuda=cuda, count=cell["chips"],
                    peak=max(prep.peak_setup, peak_window), busy_s=busy_s,
                    parts=prep.parts)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = spec.load_benchmark()
    try:
        cell = spec.cell(bench, args.workload)
    except KeyError as exc:
        print(exc, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if traffic.names_mesh(spec.mix(cell["traffic"])):
        from . import world

        return world.main(bench, args.workload, seed=args.seed,
                          seconds=args.seconds, traced=bool(args.trace),
                          device="cuda", port=PORT, t0=_T0)
    try:
        port = importlib.import_module(PORT)
    except ImportError as exc:
        print(f"the program under test is missing: {exc!r}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                   traced=bool(args.trace), device="cuda", port=port, t0=_T0)
    bad = forbidden.loaded()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    for line in check.lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

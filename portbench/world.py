"""A cell as an SPMD world of ranks: one process a card, over the port's own
mesh.

A mix that names the argument kind ``"mesh"`` runs as a world of the cell's
``chips`` ranks. The process that the benchmark's command starts
(``python3 -m portbench.run``) counts the cards but neither imports the
port nor makes a CUDA context: it writes the job into a temporary
directory, starts one process a rank (``python3 -m portbench.world <job>
<rank>``), watches them, and prints the one result line from what rank 0
leaves. Each rank:

- starts the default process group (NCCL on the card, gloo on the host)
  with a timeout, and a gloo group for the harness's control traffic on the
  host, both over a ``FileStore`` in the job's directory; then builds the
  port's mesh, ``port.parallel.make_mesh(chain_shards=world)``, as a user's
  pipeline would;
- makes its own block of chains on its own card (``sample.make_block``): no
  rank ever holds the global sample. In the mix, ``"sample"`` is that
  block, ``"superchain_ids"`` the global ids and ``"mesh"`` the mesh;
- warms up, waits for every rank, and makes the same passes as every other
  rank: after each pass rank 0 says over the control group whether the
  window has closed, outside the pass's clock and inside the window, so
  that no harness collective runs inside a timed pass;
- sends rank 0 its outputs, its launch counts pass by pass, its peak and
  its device's busy seconds over the control group; frees the program's
  state; then sends its block, a block of parameters at a time, over the
  default group, and rank 0 computes the mix's plain references
  (``reference/``) on each global block of parameters and joins them;
- as the last step of its task, once rank 0 has judged, reads the modules
  it has loaded and sends them to rank 0: a module of the JAX side loaded
  on any rank, at any point of the run, ends it without a result.

Rank 0 judges: its outputs against the references, the launch rules on
every rank's own passes, and ``ranks_agree``: every other rank's outputs
equal to rank 0's bit for bit (limit 0). The pass times, the window and the
set-up (from the start of the command's process) are rank 0's; the peak is
the largest of any card's, ``device.count`` the world's size. A rank that
fails ends the world: the watching process stops every rank and exits
non-zero with no result; a rank whose watcher is gone ends itself.
"""

from __future__ import annotations

import datetime
import faulthandler
import gc
import importlib
import importlib.util
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import check, forbidden, spec, trace, traffic
from .sample import make_block

CELL_TASK = "portbench.world:cell_task"
CALIBRATE_TASK = "portbench.world:calibrate_task"
DEADLINE_S = 1140           # a whole world, start to result
POLL_S = 0.1                # how often the watcher looks at the ranks
STOP_GRACE_S = 5.0          # between asking a rank to end and killing it
COLLECTIVE_TIMEOUT_S = 600  # a collective that waits longer fails its rank
GATHER_ENTRIES = 1 << 30    # global entries a parameter block brings to rank 0
_START = time.perf_counter()


@dataclass
class Rank:
    """This rank of a world, as a task sees it."""

    rank: int
    world: int
    ctl: object     # the gloo group of the harness's control traffic
    mesh: object    # the port's MeshConfig
    port: object
    device: str     # "cuda" or "cpu"


# ---------------------------------------------------------------- the watcher


def spawn(job: dict, task: str):
    """Run ``task`` (``"module:function"``) on every rank of a world of
    ``job["world"]`` processes; ``(0, what rank 0's task returned)``, or
    ``(code, None)`` once a rank has failed or the deadline has passed,
    every rank stopped."""
    world = job["world"]
    with tempfile.TemporaryDirectory(prefix="portbench-world-") as tmp:
        job = dict(job, task=task, store=os.path.join(tmp, "store"),
                   result=os.path.join(tmp, "result.json"))
        path = os.path.join(tmp, "job.json")
        with open(path, "w") as f:
            json.dump(job, f)
        procs = []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "portbench.world", path, str(r)],
                    cwd=spec.ROOT, env=dict(os.environ, LOCAL_RANK=str(r)),
                    stdout=2))
            code = _watch(procs, time.monotonic() + DEADLINE_S)
        finally:
            _stop(procs)
        if code:
            return code, None
        try:
            with open(job["result"]) as f:
                return 0, json.load(f)
        except FileNotFoundError:
            print("rank 0 ended without a result", file=sys.stderr)
            return 1, None


def _watch(procs, deadline: float) -> int:
    """0 once every rank has ended well; a failed rank's code, or 124 at
    the deadline, as soon as either happens."""
    while True:
        codes = [p.poll() for p in procs]
        for r, c in enumerate(codes):
            if c:
                print(f"rank {r} of {len(procs)} failed (exit {c}); "
                      "the world is stopped", file=sys.stderr)
                return c if c > 0 else 128 - c
        if all(c == 0 for c in codes):
            return 0
        if time.monotonic() > deadline:
            print("the world passed its deadline; it is stopped",
                  file=sys.stderr)
            return 124
        time.sleep(POLL_S)


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    end = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(max(end - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def job_for(bench: dict, cell_name: str, *, device: str, port: str,
            config=None, mix=None, limits=None, **fields) -> dict:
    """The job of a world: the cell's parts by name unless given (the tests
    give them at a small size) and ``fields``."""
    cell = spec.cell(bench, cell_name)
    return dict(fields, bench=bench, cell=cell, world=cell["chips"],
                device=device, port=port,
                config=config or spec.config(bench, cell["config"]),
                mix=mix or spec.mix(cell["traffic"]),
                limits=limits if limits is not None else spec.limits(cell_name))


def _port_found(port: str) -> bool:
    try:
        return importlib.util.find_spec(port) is not None
    except ImportError:
        return False


def run_world(bench: dict, cell_name: str, *, seed: int, seconds: float,
              traced: bool, device: str, port: str, t0: float, **parts):
    """``(code, {"result", "forbidden"})`` of one run of a world cell."""
    job = job_for(bench, cell_name, device=device, port=port, seed=seed,
                  seconds=seconds, traced=traced, t0=t0, **parts)
    return spawn(job, CELL_TASK)


def main(bench: dict, cell_name: str, *, port: str, **kw) -> int:
    """Run a world cell and print its result as ``run.main`` does."""
    if not _port_found(port):
        print(f"the program under test is missing: {port}", file=sys.stderr)
        return 2
    code, payload = run_world(bench, cell_name, port=port, **kw)
    if code:
        return code
    bad = sorted(set(forbidden.loaded()) | set(payload["forbidden"]))
    if bad:
        print(f"forbidden modules loaded in the world: {bad}", file=sys.stderr)
        return 3
    out = payload["result"]
    for line in check.lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def calibrate(bench: dict, cell_name: str, *, seeds, control_seeds,
              passes: int, device: str, port: str, **parts):
    """``(code, lines)`` of ``calibrate.py`` for a world cell: the program's
    and the control's readings, seed by seed, through the same world."""
    job = job_for(bench, cell_name, device=device, port=port,
                  seeds=list(seeds), control_seeds=list(control_seeds),
                  passes=passes, **parts)
    code, payload = spawn(job, CALIBRATE_TASK)
    return code, None if code else payload["lines"]


# ------------------------------------------------------------------- a rank


def _end_with_the_watcher() -> None:
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def say(w: Rank, what: str) -> None:
    """A line on standard error of where a rank has got to, so that a world
    that fails or stalls shows how far each rank came."""
    print(f"portbench.world rank {w.rank}/{w.world} at "
          f"{time.perf_counter() - _START:.1f} s: {what}", file=sys.stderr,
          flush=True)


def _task(name: str):
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


def rank_main(argv) -> int:
    path, rank = argv[0], int(argv[1])
    _end_with_the_watcher()
    # a rank stopped by the watcher prints where each of its threads was
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    with open(path) as f:
        job = json.load(f)
    world, device = job["world"], job["device"]
    try:
        if device == "cuda":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            store=dist.FileStore(job["store"], world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        ctl = dist.new_group(backend="gloo")
        port = importlib.import_module(job["port"])
        mesh = port.parallel.make_mesh(chain_shards=world, device_type=device)
        payload = _task(job["task"])(job, Rank(rank, world, ctl, mesh, port,
                                                device))
        if rank == 0:
            tmp = job["result"] + ".part"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=lambda o: o.item())
            os.replace(tmp, job["result"])
    except BaseException:
        # a rank that fails ends at once: its peers may sit in a collective
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    return 0


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def gather(obj, w: Rank):
    """Every rank's ``obj`` on rank 0, in rank order (None elsewhere)."""
    out = [None] * w.world if w.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=w.ctl)
    return out


def measure(one_pass, seconds: float, w: Rank):
    """``run.measure`` on every rank at once: after each pass rank 0 says
    whether ``seconds`` have gone by on its clock. Rank 0's ``(results,
    seconds of each pass, window seconds)``; the other ranks' times mean
    nothing."""
    results, pass_s = [], []
    closed = torch.zeros(1, dtype=torch.int32)
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        results.append(one_pass())
        now = time.perf_counter()
        pass_s.append(now - t)
        closed[0] = now - start >= seconds
        dist.broadcast(closed, src=0, group=w.ctl)
        if closed.item():
            return results, pass_s, now - start


def parameter_blocks(x: torch.Tensor, w: Rank, entries: int = GATHER_ENTRIES):
    """Rank 0 gets each ``(draws, chains, B)`` block of parameters of the
    global sample, at most ``entries`` entries (at least one parameter),
    the chains in rank order; every other rank sends its part of each block
    over the default group and gets None."""
    d, c_loc, p = x.shape
    step = max(1, entries // (d * c_loc * w.world))
    for s0 in range(0, p, step):
        part = x[:, :, s0:s0 + step].contiguous()
        if w.rank:
            dist.send(part, dst=0)
            _sync(w.device)
            yield None
            continue
        parts = [part] + [torch.empty_like(part) for _ in range(1, w.world)]
        for r in range(1, w.world):
            dist.recv(parts[r], src=r)
        block = torch.cat(parts, dim=1)
        del parts, part
        yield block


def joined(x: torch.Tensor, w: Rank, fns: dict,
           entries: int = GATHER_ENTRIES) -> dict | None:
    """Rank 0: ``{name: {field: numpy (P,)}}``, each ``fns[name](block)``
    over the global sample's parameter blocks, joined along the parameters;
    None elsewhere."""
    parts = {name: [] for name in fns}
    for block in parameter_blocks(x, w, entries):
        if block is not None:
            for name, fn in fns.items():
                parts[name].append(fn(block))
    if w.rank:
        return None
    return {name: {f: np.concatenate([o[f] for o in outs]) for f in outs[0]}
            for name, outs in parts.items()}


def reference_fns(mix: dict, config: dict) -> dict:
    """The mix's references by name, each a function of a block."""
    return {n: (lambda block, fn=spec.reference(n): fn(block, config))
            for n in {c["reference"] for c in mix["checks"]}}


def loaded_everywhere(w: Rank) -> list | None:
    """Rank 0: the forbidden modules loaded on any rank, read on each as
    the last step of its task; None elsewhere."""
    everyone = gather(forbidden.loaded(), w)
    return sorted(set().union(*everyone)) if w.rank == 0 else None


def cell_task(job: dict, w: Rank):
    from . import run

    config, mix = job["config"], job["mix"]
    cuda = w.device == "cuda"
    prep = run.prepare(
        lambda: make_block(config, job["seed"], w.rank, w.world, w.device),
        mix, config, w.port, job["t0"], mesh=w.mesh)
    dist.barrier(group=w.ctl)
    setup_s = time.perf_counter() - job["t0"]
    win = run.run_window(prep.timed, job["traced"], job["seconds"],
                         loop=lambda timed, s: measure(timed, s, w))
    say(w, f"{len(win.results)} passes made")
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    everyone = gather({
        "results": win.results, "per_pass": prep.per_pass,
        "busy_s": trace.busy_us(win.trace) / 1e6 if win.trace else None,
        "peak": max(prep.peak_setup, peak_window),
        "above": peak_window - prep.resident,
        "built": prep.parts["library_built_here"]}, w)
    calls = traffic.calls_a_pass(mix, config)
    if w.rank == 0:
        ctx = run.context(config, cuda, setup_s, win, prep.per_pass,
                          max(e["above"] for e in everyone), calls)
        metrics = run.read_metrics(job["bench"], job["cell"]["name"], ctx,
                                   win.trace is not None)

    # the program's state goes before the reference is gathered
    prep.free()
    say(w, "outputs sent; the program's state freed")
    refs = joined(prep.x, w, reference_fns(mix, config))
    say(w, "the sample's blocks sent" if w.rank else "references computed")
    out = None
    if w.rank == 0:
        differ, bad = check.disagreement([e["results"] for e in everyone])
        launches = [p for e in everyone for p in e["per_pass"]] if cuda else None
        correct, failed, checks = check.judge(
            mix, job["limits"], win.results, refs, launches, calls,
            bad_passes=bad)
        checks["ranks_agree"] = {"value": differ, "limit": 0}
        busy = [e["busy_s"] for e in everyone]
        out = run.assemble(
            (correct and differ == 0, failed, checks), win, ctx, metrics,
            cuda=cuda, count=w.world, peak=max(e["peak"] for e in everyone),
            busy_s=sum(busy) / w.world if win.trace else None,
            parts=dict(prep.parts, library_built_here=any(
                e["built"] for e in everyone)))
    loaded = loaded_everywhere(w)
    return None if w.rank else {"result": out, "forbidden": loaded}


def calibrate_task(job: dict, w: Rank):
    from .calibrate import LOWER_PRECISION, program_reading

    config, mix = job["config"], job["mix"]
    seeds, control_seeds = job["seeds"], job["control_seeds"]
    lowp = LOWER_PRECISION[config["dtype"]]
    refs_of = reference_fns(mix, config)
    lines = []
    for seed in dict.fromkeys(seeds + control_seeds):
        x = make_block(config, seed, w.rank, w.world, w.device)
        r = (program_reading(mix, config, x, w.port, job["passes"],
                             mesh=w.mesh) if seed in seeds else None)
        everyone = gather(r, w)
        fns = dict(refs_of)
        if seed in control_seeds:
            ctl = spec.reference(mix["control"])
            fns["control"] = lambda block: ctl(block, config, lowp=lowp)
        out = joined(x, w, fns)
        del x
        gc.collect()
        if w.device == "cuda":
            torch.cuda.empty_cache()
        if w.rank:
            continue
        if r is not None:
            g = {}
            for res in r["results"]:
                for k, v in check.gaps_of_pass(mix, res, out).items():
                    g[k] = max(g.get(k, 0.0), v)
            differ, _ = check.disagreement([e["results"] for e in everyone])
            lines.append({"seed": seed, "kind": "program", "gaps": g,
                          "ranks_agree": differ,
                          "launches_a_pass": [e["launches_a_pass"]
                                              for e in everyone],
                          "pass_s": r["pass_s"]})
        if seed in control_seeds:
            lines.append({"seed": seed, "kind": "control",
                          "gaps": check.gaps_of_pass(mix, out["control"], out)})
    return None if w.rank else {"lines": lines}


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))

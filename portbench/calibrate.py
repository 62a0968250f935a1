"""The readings that a cell's limits are set from, in one process on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--passes 2] [--out <file.jsonl>]

For each seed of ``--seeds`` the program runs as a run of the cell runs it
(the cell's sample, warm-up, then ``--passes`` passes through the mix's
calls) and its outputs are held to the plain references: one line
``{"seed", "kind": "program", "gaps", "launches_a_pass", "pass_s"}``. For
each seed of ``--control-seeds`` the control takes the program's place: the
mix's ``control`` reference, computed with every stored intermediate in the
next precision below the configuration's (``lowp``), held to the same
references: ``{"seed", "kind": "control", "gaps"}``. The lower reading of a
check is the largest program gap over the seeds, the upper the smallest
control gap. A cell whose mix names ``"mesh"`` is read through the same
world of ranks as its runs (``world.py``): each rank makes its block, the
references and the control are computed on rank 0 from the gathered
blocks, and a program line adds ``ranks_agree`` (values of other ranks that
differ from rank 0's) and gives ``launches_a_pass`` rank by rank.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

import torch

from . import check, spec, traffic
from .run import PORT, WARMUP_PASSES
from .sample import make_sample

LOWER_PRECISION = {"float32": torch.bfloat16, "float64": torch.float32}


def control_gaps(mix: dict, config: dict, x, refs: dict) -> dict:
    ctl = spec.reference(mix["control"])(x, config,
                                         lowp=LOWER_PRECISION[config["dtype"]])
    return check.gaps_of_pass(mix, ctl, refs)


def program_reading(mix: dict, config: dict, x, port, passes: int,
                    mesh=None) -> dict:
    one_pass = traffic.build_pass(mix, config, x, port, mesh=mesh)
    for _ in range(WARMUP_PASSES):
        one_pass()
    port.kernels.reset_launch_counts()
    results, pass_s = [], []
    for _ in range(passes):
        if x.is_cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            results.append(one_pass())
            ev[1].record()
            ev[1].synchronize()
            pass_s.append(ev[0].elapsed_time(ev[1]) / 1e3)
        else:
            t = time.perf_counter()
            results.append(one_pass())
            pass_s.append(time.perf_counter() - t)
    launches = {k: v / passes for k, v in port.kernels.launch_counts().items() if v}
    del one_pass
    gc.collect()
    torch.cuda.empty_cache()
    return {"results": results, "launches_a_pass": launches, "pass_s": pass_s}


def _write(lines, workload: str, out) -> None:
    for line in lines:
        line["workload"] = workload
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration needs the card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    config = spec.config(bench, cell["config"])
    mix = spec.mix(cell["traffic"])
    out = open(args.out, "a") if args.out else None
    if traffic.names_mesh(mix):
        from . import world

        code, lines = world.calibrate(
            bench, args.workload, seeds=args.seeds,
            control_seeds=args.control_seeds, passes=args.passes,
            device="cuda", port=PORT)
        if not code:
            _write(lines, args.workload, out)
        if out:
            out.close()
        return code
    port = importlib.import_module(PORT)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        x = make_sample(config, seed, "cuda")
        lines = []
        if seed in args.seeds:
            r = program_reading(mix, config, x, port, args.passes)
            refs = check.references(mix, x, config)
            g = {}
            for res in r["results"]:
                for k, v in check.gaps_of_pass(mix, res, refs).items():
                    g[k] = max(g.get(k, 0.0), v)
            lines.append({"seed": seed, "kind": "program", "gaps": g,
                          "launches_a_pass": r["launches_a_pass"],
                          "pass_s": r["pass_s"]})
        if seed in args.control_seeds:
            if seed not in args.seeds:
                refs = check.references(mix, x, config)
            lines.append({"seed": seed, "kind": "control",
                          "gaps": control_gaps(mix, config, x, refs)})
        _write(lines, args.workload, out)
        del x, refs
        gc.collect()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

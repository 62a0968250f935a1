"""The instruction mix of the built kernels, read from their SASS.

For every kernel of the built library whose name contains a given text (by
default the lag loop's kernels), ``cuobjdump -sass`` is parsed into: the
instruction count, the counts of the commonest opcodes, the FFMAs' share
(the lag loop is bound by instruction issue, so every instruction that is no
FFMA costs one), and the FFMAs that read all three source registers from
one register bank without help from the operand reuse cache; the same for
the kernel's hot loop alone, the shortest loop (a backward branch and its
target) that holds at least half of the kernel's FFMAs. The bank model
is the one measured on Volta and Turing (two banks, by the parity of the
register number; a source is served by the reuse cache when the previous
instruction flagged the same register ``.reuse`` in the same operand slot);
that Hopper keeps it is an assumption.

Needs ``nvcc`` and ``cuobjdump``, not the card: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.sass_mix [text]``.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

from ..kernels import _build

_INSTR = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)\s*(.*?);")
_REG = re.compile(r"\bR(\d+)(\.reuse)?\b")


def _mix(instructions) -> dict:
    """The mix of ``(address, opcode, operands)`` instructions in order."""
    opcodes = collections.Counter()
    one_bank = 0
    cached = {}  # operand slot -> register the reuse cache holds
    for _, op, operands in instructions:
        opcodes[op] += 1
        # source operands by slot (the first operand is the destination)
        sources = {slot: (int(r.group(1)), bool(r.group(2)))
                   for slot, operand in enumerate(operands.split(",")[1:])
                   if (r := _REG.search(operand))}
        if op == "FFMA":
            read = [r for slot, (r, _) in sources.items()
                    if cached.get(slot) != r]
            one_bank += len(read) == 3 and len({r % 2 for r in read}) == 1
        cached = {slot: r for slot, (r, flag) in sources.items() if flag}
    return {"instructions": sum(opcodes.values()), "opcodes": opcodes,
            "ffma": opcodes["FFMA"], "ffma_one_bank": one_bank}


def kernel_mix(sass: str, text: str) -> dict:
    """``{kernel name: {"instructions", "opcodes", "ffma", "ffma_one_bank",
    "hot_loop"}}`` for the kernels of a ``cuobjdump -sass`` listing whose
    name contains ``text``; ``hot_loop`` has the same keys for the shortest
    loop with at least half of the FFMAs, or is None."""
    out = {}
    for block in sass.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        if text not in name:
            continue
        instructions = [(int(m.group(1), 16), m.group(2).split(".")[0],
                         m.group(3))
                        for m in map(_INSTR.match, body.splitlines()) if m]
        whole = _mix(instructions)
        loops = []
        for at, op, operands in instructions:
            target = re.search(r"\b0x([0-9a-f]+)\b", operands)
            if op == "BRA" and target and int(target.group(1), 16) <= at:
                inside = [i for i in instructions
                          if int(target.group(1), 16) <= i[0] <= at]
                if 2 * sum(i[1] == "FFMA" for i in inside) >= whole["ffma"] > 0:
                    loops.append(inside)
        whole["hot_loop"] = _mix(min(loops, key=len)) if loops else None
        out[name.strip()] = whole
    return out


def main(text: str = "autocov_kernel") -> dict:
    lib, _ = _build.build()
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    mix = kernel_mix(sass, text)
    for name, whole in mix.items():
        print(name[:110])
        for part, m in (("kernel", whole), ("hot loop", whole["hot_loop"])):
            if m is None:
                print(f"  {part}: none found")
                continue
            n = m["instructions"]
            print(f"  {part}: {n} instructions, FFMA {m['ffma']} "
                  f"({m['ffma'] / max(n, 1):.1%}), of which "
                  f"{m['ffma_one_bank']} read three sources from one bank; "
                  + ", ".join(f"{op} {c}"
                              for op, c in m["opcodes"].most_common(8)))
    return mix


if __name__ == "__main__":
    main(*sys.argv[1:2])

"""The SASS of the port's kernels: for each kernel, the instructions of its
main loop as ``cuobjdump -sass`` prints them from the built library.

The main loop is the body of the innermost backward branch that holds
the most shared-memory loads (``LDS``), or where no loop loads, the most
tensor-core products (``HMMA``): a probe's unrolled round or step loop.
``instructions a load`` is the loop's other instructions over its loads,
counter and branch included: the integer work a lookup or step costs. For
the one-hot kernels (``MMA_NAMES``, HMMA a tile-round) the loop is counted
by tile-round instead: its HMMA, its SHFL and its other instructions over
its tile-rounds.

    python -m tpu_huffman_torch.prof.sass [NAME ...]

prints, for every kernel whose demangled name contains a NAME (by default
the chained-lookup probes' kernels, old and new forms), the loop's size,
its loads, the instructions a load and the count of each opcode. It needs
the CUDA toolkit's ``cuobjdump`` (beside ``nvcc``) and builds the library
first if it is not built.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

from .. import _build

# the one-hot chain kernels with accumulate (P1's), with their HMMA a
# tile-round: lut_chain_mma's sync form (16 k-steps of one n-tile) and its
# nibble form (two n-tiles, then the row sum's product)
MMA_NAMES = {"mma_lut_kernel<false, true, 0>": 16, "chain_nibble_kernel<true>": 3}
# the kernels of lut_chain's smem and addr forms, of step_chain's gather
# and gather0 in their smem and lean forms, and of lut_chain_mma's forms
DEFAULT_NAMES = (
    "lut_chain_kernel<(anonymous namespace)::ByteTable<0>",
    "lut_chain_kernel<(anonymous namespace)::WordTable<0>",
    "lut_addr_kernel",
    "step_chain_kernel<0, 0>",
    "step_chain_kernel<1, 0>",
    "step_chain_kernel<2, 0>",
    "step_lean_kernel",
) + tuple(MMA_NAMES)

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\s+0x([0-9a-f]+)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    return found or os.path.join(os.path.dirname(_build._nvcc()), name)


def _demangle(names: list[str]) -> list[str]:
    """The names as c++filt prints them; the mangled ones without it."""
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def parse(text: str) -> dict[str, list[tuple[int, str]]]:
    """cuobjdump -sass text -> {mangled function name: [(address,
    instruction)]}."""
    functions, current = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = functions.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return functions


def disassemble() -> dict[str, list[tuple[int, str]]]:
    """{demangled kernel name: [(address, instruction)]} of the library."""
    _build.load()
    text = subprocess.run([_tool("cuobjdump"), "-sass", _build.library_path()],
                          capture_output=True, text=True, check=True).stdout
    functions = parse(text)
    return dict(zip(_demangle(list(functions)), functions.values()))


def opcode(instruction: str) -> str:
    """The opcode with its modifiers, without the predicate."""
    return re.sub(r"^@!?U?P\w+\s+", "", instruction).split()[0]


def main_loop(instructions: list[tuple[int, str]]) -> list[str]:
    """The body, from its target to the branch, of the innermost backward
    branch (no other backward branch inside) with the most LDS; among
    equals (loops with no LDS among them) the one with the most HMMA, then
    the fewest global loads and stores (a step loop, not an element loop),
    then the longest. [] when the kernel has no loop."""
    spans = []
    for addr, text in instructions:
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) <= addr:
            spans.append((int(m.group(1), 16), addr))
    best, best_key = [], (-1, -1, -1, -1)
    for lo, hi in spans:
        if any(lo <= h < hi for _, h in spans):
            continue  # an inner loop sits inside this one
        body = [t for a, t in instructions if lo <= a <= hi]
        ops = [opcode(t) for t in body]
        key = (sum(op.startswith("LDS") for op in ops), sum(op.startswith("HMMA") for op in ops),
               -sum(op.startswith(("LDG", "STG")) for op in ops), len(body))
        if key > best_key:
            best, best_key = body, key
    return best


def summary(body: list[str], hmma_a_round: int | None = None) -> dict:
    """{"instructions", "loads", "per_load": other instructions over loads,
    "hmma", "shfl", "opcodes": {opcode: count}} of a loop body; with
    hmma_a_round (HMMA a tile-round) and HMMA in the loop also
    "tile_rounds" and "per_tile_round": {"HMMA", "SHFL", "other"}, each
    over the tile-rounds."""
    ops = collections.Counter(opcode(t) for t in body)

    def count(prefix):
        return sum(n for op, n in ops.items() if op.startswith(prefix))

    loads, hmma, shfl = count("LDS"), count("HMMA"), count("SHFL")
    out = {"instructions": len(body), "loads": loads,
           "per_load": (len(body) - loads) / loads if loads else None,
           "hmma": hmma, "shfl": shfl, "opcodes": dict(ops.most_common())}
    if hmma_a_round and hmma:
        rounds = hmma / hmma_a_round
        out["tile_rounds"] = rounds
        out["per_tile_round"] = {"HMMA": hmma / rounds, "SHFL": shfl / rounds,
                                 "other": (len(body) - hmma - shfl) / rounds}
    return out


def loops(names=DEFAULT_NAMES) -> dict[str, dict]:
    """{kernel: summary of its main loop} for each kernel of the library
    whose demangled name contains one of names; a kernel of MMA_NAMES is
    counted by tile-round too."""
    return {name: summary(main_loop(instrs),
                          next((k for n, k in MMA_NAMES.items() if n in name), None))
            for name, instrs in disassemble().items() if any(n in name for n in names)}


def text(r: dict) -> str:
    """A loop's summary on one line."""
    per = "no LDS loop" if r["per_load"] is None else f"{r['per_load']:.3f} a load"
    out = f"main loop {r['instructions']} instructions, {r['loads']} LDS, other instructions {per}"
    if "per_tile_round" in r:
        p = r["per_tile_round"]
        out += (f"; {r['tile_rounds']:g} tile-rounds, a tile-round {p['HMMA']:g} HMMA, "
                f"{p['SHFL']:g} SHFL, {p['other']:.3f} other")
    return out + "; " + ", ".join(f"{op} {n}" for op, n in r["opcodes"].items())


def main() -> None:
    for name, r in loops(tuple(sys.argv[1:]) or DEFAULT_NAMES).items():
        print(f"{name}: {text(r)}")


if __name__ == "__main__":
    main()

"""The by-value pack (``pack_encode.pack``, B1) on two checkouts of the port,
timed in turns in one session on one card.

Each reading is the pack at 8 MiB of random bytes (seed 2024) on the static
table, with the word count ``encode`` gives it, at block_symbols 256 and
100, as phase 5 of ``chip_smoke.py`` times it: the wrapper by CUDA events
(``prof.median_ms``) and the card alone behind a sleep kernel
(``prof.kernel_ms``). Run from anywhere, with two repository roots:

    python3 tpu_huffman_torch/prof/pack_turns.py BASE CHANGE

Each of two turns starts one process a root in the order BASE, CHANGE,
CHANGE, BASE. A process imports the port from its root, builds its kernels there,
checks the words and block offsets against ``pack_plain`` and prints one
JSON line. The words of every process must be equal. The last line is one
JSON object: every reading in order, the least of each root's, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

SEED = 2024
N = 8 << 20
BLOCK_SYMBOLS = (256, 100)
TURNS = 2
TIMEOUT = 600  # seconds a process may take, its build included


def measure(root: str) -> dict:
    """One reading of the pack in this process, the port taken from ``root``."""
    sys.path[0] = root
    import torch

    import tpu_huffman_torch as tt
    from tpu_huffman_torch.ops import pack_encode
    from tpu_huffman_torch.ops.encode import DeviceTable
    from tpu_huffman_torch.prof import kernel_ms, median_ms

    if os.path.dirname(os.path.abspath(tt.__file__)) != os.path.join(root, "tpu_huffman_torch"):
        raise RuntimeError(f"imported the port from {tt.__file__}, not from {root}")
    dev = torch.device("cuda")
    data = np.random.default_rng(SEED).integers(0, 256, size=N, dtype=np.uint8)
    sym = torch.from_numpy(data).to(dev)
    dt = DeviceTable.for_table(tt.load_static_test_table(), dev)
    tile_bits, _stats = pack_encode.count(sym, dt)
    incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
    offs = incl - tile_bits
    total = int(incl[-1])
    n_words = -(-(total + pack_encode.pad_code(total, 0xFF)[1]) // 32)
    out = {"root": root}
    for bs in BLOCK_SYMBOLS:
        def fn(bs=bs):
            return pack_encode.pack(sym, dt, offs, total, 0xFF, n_words, bs)

        words, block_offs = fn()
        want_w, want_o = pack_encode.pack_plain(sym, dt, offs, total, 0xFF, n_words, bs)
        if not (torch.equal(words, want_w) and torch.equal(block_offs, want_o)):
            raise AssertionError(f"pack at block_symbols {bs} differs from pack_plain")
        out[f"events_ms_{bs}"] = median_ms(fn)
        out[f"alone_ms_{bs}"] = kernel_ms({"pack": fn})["pack"]
    out["words_sha256"] = hashlib.sha256(words.cpu().numpy().tobytes()).hexdigest()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("base", help="root of the first checkout")
    parser.add_argument("change", help="root of the second checkout")
    args = parser.parse_args(argv)
    roots = {"base": os.path.abspath(args.base), "change": os.path.abspath(args.change)}
    readings = []
    for _ in range(TURNS):
        for side in ("base", "change", "change", "base"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", roots[side]],
                capture_output=True, text=True, timeout=TIMEOUT, stdin=subprocess.DEVNULL)
            if proc.returncode != 0:
                raise RuntimeError(f"{side} ({roots[side]}) failed:\n{proc.stdout}{proc.stderr}")
            reading = {"side": side, **json.loads(proc.stdout.splitlines()[-1])}
            print(json.dumps(reading), flush=True)
            readings.append(reading)
    if len({r["words_sha256"] for r in readings}) != 1:
        raise AssertionError("the checkouts' packs give different words")
    keys = [k for k in readings[0] if k.endswith("_ms_256") or k.endswith("_ms_100")]
    least = {side: {k: min(r[k] for r in readings if r["side"] == side) for k in keys}
             for side in roots}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "roots": roots, "least": least, "readings": readings}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))))
        sys.exit(0)
    sys.exit(main())

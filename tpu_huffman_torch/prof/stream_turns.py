"""The port's host-to-host calls on two checkouts, timed in turns in one
session on one card: the streaming calls and the one-shot round trip.

Each reading, in a process of its own with the port taken from one root:
- the three loops of ``chip_smoke.py``'s phase 6 on STREAM_MIB MiB of
  random bytes (seed 11) on the static table at 1 MiB chunks (a capped
  ``encode_chunk`` loop, a decoder fed 1 MiB input chunks, a capped drain
  of 1 MiB symbols a call after one feed): the median ms a call by the
  host clock (each call ends in a download), after one warm-up pass;
- ``encode_with_index`` then ``decode_indexed``, and ``decode``, on 8 MiB
  of random bytes (seed 2024): the median ms of REPS calls, each followed
  by ``torch.cuda.synchronize``.

Run from anywhere, with two repository roots:

    python3 tpu_huffman_torch/prof/stream_turns.py BASE CHANGE

Each of two turns starts one process a root in the order BASE, CHANGE,
CHANGE, BASE. The outputs' hashes must be equal in every process. The last
line is one JSON object: every reading in order, each root's median of its
readings, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

STREAM_MIB = 16
CHUNK = 1 << 20
ONE_SHOT = 8 << 20
REPS = 10
TURNS = 2
TIMEOUT = 600  # seconds a process may take, its build included


def measure(root: str) -> dict:
    """One reading in this process, the port taken from ``root``."""
    sys.path[0] = root
    import torch

    import tpu_huffman_torch as tt

    if os.path.dirname(os.path.abspath(tt.__file__)) != os.path.join(root, "tpu_huffman_torch"):
        raise RuntimeError(f"imported the port from {tt.__file__}, not from {root}")
    table = tt.load_static_test_table()
    data = np.random.default_rng(11).integers(0, 256, STREAM_MIB << 20, np.uint8).tobytes()
    encoded = tt.encode(data, table)
    digest = hashlib.sha256()

    def timed(call, first, again):
        """call(first), then call(again) until done: ms of each call."""
        times, arg = [], first
        while True:
            t0 = time.perf_counter()
            res, done, arg_next = call(arg)
            times.append((time.perf_counter() - t0) * 1e3)
            digest.update(res)
            if done:
                return times
            arg = arg_next if again is None else again

    def encode_loop(src):
        enc = tt.HuffmanEncoder(table)

        def call(view):
            r = enc.encode_chunk(view, CHUNK)
            return r.data, r.done, view[r.consumed:]

        return timed(call, memoryview(src), None)

    def feed_loop(stream):
        dec = tt.HuffmanDecoder(table)
        times = []
        for i in range(0, len(stream), CHUNK):
            t0 = time.perf_counter()
            digest.update(dec.decode_chunk(stream[i:i + CHUNK]).data)
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    def drain_loop(stream):
        dec = tt.HuffmanDecoder(table)

        def call(feed):
            r = dec.decode_chunk(feed, CHUNK)
            return r.data, r.done, b""

        return timed(call, stream, b"")

    warm = data[: 4 * CHUNK]
    warm_enc = tt.encode(warm, table)
    encode_loop(warm)
    feed_loop(warm_enc)
    drain_loop(warm_enc)
    digest = hashlib.sha256()  # the warm-up's outputs are not compared
    out = {"root": root,
           "encode_chunk_ms": statistics.median(encode_loop(data)),
           "fed_decode_chunk_ms": statistics.median(feed_loop(encoded)),
           "capped_drain_ms": statistics.median(drain_loop(encoded))}

    one = np.random.default_rng(2024).integers(0, 256, ONE_SHOT, np.uint8).tobytes()

    def round_trip():
        enc, idx = tt.encode_with_index(one, table)
        return tt.decode_indexed(enc, idx, table)

    enc8 = tt.encode(one, table)
    for key, fn in (("round_trip_8mib_ms", round_trip),
                    ("decode_8mib_ms", lambda: tt.decode(enc8, table))):
        digest.update(fn())
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[key] = statistics.median(times)
    out["outputs_sha256"] = digest.hexdigest()
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
    if len({r["outputs_sha256"] for r in readings}) != 1:
        raise AssertionError("the checkouts' outputs differ")
    keys = [k for k in readings[0] if k.endswith("_ms")]
    median = {side: {k: statistics.median(r[k] for r in readings if r["side"] == side)
                     for k in keys} for side in roots}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "roots": roots, "median": median, "readings": readings}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))))
        sys.exit(0)
    sys.exit(main())

"""Host time of one ``stream_decode.decode_stream`` call: what a caller
pays before the kernel runs, on walks where the kernel itself takes a few
microseconds (a 7-byte piece, the 191-symbol tail of a stream, 16 KiB).

For each walk, on 64 KiB of ``default_rng(2024)`` bytes on the static
table: the median host time of the bare call (``time.perf_counter_ns``
around it, the card idle before it, synchronised after), the wrapper timed
by CUDA events (``prof.median_ms``: five back-to-back calls a sample), and,
where the checkout's wrapper has them, the host time of its shape choice
(``walk_bits`` + ``card_shape``) and of its launch at a given shape
(``_launch``: checks, the output's allocation, the C call).

    python3 tpu_huffman_torch/prof/stream_host.py [--root DIR] [--reps N]

imports ``tpu_huffman_torch`` from the checkout at DIR (default: the one
holding this file), so that one script times the wrappers of two
checkouts; to compare them, run it in one session on the card for each, in
the order A, B, B, A. It prints the card, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPS = 2000
NBYTES = 64 * 1024
TAIL_SYMBOLS = 191
_HERE = os.path.dirname(os.path.abspath(__file__))


def host_us(torch, fn, reps: int) -> float:
    """Median host microseconds of fn(), each call made with the card idle
    and synchronised after (outside the timed span)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        t1 = time.perf_counter_ns()
        sync()
        times.append((t1 - t0) / 1e3)
    return statistics.median(times)


def walks(dev, nbytes: int = NBYTES) -> dict:
    """{walk: (words, start_bit, total_bits, out_capacity, dt)}: a 7-byte
    piece, the tail of TAIL_SYMBOLS symbols, and 16 KiB (or the stream)."""
    import numpy as np
    import torch

    import tpu_huffman_torch as tt
    from tpu_huffman_torch.ops.bitpack import stage_words
    from tpu_huffman_torch.ops.encode import DeviceTable

    table = tt.load_static_test_table()
    data = np.random.default_rng(2024).integers(0, 256, size=nbytes, dtype=np.uint8)
    enc = tt.encode(data.tobytes(), table, device="cpu")
    words = stage_words(torch.frombuffer(bytearray(enc), dtype=torch.uint8).to(dev))
    dt = DeviceTable.for_table(table, dev)
    tail = max(nbytes - TAIL_SYMBOLS, 0)
    tail_bit = int(np.asarray(table.lengths)[data[:tail]].astype(np.int64).sum())
    bits = 8 * len(enc)
    return {"piece": (words, 0, 56, None, dt), "tail": (words, tail_bit, bits, None, dt),
            "16k": (words, 0, min(8 * 16384, bits), None, dt)}


def run(dev, reps: int = REPS, nbytes: int = NBYTES) -> dict:
    """{walk: {"host_us", "events_ms" (on the card), "card_shape_us" and
    "launch_us" (where the wrapper has them)}} for the walks of
    :func:`walks` on ``dev``."""
    import torch

    from tpu_huffman_torch.ops import stream_decode

    res = {}
    for walk, args in walks(dev, nbytes).items():
        row = {"host_us": host_us(torch, lambda a=args: stream_decode.decode_stream(*a), reps)}
        if dev.type == "cuda":
            from tpu_huffman_torch.prof import median_ms

            row["events_ms"] = median_ms(lambda a=args: stream_decode.decode_stream(*a))
        words, start, total, cap, dt = args
        if hasattr(stream_decode, "card_shape"):
            shape = lambda: stream_decode.card_shape(  # noqa: E731
                stream_decode.walk_bits(start, total, cap, dt), dt)
            row["card_shape_us"] = host_us(torch, shape, reps)
        if hasattr(stream_decode, "_launch") and dev.type == "cuda":
            ww, sub = stream_decode.card_shape(stream_decode.walk_bits(start, total, cap, dt), dt)
            row["launch_us"] = host_us(
                torch, lambda a=args: stream_decode._launch(*a, ww, sub), reps)
        res[walk] = row
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(_HERE)),
                    help="the checkout whose tpu_huffman_torch is timed")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
    import torch

    import tpu_huffman_torch

    if not torch.cuda.is_available():
        raise SystemExit("stream_host times the wrapper on a CUDA device: none is available")
    if not os.path.abspath(tpu_huffman_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"tpu_huffman_torch came from {tpu_huffman_torch.__file__}, not {root}")
    from tpu_huffman_torch.prof import card

    print(card())
    print(json.dumps({"root": root, "walks": run(torch.device("cuda"), args.reps)}))


if __name__ == "__main__":
    main()

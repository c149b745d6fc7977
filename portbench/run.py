"""Run one cell of the benchmark of ``tpu_huffman_torch`` on this machine.

    python3 portbench/run.py --workload canterbury.roundtrip --seed 7 \\
        --seconds 20 --trace 0

Prints, as its last line, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, ``host`` (the reference's
set-up seconds, which ``setup_s`` leaves out; the process's CPU seconds in
the window; the host's speed after it) and, last, ``checks``: each number
compared with the reference beside its limit, also printed as the last
lines on standard error. Exits with 2 and prints no result without
the CUDA devices the cell asks for, and with 3 if JAX or the JAX package
was loaded.
"""

import time

T_START = time.time()  # set-up runs from here to the window's first call

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    from portbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())

"""Fit the ``canterbury`` configuration's static table, offline.

    python3 portbench/configs/fit_canterbury.py   # rewrites canterbury.tsv

The table is fitted once to ``FIT_BYTES`` of ``gen.canterbury_like`` at a
seed of its own (``FIT_SEED``, not a run's seed), as a deployment fits its
static table to a sample of its traffic and then ships it. Every byte's
count is raised by one first, so that every byte has a code and no input
of the benchmark's generator can hold a symbol without one. Lengths are
optimal under the 14-bit limit (package-merge), and codes are canonical:
by length, then by symbol, the shorter ones first.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench import gen  # noqa: E402

FIT_SEED = 1997
FIT_BYTES = 32 << 20
MAX_LEN = 14


def limited_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal code lengths of at most ``max_len`` bits (package-merge)."""
    syms = np.flatnonzero(freqs)
    if syms.size < 2:
        out = np.zeros(freqs.size, dtype=np.int64)
        out[syms] = 1
        return out
    leaves = [(int(freqs[s]), np.eye(1, freqs.size, s, dtype=np.int64)[0])
              for s in sorted(syms, key=lambda s: (int(freqs[s]), s))]
    items = leaves
    for _ in range(max_len - 1):
        pairs = [(a[0] + b[0], a[1] + b[1]) for a, b in zip(items[0::2], items[1::2])]
        items = sorted(leaves + pairs, key=lambda t: t[0])
    return sum(v for _, v in items[: 2 * syms.size - 2])


def canonical(lengths: np.ndarray) -> list[tuple[int, int, int]]:
    """(symbol, length, pattern) of the canonical code with these lengths."""
    code, prev, out = 0, 0, []
    for length, sym in sorted((int(lengths[s]), s) for s in np.flatnonzero(lengths)):
        code <<= length - prev
        out.append((sym, length, code))
        code, prev = code + 1, length
    return out


def main() -> None:
    data = np.concatenate([gen.canterbury_like(8 << 20, FIT_SEED, i)
                           for i in range(FIT_BYTES // (8 << 20))])
    lengths = limited_lengths(np.bincount(data, minlength=256) + 1, MAX_LEN)
    assert (2.0 ** -lengths.astype(float)).sum() == 1.0 and lengths.max() <= MAX_LEN
    lines = ["# canterbury: a static table fitted to 32 MiB of portbench.gen.canterbury_like",
             f"# (seed {FIT_SEED}, each byte's count + 1), lengths limited to {MAX_LEN} bits,",
             "# canonical codes. Written by portbench/configs/fit_canterbury.py.",
             "# Format: symbol<TAB>num_bits<TAB>pattern_hex"]
    lines += [f"{s}\t{n}\t{p:x}" for s, n, p in sorted(canonical(lengths))]
    with open(os.path.join(HERE, "canterbury.tsv"), "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()

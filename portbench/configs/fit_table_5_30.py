"""Write the ``table_5_30`` configuration: its 64 tables and its file.

    python3 portbench/configs/fit_table_5_30.py [DIR]   # rewrites table_5_30/ and table_5_30.json

BASELINE config 3 is a coder fed tables that the reference's generator tool
(``source/huffman_generator/generator.c``) emits, one per stream, with code
lengths from 5 to 30 bits. Each table here has the lengths of
``bench_suite.py``'s ``mixed_lengths_5_30`` (30 codes of 5 bits, one or two
at each length from 6 to 29, 182 of 30 bits; Kraft-complete), given to the
symbols by a permutation drawn at seed ``PERMUTATION_SEED + i`` for table
``i``; codes are canonical (by length, then by symbol, the shorter first),
as the generator emits them. The all-ones code is one of the 30-bit ones,
so padding with ones (``eos_padding`` 255) never completes a code. Each
table's file is listed in the configuration with its SHA-256.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fit_canterbury import canonical  # noqa: E402

N_TABLES = 64
PERMUTATION_SEED = 1997
NAME = "table_5_30"


def mixed_lengths_5_30() -> dict[int, int]:
    """``bench_suite.py``'s 256-symbol Kraft-complete lengths, 5..30 bits
    (copied: that module imports JAX)."""
    lens: dict[int, int] = {}
    sym = 0
    budget = 1.0
    for L in range(5, 30):  # one symbol at each length 5..29
        lens[sym] = L
        budget -= 2.0 ** -L
        sym += 1
    remaining = 256 - sym - 1  # the rest at the shallow end, greedily
    L = 5
    while remaining > 0:
        while L < 30 and 2.0 ** -L > budget - remaining * 2.0 ** -30 + 1e-18:
            L += 1
        lens[sym] = L
        budget -= 2.0 ** -L
        sym += 1
        remaining -= 1
    L_last = max(5, min(30, round(-math.log2(budget)))) if budget > 0 else 30
    while 2.0 ** -L_last > budget + 1e-15:  # the last symbol takes what is left
        L_last += 1
    lens[sym] = L_last
    return lens


def table_lines(i: int) -> list[str]:
    base = mixed_lengths_5_30()
    perm = np.random.default_rng(PERMUTATION_SEED + i).permutation(256)
    lengths = np.zeros(256, dtype=np.int64)
    for sym, length in base.items():
        lengths[perm[sym]] = length
    assert sum(2.0 ** -int(n) for n in lengths) == 1.0 and (lengths.min(), lengths.max()) == (5, 30)
    lines = [f"# {NAME} table {i:02d}: bench_suite.py's mixed_lengths_5_30 (5-30 bits) on the",
             f"# symbols permuted at seed {PERMUTATION_SEED + i}, canonical codes.",
             "# Written by portbench/configs/fit_table_5_30.py.",
             "# Format: symbol<TAB>num_bits<TAB>pattern_hex"]
    return lines + [f"{s}\t{n}\t{p:x}" for s, n, p in sorted(canonical(lengths))]


def config(tables: list[dict]) -> dict:
    return {
        "name": NAME,
        "source": "BASELINE.json:9 (BASELINE.md, Measurement configs, row 3): tables emitted by "
                  "source/huffman_generator/generator.c, one per stream, 5-30-bit codes; lengths "
                  "of bench_suite.py:48-76",
        "table": tables[0]["file"],
        "tables": tables,
        "table_note": "64 tables, each mixed_lengths_5_30's lengths (30 codes of 5 bits, one or "
                      "two at each of 6-29, 182 of 30; Kraft-complete) on its own permutation of "
                      "the symbols, canonical codes; table k is stream k's. Written by "
                      "fit_table_5_30.py; the harness's Context loads table 0, the pattern each "
                      "stream's own",
        "eos_padding": 255,
        "data": "matched_tables",
        "data_note": "object k: i.i.d. bytes over table k % 64's codes, each drawn with weight "
                     "2^-length (bench_suite.py:394-406): the short codes frequent, the 30-bit "
                     "ones rare (portbench/inputs/matched_tables.py)",
        "guarantees": [
            "every stream is bit-exact with aws-c-compression's encoder on its own table, padded "
            "with the low bits of eos_padding",
            "the block index gives every block's exact start bit and symbol count",
            "every stream decodes, with its index and its own table, to its plaintext",
        ],
        "assumed": {
            "permutation": f"table i's lengths go to the symbols by numpy's permutation at seed "
                           f"{PERMUTATION_SEED} + i",
            "tables": N_TABLES,
            "object_bytes": 16777216,
            "block_symbols": 512,
        },
    }


def main(out_dir: str = HERE) -> None:
    os.makedirs(os.path.join(out_dir, NAME), exist_ok=True)
    tables = []
    for i in range(N_TABLES):
        rel = f"{NAME}/{i:02d}.tsv"
        text = ("\n".join(table_lines(i)) + "\n").encode()
        with open(os.path.join(out_dir, rel), "wb") as f:
            f.write(text)
        tables.append({"file": rel, "sha256": hashlib.sha256(text).hexdigest()})
    with open(os.path.join(out_dir, NAME + ".json"), "w") as f:
        json.dump(config(tables), f, indent=2)
        f.write("\n")


if __name__ == "__main__":
    main(*sys.argv[1:])

"""Objects matched each to its own table: object ``index`` is i.i.d. bytes
over the codes of table ``index % len(cfg["tables"])``, each symbol drawn
with weight 2^-length (``bench_suite.py``'s ``table_5_30`` corpus), so that
the short codes are frequent and the deep ones rare.

The tables are Kraft-complete, so a uniform 32-bit number falls in exactly
one code's range of windows, and that code's symbol has probability
2^-length exactly: a draw is a decode of random bits. The top 12 bits
settle it unless they begin a longer code; those few are searched.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from portbench import gen
from portbench.reference import huffman_np as R

LOOKUP_BITS = 12


def table_paths(cfg: dict) -> list[str]:
    """Each stream's table file, in stream order (``cfg["tables"]``, beside
    the configuration's file as its ``table`` is)."""
    here = cfg["table_path"][: len(cfg["table_path"]) - len(cfg["table"])]
    return [os.path.join(here, t["file"]) for t in cfg["tables"]]


@functools.lru_cache(maxsize=None)
def _sampler(path: str) -> tuple:
    t = R.parse_tsv(path)
    if int(t.spans.sum()) != 1 << 32:
        raise ValueError(f"{path}: the table is not Kraft-complete")
    top = np.searchsorted(t.lefts, np.arange(1 << LOOKUP_BITS, dtype=np.uint64)
                          << np.uint64(32 - LOOKUP_BITS), side="right") - 1
    first = np.where(t.code_lens[top] <= LOOKUP_BITS, t.symbols[top].astype(np.int16), -1)
    return t, first


def make(n: int, seed: int, index: int, cfg: dict) -> np.ndarray:
    """``n`` bytes of object ``index``."""
    paths = table_paths(cfg)
    t, first = _sampler(paths[index % len(paths)])
    u = gen.rng(seed, index, 0).integers(0, 1 << 32, size=n, dtype=np.uint32)
    out = first[u >> (32 - LOOKUP_BITS)]
    deep = np.flatnonzero(out < 0)
    out[deep] = t.symbols[np.searchsorted(t.lefts, u[deep].astype(np.uint64), side="right") - 1]
    return out.astype(np.uint8)

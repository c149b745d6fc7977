"""A corpus matched to its table: i.i.d. bytes, each coded symbol drawn
with weight 2^-length (``bench_suite.py``'s ``table_5_30`` corpus), so
that short codes are frequent and the deep ones rare."""

from __future__ import annotations

import numpy as np

from portbench import gen
from portbench.reference import huffman_np as R


def _symbols(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """The coded symbols and the cumulative share of each."""
    t = R.parse_tsv(cfg["table_path"])
    syms = np.flatnonzero(t.lengths)
    w = np.exp2(-t.lengths[syms].astype(np.float64))
    return syms.astype(np.uint8), np.cumsum(w / w.sum())


def _draw(n: int, g: np.random.Generator, cfg: dict) -> np.ndarray:
    syms, cdf = _symbols(cfg)
    return syms[np.minimum(np.searchsorted(cdf, g.random(n), side="right"), syms.size - 1)]


def make(n: int, seed: int, index: int, cfg: dict) -> np.ndarray:
    """``n`` bytes of the matched corpus."""
    return _draw(n, gen.rng(seed, index, 0), cfg)


def fields(count: int, seed: int, index: int, cfg: dict) -> list[bytes]:
    """``count`` strings of 1-64 bytes of the matched corpus."""
    g = gen.rng(seed, index, 1)
    lens = g.integers(1, 65, size=count)
    data = _draw(int(lens.sum()), g, cfg).tobytes()
    offs = np.concatenate([[0], np.cumsum(lens)]).tolist()
    return [data[a:b] for a, b in zip(offs[:-1], offs[1:])]

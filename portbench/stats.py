"""The arithmetic of the end-to-end metrics and of the bounds.

    python3 portbench/stats.py RESULTS...   # spread of each metric over runs

A percentile is numpy's default (linear between the two nearest ranks) over
every sample of the window; a rate is all the work over all the window.
A spread is the distance between the first and the third quartile, as
``statistics.quantiles(values, n=4)`` gives them, over the median: the
measure a bound is set from.
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def rate(amount: float, seconds: float) -> float:
    return amount / seconds


def spread(values) -> float:
    """(Q3 - Q1) / median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def _lines(paths):
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.startswith("{") and '"metrics"' in line:
                    yield json.loads(line)


def main(paths) -> None:
    """Print each metric's runs, median and spread over the result lines in
    the files."""
    runs = {}
    for r in _lines(paths):
        for name, m in r["metrics"].items():
            runs.setdefault(name, []).append(m["value"])
    for name, vals in runs.items():
        sp = spread(vals) if len(vals) >= 2 else float("nan")
        print(f"{name}: n={len(vals)} median={statistics.median(vals)!r} spread={sp!r} "
              f"runs={vals}")


if __name__ == "__main__":
    main(sys.argv[1:])

"""Arithmetic that several metric readers share (``metrics/<name>.py``).

A reader takes the run's observations (``harness.run``'s ``obs``) and
returns its number, or None where the run holds nothing to read: then the
metric is left out of the line. None of these returns 0 for a share of a
peak that was not measured.
"""

from __future__ import annotations

from . import roofline

ENCODE_SPANS = ("encode_with_index", "encode_chunk")
DECODE_SPANS = ("decode_indexed", "decode", "decode_chunk")


def idle_pct(obs: dict):
    tr = obs.get("trace")
    if not tr or not tr.get("device_events"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def stage_roofline(obs: dict, spans: tuple):
    """The stage's bytes in the traced stretch at the card's bandwidth,
    over the device time (kernels and fills, not host copies) inside its
    spans, in %."""
    tr = obs.get("trace")
    if not tr:
        return None
    nbytes = sum(obs["trace_bytes"].get(s, 0) for s in spans)
    dev = sum(tr["device_s_by_span"].get(s, 0.0) for s in spans)
    return roofline.roofline_pct(nbytes, dev)


def launches(obs: dict, *keys: str) -> int:
    return sum(obs["counters"].get(k, 0) for k in keys)


def calls(obs: dict, spans: tuple = ()) -> int:
    return sum(n for s, n in obs["calls"].items() if not spans or s in spans)


def syncs(obs: dict):
    return None if obs.get("syncs") is None else sum(obs["syncs"].values())

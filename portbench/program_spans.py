"""The program's own spans and counters, read beside the harness's.

``tpu_huffman_torch.metrics`` puts spans inside the program (names that
start with ``tt.``) and keeps one counter registry. With its spans on
(``metrics.enable(True)``) and a profiler running, each span is a
``record_function`` range in the Chrome trace, on the device events'
clock. This module reads them; nothing in the harness calls it yet (see
PERF.md, Open questions, for the edits that wire it in):

- :func:`harness_events` drops the program's ranges from a trace's
  events, so that ``trace.read_trace`` gives the readings it gives for a
  program without spans: its ``span_at`` takes the span that started last,
  so a range inside a public call would take that call's device time and
  idle time from it;
- :func:`read` splits the stretch's device and idle time by the innermost
  program span open at each interval's middle (the spans nest on one
  thread), or ``outside`` where none is;
- :class:`Program` reads the registry and the span totals (host
  nanoseconds from the program's clock, with or without a profiler) before
  and after the window;
- :func:`idle_pct`, :func:`staging_host_ms_per_call` and
  :func:`copy_mb_per_call` are the per-layer readings made from them.
"""

from __future__ import annotations

import bisect
import sys
from collections import Counter

from . import trace

PREFIX = "tt."
OUTSIDE = "outside"
# The program's span layers by name prefix; every other ``tt.`` span is the
# public calls' and their glue's (``tt.encode.*``, ``tt.decode.*``,
# ``tt.walk``, the public entries, ``tt.setup.*``).
LAYERS = {"staging": ("tt.stage.",), "stitch": ("tt.selfsync.",)}


def _is_program(e: dict) -> bool:
    return e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)


def harness_events(events: list) -> list:
    """The events without the program's ranges."""
    return [e for e in events if not _is_program(e)]


def innermost(spans: list):
    """``at(t)``: the name of the innermost of the nesting ``spans`` (t0,
    t1, name) open at t, or ``OUTSIDE``."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]
    parent, open_ = [], []
    for i, (a, _b, _n) in enumerate(spans):
        while open_ and spans[open_[-1]][1] < a:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)

    def at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][1] < t:
            i = parent[i]
        return spans[i][2] if i >= 0 else OUTSIDE

    return at


def read(events: list) -> dict:
    """Over the harness's window: the program spans begun in it, and the
    device time and idle time by the innermost program span open at each
    interval's middle (seconds). Busy and idle intervals are
    ``trace.read_trace``'s, so the idle times add up to its window less
    its busy time."""
    window, spans, dev = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat == "user_annotation" and name == trace.WINDOW_SPAN:
            window = (t0, t1)
        elif _is_program(e):
            spans.append((t0, t1, name))
        elif cat in trace.DEVICE_CATS:
            dev.append((t0, t1))
    if window is None:
        return {}
    w0, w1 = window
    at = innermost(spans)
    device, idle, inside = Counter(), Counter(), []
    for t0, t1 in dev:
        a, b = max(t0, w0), min(t1, w1)
        if b > a:
            inside.append((a, b))
            device[at((a + b) / 2)] += (b - a) * 1e-6
    prev = w0
    for a, b in trace._merge(inside) + [[w1, w1]]:
        if a > prev:
            idle[at((prev + a) / 2)] += (a - prev) * 1e-6
        prev = max(prev, b)
    return {"window_s": (w1 - w0) * 1e-6,
            "program_spans": sum(w0 <= t0 <= w1 for t0, _t1, _n in spans),
            "device_s_by_program_span": dict(device), "idle_s_by_program_span": dict(idle)}


def layer_of(name: str) -> str:
    """``staging``, ``stitch``, ``calls`` (every other program span) or
    ``outside``."""
    if name == OUTSIDE:
        return OUTSIDE
    return next((k for k, p in LAYERS.items() if name.startswith(p)), "calls")


def idle_pct(tr: dict | None, layer: str):
    """Idle time under the layer's innermost spans, in % of the window;
    None without program spans in the trace."""
    if not tr or not tr.get("program_spans"):
        return None
    idle = sum(s for n, s in tr["idle_s_by_program_span"].items() if layer_of(n) == layer)
    return 100.0 * idle / tr["window_s"]


class Program:
    """The program's counter registry and span totals over the window, its
    spans on for the window (``metrics.enable``); :meth:`mark` splits the
    window where the profiler starts. A program without a registry reads
    as None."""

    def __init__(self, package: str):
        self.m = sys.modules.get(package + ".metrics")
        self.readable = all(hasattr(self.m, f) for f in ("counters_snapshot", "span_totals"))
        self._was = None
        self._snaps = []

    def _snap(self):
        return (self.m.counters_snapshot(), self.m.span_totals()) if self.readable else None

    def start(self) -> None:
        if hasattr(self.m, "enable"):
            self._was = self.m.enabled
            self.m.enable(True)
        self._snaps = [self._snap()]

    def mark(self) -> None:
        self._snaps.append(self._snap())

    def stop(self):
        """``{"window": d, "traced": d}``: d = ``{"counters": {...}, "spans":
        {name: {"count", "ns", "self_ns"}}}``, the change over the window
        and over its stretch after :meth:`mark`; None without a registry."""
        self._snaps.append(self._snap())
        if self._was is not None:
            self.m.enable(self._was)
        if not self.readable:
            return None
        first, last = self._snaps[0], self._snaps[-1]
        return {"window": _delta(first, last), "traced": _delta(self._snaps[-2], last)}


def _delta(a, b) -> dict:
    spans = {}
    for name, t in b[1].items():
        d = {k: v - a[1].get(name, {}).get(k, 0) for k, v in t.items()}
        if d["count"]:
            spans[name] = d
    return {"counters": trace.counter_deltas(a[0], b[0]), "spans": spans}


def calls(prog: dict | None, part: str = "window"):
    """The program's public calls (its ``calls`` counters), or None."""
    if not prog:
        return None
    return sum(v for k, v in prog[part]["counters"].items() if k.startswith("calls."))


def staging_host_ms_per_call(prog: dict | None, part: str = "window"):
    """Host ms in ``tt.stage.*`` spans, exclusive, per public call."""
    n = calls(prog, part)
    if not n:
        return None
    spans = prog[part]["spans"]
    return sum(t["self_ns"] for k, t in spans.items() if k.startswith(LAYERS["staging"])) / n / 1e6


def copy_mb_per_call(prog: dict | None, part: str = "window"):
    """Bytes copied both ways per public call, in 10^6 B."""
    n = calls(prog, part)
    if not n:
        return None
    c = prog[part]["counters"]
    return (c.get("copies.h2d_bytes", 0) + c.get("copies.d2h_bytes", 0)) / n / 1e6

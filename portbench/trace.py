"""What a traced stretch of the window records, and what the per-layer
metrics read from it.

The profiler (``torch.profiler``, CPU and CUDA activity) records the
harness's own spans (``record_function`` around each call into the
program, and ``harness.window`` around the stretch) beside the device's
kernels, copies and fills. Its Chrome trace is read once the stretch ends:
device time is the union of the device intervals inside the window; a
device interval belongs to the span whose host interval holds its middle
(every public call ends in a download, so its device work ends inside
it); an idle gap belongs to the span open at its middle, or ``harness``.

Host syncs are counted per call from ``torch.cuda.set_sync_debug_mode``'s
warnings; the program's launch and outcome counters are read before and
after the window: every module-level dict of ints named ``launches``,
``outcomes`` or ``encode_outcomes`` in the program's modules.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from collections import Counter

WINDOW_SPAN = "harness.window"
COUNTER_DICTS = ("launches", "outcomes", "encode_outcomes")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_counters(package: str) -> dict:
    """``{"<module>.<dict>.<key>": value}`` of the program's counters."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == package or name.startswith(package + ".")):
            continue
        for attr in COUNTER_DICTS:
            d = getattr(mod, attr, None)
            if isinstance(d, dict) and all(isinstance(v, int) for v in d.values()):
                short = name[len(package) + 1:] if name != package else ""
                for k, v in d.items():
                    out[f"{short}.{attr}.{k}".lstrip(".")] = v
    return out


def counter_deltas(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


class Profile:
    """A profiler over one stretch of the window."""

    def __init__(self, torch):
        self.torch = torch
        self._prof = None
        self._span = None

    def warm(self) -> None:
        """Start and stop the profiler once, so that its first start (which
        loads the tracing library) falls in set-up."""
        self.start()
        self.stop()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> dict:
        """End the stretch; returns :func:`read_trace` of it."""
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        return read_trace(events)


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(events: list) -> dict:
    """The stretch's window, device busy time, device time by span and by
    name, copy time, and idle time by the span the host was in (seconds)."""
    window = None
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat == "user_annotation":
            if name == WINDOW_SPAN:
                window = (t0, t1)
            else:
                spans.append((t0, t1, name))
        elif cat in DEVICE_CATS:
            dev.append((t0, t1, cat, name))
    if window is None:
        return {}
    w0, w1 = window
    spans.sort()
    starts = [s[0] for s in spans]

    def span_at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else "harness"

    by_span, by_name = Counter(), Counter()
    copy_s = 0.0
    inside = []
    for t0, t1, cat, name in dev:
        a, b = max(t0, w0), min(t1, w1)
        if b <= a:
            continue
        inside.append((a, b))
        by_name[name] += (b - a) * 1e-6
        if cat == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name):
            copy_s += (b - a) * 1e-6
        else:
            by_span[span_at((a + b) / 2)] += (b - a) * 1e-6
    busy = _merge(inside)
    idle, prev = Counter(), w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            idle[span_at((prev + a) / 2)] += (a - prev) * 1e-6
        prev = max(prev, b)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "copy_s": copy_s,
        "device_s_by_span": dict(by_span),
        "device_s_by_name": dict(by_name),
        "idle_s_by_span": dict(idle),
        "device_events": len(inside),
    }


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing: the ``breakdown`` of a traced run's line."""
    ops = sorted(tr.get("device_s_by_name", {}).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr.get("idle_s_by_span", {}).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}

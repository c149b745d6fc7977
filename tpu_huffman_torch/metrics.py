"""The port's tracing layer: spans, one counter registry, call counters and
a profiler hook (ports ``tpu_huffman/metrics.py``).

Spans. ``span(name)`` is a context manager placed where the port works:
the public calls (``tt.encode``, ``tt.stream.decode_chunk``, ...), the
host staging (``tt.stage.upload``, ``tt.stage.download``), the glue of
each stage (``tt.encode.count``, ``tt.decode.chain``, ``tt.walk``,
``tt.selfsync.*``) and the set-up (``tt.setup.*``). Off (the default) it
tests one flag and returns one shared no-op context: no clock reading, no
allocation, no torch call. On (``enable(True)``) each span adds its count,
its host nanoseconds (``time.perf_counter_ns``) and its exclusive
nanoseconds (less those of the spans opened inside it on the same thread)
to :func:`span_totals`; and while a ``torch.profiler`` profile runs, it
also opens a ``record_function`` range of its name, which the Chrome trace
holds on the same timeline as the device's kernels and copies.

Counters. Integer counters are always on: each is a module-level dict of
ints, registered here by reference under a dotted group name
(:func:`register`), and :func:`counters_snapshot` reads them all at once.
This module holds ``copies`` (host-to-device and device-to-host copies
and their bytes, counted at the staging sites), ``setup`` (kernel-library
builds and loads) and ``calls`` (one key a public entry); the kernels'
modules register their ``launches`` and ``outcomes`` (``ops.encode``'s
count the ``DeviceTable`` set-ups).

``Counters`` is the JAX package's call counter set, kept with its fields:
``encode`` and ``decode`` update it through :func:`record` when counting
is on, timed by their ``tt.*`` spans. ``trace`` writes a Chrome trace of
the enclosed work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

from torch.autograd import profiler as _autograd_profiler


@dataclasses.dataclass
class Counters:
    encode_calls: int = 0
    decode_calls: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    blocks: int = 0
    encode_seconds: float = 0.0
    decode_seconds: float = 0.0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        self.__dict__.update(Counters().__dict__)


_lock = threading.Lock()
counters = Counters()
enabled = False

_registry: dict[str, dict] = {}


def register(group: str, counts: dict) -> dict:
    """Add a module's dict of int counters to the registry under ``group``
    (by reference: the module keeps updating its own dict). Returns it."""
    _registry[group] = counts
    return counts


copies = register("copies", {"h2d": 0, "h2d_bytes": 0, "d2h": 0, "d2h_bytes": 0})
setup = register("setup", {"kernel_builds": 0, "kernel_loads": 0})
calls = register("calls", {"encode": 0, "encode_with_index": 0, "decode": 0,
                           "decode_indexed": 0, "stream.encode_chunk": 0,
                           "stream.decode_chunk": 0})


def counters_snapshot() -> dict:
    """Every registered counter, ``{"<group>.<key>": value}``."""
    return {f"{g}.{k}": v for g, d in list(_registry.items()) for k, v in list(d.items())}


def enable(flag: bool = True) -> None:
    """Turn spans and call counting on/off (off by default: a span is then
    one flag test)."""
    global enabled
    enabled = flag


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()
_thread_totals: list[dict] = []  # each thread's {name: [count, ns, self ns]}


class _Thread(threading.local):
    def __init__(self):
        self.stack = []
        self.totals = {}
        with _lock:
            _thread_totals.append(self.totals)


_here = _Thread()


class _Span:
    __slots__ = ("name", "ns", "_t0", "_inner", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        self._inner = 0
        _here.stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = self.ns = time.perf_counter_ns() - self._t0
        stack = _here.stack
        stack.pop()
        if stack:
            stack[-1]._inner += ns
        tot = _here.totals.get(self.name)
        if tot is None:
            tot = _here.totals[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += ns
        tot[2] += ns - self._inner
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A span of the port's work named ``name`` (``tt.<layer>...``): the
    shared no-op while tracing is off, and inside a span of the same name
    (that span holds its time)."""
    if not enabled:
        return _OFF
    stack = _here.stack
    if stack and stack[-1].name == name:
        return _OFF
    return _Span(name)


def span_totals() -> dict:
    """``{name: {"count", "ns", "self_ns"}}`` of every span closed while
    tracing was on, over all threads."""
    out = {}
    for totals in list(_thread_totals):
        for name, (n, ns, self_ns) in list(totals.items()):
            t = out.setdefault(name, {"count": 0, "ns": 0, "self_ns": 0})
            t["count"] += n
            t["ns"] += ns
            t["self_ns"] += self_ns
    return out


def h2d(nbytes: int):
    """Count one host-to-device copy of ``nbytes``; the upload's span."""
    copies["h2d"] += 1
    copies["h2d_bytes"] += nbytes
    return span("tt.stage.upload")


def d2h(nbytes: int):
    """Count one device-to-host read of ``nbytes``; the download's span."""
    copies["d2h"] += 1
    copies["d2h_bytes"] += nbytes
    return span("tt.stage.download")


@contextlib.contextmanager
def _count(kind: str, n_in: int):
    out_len = [0]
    with span("tt." + kind) as s:
        yield out_len
    with _lock:
        if kind == "encode":
            counters.encode_calls += 1
            counters.encode_seconds += s.ns * 1e-9
        else:
            counters.decode_calls += 1
            counters.decode_seconds += s.ns * 1e-9
        counters.bytes_in += n_in
        counters.bytes_out += out_len[0]


def record(kind: str, n_in: int):
    """Used by the public ``encode`` and ``decode``: their ``tt.<kind>``
    span, and a context whose value is a one-element list the caller sets
    to the output length."""
    if not enabled:
        return contextlib.nullcontext([0])
    return _count(kind, n_in)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed codec work with ``torch.profiler`` (CPU
    activity, plus CUDA when a card is there) and write a Chrome trace,
    ``trace_<pid>_<ns>.json``, into ``log_dir``. With tracing on
    (:func:`enable`) it holds the port's ``tt.*`` ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )

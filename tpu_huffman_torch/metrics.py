"""Thin observability: call counters and a profiler hook (ports
``tpu_huffman/metrics.py``).

A process-local counter set that the one-shot ``encode`` and ``decode``
update when counting is on (off by default), and a context manager around
``torch.profiler`` that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time


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


def enable(flag: bool = True) -> None:
    """Turn call counting on/off (off by default: zero overhead)."""
    global enabled
    enabled = flag


@contextlib.contextmanager
def _count(kind: str, n_in: int):
    t0 = time.perf_counter()
    out_len = [0]
    yield out_len
    dt = time.perf_counter() - t0
    with _lock:
        if kind == "encode":
            counters.encode_calls += 1
            counters.encode_seconds += dt
        else:
            counters.decode_calls += 1
            counters.decode_seconds += dt
        counters.bytes_in += n_in
        counters.bytes_out += out_len[0]


def record(kind: str, n_in: int):
    """Used by the public ``encode`` and ``decode``: a context whose value
    is a one-element list the caller sets to the output length."""
    if not enabled:
        return contextlib.nullcontext([0])
    return _count(kind, n_in)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed codec work with ``torch.profiler`` (CPU
    activity, plus CUDA when a card is there) and write a Chrome trace,
    ``trace_<pid>_<ns>.json``, into ``log_dir``."""
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

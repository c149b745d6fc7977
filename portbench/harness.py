"""One run of one cell: set-up, the measured window, the check, the line.

The cell's entry in ``BENCHMARK.json`` names its configuration
(``portbench/configs/<config>.json``, with its table file beside it) and
its traffic mix (``portbench/traffic/<traffic>.json``); each metric is
read by ``portbench/metrics/<name>.py`` (:func:`reader_path`). The
configuration's ``data`` names its inputs: an entry of ``gen.DATA``, or a
file ``portbench/inputs/<data>.py`` with ``make(n, seed, index, cfg)`` and,
for strings, ``fields(count, seed, index, cfg)`` (``gen.inputs``). The
mix's ``pattern`` names its calls: an entry of ``patterns.PATTERNS``, or a
file ``portbench/calls/<pattern>.py`` with a class ``Pattern(ctx)``
(``patterns.pattern``); its ``control`` names one of ``codecs.CONTROLS``.
:func:`resolve` finds every name before set-up, and refuses one that is
not ``[A-Za-z0-9_]+`` or is found in both places or in neither. A cell,
mix, configuration or metric is added by adding those files and entries.

Set-up is everything from the process's start to the window's first
call: imports, the kernels' build or load, the inputs from the seed, a
pass over every input the window will use. The window then runs whole
requests back to back until ``seconds`` have passed, and ends with the
last one. With ``trace``, the last ``TRACE_SECONDS`` of it run under the
profiler, and every call counts its host syncs. Once it has closed, the
peak memory is read, the program's state is freed, and the answers are
checked against the reference.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import resource
import sys
import time
import warnings
from array import array
from collections import Counter

import numpy as np

from . import codecs, gen, named, patterns, trace
from .reference import huffman_np as R

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "tpu_huffman_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_huffman")
TRACE_SECONDS = 3.0


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(spec: dict, workload: str, root: str = ROOT) -> dict:
    """The cell, its configuration and mix, its inputs and pattern, and
    the metrics it reports."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    cfg["table_path"] = os.path.join(os.path.dirname(os.path.join(root, conf["file"])),
                                     cfg["table"])
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    if mix.get("control") not in codecs.CONTROLS:
        raise ValueError(f"mix {cell['traffic']!r}: control {mix.get('control')!r} is not one "
                         f"of codecs.CONTROLS {codecs.CONTROLS}")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "cfg": cfg, "mix": mix, "inputs": gen.inputs(cfg),
            "pattern": patterns.pattern(mix["pattern"]),
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def reader_path(name: str) -> str:
    """``portbench/metrics/<name>.py``; a quantity split by cells,
    ``<quantity>.<part>``, without a file of its own is read by
    ``<quantity>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    return path


def reader(name: str):
    """The ``read(obs)`` of the metric's file (:func:`reader_path`)."""
    return named.load(reader_path(name), "portbench_metric_" + name.replace(".", "_")).read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def host_cpu_s() -> float:
    """This process's user and system CPU seconds so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def host_loop_ms(repeats: int = 3) -> float:
    """The best of ``repeats`` runs of a fixed Python loop, in ms: the
    host's speed for one thread, read after the window so that runs whose
    rates differ can be told apart by it."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        s = 0
        for k in range(1_000_000):
            s += k
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


class Recorder:
    """Times each public call and names its span; with ``trace``, counts
    each call's host syncs, and while ``traced`` wraps it in a profiler
    range and adds up the bytes its stage needs."""

    def __init__(self, torch, trace_on: bool):
        self.torch = torch
        self.count_syncs = trace_on and torch.cuda.is_available()
        self.traced = False
        self.reset()

    def reset(self) -> None:
        self.call_s = array("d")
        self.calls, self.syncs = Counter(), Counter()
        self.trace_calls, self.trace_bytes = Counter(), Counter()
        self._caught = None

    def call(self, span: str, fn, *args, **kw):
        if self.traced:
            from torch.profiler import record_function

            with record_function(span):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                dt = time.perf_counter() - t0
            self.trace_calls[span] += 1
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            dt = time.perf_counter() - t0
        self.call_s.append(dt)
        self.calls[span] += 1
        if self._caught:
            self.syncs[span] += sum("synchroniz" in str(w.message) for w in self._caught)
            del self._caught[:]
        return out

    def work(self, span: str, nbytes: int) -> None:
        if self.traced:
            self.trace_bytes[span] += nbytes

    @contextlib.contextmanager
    def syncs_on(self):
        """A context in which every host sync warns, and :meth:`call`
        counts the warnings."""
        if not self.count_syncs:
            yield
            return
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            self._caught = caught
            self.torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                self.torch.cuda.set_sync_debug_mode("default")
                self._caught = None


def run(workload: str, seed: int, seconds: float, trace_on: bool, t_start: float,
        device: str = "cuda", codec=None, mix_override: dict | None = None,
        root: str = ROOT, warm: bool = True) -> tuple[dict, list]:
    """One run. Returns (the result line's object, the checks). ``warm``
    False skips the pass over the inputs (for the control, which has no
    kernels to load)."""
    import torch

    torch.set_num_threads(1)
    r = resolve(load_spec(root), workload, root)
    cfg, mix = r["cfg"], {**r["mix"], **(mix_override or {})}
    dev = torch.device(device)
    if codec is None:
        from .codecs import PortCodec

        import tpu_huffman_torch as tt

        codec = PortCodec(tt, dev)
    rec = Recorder(torch, trace_on)
    ctx = patterns.Context(codec, codec.load_table(cfg["table_path"]),
                           R.parse_tsv(cfg["table_path"]), cfg, mix, seed, rec)
    pattern = r["pattern"](ctx)
    if warm:
        pattern.warm(rec)
    prof = trace.Profile(torch) if trace_on else None
    if prof:
        prof.warm()
    rec.reset()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counters0 = trace.read_counters(PROGRAM)
    gc.collect()
    gc.freeze()
    request_s, plain, failed, errors = array("d"), 0, 0, []
    tr, i = None, 0
    setup_s = time.time() - t_start - ctx.ref_s
    cpu0 = host_cpu_s()
    w0 = time.perf_counter()
    with rec.syncs_on():
        while True:
            if prof and not rec.traced and time.perf_counter() - w0 >= seconds - TRACE_SECONDS:
                prof.start()
                rec.traced = True
            t0 = time.perf_counter()
            try:
                plain += pattern.request(i)
            except Exception as e:  # a request that raises is a failed one; the run goes on
                failed += 1
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            request_s.append(time.perf_counter() - t0)
            i += 1
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
        cpu_s = host_cpu_s() - cpu0
        if rec.traced:
            rec.traced = False
            tr = prof.stop()
    gc.unfreeze()
    host = {"reference_setup_s": ctx.ref_s, "cpu_s": cpu_s, "window_s": window_s,
            "loop_ms": host_loop_ms()}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counters = trace.counter_deltas(counters0, trace.read_counters(PROGRAM))
    pattern.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, checked = pattern.check()
    checks.append(("failed", failed, 0))
    for e in errors[:5]:
        print(e, file=sys.stderr)
    obs = {"cell": workload, "setup_s": setup_s, "window_s": window_s, "requests": i,
           "plain_bytes": plain, "request_s": np.frombuffer(request_s),
           "call_s": np.frombuffer(rec.call_s), "calls": dict(rec.calls),
           "syncs": dict(rec.syncs) if rec.count_syncs else None, "counters": counters,
           "trace": tr, "trace_calls": dict(rec.trace_calls),
           "trace_bytes": dict(rec.trace_bytes)}
    metrics = {}
    for m in r["per_layer"] if trace_on else r["end_to_end"]:
        v = reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _n, v, lim in checks), "attempted": i,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace_on and tr:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = trace.breakdown(tr)
    result["host"] = host
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    result["checked"] = checked
    result["counters"] = {k: v for k, v in counters.items() if v}
    return result, checks


def main(args, t_start: float) -> int:
    spec = load_spec()
    cells = {c["name"]: c for c in spec["workloads"]}
    chips = cells[args.workload]["chips"] if args.workload in cells else 1
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s): torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, checks = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    line = json.dumps({k: v for k, v in result.items() if k not in ("checked", "counters")})
    if args.trace:
        print(f"counters: {json.dumps(result['counters'])}", file=sys.stderr)
    print(f"host: {json.dumps(result['host'])}", file=sys.stderr)
    print(f"checked: {json.dumps(result['checked'])}", file=sys.stderr)
    for n, v, lim in checks:
        print(f"check {n} {v} limit {lim}", file=sys.stderr)
    print(line, flush=True)
    return 0

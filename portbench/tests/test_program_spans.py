"""CPU tests of ``portbench/program_spans.py``: the program's spans read
beside the harness's, without moving any reading the harness makes.

    python -m pytest portbench/tests/test_program_spans.py
"""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import tpu_huffman_torch as tt  # noqa: E402
from portbench import program_spans as ps  # noqa: E402
from portbench import trace  # noqa: E402

LAYERS = ("staging", "stitch", "calls", "outside")


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def ann(name, ts, dur):
    return ev("user_annotation", name, ts, dur)


# One window of 1000 us: two harness calls (100-500, 600-900), device work,
# gaps in and out of the calls.
HARNESS = [ann(trace.WINDOW_SPAN, 0, 1000),
           ann("decode", 100, 400), ann("decode", 600, 300),
           ev("kernel", "k1", 200, 100), ev("kernel", "k2", 250, 100),
           ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 400, 50),
           ev("gpu_memset", "Memset (Device)", 700, 10), ev("kernel", "k1", 990, 100),
           ev("cpu_op", "aten::add", 100, 5)]
# The program's spans inside the calls, nested. Gaps: 0-200 (middle 100: the
# upload, which starts with tt.decode), 350-400 (375: the stitch, its pass
# closed and its download not yet open), 450-700 (575: between the calls),
# 710-990 (850: tt.walk, before its download).
PROGRAM = [ann("tt.decode", 100, 395),
           ann("tt.stage.upload", 100, 50),
           ann("tt.selfsync.stitch", 300, 190),
           ann("tt.selfsync.pass", 340, 20),
           ann("tt.stage.download", 380, 70),
           ann("tt.decode", 605, 290),
           ann("tt.walk", 610, 285),
           ann("tt.stage.download", 880, 80)]


def _harness_readings(tr):
    return {k: tr[k] for k in ("window_s", "busy_s", "copy_s", "device_s_by_span",
                               "idle_s_by_span", "device_events")}


def test_the_harness_readings_do_not_move_with_the_programs_spans_filtered_out():
    plain = trace.read_trace(HARNESS)
    filtered = trace.read_trace(ps.harness_events(HARNESS + PROGRAM))
    assert _harness_readings(filtered) == _harness_readings(plain)
    assert trace.breakdown(filtered) == trace.breakdown(plain)


def test_unfiltered_the_harness_reader_would_give_the_calls_time_to_the_programs_spans():
    moved = trace.read_trace(HARNESS + PROGRAM)
    assert any(k.startswith("tt.") for k in moved["idle_s_by_span"])
    assert moved["idle_s_by_span"] != trace.read_trace(HARNESS)["idle_s_by_span"]


def test_each_gap_goes_to_the_innermost_program_span():
    p = ps.read(HARNESS + PROGRAM)
    us = {k: round(v * 1e6, 6) for k, v in p["idle_s_by_program_span"].items()}
    assert us == {"tt.stage.upload": 200, "tt.selfsync.stitch": 50, "outside": 250,
                  "tt.walk": 280}
    assert p["program_spans"] == len(PROGRAM)
    dev = {k: round(v * 1e6, 6) for k, v in p["device_s_by_program_span"].items()}
    # middles: 250 (tt.decode, its upload closed), 300 (the stitch), 425 (the
    # download), 705 (tt.walk), 995 (outside)
    assert dev == {"tt.decode": 100, "tt.selfsync.stitch": 100, "tt.stage.download": 50,
                   "tt.walk": 10, "outside": 10}


def test_the_innermost_span_walks_up_past_closed_siblings():
    at = ps.innermost([(0, 100, "a"), (10, 20, "b"), (30, 40, "c"), (35, 38, "d"),
                       (50, 90, "e")])
    assert [at(t) for t in (5, 15, 25, 36, 39, 45, 60, 95, 100, 101, -1)] == [
        "a", "b", "a", "d", "c", "a", "e", "a", "a", "outside", "outside"]


def test_the_layers_and_outside_add_up_to_the_idle_share():
    events = HARNESS + PROGRAM
    tr = trace.read_trace(ps.harness_events(events))
    tr.update(ps.read(events))
    shares = {layer: ps.idle_pct(tr, layer) for layer in LAYERS}
    idle = 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
    assert sum(shares.values()) == pytest.approx(idle, abs=1e-9)
    assert shares == pytest.approx({"staging": 20.0, "stitch": 5.0, "calls": 28.0,
                                    "outside": 25.0})


@pytest.mark.parametrize("name,layer", [("tt.stage.upload", "staging"),
                                        ("tt.stage.download", "staging"),
                                        ("tt.selfsync.fixpoint", "stitch"),
                                        ("tt.selfsync.pass", "stitch"),
                                        ("tt.encode.count", "calls"), ("tt.walk", "calls"),
                                        ("tt.decode_indexed", "calls"),
                                        ("tt.setup.table", "calls"), ("outside", "outside")])
def test_each_span_belongs_to_one_layer(name, layer):
    assert ps.layer_of(name) == layer


def test_nothing_to_read_is_none_not_zero():
    assert ps.read(PROGRAM) == {}  # no window
    tr = trace.read_trace(HARNESS)
    tr.update(ps.read(HARNESS))  # a program without spans
    for layer in LAYERS:
        assert ps.idle_pct(tr, layer) is None and ps.idle_pct(None, layer) is None
    for f in (ps.calls, ps.staging_host_ms_per_call, ps.copy_mb_per_call):
        assert f(None) is None
    empty = {"window": {"counters": {"calls.decode": 0}, "spans": {}}}
    assert ps.staging_host_ms_per_call(empty) is None and ps.copy_mb_per_call(empty) is None


def test_the_per_call_readings():
    prog = {"window": {"counters": {"calls.decode": 3, "calls.encode": 1, "copies.h2d_bytes": 2e6,
                                    "copies.d2h_bytes": 6e6, "copies.d2h": 9},
                       "spans": {"tt.stage.upload": {"count": 4, "ns": 9e6, "self_ns": 8e6},
                                 "tt.stage.download": {"count": 9, "ns": 4e6, "self_ns": 4e6},
                                 "tt.decode": {"count": 3, "ns": 5e7, "self_ns": 1e6}}}}
    assert ps.calls(prog) == 4
    assert ps.staging_host_ms_per_call(prog) == pytest.approx(3.0)
    assert ps.copy_mb_per_call(prog) == pytest.approx(2.0)


def test_the_program_is_read_over_a_window_and_left_as_it_was():
    from tpu_huffman_torch import metrics

    t = tt.load_static_test_table()
    p = ps.Program("tpu_huffman_torch")
    assert p.readable and not metrics.enabled
    p.start()
    assert metrics.enabled
    enc = tt.encode(b"a window of calls", t, device="cpu")
    p.mark()
    tt.decode(enc, t, device="cpu")
    got = p.stop()
    assert not metrics.enabled
    w, traced = got["window"], got["traced"]
    assert ps.calls(got) == 2 and ps.calls(got, "traced") == 1
    assert w["spans"]["tt.encode"]["count"] == 1 and "tt.encode" not in traced["spans"]
    assert traced["spans"]["tt.decode"]["count"] == 1
    assert ps.copy_mb_per_call(got) > 0 and ps.staging_host_ms_per_call(got) > 0


def test_a_program_without_a_registry_reads_as_none(monkeypatch):
    import types

    fake = types.ModuleType("fake.metrics")
    fake.enabled = False
    fake.enable = lambda flag=True: setattr(fake, "enabled", flag)
    monkeypatch.setitem(sys.modules, "fake.metrics", fake)
    p = ps.Program("fake")
    p.start()
    assert fake.enabled
    assert p.stop() is None and not fake.enabled
    q = ps.Program("not_loaded")
    q.start()
    assert q.stop() is None

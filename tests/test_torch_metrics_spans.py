"""The port's tracing layer (``tpu_huffman_torch.metrics``): spans, the
counter registry, and the ranges a profiler records, on the CPU."""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest

import tpu_huffman_torch as tt
from tpu_huffman_torch import metrics
from tpu_huffman_torch.ops import selfsync

decode_mod = importlib.import_module("tpu_huffman_torch.ops.decode")  # `ops.decode` is the function

CPU = {"device": "cpu"}
PUBLIC = ("tt.encode", "tt.encode_with_index", "tt.decode", "tt.decode_indexed",
          "tt.stream.encode_chunk", "tt.stream.decode_chunk")


@pytest.fixture
def tracing():
    """Spans on for the test, and the registry and totals it starts from."""
    was = metrics.enabled
    metrics.enable(True)
    try:
        yield metrics.counters_snapshot(), metrics.span_totals()
    finally:
        metrics.enable(was)


def _grew(before: dict) -> dict:
    after = metrics.counters_snapshot()
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _span_delta(before: dict) -> dict:
    out = {}
    for name, t in metrics.span_totals().items():
        d = {k: v - before.get(name, {}).get(k, 0) for k, v in t.items()}
        if d["count"]:
            out[name] = d
    return out


def _text(n: int, seed: int = 3) -> bytes:
    return np.random.default_rng(seed).integers(32, 127, n, dtype=np.uint8).tobytes()


def test_off_a_span_is_the_shared_no_op_and_records_nothing():
    assert not metrics.enabled
    before, totals = metrics.counters_snapshot(), metrics.span_totals()
    s = metrics.span("tt.encode")
    assert s is metrics.span("tt.stage.upload") is metrics._OFF
    with s as inner:
        assert inner is s
    t = tt.load_static_test_table()
    tt.decode(tt.encode(b"off by default", t, **CPU), t, **CPU)
    assert metrics.span_totals() == totals
    grew = _grew(before)
    # the integer counters stay on
    assert grew["calls.encode"] == grew["calls.decode"] == 1 and grew["copies.d2h"] >= 2


def test_off_a_span_raises_through_and_stays_off():
    with pytest.raises(KeyError):
        with metrics.span("tt.walk"):
            raise KeyError("through")
    assert metrics._here.stack == []


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_nested_spans_add_up(tracing, depth):
    _c, totals = tracing
    names = [f"tt.test.level{i}" for i in range(depth)]

    def nest(i):
        if i == depth:
            return
        with metrics.span(names[i]):
            sum(range(2000))
            nest(i + 1)
            sum(range(2000))

    nest(0)
    d = _span_delta(totals)
    assert set(d) == set(names)
    for i, n in enumerate(names):
        inner = d[names[i + 1]]["ns"] if i + 1 < depth else 0
        assert d[n]["count"] == 1 and d[n]["self_ns"] == d[n]["ns"] - inner > 0
    assert sum(d[n]["self_ns"] for n in names) == d[names[0]]["ns"]
    assert metrics._here.stack == []


def test_a_span_inside_one_of_its_name_is_held_by_the_outer(tracing):
    _c, totals = tracing
    with metrics.span("tt.test.same") as outer:
        with metrics.span("tt.test.same") as inner:
            assert inner is metrics._OFF
        with metrics.span("tt.test.other"):
            with metrics.span("tt.test.same") as deeper:
                assert deeper is not metrics._OFF
    d = _span_delta(totals)
    assert d["tt.test.same"]["count"] == 2 and d["tt.test.other"]["count"] == 1
    assert d["tt.test.same"]["ns"] >= outer.ns


def test_a_span_that_raises_still_counts_and_unwinds(tracing):
    _c, totals = tracing
    with pytest.raises(ValueError):
        with metrics.span("tt.test.outer"):
            with metrics.span("tt.test.inner"):
                raise ValueError("x")
    d = _span_delta(totals)
    assert d["tt.test.outer"]["count"] == d["tt.test.inner"]["count"] == 1
    assert d["tt.test.outer"]["ns"] >= d["tt.test.inner"]["ns"]
    assert metrics._here.stack == []


def test_spans_of_two_threads_do_not_nest_into_each_other(tracing):
    import threading

    _c, totals = tracing
    go = threading.Barrier(2, timeout=30)

    def work(name):
        with metrics.span(name):
            go.wait()
            sum(range(5000))
            go.wait()

    threads = [threading.Thread(target=work, args=(f"tt.test.thread{i}",)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    d = _span_delta(totals)
    for i in range(2):
        t = d[f"tt.test.thread{i}"]
        assert t["count"] == 1 and t["self_ns"] == t["ns"]


@pytest.mark.parametrize("call", ["encode", "encode_with_index", "decode", "decode_indexed",
                                  "stream.encode_chunk", "stream.decode_chunk"])
def test_each_public_entry_counts_a_call_and_opens_its_span(tracing, call):
    t = tt.load_static_test_table()
    data = _text(5000)
    enc, idx = tt.encode_with_index(data, t, **CPU)
    before, totals = metrics.counters_snapshot(), metrics.span_totals()
    if call == "encode":
        tt.encode(data, t, **CPU)
    elif call == "encode_with_index":
        tt.encode_with_index(data, t, **CPU)
    elif call == "decode":
        tt.decode(enc, t, **CPU)
    elif call == "decode_indexed":
        tt.decode_indexed(enc, idx, t, **CPU)
    elif call == "stream.encode_chunk":
        tt.HuffmanEncoder(t, **CPU).encode_chunk(data, 100)
    else:
        tt.HuffmanDecoder(t, **CPU).decode_chunk(enc[:300], 50)
    grew, d = _grew(before), _span_delta(totals)
    assert grew["calls." + call] == 1
    assert sum(v for k, v in grew.items() if k.startswith("calls.")) == 1
    assert [n for n in PUBLIC if n in d] == ["tt." + call]
    assert d["tt.stage.upload"]["count"] >= 1 and d["tt.stage.download"]["count"] >= 1
    assert grew["copies.h2d"] >= 1 and grew["copies.d2h"] >= 1
    # the public span holds every other span of the call
    outer = d["tt." + call]
    assert outer["ns"] >= sum(t["self_ns"] for n, t in d.items() if n != "tt." + call)


def test_encode_under_the_profiler_nests_its_ranges_inside_the_public_span(tmp_path, tracing):
    t = tt.load_static_test_table()
    with metrics.trace(str(tmp_path)):
        tt.encode(_text(3000), t, **CPU)
    (name,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / name))["traceEvents"]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("tt.")]
    (outer,) = [r for r in ranges if r[2] == "tt.encode"]
    inner = [r for r in ranges if r is not outer]
    assert {"tt.stage.upload", "tt.encode.count", "tt.stage.download", "tt.encode.pack"} <= {
        r[2] for r in inner}
    assert all(outer[0] <= a and b <= outer[1] for a, b, _n in inner)
    order = [r[2] for r in sorted(inner) if r[2] in ("tt.stage.upload", "tt.encode.count")]
    assert order[0] == "tt.stage.upload"


def test_no_ranges_while_tracing_is_off(tmp_path):
    t = tt.load_static_test_table()
    with metrics.trace(str(tmp_path)):
        tt.encode(_text(3000), t, **CPU)
    (name,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / name))["traceEvents"]
    assert not [e for e in events if e.get("name", "").startswith("tt.")]


def test_a_foreign_decode_past_the_sequential_cut_shows_the_stitch(tracing):
    t = tt.load_static_test_table()
    data = _text(decode_mod.SEQUENTIAL_MAX_BYTES * 4)
    enc = tt.encode(data, t, **CPU)
    assert len(enc) > decode_mod.SEQUENTIAL_MAX_BYTES
    totals = metrics.span_totals()
    before = metrics.counters_snapshot()
    assert tt.decode(enc, t, **CPU) == data
    d, grew = _span_delta(totals), _grew(before)
    assert d["tt.selfsync.pass"]["count"] >= 2 and d["tt.selfsync.stitch"]["count"] == 1
    assert d["tt.walk"]["count"] >= 1
    assert grew.get("ops.selfsync.launches.selfsync_decode", 0) == 0  # plain passes on the CPU


def test_the_fixpoint_has_its_own_span(tracing, monkeypatch):
    monkeypatch.setattr(selfsync, "stitch", lambda *a, **k: None)  # force the fallback
    t = tt.load_static_test_table()
    data = _text(decode_mod.SEQUENTIAL_MAX_BYTES * 3)
    enc = tt.encode(data, t, **CPU)
    totals = metrics.span_totals()
    assert tt.decode(enc, t, **CPU) == data
    d = _span_delta(totals)
    assert d["tt.selfsync.fixpoint"]["count"] == 1
    assert d["tt.selfsync.pass"]["count"] >= 1


@pytest.mark.parametrize("n", [1, 2000, 30000])
def test_a_one_shot_decode_downloads_at_least_its_plaintext(n):
    t = tt.load_static_test_table()
    data = _text(n)
    enc = tt.encode(data, t, **CPU)
    before = metrics.counters_snapshot()
    assert tt.decode(enc, t, **CPU) == data
    grew = _grew(before)
    assert grew["copies.d2h_bytes"] >= n and grew["copies.h2d_bytes"] >= len(enc)


def test_a_round_trip_counts_its_uploads_and_downloads():
    t = tt.load_static_test_table()
    data = _text(40000)
    before = metrics.counters_snapshot()
    enc, idx = tt.encode_with_index(data, t, **CPU)
    assert tt.decode_indexed(enc, idx, t, **CPU) == data
    grew = _grew(before)
    n_blocks = len(idx.bit_offsets)
    # the table's arrays up in one copy at its first use; the plaintext and the
    # stream up; the index's three arrays up with the stream
    assert grew["ops.encode.outcomes.device_tables"] == 1
    assert grew["copies.h2d"] == 6
    assert grew["copies.h2d_bytes"] == (grew["ops.encode.outcomes.device_table_h2d_bytes"]
                                        + len(data) + len(enc) + n_blocks * (8 + 4 + 8))
    # scalars, block offsets and stream down; the plaintext and its error flag down
    assert grew["copies.d2h"] == 5
    assert grew["copies.d2h_bytes"] >= len(enc) + len(data) + 8 * n_blocks


def test_a_table_is_staged_once_per_device(tmp_path):
    (tmp_path / "t.tsv").write_text(tt.load_static_test_table().to_tsv())
    t = tt.HuffmanTable.from_tsv_file(str(tmp_path / "t.tsv"))  # a table no call has staged
    before = metrics.counters_snapshot()
    tt.encode(b"first call", t, **CPU)
    tt.encode(b"second call", t, **CPU)
    tt.decode(tt.encode(b"third", t, **CPU), t, **CPU)
    assert _grew(before)["ops.encode.outcomes.device_tables"] == 1


def test_the_registry_holds_the_kernel_modules_counters_by_reference():
    from tpu_huffman_torch import stream
    from tpu_huffman_torch.ops import chain_decode, pack_encode, stream_decode

    snap = metrics.counters_snapshot()
    for group, d in (("ops.chain_decode.launches", chain_decode.launches),
                     ("ops.pack_encode.launches", pack_encode.launches),
                     ("ops.selfsync.launches", selfsync.launches),
                     ("ops.selfsync.outcomes", selfsync.outcomes),
                     ("ops.stream_decode.launches", stream_decode.launches),
                     ("stream.encode_outcomes", stream.encode_outcomes)):
        assert metrics._registry[group] is d
        assert all(snap[f"{group}.{k}"] == v for k, v in d.items())
    for group in ("copies", "setup", "calls"):
        assert metrics._registry[group] is getattr(metrics, group)


def test_record_times_encode_and_decode_through_their_spans(tracing):
    _c, totals = tracing
    metrics.counters.reset()
    try:
        t = tt.load_static_test_table()
        tt.decode(tt.encode(b"timed by the span", t, **CPU), t, **CPU)
        d = _span_delta(totals)
        snap = metrics.counters.snapshot()
        assert snap["encode_seconds"] == pytest.approx(d["tt.encode"]["ns"] * 1e-9)
        assert snap["decode_seconds"] == pytest.approx(d["tt.decode"]["ns"] * 1e-9)
    finally:
        metrics.counters.reset()


def test_every_span_name_belongs_to_a_layer():
    import re

    root = os.path.dirname(tt.__file__)
    names = set()
    for dirpath, _d, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                names |= set(re.findall(r'span\("(tt\.[a-z_.]+)"\)', text))
    layers = ("tt.stage.", "tt.encode.", "tt.decode.", "tt.selfsync.", "tt.setup.")
    others = {n for n in names if not n.startswith(layers)}
    assert others == {"tt.encode_with_index", "tt.decode_indexed", "tt.stream.encode_chunk",
                      "tt.stream.decode_chunk", "tt.walk"}
    assert {"tt.stage.upload", "tt.stage.download", "tt.encode.count", "tt.encode.pack",
            "tt.decode.index", "tt.decode.chain", "tt.selfsync.pass", "tt.selfsync.stitch",
            "tt.selfsync.fixpoint", "tt.setup.kernels", "tt.setup.table"} <= names

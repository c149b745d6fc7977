"""The streaming codec's fused calls on the CPU, through the plain versions:
``HuffmanEncoder.encode_chunk`` (count, cut, the device-total pack and one
download) and the bulk ``HuffmanDecoder.decode_chunk`` drain
(``selfsync.fused_drain_words``: the stitch with its repair, the assembly
and the device-scalar tail walk, one download).

Every call is held against the JAX package's ``HuffmanEncoder`` and
``HuffmanDecoder`` (which run their classic paths on the CPU) and the C++
oracle, chunk by chunk: bytes, ``consumed``, ``done``, carries,
``leftover_bits``, ``state()`` and errors, all exact. The decoder's bulk
path runs here with ``BULK_DECODE_THRESHOLD`` and ``SEG_WORDS`` lowered, as
tests/test_torch_stream_words.py runs the classic drains. The
device-scalar ``stream_decode`` form is held against the by-value form.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from chip_smoke import mixed_lengths_5_30  # noqa: E402  (bench_suite without its JAX set-up)
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman_torch import stream as tstream  # noqa: E402
from tpu_huffman_torch.ops import selfsync, stream_decode  # noqa: E402
from tpu_huffman_torch.ops.bitpack import stage_words  # noqa: E402
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402

CPU = torch.device("cpu")


def _pair(name):
    if name == "static":
        return th.load_static_test_table(), tt.load_static_test_table()
    if name == "hpack":
        return th.load_hpack_table(), tt.load_hpack_table()
    lens = mixed_lengths_5_30()
    return th.make_canonical(lens, name="mixed_5_30"), tt.make_canonical(lens, name="mixed_5_30")


@pytest.fixture(scope="module", params=["static", "hpack", "5_30"])
def tables(request):
    return _pair(request.param)


def _symbols(ref, n, seed):
    """``n`` bytes that the table codes, the shorter codes likelier (so
    that the self-sync segments merge within their patch)."""
    coded = np.flatnonzero(ref.lengths > 0)
    weight = 2.0 ** -ref.lengths[coded].astype(np.float64)
    rng = np.random.default_rng(seed)
    return rng.choice(coded, size=n, p=weight / weight.sum()).astype(np.uint8).tobytes()


@pytest.fixture
def bulk(monkeypatch):
    """The bulk drain at a small size: 512-bit segments (short enough for
    several in a few hundred bytes, long enough that the pass's chains join
    within them) past 64 bytes."""
    monkeypatch.setattr(tstream, "BULK_DECODE_THRESHOLD", 64)
    monkeypatch.setattr(selfsync, "SEG_WORDS", 16)


def _ends():
    return dict(selfsync.outcomes)


def _delta(before):
    return {k: v - before[k] for k, v in selfsync.outcomes.items()}


# --- encoder -----------------------------------------------------------------


def _cuts(ref, data):
    """(a capacity that cuts mid-code, one that ends on a code boundary)."""
    ends = np.cumsum(ref.lengths[np.frombuffer(data, np.uint8)].astype(np.int64))
    on = ends[(ends % 8 == 0) & (ends > 64)]
    mid = next(c for c in range(9, int(ends[-1]) // 8) if 8 * c not in set(ends.tolist()))
    return mid, int(on[0]) // 8


def _encode_all(ref, t, data, cap, eos=0xFF):
    """The fused encoder, its classic form, the JAX encoder and the oracle
    through the capacity protocol in step, every chunk and carry equal."""
    ours = tt.HuffmanEncoder(t, eos_padding=eos, device=CPU)
    classic = tt.HuffmanEncoder(t, eos_padding=eos, device=CPU)
    theirs = th.HuffmanEncoder(ref, eos_padding=eos)
    orc = oracle.OracleEncoder(oracle.OracleTable(ref), eos)
    chunks, pending = [], data
    for _ in range(10_000):
        r = ours.encode_chunk(pending, cap)
        c = classic._encode_chunk_classic(pending, cap)
        j = theirs.encode_chunk(pending, cap)
        assert (r.data, r.consumed, r.done) == (c.data, c.consumed, c.done) == (
            j.data, j.consumed, j.done)
        if cap is not None:
            assert (r.data, r.consumed, r.done) == orc.encode_chunk(pending, cap)
        assert ours.state() == classic.state() == theirs.state()
        if cap is not None:
            assert ours.overflow_bits == orc.overflow_bits
        chunks.append(r)
        pending = pending[r.consumed:]
        if r.done or cap == 0:
            return chunks
    raise AssertionError("encoder did not finish")


@pytest.mark.parametrize("which", ["0", "1", "mid-code", "code boundary", "None"])
def test_fused_encode_chunk_capacities(tables, which):
    """Capacities 0 and 1 (a code longer than 16 bits leaves a carry longer
    than a 1-byte budget: carry_len >= writable), a cut inside a code and one on a code
    boundary, and no cap: every chunk equals the classic form's, the JAX
    package's and the oracle's, and the chunks join to the one-shot
    encoding."""
    ref, t = tables
    longest = int(np.argmax(ref.lengths))
    # a byte a call at capacity 1: fewer symbols, the JAX encoder's calls are slow here
    data = _symbols(ref, 100 if which == "1" else 400, 7) + bytes([longest]) * 4
    mid, boundary = _cuts(ref, data)
    cap = {"0": 0, "1": 1, "mid-code": mid, "code boundary": boundary, "None": None}[which]
    chunks = _encode_all(ref, t, data, cap)
    if cap == 0:
        assert chunks == [tt.EncodeResult(b"", 0, False)]
        return
    assert b"".join(c.data for c in chunks) == th.encode(data, ref)
    if which == "1" and ref.max_len > 16:  # a carry past the next budget
        assert any(c.consumed == 0 and not c.done for c in chunks)


def test_fused_encode_chunk_carry_then_eos():
    """A call cut mid-code leaves a carry; the next, uncapped, call puts it
    before its codes and pads with the encoder's eos_padding."""
    ref, t = _pair("hpack")
    data = bytes([22, 13, 10, 249, 1, 97, 127, 220]) * 5
    for eos in (0x00, 0x5A):
        ours = tt.HuffmanEncoder(t, eos_padding=eos, device=CPU)
        theirs = th.HuffmanEncoder(ref, eos_padding=eos)
        r, j = ours.encode_chunk(data, 5), theirs.encode_chunk(data, 5)
        assert (r.data, r.consumed, r.done) == (j.data, j.consumed, j.done)
        assert ours.overflow_bits == theirs.overflow_bits and ours.overflow_bits[1]
        rest = data[r.consumed:]
        assert ours.encode_chunk(rest).data == theirs.encode_chunk(rest).data


def test_fused_encode_chunk_unknown_symbol_keeps_state():
    """An unknown symbol raises with its index and value before any output,
    on the fused path and on the host's (a budget of 0 that the carry
    spends), and leaves the carry as it was: the next call goes on as the
    JAX encoder's does."""
    spec = {65: 1, 66: 2, 67: 3, 68: 3}
    ref, t = th.make_canonical(spec), tt.make_canonical(spec)
    data = b"ABCD" * 40 + b"Z" + b"A" * 10
    for cap, pending in ((None, data[150:]), (3, data[150:]), (7, data[150:]),
                         (100, data[150:]), (0, b"ZA")):
        ours, theirs = tt.HuffmanEncoder(t, device=CPU), th.HuffmanEncoder(ref)
        r, j = ours.encode_chunk(b"DCDC", 1), theirs.encode_chunk(b"DCDC", 1)
        assert (r.data, r.consumed, r.done) == (j.data, j.consumed, j.done)
        before = ours.state()
        assert before == theirs.state() and before["carry_len"]
        with pytest.raises(tt.UnknownSymbolError) as exc:
            ours.encode_chunk(pending, cap)
        with pytest.raises(th.UnknownSymbolError) as jexc:
            theirs.encode_chunk(pending, cap)
        assert (exc.value.index, exc.value.symbol) == (jexc.value.index, jexc.value.symbol)
        assert ours.state() == theirs.state() == before
        r, j = ours.encode_chunk(b"ABBA", None), theirs.encode_chunk(b"ABBA", None)
        assert (r.data, r.consumed, r.done) == (j.data, j.consumed, j.done)


def test_fused_encode_chunk_rate_hint_miss():
    """An uncapped call downloads what the table's rate hint says; a call
    whose codes are longer fetches the rest with a second download, and
    its bytes are still the JAX encoder's."""
    ref, t = _pair("static")
    short, long_ = _symbols(ref, 3000, 1), bytes(range(256)) * 4
    ours, theirs = tt.HuffmanEncoder(t, device=CPU), th.HuffmanEncoder(ref)
    dt = DeviceTable.for_table(t, CPU)
    dt.encode_rate = None
    assert ours.encode(short) == theirs.encode(short)
    rate = dt.encode_rate
    assert rate == pytest.approx(selfsync.RATE_MARGIN * int(
        ref.lengths[np.frombuffer(short, np.uint8)].sum()) / len(short))
    seconds = tstream.encode_outcomes["second_downloads"]
    assert ours.encode(long_) == theirs.encode(long_)
    assert tstream.encode_outcomes["second_downloads"] == seconds + 1
    assert dt.encode_rate > rate


# --- decoder -------------------------------------------------------------------


@pytest.mark.usefixtures("bulk")
def test_fused_drain_appends_and_compaction(tables, monkeypatch):
    """Odd-sized feeds put every byte phase of the append before the fused
    drain, and the consumed words slide off at a call's start once they
    pass 1024 words: every chunk, leftover_bits and state() equal the JAX
    decoder's and the oracle's, with no fallback."""
    ref, t = tables
    calls = {"drains": 0, "slides": 0}
    real_drain, real_slide = selfsync.fused_drain_words, tstream.slide_words

    def drain(*args, **kw):
        calls["drains"] += 1
        return real_drain(*args, **kw)

    def slide(*args, **kw):
        calls["slides"] += 1
        return real_slide(*args, **kw)

    monkeypatch.setattr(selfsync, "fused_drain_words", drain)
    monkeypatch.setattr(tstream, "slide_words", slide)
    data = _symbols(ref, 9000, 21)
    enc = th.encode(data, ref)
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    orc = oracle.OracleDecoder(oracle.OracleTable(ref))
    before = _ends()
    got, pos, phases = b"", 0, set()
    for step in (517, 102, 3, 250, 2500, 3001, 10_000):
        phases.add(ours._rem.nbytes % 4)
        chunk = enc[pos:pos + step]
        pos += step
        r, j = ours.decode_chunk(chunk), theirs.decode_chunk(chunk)
        assert (r.data, r.done) == (j.data, j.done)
        o_out, o_used, _ = orc.decode_chunk(chunk, len(data))
        assert r.data == o_out and o_used == len(chunk)
        assert ours.leftover_bits == theirs.leftover_bits
        assert ours.state() == theirs.state()
        got += r.data
    assert got == data and pos >= len(enc)
    assert phases == {0, 1, 2, 3}
    assert calls["drains"] >= 5 and calls["slides"] >= 1
    ends = _delta(before)
    assert ends["fallback"] == 0 and ends["stitched"] + ends["repaired"] >= 3


@pytest.mark.usefixtures("bulk")
@pytest.mark.parametrize("cap", [0, 1, 37, 250, 500])
def test_fused_capped_drain(cap):
    """Feed once, drain `cap` symbols a call: the walk alone (0, 1 and 37: a
    prefix of at most four segments) or the segments and the tail (250 and
    500), every chunk equal to the JAX decoder's and the oracle's."""
    ref, t = _pair("static")
    data = _symbols(ref, 1200, 9)
    enc = th.encode(data, ref)
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    orc = oracle.OracleDecoder(oracle.OracleTable(ref))
    before = _ends()
    pending_o, feed, got = enc, enc, b""
    for _ in range(4 if cap < 250 else 100):
        r, j = ours.decode_chunk(feed, cap), theirs.decode_chunk(feed, cap)
        feed = b""
        assert (r.data, r.done) == (j.data, j.done)
        assert ours.state() == theirs.state()
        o_out, o_used, o_done = orc.decode_chunk(pending_o, cap)
        pending_o = pending_o[o_used:]
        assert r.data == o_out and r.done == (o_done and not pending_o)
        got += r.data
        if r.done:
            break
    assert got == data[:len(got)] and (cap < 250 or got == data)
    ends = _delta(before)
    assert ends["fallback"] == 0 and (cap < 250 or ends["stitched"] + ends["repaired"])


@pytest.mark.usefixtures("bulk")
@pytest.mark.parametrize("where", ["body", "tail"])
@pytest.mark.parametrize("cap", [None, 300])
def test_fused_drain_unknown_symbol_keeps_state(where, cap):
    """Zero bytes match no code of the static table. In the segments the
    drain falls back and the classic drain raises; in the tail (the last
    ten bytes) the walk raises. Either way the JAX decoder raises on the
    same call and the decoder's state is as it was before that call."""
    ref, t = _pair("static")
    good = th.encode(_symbols(ref, 1500, 5), ref)
    bad = good[:200] + bytes(6) + good[200:] if where == "body" else good + bytes(5) + good[:5]
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    fell = selfsync.outcomes["fallback"]
    for feed in [bad[:100], bad[100:]] + [b""] * 60:
        before = ours.state()
        try:
            r = ours.decode_chunk(feed, cap)
        except tt.UnknownSymbolError:
            with pytest.raises(th.UnknownSymbolError):
                theirs.decode_chunk(feed, cap)
            break
        j = theirs.decode_chunk(feed, cap)
        assert (r.data, r.done) == (j.data, j.done)
        assert ours.state() == theirs.state()
    else:
        raise AssertionError("the corrupt stream did not raise")
    assert ours.state() == theirs.state() == before
    assert ours.leftover_bits == theirs.leftover_bits
    if cap is None:
        assert (selfsync.outcomes["fallback"] > fell) == (where == "body")


@pytest.mark.usefixtures("bulk")
def test_fused_drain_fallback_counted(monkeypatch):
    """More failed segments than the repair's lanes (a 2-code patch, one
    lane): the fused drain runs the classic one over the same buffer,
    counts it, and gives the JAX decoder's chunks."""
    monkeypatch.setattr(selfsync, "PATCH_SYMS", 2)
    monkeypatch.setattr(selfsync, "R_MAX", 1)
    ref, t = _pair("static")
    data = _symbols(ref, 1200, 4)
    enc = th.encode(data, ref)
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    before = _ends()
    for chunk in (enc[:500], enc[500:]):
        r, j = ours.decode_chunk(chunk), theirs.decode_chunk(chunk)
        assert (r.data, r.done) == (j.data, j.done)
        assert ours.state() == theirs.state()
    assert _delta(before)["fallback"] >= 1


@pytest.mark.usefixtures("bulk")
def test_fused_drain_rate_hint_miss():
    """An uncapped drain downloads what the decoder's rate hint says; a
    hint far below the stream's symbols takes a second download, counted,
    with the same chunk as the JAX decoder's, and the hint is learnt."""
    ref, t = _pair("static")
    data = _symbols(ref, 2000, 3)
    enc = th.encode(data, ref)
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    ours._rate = 1e-4
    before = _ends()
    r, j = ours.decode_chunk(enc), theirs.decode_chunk(enc)
    assert (r.data, r.done) == (j.data, j.done) and r.data == data
    assert ours.state() == theirs.state()
    assert _delta(before)["second_downloads"] == 1
    assert ours._rate > 0.01


# --- the device-scalar stream_decode ----------------------------------------------


def test_stream_decode_dev_plain_matches_by_value():
    """The device-scalar form's plain version against the by-value form's,
    over random start bits, limits and budgets (negative ones count as 0),
    with out_slots at the bits' bound."""
    ref, t = _pair("hpack")
    raw = th.encode(_symbols(ref, 600, 2), ref)
    words = stage_words(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    dt = DeviceTable.for_table(t, CPU)
    rng = np.random.default_rng(12)
    total = 8 * len(raw)
    for _ in range(24):
        start = int(rng.integers(-40, total))
        limit = int(rng.integers(max(start, 0), total + 1))
        budget = int(rng.integers(-3, 300))
        slots = (limit - max(start, 0)) // int(t.min_len) + 1 + int(rng.integers(0, 9))
        args = torch.tensor([start, limit, budget], dtype=torch.int64)
        got, info = stream_decode.decode_stream_dev(words, args, slots, dt)
        want, want_info = stream_decode.decode_stream(words, max(start, 0), limit,
                                                      max(budget, 0), dt)
        n = int(info[0])
        assert torch.equal(info, want_info)
        assert got.numel() == slots and torch.equal(got[:n], want[:n])
    with pytest.raises(ValueError):
        stream_decode.decode_stream_dev(words, torch.zeros(2, dtype=torch.int64), 4, dt)

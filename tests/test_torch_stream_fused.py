"""The streaming codec's fused calls on the CPU, through the plain versions:
``HuffmanEncoder.encode_chunk`` (count, cut, the device-total pack and one
download) and the bulk ``HuffmanDecoder.decode_chunk`` drain
(``selfsync.fused_drain_words``: the stitch with its repair, the assembly
and the device-scalar tail walk, one download).

Every call is held against the JAX package's ``HuffmanEncoder`` and
``HuffmanDecoder`` (which run their classic paths on the CPU) and the C++
oracle, chunk by chunk: bytes, ``consumed``, ``done``, carries,
``leftover_bits``, ``state()`` and errors, all exact. Where a capped
``encode_chunk`` meets an unknown symbol at or past its cut, the JAX
encoder raises and the oracle does not: there the port is held against
the oracle alone. The decoder's bulk path runs here with
``BULK_DECODE_THRESHOLD`` and ``SEG_WORDS`` lowered, as
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
    """Where the oracle raises (uncapped, or capped with the unknown symbol
    starting before the cut), the fused path raises with its index and
    value before any output and leaves the carry as it was, as the JAX
    encoder does. Where the symbol starts at or past the cut (capacity 3
    here, and 0 on the host's path, whose budget the carry spends) the call
    returns the oracle's chunk and carry, not the JAX encoder's error. The
    next call goes on as the JAX encoder's does from the same state."""
    spec = {65: 1, 66: 2, 67: 3, 68: 3}
    ref, t = th.make_canonical(spec), tt.make_canonical(spec)
    data = b"ABCD" * 40 + b"Z" + b"A" * 10
    returns = {3: (bytes.fromhex("eeb75b"), 10, False), 0: (b"", 0, False)}
    for cap, pending in ((None, data[150:]), (3, data[150:]), (7, data[150:]),
                         (100, data[150:]), (0, b"ZA")):
        ours, theirs = tt.HuffmanEncoder(t, device=CPU), th.HuffmanEncoder(ref)
        orc = oracle.OracleEncoder(oracle.OracleTable(ref))
        r, j = ours.encode_chunk(b"DCDC", 1), theirs.encode_chunk(b"DCDC", 1)
        assert (r.data, r.consumed, r.done) == (j.data, j.consumed, j.done) == (
            orc.encode_chunk(b"DCDC", 1))
        before = ours.state()
        assert before == theirs.state() and ours.overflow_bits == orc.overflow_bits == (1, 1)
        if cap in returns:
            r = ours.encode_chunk(pending, cap)
            assert (r.data, r.consumed, r.done) == returns[cap] == orc.encode_chunk(pending, cap)
            assert ours.overflow_bits == orc.overflow_bits == (1, 1)
        else:
            with pytest.raises(tt.UnknownSymbolError) as exc:
                ours.encode_chunk(pending, cap)
            with pytest.raises(th.UnknownSymbolError) as jexc:
                theirs.encode_chunk(pending, cap)
            assert (exc.value.index, exc.value.symbol) == (jexc.value.index, jexc.value.symbol)
            assert ours.state() == theirs.state() == before
        theirs.load_state(ours.state())
        r, j = ours.encode_chunk(b"ABBA", None), theirs.encode_chunk(b"ABBA", None)
        assert (r.data, r.consumed, r.done) == (j.data, j.consumed, j.done)


_C4_SPEC = {65: 1, 66: 2, 67: 3, 68: 3}  # A B C D; Z (90) has no code
_DCDC = [(b"DCDC", 1)]  # leaves the carry (1, 1)


def _c4_case(cap, carry, where):
    """(setup calls, data) whose first Z starts where ``where`` says, relative
    to the cut of a call at ``cap`` bytes after a carry of ``carry`` bits."""
    setup = _DCDC if carry else []
    before = 8 * cap - carry  # A (1 bit) symbols that end at the cut
    head = {"cut-1": b"A" * (before - 1), "cut": b"A" * before, "cut+1": b"A" * (before + 1),
            "straddle": b"A" * (before - 1) + b"D",
            "run": b"A" * before + b"ZZZ"}[where]
    return setup, head + b"ZA" + b"BCD" * 3


def _c4_stream(t, ref, setup, data, cap, seed=None):
    """The fused call, ``_encode_chunk_classic`` and the oracle through the
    capacity protocol in step: every chunk's (data, consumed, done,
    overflow_bits) equal, and a raise exactly where the oracle raises, with
    the first unknown symbol's index and value. After a raise all three
    restart from a reset past the symbol (the oracle's carry went out with
    its error). ``seed`` draws each call's capacity from 0-7. Returns each
    call's (data, consumed, done, overflow_bits), None for a raise."""
    ours, classic = tt.HuffmanEncoder(t, device=CPU), tt.HuffmanEncoder(t, device=CPU)
    orc = oracle.OracleEncoder(oracle.OracleTable(ref))
    rng = np.random.default_rng(seed)
    for pending, c in setup:
        r = ours.encode_chunk(pending, c)
        assert (r.data, r.consumed, r.done) == orc.encode_chunk(pending, c)
        classic.load_state(ours.state())
    outcomes, pending = [], data
    for _ in range(10_000):
        c = cap if seed is None else int(rng.integers(0, 8))
        before = ours.state()
        try:
            want = orc.encode_chunk(pending, c) + (orc.overflow_bits,)
        except th.UnknownSymbolError:
            want = None
        got = []
        for enc, call in ((ours, ours.encode_chunk), (classic, classic._encode_chunk_classic)):
            try:
                r = call(pending, c)
                got.append((r.data, r.consumed, r.done, enc.overflow_bits))
            except tt.UnknownSymbolError as exc:
                bad = np.flatnonzero(t.lengths[np.frombuffer(pending, np.uint8)] == 0)[0]
                assert (exc.index, exc.symbol) == (bad, pending[bad])
                assert enc.state() == before
                got.append(None)
        assert got == [want, want]
        outcomes.append(want)
        if want is None:
            for enc in (ours, classic, orc):
                enc.reset()
            pending = pending[bad + 1:]
            continue
        pending = pending[want[1]:]
        if want[2] or (c == 0 and seed is None):
            return outcomes
    raise AssertionError("encoder did not finish")


@pytest.mark.parametrize("where", ["cut-1", "cut", "cut+1", "straddle", "run"])
@pytest.mark.parametrize("carry", [0, 1])
@pytest.mark.parametrize("cap", [0, 1, 3, 7])
def test_encode_chunk_unknown_symbol_at_cut_matches_oracle(cap, carry, where, monkeypatch):
    """A capped call raises if and only if its first unknown symbol starts
    before the cut (the oracle's rule); otherwise it returns the chunk
    before the cut with the oracle's consumed, done and carry. The fused
    call, the classic form and the host's path (capacity 0) agree with the
    oracle call by call, through the rest of the stream."""
    ref, t = th.make_canonical(_C4_SPEC), tt.make_canonical(_C4_SPEC)
    setup, data = _c4_case(cap, carry, where)
    host = []
    real = tstream.HuffmanEncoder._encode_host
    monkeypatch.setattr(tstream.HuffmanEncoder, "_encode_host",
                        lambda self, *a: host.append(1) or real(self, *a))
    outcomes = _c4_stream(t, ref, setup, data, cap)
    if cap == 0:
        assert host and outcomes == [(b"", 0, False, (1, 1) if carry else (0, 0))]
        return
    assert (outcomes[0] is None) == (where == "cut-1")
    assert outcomes.count(None) == data.count(b"Z")
    if where == "cut" and not carry:
        assert outcomes[0] == (b"\x00" * cap, 8 * cap, False, (0, 0))


_REPRO = [([], b"AAAAAAAAZ", 1, (b"\x00", 8, False, (0, 0))),
          ([], b"AAAAAAAAAZ", 1, (b"\x00", 8, False, (0, 0))),
          ([], b"ZA", 0, (b"", 0, False, (0, 0))),
          ([], b"AAAAAAAZ", 1, None),
          (_DCDC, (b"ABCD" * 40 + b"Z" + b"A" * 10)[150:], 3,
           (bytes.fromhex("eeb75b"), 10, False, (1, 1))),
          (_DCDC, b"ZA", 0, (b"", 0, False, (1, 1)))]


@pytest.mark.parametrize("setup, data, cap, first", _REPRO)
def test_encode_chunk_unknown_symbol_repro_cases(setup, data, cap, first):
    """The calls where the port raised and the oracle did not, and one where
    both raise: an input that ends in the unknown symbol at the cut is not
    done, and consumes the codes before it only."""
    ref, t = th.make_canonical(_C4_SPEC), tt.make_canonical(_C4_SPEC)
    assert _c4_stream(t, ref, setup, data, cap)[0] == first


_T = tstream._TILE
_TILE_EDGES = {  # (data, capacity, the first call raises)
    "first of tile 1 at the cut": (b"A" * _T + b"Z" + b"A" * 50, _T // 8, False),
    "first of tile 1 before the cut": (b"A" * _T + b"Z" + b"A" * 50, _T // 8 + 1, True),
    "last of tile 0 before the cut": (b"A" * (_T - 1) + b"Z" + b"A" * 50, _T // 8, True),
    "in tile 0, which ends at the cut": (b"A" * 99 + b"BZ" + b"A" * (_T - 101) + b"A" * 50,
                                         _T // 8, True),
    # 4 D and T - 12 A fill tile 0's bits to the cut, and 8 Z end it; staging
    # (8 * capacity + 2 symbols) reaches 2 Z into tile 1
    "run across tiles at the cut": (b"D" * 4 + b"A" * (_T - 12) + b"Z" * 16 + b"A" * 50,
                                    _T // 8, False),
    "straddle in tile 0, Z first of tile 1": (b"A" * (_T - 1) + b"DZ" + b"A" * 50, _T // 8,
                                              False),
}


@pytest.mark.parametrize("case", list(_TILE_EDGES))
def test_encode_chunk_unknown_symbol_tile_edges_matches_oracle(case):
    """The unknown symbol's tile differs from the cut's (before and after
    it), or a run of them crosses a tile boundary at the cut: the raise and
    the consumed codes still come out as the oracle's."""
    data, cap, raises = _TILE_EDGES[case]
    ref, t = th.make_canonical(_C4_SPEC), tt.make_canonical(_C4_SPEC)
    outcomes = _c4_stream(t, ref, [], data, cap)
    assert (outcomes[0] is None) == raises
    assert outcomes.count(None) == data.count(b"Z")


def test_encode_chunk_built_table_holes_matches_oracle():
    """A table built from a seeded corpus codes only the bytes it saw: an
    input with bytes outside it, streamed at capacities drawn from 0-7,
    meets the cut at every offset. Fused, classic and oracle agree call by
    call, raises included."""
    rng = np.random.default_rng(16)
    corpus = rng.choice(np.arange(40, 104), size=4000).astype(np.uint8)
    ref, t = th.build_table(corpus.tobytes()), tt.build_table(corpus.tobytes())
    assert (t.lengths == ref.lengths).all() and (t.lengths == 0).sum() > 100
    data = rng.integers(36, 108, size=400, dtype=np.uint8).tobytes()
    outcomes = _c4_stream(t, ref, [], data, None, seed=16)
    assert len(outcomes) > 50 and outcomes.count(None) > 5


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

"""The streaming decoder's device-resident parts, on the CPU: the word
append and slide (``ops/bitpack.py``), the words drains and the capped
decode of ``ops/selfsync.py``, and the self-sync kernel's ``starts``
output, through their plain versions.

The drains run here at ``seg_words=4`` with the decoder's threshold
lowered, as tests/test_stream.py forces the JAX package's. They are held
against the JAX package: its decoder chunk by chunk, its
``selfsync_decode_capped`` and ``_selfsync_segments`` (Pallas kernels in
interpret mode, so only a few calls). Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman.ops import selfsync as jax_selfsync  # noqa: E402
from tpu_huffman_torch import stream as tstream  # noqa: E402
from tpu_huffman_torch.ops import selfsync  # noqa: E402
from tpu_huffman_torch.ops.bitpack import (  # noqa: E402
    merge_words,
    slide_words,
    stage_words,
)
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tables():
    return th.load_static_test_table(), tt.load_static_test_table()


def _random(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _words(raw: bytes, spare: int = 0):
    w = stage_words(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    return torch.cat([w, torch.zeros(spare, dtype=torch.int32)])


def _bits(ref, data) -> np.ndarray:
    """The code bits of ``data``, unpadded."""
    total = int(ref.lengths[np.frombuffer(data, np.uint8)].astype(np.int64).sum())
    return np.unpackbits(np.frombuffer(th.encode(data, ref), np.uint8))[:total]


def _stream(*parts) -> bytes:
    """Bit arrays joined and padded with ones to a whole byte."""
    bits = np.concatenate(parts)
    pad = (-bits.size) % 8
    return np.packbits(np.concatenate([bits, np.ones(pad, np.uint8)])).tobytes()


# --- bitpack: append and slide ------------------------------------------------


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_merge_words_every_byte_phase(phase):
    """Appending at each byte phase gives the words of the joined bytes;
    the bits past the stream stay zero."""
    old, new = _random(4 * 5 + phase, phase), _random(13 + phase, 10 + phase)
    buf = _words(old, 16)
    up = _words(new)
    merge_words(buf, up, len(old) // 4, 8 * (len(old) % 4))
    want = _words(old + new)
    assert torch.equal(buf[: want.numel()], want)
    assert not buf[want.numel():].any()


def test_slide_words():
    buf = _words(_random(40, 1))
    got = slide_words(buf, 3)
    assert got.numel() == buf.numel()
    assert torch.equal(got[:-3], buf[3:]) and not got[-3:].any()


# --- the decoder on the words drains ----------------------------------------


def _spy(monkeypatch, module, name, counter):
    real = getattr(module, name)

    def spy(*args, **kw):
        counter[name] = counter.get(name, 0) + 1
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)


def test_decoder_words_drain_appends_and_compaction(tables, monkeypatch):
    """Odd-sized feeds put every byte phase of the append on the bulk
    drain, and the consumed words are slid off (at a call's start) once
    they pass 1024 words: every chunk, leftover_bits and state() equal the
    JAX decoder's."""
    ref, t = tables
    monkeypatch.setattr(tstream, "BULK_DECODE_THRESHOLD", 64)
    monkeypatch.setattr(selfsync, "SEG_WORDS", 4)
    calls = {}
    _spy(monkeypatch, selfsync, "fused_drain_words", calls)
    _spy(monkeypatch, tstream, "slide_words", calls)
    data = _random(6000, 21)
    enc = th.encode(data, ref)
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    got, pos, phases = b"", 0, set()
    # the last, empty, feed slides the consumed words off at its start
    for step in (517, 102, 3, 250, 2500, 10_000, 1):
        phases.add(ours._rem.nbytes % 4)
        chunk = enc[pos:pos + step]
        pos += step
        r, j = ours.decode_chunk(chunk), theirs.decode_chunk(chunk)
        assert (r.data, r.done) == (j.data, j.done)
        assert ours.leftover_bits == theirs.leftover_bits
        assert ours.state() == theirs.state()
        got += r.data
    assert got == data and pos >= len(enc)
    assert phases == {0, 1, 2, 3}
    assert calls["fused_drain_words"] >= 5 and calls["slide_words"] >= 1
    assert ours.padding_is_all_ones()


@pytest.mark.parametrize("cap", [800, 1600])
def test_decoder_capped_words_drain(tables, monkeypatch, cap):
    """Feed once, drain `cap` symbols a call through the capped words drain
    with the kernel's starts: every chunk equals the JAX decoder's and the
    oracle's (tests/test_stream.py:426-468)."""
    ref, t = tables
    monkeypatch.setattr(tstream, "BULK_DECODE_THRESHOLD", 256)
    monkeypatch.setattr(selfsync, "SEG_WORDS", 4)
    with_starts = []
    real = selfsync.decode_segments

    def spy(words, entries, seg_bits, max_syms, dt, **kw):
        with_starts.append(kw.get("starts") is not None)
        return real(words, entries, seg_bits, max_syms, dt, **kw)

    monkeypatch.setattr(selfsync, "decode_segments", spy)
    data = _random(2500, 9)
    enc = th.encode(data, ref)
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    orc = oracle.OracleDecoder(oracle.OracleTable(ref))
    pending_o, feed, got = enc, enc, b""
    while True:
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
    assert got == data
    assert any(with_starts)
    assert ours.leftover_bits == theirs.leftover_bits


# --- the capped decode against the JAX package's -----------------------------


def test_capped_cut_in_body_and_tail(tables):
    """A cut inside the kernel body (start_bit 0) and one in the sequential
    tail (start_bit 5): (symbols, end_bit, more) equal the JAX package's
    selfsync_decode_capped, and the words form agrees from a mid-word
    cursor."""
    ref, t = tables
    data = _random(1500, 14)
    clean = th.encode(data, ref)
    shifted = _stream(np.array([1, 0, 1, 1, 0], np.uint8), _bits(ref, data))
    for raw, start_bit, cap, in_body in ((clean, 0, 1000, True), (shifted, 5, 100, False)):
        total_bits = 8 * len(raw)
        prefix = min(-(-total_bits // 32), -(-(start_bit + (cap + 1) * 10 + 64) // 32)) * 32
        n_segs, seg_bits = selfsync._plan_segments(prefix, 4)
        body_bits = n_segs * seg_bits
        got = selfsync.selfsync_decode_capped(raw, t, cap, seg_words=4, start_bit=start_bit,
                                              device=CPU)
        want = jax_selfsync.selfsync_decode_capped(raw, ref, cap, seg_words=4,
                                                   start_bit=start_bit)
        assert got == want
        out, end_bit, more = got
        assert out == data[:cap] and more
        assert (end_bit < body_bits) == in_body
        # the same drain on a word buffer from a mid-word cursor
        skip = len(out) // 3
        consumed = start_bit + int(ref.lengths[np.frombuffer(out[:skip], np.uint8)].sum())
        words = _words(raw, 8)
        rest = selfsync.selfsync_decode_capped_words(words, len(raw), consumed, t, cap,
                                                     seg_words=4)
        assert rest[0] == data[skip:skip + cap] and rest[2]


def test_capped_invalid_window_at_the_cap(tables):
    """An invalid window after k good symbols: a cap of k - 1 stops before
    it, a cap of k (the window right after the cap) or more raises, as the
    reference checks an unknown symbol before a full output. In the body,
    against the JAX package; in the tail, against the plaintext."""
    ref, t = tables
    k = 400
    good, more_syms = _random(k, 30), _random(6, 31)
    zeros = np.zeros(40, np.uint8)
    in_body = _stream(_bits(ref, good), zeros, _bits(ref, _random(300, 32)))
    in_tail = _stream(_bits(ref, good), zeros, _bits(ref, more_syms))
    prefix = -(-(k * 10 + 64) // 32) * 32  # the prefix a cap of k - 1 decodes
    n_segs, seg_bits = selfsync._plan_segments(prefix, 4)
    assert n_segs * seg_bits > len(_bits(ref, good))
    got = selfsync.selfsync_decode_capped(in_body, t, k - 1, seg_words=4, device=CPU)
    assert got == jax_selfsync.selfsync_decode_capped(in_body, ref, k - 1, seg_words=4)
    assert got[0] == good[:k - 1] and got[2]
    with pytest.raises(tt.UnknownSymbolError):
        selfsync.selfsync_decode_capped(in_body, t, k, seg_words=4, device=CPU)
    with pytest.raises(th.UnknownSymbolError):
        jax_selfsync.selfsync_decode_capped(in_body, ref, k, seg_words=4)
    with pytest.raises(tt.UnknownSymbolError):
        selfsync.selfsync_decode_capped(in_body, t, k + 5, seg_words=4, device=CPU)
    # the invalid window past the last kernel segment: the tail raises
    n_segs, seg_bits = selfsync._plan_segments(8 * len(in_tail), 4)
    assert n_segs * seg_bits < len(_bits(ref, good))
    out, end_bit, more = selfsync.selfsync_decode_capped(in_tail, t, k - 1, seg_words=4,
                                                         device=CPU)
    assert out == good[:k - 1] and more
    for cap in (k, k + 5):
        with pytest.raises(tt.UnknownSymbolError):
            selfsync.selfsync_decode_capped(in_tail, t, cap, seg_words=4, device=CPU)
    with pytest.raises(th.UnknownSymbolError):
        jax_selfsync.selfsync_decode_capped(in_tail, ref, k + 5, seg_words=4)


def test_capped_arguments_checked(tables):
    _ref, t = tables
    for kw in ({"start_bit": 8}, {"seg_words": 0}):
        with pytest.raises(ValueError):
            selfsync.selfsync_decode_capped(b"\x9e\x79", t, 1, device=CPU, **kw)
    with pytest.raises(ValueError):
        selfsync.selfsync_decode_capped_words(_words(b"\x9e\x79"), 2, 0, t, -1)
    with pytest.raises(ValueError):
        selfsync.selfsync_decode_words(_words(b"\x9e\x79"), 2, 17, t)


# --- the kernel's starts -------------------------------------------------------


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupted"])
def test_plain_starts_match_jax_segments(tables, corrupt):
    """The converged pass's starts and symbols equal those of the JAX
    package's _selfsync_segments (its emit_offs kernel and stitch), row by
    row below each count; on a corrupted stream only before the first
    invalid window. start_bit 3."""
    ref, t = tables
    data = _random(1400, 40)
    raw = bytearray(th.encode(data, ref))
    if corrupt:
        raw[900:906] = bytes(6)
    raw = bytes(raw)
    start_bit = 3
    raw = _stream(np.array([0, 1, 1], np.uint8), np.unpackbits(np.frombuffer(raw, np.uint8)))
    n_segs, seg_bits = selfsync._plan_segments(8 * len(raw), 4)
    max_syms = selfsync.max_symbols(t, seg_bits)
    starts = torch.zeros((n_segs, max_syms), dtype=torch.int16)
    syms, counts, _exits, bad, _entries, _passes = selfsync._fixpoint(
        _words(raw), n_segs, seg_bits, start_bit, max_syms, DeviceTable.for_table(t, CPU),
        starts=starts,
    )
    j_syms, j_starts, j_counts, j_bad, j_s, j_seg_bits, _tail = jax_selfsync._selfsync_segments(
        raw, ref, 4, start_bit)
    assert (j_s, j_seg_bits) == (n_segs, seg_bits)
    bad_np = bad.numpy()
    assert bool(bad_np.any()) == corrupt == bool((j_bad != 0).any())
    first_bad = int(np.flatnonzero(bad_np)[0]) if corrupt else n_segs
    compared = 0
    for s in range(min(first_bad + 1, n_segs)):
        c = int(counts[s])
        if s == first_bad:
            c = int((starts[s, :c].to(torch.int64) < int(bad[s]) - 1).sum())
        else:
            assert c == int(j_counts[s])
        assert starts[s, :c].tolist() == j_starts[s, :c].tolist()
        assert syms[s, :c].tolist() == j_syms[s, :c].tolist()
        assert (starts[s, int(counts[s]):] == selfsync.NO_START).all()
        compared += c
    assert compared > (600 if corrupt else 1300)


def test_starts_arguments_checked(tables):
    _ref, t = tables
    dt = DeviceTable.for_table(t, CPU)
    words = _words(th.encode(_random(200, 2), th.load_static_test_table()))
    entries = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int16"):
        selfsync.decode_segments(words, entries, 32768, 10, dt,
                                 starts=torch.zeros((2, 10), dtype=torch.int16))
    with pytest.raises(ValueError, match="int16"):
        selfsync.decode_segments(words, entries, 128, 10, dt,
                                 starts=torch.zeros((2, 10), dtype=torch.int32))

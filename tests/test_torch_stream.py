"""The port's streaming codec (``tpu_huffman_torch.stream``) against the
JAX package's ``HuffmanEncoder``/``HuffmanDecoder`` and the C++ oracle,
chunk by chunk, on the CPU: every chunk's bytes, ``consumed``, ``done``,
carry, ``leftover_bits``, ``state()`` and error. Inputs come from numpy
seeds; every comparison is exact (the codec is integer).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from golden import (  # noqa: E402
    ALL_CODES,
    ALL_CODES_ENCODED,
    STEP_SIZES,
    URL,
    URL_ENCODED,
)
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman_torch import testing as ttesting  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def tables():
    return th.load_static_test_table(), tt.load_static_test_table()


def _random(n, seed, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, size=n, dtype=np.uint8).tobytes()


def _encode_all(ours, theirs, orc, data, cap):
    """Drive the three encoders through the capacity protocol in step,
    holding every chunk equal. Returns the port's chunks."""
    chunks = []
    pending = data
    for _ in range(100_000):
        r = ours.encode_chunk(pending, cap)
        j = theirs.encode_chunk(pending, cap)
        o = orc.encode_chunk(pending, cap)
        assert (r.data, r.consumed, r.done) == (j.data, j.consumed, j.done) == o
        assert ours.overflow_bits == theirs.overflow_bits == orc.overflow_bits
        chunks.append(r)
        pending = pending[r.consumed:]
        if r.done:
            assert not pending
            return chunks
    raise AssertionError("encoder did not finish")


# --- encoder ----------------------------------------------------------------


@pytest.mark.parametrize("step", STEP_SIZES)
def test_encoder_chunks_match_jax_and_oracle(tables, step):
    """Every chunk's bytes, consumed, done and overflow_bits equal the JAX
    encoder's and the oracle's (reference tests/huffman_test.c:117-165)."""
    ref, t = tables
    data = ALL_CODES + _random(300, step)
    chunks = _encode_all(tt.HuffmanEncoder(t, device=CPU), th.HuffmanEncoder(ref),
                         oracle.OracleEncoder(oracle.OracleTable(ref)), data, step)
    assert b"".join(c.data for c in chunks) == th.encode(data, ref)
    assert all(len(c.data) == step for c in chunks[:-1])


@pytest.mark.parametrize("pad", [0x00, 0x5A])
def test_encoder_eos_padding(tables, pad):
    """Non-default padding on the final chunk only, one-shot and chunked."""
    ref, t = tables
    data = _random(200, 40 + pad)
    ours = tt.HuffmanEncoder(t, eos_padding=pad, device=CPU)
    assert ours.encode(URL) == th.HuffmanEncoder(ref, eos_padding=pad).encode(URL)
    assert ours.encode(URL) == oracle.OracleEncoder(oracle.OracleTable(ref), pad).encode(URL)
    chunks = _encode_all(ours, th.HuffmanEncoder(ref, eos_padding=pad),
                         oracle.OracleEncoder(oracle.OracleTable(ref), pad), data, 13)
    assert b"".join(c.data for c in chunks) == th.encode(data, ref, eos_padding=pad)


def test_encoder_zero_capacity_and_empty(tables):
    ref, t = tables
    ours = tt.HuffmanEncoder(t, device=CPU)
    assert ours.encode_chunk(URL, 0) == tt.EncodeResult(b"", 0, False)
    assert th.HuffmanEncoder(ref).encode_chunk(URL, 0) == th.EncodeResult(b"", 0, False)
    assert ours.encode_chunk(b"", 0) == tt.EncodeResult(b"", 0, True)
    assert ours.encode_chunk(b"", None) == tt.EncodeResult(b"", 0, True)
    assert ours.encode_chunk(b"?", 1) == tt.EncodeResult(bytes([0xBA]), 1, True)
    assert ours.encode_chunk(b"yz", 2) == tt.EncodeResult(bytes([0xA3, 0x79]), 2, True)
    with pytest.raises(ValueError):
        ours.encode_chunk(URL, -1)
    # a carry alone, finished by an empty call, padded as the JAX encoder pads it
    theirs = th.HuffmanEncoder(ref, eos_padding=0x5A)
    ours = tt.HuffmanEncoder(t, eos_padding=0x5A, device=CPU)
    for enc in (ours, theirs):
        enc.load_state({"carry_pattern": 0b1011, "carry_len": 11})
    for cap, carry in ((1, (0b011, 3)), (None, (0, 0))):
        r, j = ours.encode_chunk(b"", cap), theirs.encode_chunk(b"", cap)
        assert (r.data, r.consumed, r.done) == (j.data, j.consumed, j.done)
        assert ours.overflow_bits == theirs.overflow_bits == carry


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_encoder_carry_longer_than_budget(cap):
    """HPACK's 23-30 bit codes leave carries longer than a 1-3 byte budget:
    the carry alone overflows and re-carries its tail, consuming no input."""
    ref, t = th.load_hpack_table(), tt.load_hpack_table()
    data = bytes([22, 13, 10, 249, 1, 97, 127, 220]) * 3
    chunks = _encode_all(tt.HuffmanEncoder(t, device=CPU), th.HuffmanEncoder(ref),
                         oracle.OracleEncoder(oracle.OracleTable(ref)), data, cap)
    assert any(c.consumed == 0 and not c.done for c in chunks)
    assert b"".join(c.data for c in chunks) == th.encode(data, ref)


def test_encoder_input_chunking_pads_each_chunk(tables):
    """Chunked *input* pads every chunk, as the reference does."""
    ref, t = tables
    ours = tt.HuffmanEncoder(t, eos_padding=0x5A, device=CPU)
    theirs = th.HuffmanEncoder(ref, eos_padding=0x5A)
    parts = [b"w", b"ww", URL, b"", ALL_CODES]
    assert [ours.encode(p) for p in parts] == [theirs.encode(p) for p in parts]
    assert ours.encode(b"w") == tt.encode(b"w", t, eos_padding=0x5A, device=CPU)
    assert ours.encoded_length(ALL_CODES) == theirs.encoded_length(ALL_CODES)


def test_encoder_unknown_symbol_mid_stream():
    """The first unknown symbol raises with its index and value, before any
    output and with the carry untouched, where the oracle raises: uncapped
    at once, capped only in the call where it starts before the cut. At
    capacity 3 the oracle returns two more chunks after the call that the
    JAX package raises in; the port follows the oracle, and is held against
    the JAX package where the two agree (None and 100)."""
    spec = {65: 1, 66: 2, 67: 3, 68: 3}
    ref, t = th.make_canonical(spec), tt.make_canonical(spec)
    data = b"ABCD" * 40 + b"Z" + b"A" * 10
    for cap in (None, 3, 100):
        ours, theirs = tt.HuffmanEncoder(t, device=CPU), th.HuffmanEncoder(ref)
        orc = oracle.OracleEncoder(oracle.OracleTable(ref))
        pending, calls = data, []
        while True:
            before = ours.state()
            try:
                r = ours.encode_chunk(pending, cap)
            except tt.UnknownSymbolError as exc:
                assert (exc.index, exc.symbol) == (pending.index(b"Z"), ord("Z"))
                assert ours.state() == before
                if cap is not None:
                    with pytest.raises(th.UnknownSymbolError):
                        orc.encode_chunk(pending, cap)
                if cap != 3:
                    with pytest.raises(th.UnknownSymbolError) as jexc:
                        theirs.encode_chunk(pending, cap)
                    assert (exc.index, exc.symbol) == (jexc.value.index, jexc.value.symbol)
                break
            calls.append((r.data.hex(), r.consumed))
            assert (r.data, r.consumed, r.done) == orc.encode_chunk(pending, cap)
            assert ours.overflow_bits == orc.overflow_bits
            assert not r.done
            pending = pending[r.consumed:]
        assert len(calls) == {None: 0, 3: 15, 100: 0}[cap]
        if cap == 3:  # the two calls whose Z starts at or past the cut
            assert calls[13:] == [("eb75ba", 11), ("dd6eb7", 10)]
            assert pending[:1] == b"Z"


def test_encoder_state_across_packages(tables):
    """A carry saved by either package continues in the other."""
    ref, t = tables
    data = _random(500, 3)
    want = th.encode(data, ref)
    for first, second in ((tt.HuffmanEncoder(t, device=CPU), th.HuffmanEncoder(ref)),
                          (th.HuffmanEncoder(ref), tt.HuffmanEncoder(t, device=CPU))):
        out, pending = b"", data
        for _ in range(3):
            r = first.encode_chunk(pending, 37)
            out, pending = out + r.data, pending[r.consumed:]
        assert first.overflow_bits != (0, 0)
        second.load_state(first.state())
        assert second.state() == first.state()
        while True:
            r = second.encode_chunk(pending, 37)
            out, pending = out + r.data, pending[r.consumed:]
            if r.done:
                break
        assert out == want
    enc = tt.HuffmanEncoder(t, device=CPU)
    enc.encode_chunk(data, 5)
    enc.reset()
    assert enc.overflow_bits == (0, 0) and enc.encode(URL) == URL_ENCODED


# --- decoder ----------------------------------------------------------------


@pytest.mark.parametrize("step", STEP_SIZES)
def test_decoder_input_steps(tables, step):
    """Input fed `step` bytes at a time: every chunk's symbols, done and
    leftover_bits equal the JAX decoder's, and the symbols and window the
    oracle's (reference tests/huffman_test.c:275-314)."""
    ref, t = tables
    data = _random(300, 100 + step)
    enc = th.encode(data, ref)
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    orc = oracle.OracleDecoder(oracle.OracleTable(ref))
    got = b""
    for i in range(0, len(enc), step):
        chunk = enc[i:i + step]
        r, j = ours.decode_chunk(chunk), theirs.decode_chunk(chunk)
        assert (r.data, r.done) == (j.data, j.done)
        o_out, o_used, _ = orc.decode_chunk(chunk, len(data))
        assert r.data == o_out and o_used == len(chunk)
        assert ours.leftover_bits == theirs.leftover_bits
        v_r, n_r = orc.leftover_bits
        assert ours.leftover_bits == ((v_r >> (64 - n_r)) if n_r else 0, n_r)
        got += r.data
    assert got == data
    assert ours.state() == theirs.state()
    assert ours.padding_is_all_ones() and theirs.padding_is_all_ones()


@pytest.mark.parametrize("cap", STEP_SIZES)
def test_decoder_capped_drain(tables, cap):
    """Capacity-bounded drains after one feed: every chunk equals the JAX
    decoder's and the oracle's (reference tests/huffman_test.c:316-363)."""
    ref, t = tables
    data = _random(60 + 3 * cap, 200 + cap)  # few calls: the JAX decoder's are slow here
    enc = th.encode(data, ref)
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    orc = oracle.OracleDecoder(oracle.OracleTable(ref))
    pending_o = enc
    feed, got = enc, b""
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


def test_decoder_allow_growth_and_short_buffer(tables):
    ref, t = tables
    assert tt.HuffmanDecoder(t, allow_growth=True, device=CPU).decode(URL_ENCODED, 1) == URL
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    with pytest.raises(tt.ShortBufferError) as exc:
        ours.decode(URL_ENCODED, capacity=4)
    with pytest.raises(th.ShortBufferError) as jexc:
        theirs.decode(URL_ENCODED, capacity=4)
    assert exc.value.args == jexc.value.args == (URL[:4],)
    assert ours.state() == theirs.state()
    assert ours.decode(b"", capacity=100) == URL[4:]
    assert ours.decode(b"") == b""
    with pytest.raises(ValueError):
        ours.decode_chunk(b"", -1)


def test_decoder_reset_and_padding(tables):
    ref, t = tables
    dec = tt.HuffmanDecoder(t, device=CPU)
    dec.decode_chunk(ALL_CODES_ENCODED[:5], None)
    assert dec.leftover_bits[1] > 0
    dec.reset()
    assert dec.leftover_bits == (0, 0) and dec.state() == {"rem": b"", "rem_start_bit": 0}
    assert dec.decode_chunk(URL_ENCODED, None).data == URL
    assert dec.leftover_bits == (0b11111, 5)  # URL's padding stays until a reset
    dec.reset()
    res = dec.decode_chunk(tt.encode(b"w", t, device=CPU), None)
    assert res.done and res.data == b"w"
    assert dec.leftover_bits == (0b11, 2) and dec.padding_is_all_ones()
    for pad in (0x00, 0x5A):
        ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
        enc = th.encode(b"w", ref, eos_padding=pad)
        assert ours.decode_chunk(enc).data == theirs.decode_chunk(enc).data == b"w"
        assert ours.leftover_bits == theirs.leftover_bits
        assert ours.padding_is_all_ones() == theirs.padding_is_all_ones() is False


@pytest.mark.parametrize("cap", [None, 50])
def test_decoder_unknown_symbol_mid_stream(tables, cap):
    """Zero bytes match no code of the static table: the same chunk raises
    in both packages, the oracle raises too, and the failed call leaves the
    decoder's state as it was."""
    ref, t = tables
    good = _random(120, 5)
    stream = th.encode(good, ref) + bytes(6) + th.encode(good, ref)
    ours, theirs = tt.HuffmanDecoder(t, device=CPU), th.HuffmanDecoder(ref)
    raised = None
    for i in range(0, len(stream), 7):
        chunk = stream[i:i + 7]
        try:
            r = ours.decode_chunk(chunk, cap)
        except tt.UnknownSymbolError:
            with pytest.raises(th.UnknownSymbolError):
                theirs.decode_chunk(chunk, cap)
            raised = i
            break
        j = theirs.decode_chunk(chunk, cap)
        assert (r.data, r.done) == (j.data, j.done)
        assert ours.state() == theirs.state()
    assert raised is not None
    assert ours.state() == theirs.state()
    with pytest.raises(th.UnknownSymbolError):
        oracle.OracleDecoder(oracle.OracleTable(ref)).decode(stream)


def test_decoder_state_across_packages(tables):
    """A remainder saved by either package, mid-byte, continues in the
    other with the same output."""
    ref, t = tables
    data = _random(700, 8)
    enc = th.encode(data, ref)
    for make_first, make_second in (
        (lambda: tt.HuffmanDecoder(t, device=CPU), lambda: th.HuffmanDecoder(ref)),
        (lambda: th.HuffmanDecoder(ref), lambda: tt.HuffmanDecoder(t, device=CPU)),
    ):
        first = make_first()
        out = first.decode_chunk(enc[:300], 111).data
        out += first.decode_chunk(enc[300:501], None).data
        st = first.state()
        assert st["rem"] and st["rem_start_bit"] in range(8)
        second = make_second()
        second.load_state(st)
        assert second.state() == st and second.leftover_bits == first.leftover_bits
        r = second.decode_chunk(enc[501:], 97)
        out += r.data
        while not r.done:
            r = second.decode_chunk(b"", 97)
            out += r.data
        assert out == data


# --- the transitive oracles ---------------------------------------------------


@pytest.mark.parametrize("step", [1, 7, 64])
def test_transitive_helpers(tables, step):
    _ref, t = tables
    ttesting.transitive(t, URL, len(URL_ENCODED), device=CPU)
    ttesting.transitive(t, b"cdfh", 3, device=CPU)
    ttesting.transitive_chunked(t, ALL_CODES, len(ALL_CODES_ENCODED), step, device=CPU)
    ttesting.transitive_chunked_input(t, ALL_CODES, step, device=CPU)
    with pytest.raises(AssertionError):
        ttesting.transitive(t, URL, len(URL_ENCODED) + 1, device=CPU)


def test_constructors_default_to_the_card(tables):
    """No CUDA device here: the default device raises; nothing falls back."""
    _ref, t = tables
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (tt.HuffmanEncoder, tt.HuffmanDecoder):
        with pytest.raises(RuntimeError, match="cuda"):
            cls(t)

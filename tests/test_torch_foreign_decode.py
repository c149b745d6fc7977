"""The port's one-shot foreign-stream decode against the JAX package and the
C++ oracle.

On the CPU ``tt.decode`` runs the plain versions of its kernels: the
sequential decode for inputs of at most 2048 bytes and for capped calls, the
self-synchronising segment decode (plus the sequential tail) above that.
The JAX package's ``decode`` takes its ``lax.scan`` path here. Every
comparison is exact: bytes, end bit, status and error type.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from chip_smoke import hpack_corpus  # noqa: E402
from golden import (  # noqa: E402
    ALL_CODES,
    ALL_CODES_ENCODED,
    EVEN_BYTES,
    EXACT_FIT_1BYTE,
    EXACT_FIT_2BYTE,
    URL,
    URL_ENCODED,
)
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman.ops.bitpack import words_from_bytes_np  # noqa: E402
from tpu_huffman_torch import stream as tstream  # noqa: E402
from tpu_huffman_torch.ops import selfsync, stream_decode  # noqa: E402
from tpu_huffman_torch.ops.bitpack import stage_words  # noqa: E402
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402

CPU = "cpu"
# the module: ``tpu_huffman.ops.decode`` is also the name of the function
jax_decode = importlib.import_module("tpu_huffman.ops.decode")


@pytest.fixture(scope="module")
def tables():
    return th.load_static_test_table(), tt.load_static_test_table()


def _random(n, seed, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, size=n, dtype=np.uint8).tobytes()


def _outcome(fn):
    """The bytes a decode returns, or the type of error it raises."""
    try:
        return fn()
    except th.UnknownSymbolError:
        return "unknown"
    except tt.UnknownSymbolError:
        return "unknown"


def _both(enc, ref, t, **kw):
    got = _outcome(lambda: tt.decode(enc, t, device=CPU, **kw))
    want = _outcome(lambda: th.decode(enc, ref, **kw))
    assert got == want
    return got


@pytest.mark.parametrize("plain,enc", [
    (URL, URL_ENCODED),
    (ALL_CODES, ALL_CODES_ENCODED),
    EXACT_FIT_1BYTE,
    EXACT_FIT_2BYTE,
    (EVEN_BYTES[0], None),
    (b"w", bytes([0b10011111])),  # a 6-bit code and 2 bits of padding
    (b"", b""),
], ids=["url", "all_codes", "exact_fit_1", "exact_fit_2", "even_bytes",
        "trailing_padding", "empty"])
def test_golden_vectors(tables, plain, enc):
    ref, t = tables
    if enc is None:
        enc = th.encode(plain, ref)
    assert _both(enc, ref, t) == plain
    if enc:
        assert oracle.oracle_decode(enc, ref) == plain


@pytest.mark.parametrize("n", [1000, 5000, 20000])
def test_random_static(tables, n):
    """Plaintext sizes on both sides of the 2048-byte dispatch."""
    ref, t = tables
    data = _random(n, n)
    enc = th.encode(data, ref)
    assert (len(enc) > 2048) == (n > 1000)
    before = dict(selfsync.launches), dict(stream_decode.launches)
    assert _both(enc, ref, t) == data == oracle.oracle_decode(enc, ref)
    assert (dict(selfsync.launches), dict(stream_decode.launches)) == before


def test_hpack_headers():
    ref, t = th.load_hpack_table(), tt.load_hpack_table()
    data = hpack_corpus(16 * 1024)
    enc = oracle.oracle_encode(data, ref)
    assert _both(enc, ref, t) == data == oracle.oracle_decode(enc, ref)


def _gap():
    specs = [(97, 2, 0), (98, 2, 1), (99, 2, 3)]  # codes 00, 01, 11; 10 is invalid
    return (th.HuffmanTable.from_specs([th.CodeSpec(*s) for s in specs], name="gap"),
            tt.HuffmanTable.from_specs([tt.CodeSpec(*s) for s in specs], name="gap"))


def _deep32():
    lens = {0: 1, **{i: i + 1 for i in range(1, 31)}, 31: 32, 32: 32}
    return th.make_canonical(lens, name="deep32"), tt.make_canonical(lens, name="deep32")


def _one_bit():
    lens = {65: 1, 66: 2}  # Kraft-incomplete: the prefix 11 matches nothing
    return th.make_canonical(lens, name="ab"), tt.make_canonical(lens, name="ab")


@pytest.mark.parametrize("kind,n", [
    ("gap", 400), ("gap", 12000),
    ("deep32", 300), ("deep32", 800),
    ("one_bit", 3000), ("one_bit", 20000),
])
def test_other_tables(kind, n):
    """A non-range-monotone table, 32-bit codes and a 1-bit code, each
    below and above the dispatch size."""
    ref, t = {"gap": _gap, "deep32": _deep32, "one_bit": _one_bit}[kind]()
    lo, hi = {"gap": (97, 100), "deep32": (25, 33), "one_bit": (65, 67)}[kind]
    data = _random(n, 40 + n, lo, hi)
    enc = oracle.oracle_encode(data, ref)
    assert th.encode(data, ref) == enc
    assert (len(enc) > 2048) == (n in (12000, 800, 20000))
    assert _both(enc, ref, t) == data


@pytest.mark.parametrize("size", ["sequential", "selfsync"])
def test_max_output(tables, size):
    ref, t = tables
    n = 1000 if size == "sequential" else 3000
    data = _random(n, 3 + n)
    enc = th.encode(data, ref)
    for k in (0, 1, n // 2, n - 1, n, n + 5):
        assert _both(enc, ref, t, max_output=k) == data[:k], k


@pytest.mark.parametrize("n", [300, 8192])
def test_zero_blob_raises(tables, n):
    """Zeros match no code of the static table: unknown symbol on both
    dispatch paths."""
    ref, t = tables
    with pytest.raises(tt.UnknownSymbolError):
        tt.decode(bytes(n), t, device=CPU)
    with pytest.raises(th.UnknownSymbolError):
        th.decode(bytes(n), ref)


@pytest.mark.parametrize("n", [1200, 6000])
@pytest.mark.parametrize("where", ["mid", "last3", "last5"])
def test_corrupt_stream(tables, n, where):
    """Zeroed bytes mid-way raise. Near the end, where fewer than 32 bits
    are left, the reference stops for more input instead of raising. The
    port does what the JAX package does."""
    ref, t = tables
    data = _random(n, 11 + n)
    enc = bytearray(th.encode(data, ref))
    at = {"mid": len(enc) // 2, "last3": len(enc) - 3, "last5": len(enc) - 5}[where]
    enc[at:at + 5] = bytes(len(enc[at:at + 5]))
    got = _both(bytes(enc), ref, t)
    if where == "mid":
        assert got == "unknown"


def test_gap_table_invalid_code_raises():
    ref, t = _gap()
    data = _random(12000, 5, 97, 100)
    enc = bytearray(th.encode(data, ref))
    enc[1000:1004] = b"\xaa" * 4  # 10 10 10 ...: the invalid prefix
    assert _both(bytes(enc), ref, t) == "unknown"


def _jax_stream(enc, ref, start_bit, total_bits, cap):
    words_np, _ = words_from_bytes_np(enc)
    words = jnp.concatenate([jnp.asarray(words_np), jnp.zeros(2, dtype=jnp.uint32)])
    dt = jax_decode.DeviceTable.for_table(ref)
    steps = 1 << max(8, min(cap + 1, total_bits + 1).bit_length())
    syms, _valid, n, end_bit, status = jax_decode.decode_stream_kernel(
        words, jnp.int32(start_bit), jnp.int32(total_bits), jnp.int32(cap),
        dt.l0_bits, dt.l0_val, dt.l1_bits, dt.l1_val,
        root_bits=ref.root_bits, steps=steps,
    )
    n = int(n)
    return bytes(np.asarray(syms)[:n]), n, int(end_bit), int(status)


@pytest.mark.parametrize("case", [
    "whole", "start_7", "cap_mid", "cap_0", "short_total", "zero_blob",
])
def test_stream_decode_plain_matches_jax_kernel(tables, case):
    """The plain sequential decode against the JAX ``decode_stream_kernel``
    on (start_bit, total_bits, capacity) triples covering all three
    statuses."""
    ref, t = tables
    enc = th.encode(_random(400, 21), ref) if case != "zero_blob" else bytes(64)
    bits = 8 * len(enc)
    start, total, cap = {
        "whole": (0, bits, 10**6),          # trailing padding: OK
        "start_7": (7, bits, 10**6),        # a wrong offset: resyncs or UNKNOWN
        "cap_mid": (0, bits, 123),          # OUTPUT_FULL
        "cap_0": (0, bits, 0),              # OUTPUT_FULL before the first symbol
        "short_total": (0, bits - 37, 10**6),  # needs more input: OK
        "zero_blob": (0, bits, 10**6),      # UNKNOWN
    }[case]
    syms, info = stream_decode.decode_stream(
        stage_words(torch.frombuffer(bytearray(enc), dtype=torch.uint8)),
        start, total, cap, DeviceTable.for_table(t, torch.device(CPU)),
    )
    n, end_bit, status = info.tolist()
    got = (bytes(syms[:n].numpy()), n, end_bit, status)
    assert got == _jax_stream(enc, ref, start, total, cap)
    want_status = {"cap_mid": tt.ops.STATUS_OUTPUT_FULL, "cap_0": tt.ops.STATUS_OUTPUT_FULL,
                   "zero_blob": tt.ops.STATUS_UNKNOWN_SYMBOL}.get(case)
    if want_status is not None:
        assert status == want_status
    elif case != "start_7":
        assert status == tt.ops.STATUS_OK


def test_cuda_without_gpu_raises(monkeypatch, tables):
    """device="cuda" with no usable card raises; it never falls back to the
    CPU versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, t = tables
    enc = th.encode(b"www.example.com" * 300, ref)
    before = dict(selfsync.launches), dict(stream_decode.launches)
    for kw in ({}, {"device": "cuda:0"}, {"max_output": 3}):
        with pytest.raises(RuntimeError, match="cuda"):
            tt.decode(enc, t, **kw)
    assert (dict(selfsync.launches), dict(stream_decode.launches)) == before


def _root16(build):
    """The HPACK table with a 16-bit root LUT, from its specs or from the
    JAX package's table; and the JAX package's table at the same width."""
    ref = th.HuffmanTable.from_specs(th.load_hpack_table().specs(), name="hpack16",
                                     root_bits=16)
    if build == "from_specs":
        t = tt.HuffmanTable.from_specs(tt.load_hpack_table().specs(), name="hpack16",
                                       root_bits=16)
    else:
        t = tt.from_reference(ref)
    return ref, t


@pytest.mark.parametrize("build", ["from_specs", "from_reference"])
@pytest.mark.parametrize("path", ["decode", "decode_indexed", "decoder"])
def test_root_bits_16(monkeypatch, build, path):
    """A table built at root_bits 16 (fault C1): the device LUT is built at
    12, and random bytes, which reach HPACK's 30-bit codes, decode through
    every path equal to the JAX package and the oracle."""
    ref, t = _root16(build)
    assert (ref.root_bits, t.root_bits) == (16, 16)
    assert DeviceTable.for_table(t, torch.device(CPU)).root_bits == 12
    data = _random(1500, 16)
    enc = th.encode(data, ref)
    assert len(enc) > 2048 and int(t.lengths[np.frombuffer(data, np.uint8)].max()) == 30
    assert enc == oracle.oracle_encode(data, ref) == tt.encode(data, t, device=CPU)
    if path == "decode":
        got = tt.decode(enc, t, device=CPU)
        assert got == th.decode(enc, ref)
    elif path == "decode_indexed":
        enc_i, idx = tt.encode_with_index(data, t, block_symbols=256, device=CPU)
        assert enc_i == enc
        got = tt.decode_indexed(enc_i, idx, t, device=CPU)
    else:
        monkeypatch.setattr(tstream, "BULK_DECODE_THRESHOLD", 64)
        dec = tt.HuffmanDecoder(t, device=CPU)
        got = dec.decode_chunk(enc[:1000]).data + dec.decode_chunk(enc[1000:]).data
        assert got == th.HuffmanDecoder(ref).decode_chunk(enc).data
    assert got == data == oracle.oracle_decode(enc, ref)

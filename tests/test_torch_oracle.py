"""The port's C++ oracle binding and numpy word helpers against the JAX
package's.

Both bindings load a library built from the same ``cpp/`` sources (the
port's into ``tpu_huffman_torch/_build/``), so every comparison is exact:
bytes, consumed counts, ``done`` flags, carries and error types.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from chip_smoke import mixed_lengths_5_30  # noqa: E402  (bench_suite without its JAX set-up)
from tpu_huffman import oracle as th_oracle  # noqa: E402
from tpu_huffman.ops import bitpack as th_bitpack  # noqa: E402
from tpu_huffman_torch import oracle as tt_oracle  # noqa: E402
from tpu_huffman_torch.ops import bitpack as tt_bitpack  # noqa: E402

TABLES = ("static", "hpack", "5-30")
EOS = (0xFF, 0x00, 0x5A)


def tables(name):
    """(JAX package's table, port's table) of one name."""
    if name == "static":
        return th.load_static_test_table(), tt.load_static_test_table()
    if name == "hpack":
        return th.load_hpack_table(), tt.load_hpack_table()
    lens = mixed_lengths_5_30()
    return (th.make_canonical(lens, name="mixed_5_30"),
            tt.make_canonical(lens, name="mixed_5_30"))


def _random(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("eos", EOS, ids=lambda e: f"eos{e:02x}")
@pytest.mark.parametrize("name", TABLES)
def test_one_shot_matches(name, eos):
    ref_t, port_t = tables(name)
    data = _random(3000, seed=len(name) + eos)
    ref_enc = th_oracle.OracleEncoder(th_oracle.OracleTable(ref_t), eos)
    port_enc = tt_oracle.OracleEncoder(tt_oracle.OracleTable(port_t), eos)
    assert port_enc.encoded_length(data) == ref_enc.encoded_length(data)
    encoded = port_enc.encode(data)
    assert encoded == ref_enc.encode(data)
    assert port_enc.overflow_bits == ref_enc.overflow_bits == (0, 0)
    assert tt_oracle.oracle_encode(data, port_t, eos) == th_oracle.oracle_encode(data, ref_t, eos)
    assert tt_oracle.oracle_decode(encoded, port_t) == th_oracle.oracle_decode(encoded, ref_t)
    if eos == 0xFF:
        assert tt_oracle.oracle_decode(encoded, port_t) == data


def _encode_steps(enc, data, step):
    """Every encode_chunk of a SHORT_BUFFER loop at capacity ``step``, with
    the carry after it."""
    calls, pending = [], data
    for _ in range(100_000):
        out, consumed, done = enc.encode_chunk(pending, step)
        calls.append((out, consumed, done, enc.overflow_bits))
        pending = pending[consumed:]
        if done:
            return calls
    raise AssertionError("encoder loop did not finish")


def _decode_steps(dec, encoded, step):
    """Every decode_chunk of ``step``-byte input pieces at output capacity
    ``step``, with the leftover bits after it."""
    calls = []
    for i in range(0, len(encoded), step):
        pending = encoded[i:i + step]
        for _ in range(100_000):
            out, consumed, done = dec.decode_chunk(pending, step)
            calls.append((out, consumed, done, dec.leftover_bits))
            pending = pending[consumed:]
            if done and not pending:
                break
    return calls


@pytest.mark.parametrize("step", range(1, 18))
@pytest.mark.parametrize("name", TABLES)
def test_chunks_match(name, step):
    ref_t, port_t = tables(name)
    data = _random(160, seed=step)
    ref_o, port_o = th_oracle.OracleTable(ref_t), tt_oracle.OracleTable(port_t)
    got = _encode_steps(tt_oracle.OracleEncoder(port_o), data, step)
    assert got == _encode_steps(th_oracle.OracleEncoder(ref_o), data, step)
    encoded = b"".join(c[0] for c in got)
    got = _decode_steps(tt_oracle.OracleDecoder(port_o), encoded, step)
    assert got == _decode_steps(th_oracle.OracleDecoder(ref_o), encoded, step)
    assert b"".join(c[0] for c in got) == data


def test_reset_clears_the_carry():
    ref_t, port_t = tables("static")
    pair = []
    for oracle, table in ((th_oracle, ref_t), (tt_oracle, port_t)):
        otable = oracle.OracleTable(table)
        enc, dec = oracle.OracleEncoder(otable), oracle.OracleDecoder(otable)
        enc.encode_chunk(b"abc", 1)
        dec.decode_chunk(oracle.oracle_encode(b"abc", table)[:1], 8)
        carries = [enc.overflow_bits, dec.leftover_bits]
        enc.reset()
        dec.reset()
        pair.append(carries + [enc.overflow_bits, dec.leftover_bits])
    assert pair[0] == pair[1]
    assert pair[1][0][1] and pair[1][1][1] and pair[1][2:] == [(0, 0), (0, 0)]


@pytest.mark.parametrize("case", ["encode_unknown", "decode_invalid"])
def test_errors_match(case):
    if case == "encode_unknown":
        lens = {97: 1, 98: 2, 99: 2}
        ref_t, port_t = th.make_canonical(lens), tt.make_canonical(lens)
        run_ref = lambda: th_oracle.oracle_encode(b"abz", ref_t)  # noqa: E731
        run_port = lambda: tt_oracle.oracle_encode(b"abz", port_t)  # noqa: E731
    else:
        ref_t, port_t = tables("static")
        run_ref = lambda: th_oracle.oracle_decode(bytes(64), ref_t)  # noqa: E731
        run_port = lambda: tt_oracle.oracle_decode(bytes(64), port_t)  # noqa: E731
    with pytest.raises(th.UnknownSymbolError):
        run_ref()
    with pytest.raises(tt.UnknownSymbolError):
        run_port()


def test_library_builds_in_the_port():
    assert tt_oracle.oracle_available()
    assert tt_oracle._LIB_PATH.endswith("tpu_huffman_torch/_build/libtpuhuff.so")


@pytest.mark.parametrize("n", range(68))
def test_word_helpers_match(n):
    data = _random(n, seed=100 + n)
    ref_w, ref_n = th_bitpack.words_from_bytes_np(data)
    got_w, got_n = tt_bitpack.words_from_bytes_np(data)
    assert got_n == ref_n == n
    assert got_w.dtype == ref_w.dtype == np.uint32 and np.array_equal(got_w, ref_w)
    arr = np.frombuffer(data, dtype=np.uint8)
    assert np.array_equal(tt_bitpack.words_from_bytes_np(arr)[0], ref_w)
    for k in range(n + 1):
        want = th_bitpack.bytes_from_words_np(ref_w, k)
        assert tt_bitpack.bytes_from_words_np(ref_w, k) == want == data[:k]
    # the port's tensors hold words as int32: the same bits, the same bytes
    assert tt_bitpack.bytes_from_words_np(ref_w.view(np.int32), n) == data


@pytest.mark.parametrize("module", [
    "oracle", "ops.bitpack", "ops.encode",
])
def test_public_names_are_ported(module):
    """Every public function and class the JAX module defines, but for its
    XLA functions (the kernels stand in for them), is in the port's module."""
    xla = {"encode_block_kernel", "encode_block_kernel_indexed", "encoded_length_bits_kernel"}
    ref = importlib.import_module(f"tpu_huffman.{module}")
    port = importlib.import_module(f"tpu_huffman_torch.{module}")
    defined = {k for k, v in vars(ref).items()
               if not k.startswith("_") and getattr(v, "__module__", None) == ref.__name__}
    assert defined - xla <= set(vars(port)), sorted(defined - xla - set(vars(port)))

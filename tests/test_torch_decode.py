"""The PyTorch port's indexed decode against the JAX package.

The JAX package's decode_indexed takes its scan path
(``decode_blocks_kernel``) here for block_symbols > 32, so comparisons use
block_symbols >= 64; that its Pallas kernels agree with the scan path is
asserted by tests/test_pallas_decode.py. Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from chip_smoke import hpack_corpus  # noqa: E402  (bench_suite without its JAX set-up)
from tpu_huffman import oracle  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def tables():
    return th.load_static_test_table(), tt.load_static_test_table()


def _random(n, seed, hi=256):
    return np.random.default_rng(seed).integers(0, hi, size=n, dtype=np.uint8).tobytes()


def _port_index(idx):
    """A JAX-package BlockIndex as the port's (the same fields)."""
    return tt.BlockIndex(
        idx.symbols_per_block, idx.bit_offsets, idx.n_symbols,
        idx.total_symbols, idx.total_bits, idx.max_code_len,
    )


@pytest.mark.parametrize("block_symbols", [64, 256])
@pytest.mark.parametrize("n", [1, 1000, 40000])
def test_round_trip_equals_reference(tables, n, block_symbols):
    ref, t = tables
    data = _random(n, n + block_symbols)
    enc, idx = tt.encode_with_index(data, t, block_symbols=block_symbols, device=CPU)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=block_symbols)
    got = tt.decode_indexed(enc, idx, t, device=CPU)
    assert got == th.decode_indexed(ref_enc, ref_idx, ref) == data
    # the port decodes the JAX package's own index too
    assert tt.decode_indexed(ref_enc, _port_index(ref_idx), t, device=CPU) == data


@pytest.mark.parametrize("n,block_symbols", [(300, 512), (5000, 512), (200, 256)],
                         ids=["one_block_512", "k512", "one_block_256"])
def test_single_chain_cases(tables, n, block_symbols):
    """One-block inputs and K = 512: the cases the JAX package sends to its
    single-chain kernel (B3)."""
    ref, t = tables
    data = _random(n, 77 + n)
    enc, idx = tt.encode_with_index(data, t, block_symbols=block_symbols, device=CPU)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=block_symbols)
    assert enc == ref_enc
    assert tt.decode_indexed(enc, idx, t, device=CPU) == data
    assert th.decode_indexed(ref_enc, ref_idx, ref) == data


def test_ragged_index(tables):
    ref, t = tables
    data = _random(3000, 9)
    enc = tt.encode(data, t, device=CPU)
    counts = np.array([64, 1, 37, 64, 0, 64, 50] + [64] * 43, dtype=np.int32)
    counts[-1] += len(data) - counts.sum()
    assert 0 < counts[-1] <= 64
    ends = np.cumsum(ref.lengths[np.frombuffer(data, np.uint8)].astype(np.int64))
    firsts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offs = np.where(firsts > 0, ends[np.maximum(firsts - 1, 0)], 0).astype(np.int64)
    args = (64, offs, counts, len(data), int(ends[-1]), int(ref.max_len))
    got = tt.decode_indexed(enc, tt.BlockIndex(*args), t, device=CPU)
    assert got == th.decode_indexed(enc, th.BlockIndex(*args), ref) == data


def test_non_range_monotone_gap_table():
    specs = [(97, 2, 0), (98, 2, 1), (99, 2, 3)]  # codes 00, 01, 11
    ref = th.HuffmanTable.from_specs([th.CodeSpec(*s) for s in specs], name="gap")
    t = tt.HuffmanTable.from_specs([tt.CodeSpec(*s) for s in specs], name="gap")
    data = b"abcabccba" * 50
    enc, idx = tt.encode_with_index(data, t, block_symbols=64, device=CPU)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=64)
    assert enc == ref_enc
    assert tt.decode_indexed(enc, idx, t, device=CPU) == th.decode_indexed(
        ref_enc, ref_idx, ref) == data


@pytest.mark.parametrize("corpus", ["headers", "random"])
def test_hpack(corpus):
    ref, t = th.load_hpack_table(), tt.load_hpack_table()
    data = hpack_corpus(20000) if corpus == "headers" else _random(20000, 12)
    enc, idx = tt.encode_with_index(data, t, block_symbols=64, device=CPU)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=64)
    assert enc == ref_enc == oracle.oracle_encode(data, ref)
    assert tt.decode_indexed(enc, idx, t, device=CPU) == th.decode_indexed(
        ref_enc, ref_idx, ref) == data


def test_32_bit_codes():
    lens = {0: 1, **{i: i + 1 for i in range(1, 31)}, 31: 32, 32: 32}
    ref, t = th.make_canonical(lens, name="deep32"), tt.make_canonical(lens, name="deep32")
    data = np.random.default_rng(5).integers(25, 33, size=700, dtype=np.uint8).tobytes()
    enc, idx = tt.encode_with_index(data, t, block_symbols=64, device=CPU)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=64)
    assert enc == ref_enc == oracle.oracle_encode(data, ref)
    assert idx.max_code_len == 32
    assert tt.decode_indexed(enc, idx, t, device=CPU) == data


def test_corrupt_stream_raises():
    """Kraft-incomplete table: the prefix 11 matches no code, so a block
    running into 0xFF bytes must raise, as the JAX package's Pallas decode
    does."""
    t = tt.make_canonical({65: 1, 66: 2})
    data = b"AB" * 400
    enc, idx = tt.encode_with_index(data, t, block_symbols=64, device=CPU)
    assert tt.decode_indexed(enc, idx, t, device=CPU) == data
    bad = bytearray(enc)
    bad[40:48] = b"\xff" * 8
    with pytest.raises(tt.UnknownSymbolError):
        tt.decode_indexed(bytes(bad), idx, t, device=CPU)


def test_malformed_index_rejected(tables):
    _ref, t = tables
    data = _random(500, 4)
    enc, idx = tt.encode_with_index(data, t, block_symbols=64, device=CPU)
    fields = dict(symbols_per_block=64, bit_offsets=idx.bit_offsets,
                  n_symbols=idx.n_symbols, total_symbols=500,
                  total_bits=idx.total_bits)
    for change in (
        dict(total_symbols=499),
        dict(n_symbols=idx.n_symbols[:-1]),
        dict(bit_offsets=idx.bit_offsets + 8 * len(enc)),
        dict(bit_offsets=idx.bit_offsets - 1),
    ):
        with pytest.raises(ValueError):
            tt.decode_indexed(enc, tt.BlockIndex(**{**fields, **change}), t, device=CPU)

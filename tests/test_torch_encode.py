"""The PyTorch port's encode against the JAX package and the C++ oracle.

On the CPU the port's wrappers run the kernels' plain versions. The JAX
package's encode_with_index takes its XLA path here
(``encode_block_kernel_indexed``), so comparisons pass an explicit
block_symbols. Every comparison is exact: the codec is integer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman_torch.ops import pack_encode  # noqa: E402

import golden  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def tables():
    return th.load_static_test_table(), tt.load_static_test_table()


def _index_fields(idx):
    return (idx.symbols_per_block, idx.total_symbols, idx.total_bits, idx.max_code_len)


def assert_same_index(port, ref):
    assert _index_fields(port) == _index_fields(ref)
    assert port.bit_offsets.dtype == ref.bit_offsets.dtype == np.int64
    assert port.n_symbols.dtype == ref.n_symbols.dtype
    assert np.array_equal(port.bit_offsets, ref.bit_offsets)
    assert np.array_equal(port.n_symbols, ref.n_symbols)


@pytest.mark.parametrize(
    "plain,want",
    [
        (golden.URL, golden.URL_ENCODED),
        (golden.ALL_CODES, golden.ALL_CODES_ENCODED),
        golden.EXACT_FIT_1BYTE,
        golden.EXACT_FIT_2BYTE,
    ],
    ids=["url", "all_codes", "exact_fit_1", "exact_fit_2"],
)
def test_golden_vectors(tables, plain, want):
    _ref, t = tables
    assert tt.encode(plain, t, device=CPU) == want
    enc, idx = tt.encode_with_index(plain, t, device=CPU)
    assert enc == want
    assert tt.decode_indexed(enc, idx, t, device=CPU) == plain


def test_even_bytes_need_no_padding(tables):
    _ref, t = tables
    data, nbytes = golden.EVEN_BYTES
    assert len(tt.encode(data, t, device=CPU)) == nbytes
    assert tt.get_encoded_length(data, t) == nbytes


@pytest.mark.parametrize("eos", [0xFF, 0x00, 0xA5])
def test_eos_padding(tables, eos):
    ref, t = tables
    data = golden.URL + b"?"  # 93 bits: 3 bits of padding
    want = th.encode(data, ref, eos_padding=eos)
    assert want == oracle.oracle_encode(data, ref, eos_padding=eos)
    assert tt.encode(data, t, eos_padding=eos, device=CPU) == want
    enc, _idx = tt.encode_with_index(data, t, eos_padding=eos, block_symbols=64, device=CPU)
    assert enc == want


def test_empty_input(tables):
    ref, t = tables
    assert tt.encode(b"", t, device=CPU) == b""
    enc, idx = tt.encode_with_index(b"", t, block_symbols=64, device=CPU)
    ref_enc, ref_idx = th.encode_with_index(b"", ref, block_symbols=64)
    assert enc == ref_enc == b""
    assert_same_index(idx, ref_idx)
    assert tt.decode_indexed(enc, idx, t, device=CPU) == b""


@pytest.mark.parametrize("with_index", [False, True])
def test_unknown_symbol_matches_reference(with_index):
    ref = th.make_canonical({65: 1, 66: 2})
    t = tt.make_canonical({65: 1, 66: 2})
    data = b"AB" * 300 + b"C" + b"AB" * 3 + b"D"
    with pytest.raises(th.UnknownSymbolError) as want:
        th.encode(data, ref)
    with pytest.raises(tt.UnknownSymbolError) as got:
        if with_index:
            tt.encode_with_index(data, t, block_symbols=64, device=CPU)
        else:
            tt.encode(data, t, device=CPU)
    assert (got.value.index, got.value.symbol) == (want.value.index, want.value.symbol)
    assert (got.value.index, got.value.symbol) == (600, 67)


@pytest.mark.parametrize("block_symbols", [64, 192, 256, 512])
@pytest.mark.parametrize("n", [1, 33, 1000, 40000])
def test_random_equals_reference_and_oracle(tables, n, block_symbols):
    ref, t = tables
    data = np.random.default_rng(n * 7 + block_symbols).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()
    enc, idx = tt.encode_with_index(data, t, block_symbols=block_symbols, device=CPU)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=block_symbols)
    assert enc == ref_enc == oracle.oracle_encode(data, ref)
    assert_same_index(idx, ref_idx)
    assert tt.encode(data, t, device=CPU) == enc


@pytest.mark.parametrize("block_symbols", [256, 512])
def test_seam_exact_multiple_of_launch_block(tables, block_symbols):
    """n an exact multiple of the index block and of the encode kernels'
    tile (one CUDA block's symbols): the stitch seam where the JAX TPU path
    once miscounted."""
    ref, t = tables
    n = 2 * pack_encode.TILE
    assert n % block_symbols == 0
    data = np.random.default_rng(3).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    enc, idx = tt.encode_with_index(data, t, block_symbols=block_symbols, device=CPU)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=block_symbols)
    assert enc == ref_enc == oracle.oracle_encode(data, ref)
    assert_same_index(idx, ref_idx)


def test_hpack_long_codes_and_get_encoded_length():
    ref, t = th.load_hpack_table(), tt.load_hpack_table()
    data = np.random.default_rng(5).integers(0, 256, size=3000, dtype=np.uint8).tobytes()
    enc, idx = tt.encode_with_index(data, t, block_symbols=64, device=CPU)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=64)
    assert enc == ref_enc == oracle.oracle_encode(data, ref)
    assert_same_index(idx, ref_idx)
    assert idx.max_code_len == 30
    assert tt.get_encoded_length(data, t) == th.get_encoded_length(data, ref) == len(enc)


@pytest.mark.parametrize("block_symbols", [0, -64])
def test_bad_block_symbols_rejected(tables, block_symbols):
    _ref, t = tables
    with pytest.raises(ValueError):
        tt.encode_with_index(b"abc", t, block_symbols=block_symbols, device=CPU)


def test_input_forms(tables):
    _ref, t = tables
    data = golden.URL
    want = golden.URL_ENCODED
    assert tt.encode(bytearray(data), t, device=CPU) == want
    assert tt.encode(np.frombuffer(data, np.uint8), t, device=CPU) == want
    assert tt.encode(torch.tensor(list(data), dtype=torch.uint8), t, device=CPU) == want
    with pytest.raises(ValueError):
        tt.encode(torch.tensor(list(data), dtype=torch.int32), t, device=CPU)

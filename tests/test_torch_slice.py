"""The port's main path end to end: encode_with_index, then decode_indexed.

On the CPU this runs the kernels' plain versions and holds the result
against the C++ oracle's bytes and the JAX package's index. The kernels
themselves run only on a CUDA card (test_kernels_match_plain_on_card, and
chip_smoke.py, which drives the same path at full size there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from chip_smoke import hpack_corpus  # noqa: E402
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman_torch.ops import chain_decode, pack_encode  # noqa: E402
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402

KIB = 1024


def _launches():
    return {**pack_encode.launches, **chain_decode.launches}


@pytest.mark.parametrize("kind", ["static_256k_random", "hpack_64k_headers"])
def test_slice_end_to_end(kind):
    if kind.startswith("static"):
        ref, t = th.load_static_test_table(), tt.load_static_test_table()
        data = np.random.default_rng(2024).integers(
            0, 256, size=256 * KIB, dtype=np.uint8).tobytes()
    else:
        ref, t = th.load_hpack_table(), tt.load_hpack_table()
        data = hpack_corpus(64 * KIB)
    before = _launches()
    enc, idx = tt.encode_with_index(data, t, device="cpu")
    assert idx.symbols_per_block == 256  # the port's default
    assert enc == oracle.oracle_encode(data, ref)
    _ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=256)
    assert np.array_equal(idx.bit_offsets, ref_idx.bit_offsets)
    assert idx.bit_offsets.dtype == ref_idx.bit_offsets.dtype
    assert np.array_equal(idx.n_symbols, ref_idx.n_symbols)
    assert (idx.total_symbols, idx.total_bits, idx.max_code_len) == (
        ref_idx.total_symbols, ref_idx.total_bits, ref_idx.max_code_len)
    assert tt.decode_indexed(enc, idx, t, device="cpu") == data
    assert _launches() == before  # CPU tensors never reach a kernel


@pytest.mark.parametrize("call", ["encode", "encode_with_index", "decode_indexed"])
def test_cuda_without_gpu_raises(monkeypatch, call):
    """device="cuda" with no usable card raises; it never falls back to the
    CPU versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = tt.load_static_test_table()
    enc, idx = tt.encode_with_index(b"abc", t, device="cpu")
    args = {
        "encode": (tt.encode, (b"abc", t)),
        "encode_with_index": (tt.encode_with_index, (b"abc", t)),
        "decode_indexed": (tt.decode_indexed, (enc, idx, t)),
    }
    fn, a = args[call]
    before = _launches()
    with pytest.raises(RuntimeError, match="cuda"):
        fn(*a)
    with pytest.raises(RuntimeError, match="cuda"):
        fn(*a, device="cuda:0")
    assert _launches() == before


def test_unsupported_device_rejected():
    t = tt.load_static_test_table()
    with pytest.raises(ValueError):
        tt.encode(b"abc", t, device="meta")


def test_library_init_parity():
    tt.library_clean_up()
    assert not tt.library_is_initialized()
    tt.library_init()
    tt.library_init()  # idempotent
    assert tt.library_is_initialized()
    tt.library_clean_up()
    assert not tt.library_is_initialized()
    assert set(tt.__all__) <= set(dir(tt))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each kernel equals its plain version on the same CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    t = tt.load_hpack_table()
    dt = DeviceTable.for_table(t, dev)
    data = np.random.default_rng(1).integers(0, 256, size=100_000, dtype=np.uint8)
    sym = torch.from_numpy(data).to(dev)
    cb, st = pack_encode.count(sym, dt)
    cb_p, st_p = pack_encode.count_plain(sym, dt)
    assert torch.equal(cb, cb_p) and torch.equal(st, st_p)
    incl = torch.cumsum(cb, 0, dtype=torch.int64)
    offs = incl - cb
    total = int(incl[-1])
    n_words = -(-(total + pack_encode.pad_code(total, 0xFF)[1]) // 32)
    w, block_offs = pack_encode.pack(sym, dt, offs, total, 0xFF, n_words, 256)
    w_p, block_offs_p = pack_encode.pack_plain(sym, dt, offs, total, 0xFF, n_words, 256)
    assert torch.equal(w, w_p) and torch.equal(block_offs, block_offs_p)
    nb = block_offs.numel()
    nsyms = torch.full((nb,), 256, dtype=torch.int32, device=dev)
    nsyms[-1] = sym.numel() - (nb - 1) * 256
    out_start = torch.arange(nb, dtype=torch.int64, device=dev) * 256
    got = chain_decode.decode_chains(w, block_offs, nsyms, out_start, sym.numel(), dt)
    want = chain_decode.decode_chains_plain(w, block_offs, nsyms, out_start, sym.numel(), dt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0], sym)

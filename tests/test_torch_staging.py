"""Host staging of the port's downloads (``ops.encode.to_host``).

Every read of a device tensor back to the host in the public calls goes
through ``to_host``: on a card into a pinned block that torch's caching
host allocator keeps, one blocking copy; on the CPU the tensor
as it is. The answers, the downloads a call (``copies.d2h``) and the host
syncs a call stay those of the ``.cpu()`` reads it replaced, and no array
handed to a caller is a view of the block, which the allocator hands out
again.

The file imports no JAX: the C++ oracle (``tpu_huffman_torch.oracle``) is
the reference, so that the ``cuda`` tests run on a card as they are.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman_torch as tt  # noqa: E402
from tpu_huffman_torch import metrics, oracle  # noqa: E402
from tpu_huffman_torch import stream as tstream  # noqa: E402
from tpu_huffman_torch.ops import bitpack  # noqa: E402
from tpu_huffman_torch.ops import selfsync  # noqa: E402

encode_ops = importlib.import_module("tpu_huffman_torch.ops.encode")  # `ops.encode` is the function

MIB = 1 << 20


def _text(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(32, 127, n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def table():
    return tt.load_static_test_table()


def _round_trip(t, dev, n):
    data = _text(n, 1)
    enc, idx = tt.encode_with_index(data, t, device=dev)
    return [(enc, oracle.oracle_encode(data, t)), (tt.decode_indexed(enc, idx, t, device=dev),
                                                   data)], 2


def _encode(t, dev, n):
    data = _text(n, 2)
    return [(tt.encode(data, t, device=dev), oracle.oracle_encode(data, t))], 1


def _foreign(t, dev, n):
    data = _text(n, 3)
    return [(tt.decode(oracle.oracle_encode(data, t), t, device=dev), data)], 1


def _fed(t, dev, n):
    """HPACK's shape: short strings, each a decode_chunk and a padding check;
    every other one's codes end on a byte, so that its padding check reads
    an empty remainder."""
    dec = tstream.HuffmanDecoder(t, device=dev)
    pairs, seed = [], 40
    for i in range(n):
        while True:
            s, seed = _text(1 + 7 * i % 50, seed), seed + 1
            if i % 2 or int(t.lengths[np.frombuffer(s, np.uint8)].sum()) % 8 == 0:
                break
        pairs.append((dec.decode_chunk(oracle.oracle_encode(s, t)).data, s))
        pairs.append((dec.padding_is_all_ones(), True))
        dec.reset()
    return pairs, n


def _fed_bulk(t, dev, n):
    """A stream fed in chunks over the bulk threshold: the fused drains."""
    data = _text(n, 4)
    enc = oracle.oracle_encode(data, t)
    dec = tstream.HuffmanDecoder(t, device=dev)
    step = -(-len(enc) // 4)
    out = b"".join(dec.decode_chunk(enc[i:i + step]).data for i in range(0, len(enc), step))
    return [(out, data)], -(-len(enc) // step)


def _encode_chunks(t, dev, n):
    """A capped streaming encode: the fused call and its one download."""
    data = _text(n, 5)
    encoder, out, calls, left = tstream.HuffmanEncoder(t, device=dev), b"", 0, data
    while True:
        r = encoder.encode_chunk(left, n // 5)
        out, left, calls = out + r.data, left[r.consumed:], calls + 1
        if r.done:
            break
    return [(out, oracle.oracle_encode(data, t))], calls


# name -> (the case, its size on the CPU, the downloads it makes there: the
# count the `.cpu()` reads made before to_host)
CASES = {
    "round_trip": (_round_trip, 40000, 5),
    "encode": (_encode, 30000, 2),
    "foreign": (_foreign, 20000, 4),
    "fed": (_fed, 12, 36),
    "fed_bulk": (_fed_bulk, 20000, 4),
    "encode_chunks": (_encode_chunks, 20000, 6),
}


@contextlib.contextmanager
def _small_bulk():
    """The bulk paths at a CPU test's sizes (as tests/test_torch_stream_words.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstream, "BULK_DECODE_THRESHOLD", 256)
        mp.setattr(selfsync, "SEG_WORDS", 16)
        yield


def _spy(monkeypatch, wrap=None):
    """Every module's ``to_host`` wrapped; returns the tensors it handed out
    (``wrap`` in place of the real helper, if given)."""
    real, seen = encode_ops.to_host, []

    def spy(t):
        host = (wrap or real)(t)
        seen.append(host)
        return host

    for name, mod in list(sys.modules.items()):
        if name.startswith("tpu_huffman_torch") and getattr(mod, "to_host", None) is real:
            monkeypatch.setattr(mod, "to_host", spy)
    return seen


def _grew(before: dict) -> dict:
    after = metrics.counters_snapshot()
    return {k: after[k] - before.get(k, 0) for k in after}


@pytest.mark.parametrize("case", list(CASES))
def test_answers_equal_the_oracle_on_cpu(table, case):
    fn, n, _downloads = CASES[case]
    with _small_bulk():
        pairs, _calls = fn(table, "cpu", n)
    for got, want in pairs:
        assert got == want


@pytest.mark.parametrize("case", list(CASES))
def test_every_download_goes_through_to_host(table, monkeypatch, case):
    fn, n, downloads = CASES[case]
    with _small_bulk():
        fn(table, "cpu", n)  # the table's set-up and the oracle's load out of the count
        seen = _spy(monkeypatch)
        before = metrics.counters_snapshot()
        fn(table, "cpu", n)
    grew = _grew(before)
    assert grew["copies.d2h"] == downloads == len(seen)
    assert grew["copies.d2h_pinned"] == 0  # nothing is pinned on the CPU


def _owns(arr: np.ndarray, blocks) -> bool:
    return arr.base is None and not any(np.shares_memory(arr, b.numpy()) for b in blocks)


def test_block_offsets_own_their_memory(table, monkeypatch):
    # each read lands in a fresh tensor, as in a pinned block on a card
    blocks = _spy(monkeypatch, lambda t: t.clone())
    data = _text(5000, 6)
    enc, idx = tt.encode_with_index(data, table, block_symbols=100, device="cpu")
    assert len(blocks) == 3 and _owns(idx.bit_offsets, blocks)
    assert tt.decode_indexed(enc, idx, table, device="cpu") == data


@pytest.mark.parametrize("sizes", [(0,), (5,), (3, 0, 1000)])
def test_download_parts_own_their_memory(monkeypatch, sizes):
    blocks = _spy(monkeypatch, lambda t: t.clone())
    scalars = torch.tensor([7, -1, 1 << 40], dtype=torch.int64)
    parts = [torch.arange(n, dtype=torch.int64).to(torch.uint8) for n in sizes]
    vals, arrays = bitpack.download(scalars, *parts)
    assert vals == [7, -1, 1 << 40] and len(blocks) == 1
    for arr, part in zip(arrays, parts):
        assert np.array_equal(arr, part.numpy()) and _owns(arr, blocks)


def test_a_fed_remainder_owns_its_memory(table, monkeypatch):
    blocks = _spy(monkeypatch, lambda t: t.clone())
    dec = tstream.HuffmanDecoder(table, device="cpu")
    enc = oracle.oracle_encode(b"www.example.com", table)
    assert dec.decode_chunk(enc[:-1], capacity=3).data == b"www"
    data, _start = dec._rem.to_host()
    assert data.size and _owns(data, blocks)


# ---- on a card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


# sizes on the card: 8 MiB for the bulk calls
CARD_SIZES = {"round_trip": 8 * MIB, "encode": 8 * MIB, "foreign": 8 * MIB, "fed": 12,
              "fed_bulk": 8 * MIB, "encode_chunks": 8 * MIB}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_every_download_lands_in_a_pinned_block_on_card(table, monkeypatch, case):
    dev = _card()
    fn = CASES[case][0]
    fn(table, dev, CARD_SIZES[case])
    blocks = _spy(monkeypatch)
    before = metrics.counters_snapshot()
    pairs, _calls = fn(table, dev, CARD_SIZES[case])
    grew = _grew(before)
    assert grew["copies.d2h"] > 0 and grew["copies.d2h_pinned"] == grew["copies.d2h"]
    assert len(blocks) == grew["copies.d2h"]
    assert all(b.is_pinned() for b in blocks if b.numel())
    for got, want in pairs:
        assert got == want


def _syncs(fn) -> int:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # not the mode's own notice, given once a process ("Synchronization debug mode ...")
    return sum("called a synchronizing" in str(w.message) for w in caught)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_host_syncs_a_call_equal_the_pageable_reads(table, monkeypatch, case):
    """Each call waits as often as with the ``.cpu()`` reads it replaced."""
    dev = _card()
    fn, n = CASES[case][0], CARD_SIZES[case]
    fn(table, dev, n)
    torch.cuda.synchronize()
    pinned = _syncs(lambda: fn(table, dev, n))
    with monkeypatch.context() as mp:
        seen = _spy(mp, lambda t: t.cpu())
        pageable = _syncs(lambda: fn(table, dev, n))
    assert seen and pinned == pageable


@pytest.mark.cuda
def test_answers_outlive_the_next_call_of_their_size(table):
    """Two answers and indexes taken before a third call of the same size
    are unchanged after it: no pinned block was handed out again under an
    answer a caller holds."""
    dev = _card()
    datas = [_text(8 * MIB, 10 + i) for i in range(3)]
    kept = []
    for data in datas[:2]:
        enc, idx = tt.encode_with_index(data, table, device=dev)
        kept.append((data, enc, idx, tt.decode_indexed(enc, idx, table, device=dev),
                     tt.decode(enc, table, device=dev)))
    enc3, idx3 = tt.encode_with_index(datas[2], table, device=dev)
    assert tt.decode_indexed(enc3, idx3, table, device=dev) == datas[2]
    assert tt.decode(enc3, table, device=dev) == datas[2]
    for data, enc, idx, dec, foreign in kept:
        assert enc == oracle.oracle_encode(data, table) and dec == foreign == data
        want = tt.encode_with_index(data, table, device="cpu")[1]
        assert np.array_equal(idx.bit_offsets, want.bit_offsets)

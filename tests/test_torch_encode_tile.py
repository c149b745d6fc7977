"""The encode's tile contract (``ops/pack_encode.py``: count and pack over
tiles of ``TILE`` symbols, the index's block offsets from the pack) against
the JAX package and the C++ oracle, on the CPU.

The wrappers run their plain versions here; the kernels run only on a CUDA
card (chip_smoke.py phase 2 holds them against these plain versions at the
same edges). Inputs come from numpy seeds; every comparison is exact: the
codec is integer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman_torch.ops import pack_encode  # noqa: E402
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402
from tpu_huffman_torch.prof import pack_ablate  # noqa: E402

CPU = torch.device("cpu")
TILE = pack_encode.TILE
SIZES = [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 17]


@pytest.fixture(scope="module")
def static():
    return th.load_static_test_table(), tt.load_static_test_table()


@pytest.fixture(scope="module")
def hpack():
    return th.load_hpack_table(), tt.load_hpack_table()


def _data(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8)


def _assert_same(data, ref, t, block_symbols):
    enc, idx = tt.encode_with_index(data, t, block_symbols=block_symbols, device="cpu")
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=block_symbols)
    assert enc == ref_enc == oracle.oracle_encode(data, ref)
    assert (idx.symbols_per_block, idx.total_symbols, idx.total_bits, idx.max_code_len) == (
        ref_idx.symbols_per_block, ref_idx.total_symbols, ref_idx.total_bits,
        ref_idx.max_code_len)
    assert idx.bit_offsets.dtype == ref_idx.bit_offsets.dtype == np.int64
    assert np.array_equal(idx.bit_offsets, ref_idx.bit_offsets)
    assert np.array_equal(idx.n_symbols, ref_idx.n_symbols)
    return enc, idx


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("block_symbols", [1, 3, 100, 257, 4096, 5000])
def test_encode_with_index_any_block_size(static, n, block_symbols):
    """The index at any block_symbols >= 1 comes from the pack's own scan
    over fixed tiles: equal to the JAX package's, bytes equal the oracle's."""
    ref, t = static
    data = _data(n, n + block_symbols).tobytes()
    enc, idx = _assert_same(data, ref, t, block_symbols)
    assert tt.decode_indexed(enc, idx, t, device="cpu") == data


@pytest.mark.parametrize("n,block_symbols", [(TILE + 1, 100), (3 * TILE + 17, 257),
                                             (2 * TILE, 1)])
def test_encode_with_index_hpack_long_codes(hpack, n, block_symbols):
    """HPACK's codes up to 30 bits: a thread's 16 codes cross up to 15
    words, a tile's last word takes several of the next tile's codes."""
    ref, t = hpack
    data = _data(n, 7 * n).tobytes()
    _enc, idx = _assert_same(data, ref, t, block_symbols)
    assert idx.max_code_len == 30


@pytest.mark.parametrize("n", SIZES)
def test_count_plain_tile_totals_equal_numpy(static, n):
    _ref, t = static
    data = _data(n, 3 * n)
    data[n // 2] = 0  # every byte has a code in the static table
    tile_bits, stats = pack_encode.count(torch.from_numpy(data), DeviceTable.for_table(t, CPU))
    lens = t.lengths[data].astype(np.int64)
    want = [lens[i:i + TILE].sum() for i in range(0, n, TILE)]
    assert tile_bits.dtype == torch.int32
    assert tile_bits.tolist() == want
    assert stats.tolist() == [n, lens.max()]


def test_count_plain_first_unknown_symbol():
    t = tt.make_canonical({65: 1, 66: 2})
    data = np.full(3 * TILE, 65, np.uint8)
    data[7] = 66  # the longest code in the data: 2 bits
    data[TILE + 5] = 67
    data[2 * TILE] = 68
    _bits, stats = pack_encode.count(torch.from_numpy(data), DeviceTable.for_table(t, CPU))
    assert stats.tolist() == [TILE + 5, 2]


def test_pack_plain_code_straddles_the_tile_edge_word(static):
    """A tile whose last word is completed by the next tile's first codes:
    the words equal the reference's bytes, the block offsets its index."""
    ref, t = static
    dt = DeviceTable.for_table(t, CPU)
    # pick a seed whose tile 0 ends mid-word with tile 1's first code
    # crossing that word's end
    for seed in range(100):
        data = _data(2 * TILE + 9, seed)
        ends = np.cumsum(t.lengths[data].astype(np.int64))
        edge, first_end = int(ends[TILE - 1]), int(ends[TILE])
        if edge % 32 and first_end > (edge | 31) + 1:
            break
    else:
        raise AssertionError("no seed gives a code across the tile edge's word")
    sym = torch.from_numpy(data)
    offs, total, n_words = pack_ablate.layout(sym, dt)
    assert offs.tolist() == [0, edge, int(ends[2 * TILE - 1])]
    words, block_offs = pack_encode.pack(sym, dt, offs, total, 0xFF, n_words, 100)
    got = tt.ops.bitpack.words_to_bytes(words).numpy().tobytes()[: -(-total // 8)]
    assert got == th.encode(data.tobytes(), ref)
    ref_idx = th.encode_with_index(data.tobytes(), ref, block_symbols=100)[1]
    assert np.array_equal(block_offs.numpy(), ref_idx.bit_offsets)


def test_pack_writes_every_word_of_out(static):
    """pack into a junk-filled ``out``: every word is written, zeros past
    the pad (the kernel allocates its words with torch.empty)."""
    _ref, t = static
    dt = DeviceTable.for_table(t, CPU)
    sym = torch.from_numpy(_data(TILE + 3, 11))
    offs, total, n_words = pack_ablate.layout(sym, dt)
    out = torch.full((n_words + 4,), -5, dtype=torch.int32)
    words, none = pack_encode.pack(sym, dt, offs, total, 0xFF, n_words + 4, out=out)
    assert words is out and none is None
    want = pack_encode.pack_plain(sym, dt, offs, total, 0xFF, n_words + 4)[0]
    assert torch.equal(out, want)
    assert out[n_words:].tolist() == [0] * 4


def test_pack_of_a_view_off_alignment(static):
    """A view that starts off 16-byte alignment (the kernel's byte loads)
    packs as its copy does."""
    _ref, t = static
    dt = DeviceTable.for_table(t, CPU)
    buf = torch.from_numpy(_data(TILE + 60, 12))
    start = (16 - buf.data_ptr() % 16) % 16 + 3
    view = buf[start:start + TILE + 20]
    copy = view.clone()
    assert view.data_ptr() % 16 == 3
    offs, total, n_words = pack_ablate.layout(copy, dt)
    assert torch.equal(pack_encode.count(view, dt)[0], pack_encode.count(copy, dt)[0])
    got = pack_encode.pack(view, dt, offs, total, 0xFF, n_words, 7)
    want = pack_encode.pack(copy, dt, offs, total, 0xFF, n_words, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["tile_offs", "n_words", "block_symbols", "out"])
def test_pack_rejects_bad_arguments(static, bad):
    _ref, t = static
    dt = DeviceTable.for_table(t, CPU)
    sym = torch.from_numpy(_data(TILE + 1, 13))
    offs, total, n_words = pack_ablate.layout(sym, dt)
    args = {"tile_offs": offs, "total_bits": total, "eos_padding": 0xFF,
            "n_words": n_words, "block_symbols": 256, "out": None}
    args[bad] = {"tile_offs": offs[:1], "n_words": n_words - 1, "block_symbols": 0,
                 "out": torch.zeros(n_words, dtype=torch.int64)}[bad]
    with pytest.raises(ValueError):
        pack_encode.pack(sym, dt, **args)


def _stream(enc, data, caps):
    """encode_chunk with caps[0], then caps[1] until done; every result and
    the state after it."""
    rec, pending = [], memoryview(data)
    cap = caps[0]
    while True:
        r = enc.encode_chunk(pending, cap)
        rec.append((r.data, r.consumed, r.done, enc.state()))
        pending = pending[r.consumed:]
        cap = caps[1]
        if r.done:
            return rec


def _cut_case(t, case):
    """(data, first capacity in bytes) whose first cut lands where `case`
    says, relative to tile 1 (symbols TILE .. 2 TILE - 1)."""
    for seed in range(400):
        data = _data(3 * TILE + 17, 100 + seed)
        ends = np.cumsum(t.lengths[data].astype(np.int64))
        first, last = (TILE, 2 * TILE - 1)
        lo = {"tile_first_bit": ends[first - 1], "first_symbol": ends[first - 1] + 1,
              "last_symbol": ends[last - 1] + 1}[case]
        hi = {"tile_first_bit": ends[first - 1], "first_symbol": ends[first] - 1,
              "last_symbol": ends[last] - 1}[case]
        cut = -(-int(lo) // 8) * 8
        if cut <= hi:
            return data.tobytes(), cut // 8
    raise AssertionError(f"no seed gives a cut at {case}")


@pytest.mark.parametrize("case", ["tile_first_bit", "first_symbol", "last_symbol"])
def test_encoder_capacity_cut_at_tile_edges(static, case):
    """A capacity cut exactly at a tile's first bit, inside its first
    symbol and inside its last: every chunk, carry and state equal the JAX
    encoder's (the cut is found by tile, then by symbol in the tile)."""
    ref, t = static
    data, cap = _cut_case(t, case)
    ours = _stream(tt.HuffmanEncoder(t, device="cpu"), data, (cap, 997))
    theirs = _stream(th.HuffmanEncoder(ref), data, (cap, 997))
    assert ours == theirs
    # symbols consumed by the first call, and whether a code straddles it
    want = {"tile_first_bit": (TILE, 0), "first_symbol": (TILE + 1, 1),
            "last_symbol": (2 * TILE, 1)}[case]
    assert (ours[0][1], min(ours[0][3]["carry_len"], 1)) == want
    assert b"".join(r[0] for r in ours) == th.encode(data, ref)


def test_encoder_cuts_across_tile_edges(static):
    """Capacities just above a tile's bytes: each call's cut crosses a tile
    edge, the carry moves the next call's tile offsets."""
    ref, t = static
    raw = _data(5 * TILE + 3, 21)
    data = raw.tobytes()
    cap = int(t.lengths[raw[:TILE]].astype(np.int64).sum()) // 8 + 3
    ours = _stream(tt.HuffmanEncoder(t, device="cpu"), data, (cap, cap))
    theirs = _stream(th.HuffmanEncoder(ref), data, (cap, cap))
    assert ours == theirs
    assert len(ours) > 4
    assert b"".join(r[0] for r in ours) == th.encode(data, ref)


def test_pack_ablate_thread_plain_equals_pack_plain(static):
    """pack_ablate's ``thread`` mode (the earlier per-thread loop: codes placed
    from chunk offsets) gives pack_plain's words at any chunk."""
    _ref, t = static
    dt = DeviceTable.for_table(t, CPU)
    sym = torch.from_numpy(pack_ablate.p5_inputs(3 * TILE + 17))
    offs, total, n_words = pack_ablate.layout(sym, dt)
    want = pack_encode.pack_plain(sym, dt, offs, total, 0xFF, n_words)[0]
    for chunk in pack_ablate.THREAD_CHUNKS + (1, 7):
        lay = pack_ablate.layout(sym, dt, chunk)
        assert lay[1:] == (total, n_words)
        assert torch.equal(pack_ablate.pack_ablate(sym, dt, "thread", lay, chunk), want)
    assert torch.equal(pack_ablate.pack_ablate(sym, dt, "full"), want)
    lens = t.lengths[sym.numpy()].astype(np.int64)
    assert pack_ablate.pack_ablate(sym, dt, "tile_scan").tolist() == [
        lens[i:i + TILE].sum() for i in range(0, sym.numel(), TILE)]

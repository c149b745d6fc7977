"""The decode kernels' store design on the CPU, through their plain
versions: the indexed decode at block sizes whose lane spans are not
16-byte aligned, the self-sync rows' contract (a live lane writes its whole
row, so the rows need no fill), and the ablation probe's plain versions
(``tpu_huffman_torch.prof.decode_ablate``), its stream case included. The
kernels themselves run only on a CUDA card (chip_smoke.py phases 2, 5 and
10). Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from tpu_huffman_torch.ops import chain_decode, selfsync, stream_decode  # noqa: E402
from tpu_huffman_torch.ops.bitpack import stage_words  # noqa: E402
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402
from tpu_huffman_torch.prof import decode_ablate  # noqa: E402

CPU = torch.device("cpu")
JUNK = -5  # what a row holds before the call: every live slot is overwritten


def _random(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _words(raw):
    return stage_words(torch.frombuffer(bytearray(raw), dtype=torch.uint8))


def _tables(kind):
    if kind == "static":
        return th.load_static_test_table(), tt.load_static_test_table()
    return th.load_hpack_table(), tt.load_hpack_table()


@pytest.mark.parametrize("block_symbols", [100, 257])
@pytest.mark.parametrize("kind", ["static", "hpack"])
def test_decode_indexed_unaligned_blocks_equals_jax(kind, block_symbols):
    """Blocks of 100 and 257 symbols (lane spans off 16-byte boundaries):
    the port's indexed decode equals the JAX package's and the input; random
    bytes on the HPACK table reach its 30-bit codes."""
    ref, t = _tables(kind)
    data = _random(24_000 if kind == "static" else 12_000, block_symbols)
    enc, idx = tt.encode_with_index(data, t, block_symbols=block_symbols, device="cpu")
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=block_symbols)
    assert enc == ref_enc and np.array_equal(idx.bit_offsets, ref_idx.bit_offsets)
    got = tt.decode_indexed(enc, idx, t, device="cpu")
    assert got == th.decode_indexed(ref_enc, ref_idx, ref) == data


@pytest.mark.parametrize("kind", ["static", "hpack"])
@pytest.mark.parametrize("seg_bits", [128, 1024])
def test_max_symbols_is_a_padded_pitch(kind, seg_bits):
    """The row pitch is a multiple of ROW_SLOTS and holds the most codes
    that can start in a segment."""
    _ref, t = _tables(kind)
    pitch = selfsync.max_symbols(t, seg_bits)
    most = (seg_bits + t.max_len) // t.min_len + 1
    assert pitch % selfsync.ROW_SLOTS == 0 and most <= pitch < most + selfsync.ROW_SLOTS


def _form(form, words, n_segs, seg_bits, dt):
    """The stitch's launch of ``form`` on junk-filled starts: (its four
    outputs, starts, the lanes' segment ids)."""
    pitch = selfsync.max_symbols(dt.table, seg_bits)
    entries0 = torch.zeros(n_segs, dtype=torch.int32)
    exits0 = selfsync.decode_segments(words, entries0, seg_bits, pitch, dt)[2]
    entries1 = torch.cat([entries0[:1], exits0[:-1] - seg_bits])
    if form == "full":
        ids, ent, kw = torch.arange(n_segs, dtype=torch.int32), entries0, {}
    elif form == "patch":
        pitch = selfsync.PATCH_SYMS
        ids, ent, kw = torch.arange(n_segs, dtype=torch.int32), entries1, {"max_codes": pitch}
    else:  # a repair: three live lanes and two dead ones
        ids = torch.tensor([5, -1, 0, n_segs - 1, -3], dtype=torch.int32)
        ent = torch.where(ids >= 0, entries1[ids.clamp(min=0).long()], 0)
        kw = {"seg_ids": ids}
    starts = torch.full((ent.numel(), pitch), JUNK, dtype=torch.int16)
    out = selfsync.decode_segments(words, ent, seg_bits, pitch, dt, starts=starts, **kw)
    return out, starts, ids


@pytest.mark.parametrize("form", ["full", "patch", "repair"])
def test_segment_rows_are_written_whole(form):
    """Pass 0, the patch and a repair with dead lanes: a live lane's row
    holds its symbols then 0, and its starts, ascending, then NO_START, to
    the end of the padded row; a dead lane leaves its starts as they were
    and reports 0s."""
    t = tt.load_static_test_table()
    enc = tt.encode(_random(6000, 3), t, device="cpu")
    words = _words(enc)
    n_segs, seg_bits = selfsync._plan_segments(8 * len(enc), selfsync.SEG_WORDS)
    dt = DeviceTable.for_table(t, CPU)
    (syms, counts, exits, bad), starts, ids = _form(form, words, n_segs, seg_bits, dt)
    assert syms.shape[1] % selfsync.ROW_SLOTS == 0
    for lane in range(ids.numel()):
        c = int(counts[lane])
        if int(ids[lane]) < 0:
            assert (starts[lane] == JUNK).all()
            assert (c, int(exits[lane]), int(bad[lane])) == (0, 0, 0)
            continue
        assert c > 0 and not syms[lane, c:].any()
        assert (starts[lane, c:] == selfsync.NO_START).all()
        assert bool((starts[lane, :c].diff() > 0).all()) and int(starts[lane, 0]) >= 0
    if form == "patch":
        assert (counts == selfsync.PATCH_SYMS).any()


def test_fixpoint_starts_need_no_fill():
    """_fixpoint's starts, from an uninitialised tensor, end up NO_START past
    each count, as the capped fallback's cut reads them."""
    t = tt.load_static_test_table()
    enc = tt.encode(_random(3000, 8), t, device="cpu")
    n_segs, seg_bits = selfsync._plan_segments(8 * len(enc), 4)
    pitch = selfsync.max_symbols(t, seg_bits)
    starts = torch.full((n_segs, pitch), JUNK, dtype=torch.int16)
    _s, counts, _e, _b, _ent, _passes = selfsync._fixpoint(
        _words(enc), n_segs, seg_bits, 0, pitch, DeviceTable.for_table(t, CPU), starts=starts)
    cols = torch.arange(pitch)[None, :]
    past = cols >= counts[:, None]
    assert (starts[past] == selfsync.NO_START).all() and (starts[~past] >= 0).all()


@pytest.fixture(scope="module")
def ablate_cases():
    data = np.frombuffer(_random(4000, 21), np.uint8).copy()
    return decode_ablate.inputs(CPU, data)


def _direct(case, args, kw):
    """The plain decode the case stands for, with its starts and blast."""
    if case == "chain":
        return chain_decode.decode_chains_plain(*args)
    words, entries, seg_bits, pitch, dt = args
    st = torch.full((entries.numel(), pitch), JUNK, dtype=torch.int16)
    bl = torch.full((entries.numel(),), JUNK, dtype=torch.int32) if kw.get("blast") else None
    out = selfsync.decode_segments_plain(words, entries, seg_bits, pitch, dt, st, bl,
                                         kw.get("max_codes", 0))
    return (*out, st) + ((bl,) if bl is not None else ())


@pytest.mark.parametrize("mode", decode_ablate.MODES)
@pytest.mark.parametrize("case", decode_ablate.CASES)
def test_ablate_plain_equals_decode_plain(ablate_cases, case, mode):
    """Every mode's plain version returns the plain decode's outputs:
    ``byte`` and ``sector`` all of them, ``none`` the per-lane ones."""
    fn, plain, args, kw = ablate_cases[case]
    want = _direct(case, args, kw)
    if mode == "none":
        want = want[1:] if case == "chain" else want[1:4] + want[5:]
    got = fn(*args, mode, **kw)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(plain(*args, mode, **kw), want))


def test_ablate_arguments_checked(ablate_cases):
    fn, _plain, args, kw = ablate_cases["full"]
    with pytest.raises(ValueError):
        fn(*args, "half", **kw)
    with pytest.raises(ValueError):
        fn(*args[:3], 10, args[4], "sector", max_codes=11)


@pytest.fixture(scope="module")
def stream_walks():
    return decode_ablate.stream_walks(CPU, np.frombuffer(_random(1500, 22), np.uint8).copy())


@pytest.mark.parametrize("mode", decode_ablate.STREAM_MODES)
@pytest.mark.parametrize("walk", list(decode_ablate.STREAM_WALKS))
def test_stream_ablate_plain_equals_decode_stream(stream_walks, walk, mode):
    """Every stream mode's plain version at every walk gives what the
    serial plain decode gives: symbols up to n and info (``none``: info
    only)."""
    args = stream_walks[walk]
    want = stream_decode.decode_stream_plain(*args)
    got = decode_ablate.stream_ablate(*args, mode)
    n = int(want[1][0])
    assert len(got) == (1 if mode == "none" else 2)
    assert torch.equal(got[-1], want[1])
    if mode != "none":
        assert torch.equal(got[0][:n], want[0][:n])


def test_stream_walks_reach_their_shapes(stream_walks):
    """The tail walk starts on a code boundary TAIL_SYMBOLS from the end; the
    capped walk is capped; the piece is 7 bytes."""
    words, start, total, cap, dt = stream_walks["tail"]
    info = stream_decode.decode_stream_plain(words, start, total, cap, dt)[1]
    assert info.tolist() == [decode_ablate.TAIL_SYMBOLS, info[1], stream_decode.STATUS_OK]
    assert stream_walks["cap1m"][3] == 1500 and stream_walks["piece"][2] == 56
    with pytest.raises(ValueError):
        decode_ablate.stream_ablate(*stream_walks["piece"], "half")


@pytest.mark.cuda
def test_ablate_kernels_match_plain_on_card():
    """Every mode of the probe's kernels equals its plain version on the
    same CUDA tensors, at each block size it is timed at."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    data = np.frombuffer(_random(200_000, 4), np.uint8).copy()
    cases = decode_ablate.inputs(torch.device("cuda"), data)
    for fn, plain, args, kw in cases.values():
        for mode in decode_ablate.MODES:
            want = plain(*args, mode, **kw)
            for block in decode_ablate.BLOCKS:
                got = fn(*args, mode, block=block, **kw)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
    for args in decode_ablate.stream_walks(torch.device("cuda"), data).values():
        want = stream_decode.decode_stream_plain(*args)
        n = int(want[1][0])
        for mode in decode_ablate.STREAM_MODES:
            got = decode_ablate.stream_ablate(*args, mode)
            assert torch.equal(got[-1], want[1])
            assert mode == "none" or torch.equal(got[0][:n], want[0][:n])

"""The block walk of ``stream_decode`` on the CPU, through its plain version
``decode_stream_blocked_plain``: the kernel's algorithm (windows, slices
decoded from guessed entries, sync rounds, the first stop on the true walk,
the scan, the cap) with torch ops. Each case runs at windows of 4 and 64
words and slices of 32 and 64 bits, so that a walk spans many slices and
windows, and is held against the JAX package's ``decode_stream_kernel``
(its ``lax.scan``, on the CPU) and against ``decode_stream_plain``, the
port's one-step-a-symbol version. Every comparison is exact: symbols, the
count, the end bit and the status. The kernel itself runs only on a CUDA
card (chip_smoke.py phase 2).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from test_torch_foreign_decode import _deep32, _gap, _jax_stream, _one_bit  # noqa: E402
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman_torch.ops import stream_decode  # noqa: E402
from tpu_huffman_torch.ops.bitpack import stage_words  # noqa: E402
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402

CPU = torch.device("cpu")
SETTINGS = [(4, 32), (4, 64), (64, 32), (64, 64)]  # (window_words, sub_bits)


def _flat8():
    lens = {i: 8 for i in range(256)}  # every code 8 bits: a wrong phase never resynchronises
    return th.make_canonical(lens, name="flat8"), tt.make_canonical(lens, name="flat8")


TABLES = {
    "static": lambda: (th.load_static_test_table(), tt.load_static_test_table()),
    "hpack": lambda: (th.load_hpack_table(), tt.load_hpack_table()),
    "one_bit": _one_bit,
    "gap": _gap,
    "deep32": _deep32,
    "flat8": _flat8,
}
SYMBOLS = {"static": (0, 256), "hpack": (0, 256), "one_bit": (65, 67), "gap": (97, 100),
           "deep32": (25, 33), "flat8": (0, 256)}
# symbols a stream: 2,400 to 4,000 bits (the JAX scan then takes 2^12 steps)
N_SYMBOLS = {"static": 260, "hpack": 160, "one_bit": 1800, "gap": 1300, "deep32": 100,
             "flat8": 320}
# bytes that match no code of the table (None: the table's codes are complete)
BAD = {"static": 0x00, "hpack": 0xFF, "one_bit": 0xFF, "gap": 0xAA, "deep32": None,
       "flat8": None}
CASES = ["whole", "start_7", "cap_mid", "cap_0", "short_total", "zero_blob",
         "cap_slice_first", "cap_window", "padding_straddle", "total_mid_window",
         "start_ge_32", "unknown_first", "unknown_mid", "unknown_last"]
PARAMS = [(k, c) for k in TABLES for c in CASES
          if not (c.startswith("unknown") and BAD[k] is None)]


@functools.lru_cache(maxsize=None)
def _stream(kind):
    """(JAX table, port table, plaintext, encoded bytes, code starts)."""
    ref, t = TABLES[kind]()
    lo, hi = SYMBOLS[kind]
    data = np.random.default_rng(len(kind)).integers(lo, hi, N_SYMBOLS[kind], dtype=np.uint8)
    enc = oracle.oracle_encode(data.tobytes(), ref)
    starts = np.concatenate([[0], np.cumsum(t.lengths[data].astype(np.int64))])
    return ref, t, data.tobytes(), enc, starts


def _case(kind, case):
    """(stream bytes, start_bit, total_bits, capacity) of a case."""
    _ref, t, _data, enc, starts = _stream(kind)
    bits = 8 * len(enc)
    count_before = lambda bit: int(np.searchsorted(starts, bit))  # noqa: E731
    if case.startswith("unknown"):
        at = {"unknown_first": 1, "unknown_mid": len(enc) // 2,
              "unknown_last": len(enc) - 9}[case]  # the last: 72 bits left at the bad bytes
        bad = bytearray(enc)
        bad[at:at + 5] = bytes([BAD[kind]]) * 5
        return bytes(bad), 0, bits, 10**6
    if case == "zero_blob":
        return bytes(len(enc)), 0, bits, 10**6
    if case == "padding_straddle":
        # a stream cut one bit past a 64-bit boundary inside a code: that code
        # is longer than the bits left (rule 4), across two slices where one
        # straddles the boundary (tables of even lengths: one starting at it)
        cuts = [(b, int(np.searchsorted(starts, b, side="right")) - 1)
                for b in range(64, int(starts[-1]), 64)]
        cuts = [(b, i) for b, i in cuts if starts[i + 1] > b + 1]
        b, _i = next(((b, i) for b, i in cuts if starts[i] < b), cuts[0])
        return enc, 0, b + 1, 10**6
    start, total, cap = {
        "whole": (0, bits, 10**6),
        "start_7": (7, bits, 10**6),  # a wrong phase: resyncs, or UNKNOWN
        "cap_mid": (0, bits, N_SYMBOLS[kind] // 2),
        "cap_0": (0, bits, 0),
        "short_total": (0, bits - 37, 10**6),
        # 128 bits: a slice boundary at every setting, a window's at 4 words
        "cap_slice_first": (0, bits, count_before(128)),
        "cap_window": (0, bits, count_before(2048)),  # a window boundary at 64 words
        "total_mid_window": (0, 2048 + 77, 10**6),
        "start_ge_32": (int(starts[np.searchsorted(starts, 40)]), bits, 10**6),
    }[case]
    assert total <= bits
    return enc, start, total, cap


def test_cases_reach_their_shapes():
    """The streams are long enough for the window and slice cases."""
    for kind in TABLES:
        _ref, _t, _data, enc, starts = _stream(kind)
        assert 2048 + 77 < 8 * len(enc) < 4095 and starts[-1] > 2048
        assert _case(kind, "cap_window")[3] < N_SYMBOLS[kind]


@pytest.mark.parametrize("kind,case", PARAMS)
def test_blocked_plain_matches_jax_kernel(kind, case):
    """decode_stream_blocked_plain at every setting against the JAX
    decode_stream_kernel and decode_stream_plain; its sync rounds stay
    within a window's slices."""
    ref, t, _data, _enc, _starts = _stream(kind)
    enc, start, total, cap = _case(kind, case)
    want = _jax_stream(enc, ref, start, total, cap)
    words = stage_words(torch.frombuffer(bytearray(enc), dtype=torch.uint8))
    dt = DeviceTable.for_table(t, CPU)
    syms, info = stream_decode.decode_stream_plain(words, start, total, cap, dt)
    n = int(info[0])
    assert (bytes(syms[:n].numpy()), *info.tolist()) == want
    for window_words, sub_bits in SETTINGS:
        stats = torch.zeros(2, dtype=torch.int64)
        syms, info = stream_decode.decode_stream_blocked_plain(
            words, start, total, cap, dt, window_words=window_words, sub_bits=sub_bits,
            stats=stats)
        got = (bytes(syms[:int(info[0])].numpy()), *info.tolist())
        assert got == want, (window_words, sub_bits)
        slices = 32 * window_words // sub_bits
        windows, rounds = stats.tolist()
        assert windows >= 1 and 0 <= rounds <= slices - 1
    if case.startswith("unknown"):
        assert want[3] == stream_decode.STATUS_UNKNOWN_SYMBOL
    if case in ("cap_0", "cap_mid", "cap_slice_first", "cap_window"):
        assert want[3] == stream_decode.STATUS_OUTPUT_FULL and want[1] == cap


def test_never_resynchronising_table_takes_a_round_a_slice():
    """The 256 x 8-bit table from bit 7: every slice guesses the wrong phase,
    so each round fixes one more slice (slices - 1 rounds a window), and the
    answer is exact."""
    ref, t, _data, enc, _starts = _stream("flat8")
    words = stage_words(torch.frombuffer(bytearray(enc), dtype=torch.uint8))
    dt = DeviceTable.for_table(t, CPU)
    want = stream_decode.decode_stream_plain(words, 7, 8 * len(enc), None, dt)
    stats = torch.zeros(2, dtype=torch.int64)
    got = stream_decode.decode_stream_blocked_plain(words, 7, 8 * len(enc), None, dt,
                                                    window_words=64, sub_bits=32, stats=stats)
    n = int(want[1][0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[0][:n], want[0][:n])
    assert stats.tolist() == [-(-(8 * len(enc)) // 2048), 63]


def test_output_and_stats_arguments():
    """``out`` takes the symbols (bytes past n left as they were), and the
    wrapper's CPU route is the blocked plain version at CPU_WINDOW_WORDS and
    CPU_SUB_BITS."""
    _ref, t, _data, enc, _starts = _stream("static")
    words = stage_words(torch.frombuffer(bytearray(enc), dtype=torch.uint8))
    dt = DeviceTable.for_table(t, CPU)
    bits = 8 * len(enc)
    m = stream_decode.out_size(dt, 0, bits, None)
    out = torch.full((m + 5,), 0xAB, dtype=torch.uint8)
    stats = torch.zeros(2, dtype=torch.int64)
    syms, info = stream_decode.decode_stream(words, 0, bits, None, dt, out=out, stats=stats)
    st_p = torch.zeros(2, dtype=torch.int64)
    want = stream_decode.decode_stream_blocked_plain(
        words, 0, bits, None, dt, window_words=stream_decode.CPU_WINDOW_WORDS,
        sub_bits=stream_decode.CPU_SUB_BITS, stats=st_p)
    n = int(info[0])
    assert syms is out and torch.equal(info, want[1]) and torch.equal(stats, st_p)
    assert torch.equal(out[:n], want[0][:n]) and bool((out[m:] == 0xAB).all())
    with pytest.raises(ValueError):
        stream_decode.decode_stream(words, 0, bits, None, dt, out=out[:3])
    with pytest.raises(ValueError):
        stream_decode.decode_stream_blocked_plain(words, 0, bits, None, dt, window_words=3,
                                                  sub_bits=64)


@pytest.mark.parametrize("kind", ["static", "hpack"])
def test_decode_and_streaming_decoder_equal_oracle(kind):
    """tt.decode of a small input and of a capped call, and a HuffmanDecoder
    fed 16 KiB pieces (each drain through stream_decode's CPU route), equal
    the oracle and the JAX package."""
    ref, t = TABLES[kind]()
    data = np.random.default_rng(9).integers(0, 256, 60_000, dtype=np.uint8).tobytes()
    enc = oracle.oracle_encode(data, ref)
    small = oracle.oracle_encode(data[:800], ref)
    assert len(small) <= 2048
    assert tt.decode(small, t, device="cpu") == data[:800] == th.decode(small, ref)
    assert tt.decode(enc, t, max_output=777, device="cpu") == data[:777]
    dec = tt.HuffmanDecoder(t, device="cpu")
    piece = 16 * 1024
    out = b"".join(dec.decode_chunk(enc[i:i + piece]).data for i in range(0, len(enc), piece))
    assert out == data == oracle.oracle_decode(enc, ref)


@pytest.mark.parametrize("kind", ["static", "hpack", "one_bit", "deep32"])
@pytest.mark.parametrize("walk", [0, 56, 1536, 8 * 2048, 8 * 16384, 8 * 65536, 1 << 23])
def test_card_shape_fits_and_reaches_the_walks_end(kind, walk):
    """The kernel's shape for a walk: slices of SUB_BITS (LONG_SUB_BITS past
    LONG_WALK_BITS), whole warps within MIN_THREADS and MAX_THREADS (fewer
    only where the window's shared memory would not fit), one window over
    the walk where the threads allow it, the shared memory within the
    card's, and the same answer from the cache on a second call."""
    _ref, t = TABLES[kind]()
    dt = DeviceTable.for_table(t, CPU)
    ww, sub = stream_decode.card_shape(walk, dt)
    threads = stream_decode.geometry(ww, sub)
    smem = stream_decode.walk_smem(threads, sub, dt.root_bits, dt.l1.numel(), int(t.min_len))
    assert sub == (stream_decode.LONG_SUB_BITS if walk > stream_decode.LONG_WALK_BITS
                   else stream_decode.SUB_BITS)
    assert threads % 32 == 0 and 32 <= threads <= stream_decode.MAX_THREADS
    assert smem <= stream_decode.MAX_SMEM
    fits = stream_decode.walk_smem(2 * threads, sub, dt.root_bits, dt.l1.numel(),
                                   int(t.min_len)) <= stream_decode.MAX_SMEM
    if threads < stream_decode.MIN_THREADS or (threads < stream_decode.MAX_THREADS
                                               and 32 * ww < walk + 32):
        assert not fits  # halved only to fit
    assert stream_decode.card_shape(walk, dt) == (ww, sub)


def test_stream_host_times_the_wrapper_on_the_cpu():
    """The wrapper-host-time script's run() on the CPU (the blocked plain
    version behind the wrapper): the three walks, a host time and a shape
    time each, no card numbers."""
    from tpu_huffman_torch.prof import stream_host

    res = stream_host.run(CPU, reps=2, nbytes=1024)
    assert sorted(res) == ["16k", "piece", "tail"]
    for row in res.values():
        assert sorted(row) == ["card_shape_us", "host_us"]
        assert row["host_us"] > 0 and row["card_shape_us"] > 0

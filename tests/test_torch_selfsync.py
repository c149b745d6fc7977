"""The port's self-synchronising segment decode (the counterpart of the
Pallas kernel B4) and its fixpoint loop, on the CPU.

``selfsync_decode_ex`` is held against the JAX package's at ``seg_words=4``
(its Pallas kernels in interpret mode, as tests/test_selfsync.py runs them;
about 2 KB, since the interpreter is slow), including resumed decodes. The
plain segment decode is held against a bit-by-bit walk in Python, and the
converged entries against the true codeword boundaries. Every comparison
is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from chip_smoke import hpack_corpus  # noqa: E402
from tpu_huffman.ops import selfsync as jax_selfsync  # noqa: E402
from tpu_huffman_torch.ops import selfsync  # noqa: E402
from tpu_huffman_torch.ops.bitpack import stage_words  # noqa: E402
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tables():
    return th.load_static_test_table(), tt.load_static_test_table()


def _random(n, seed, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, size=n, dtype=np.uint8).tobytes()


def _words(enc):
    return stage_words(torch.frombuffer(bytearray(enc), dtype=torch.uint8))


@pytest.mark.parametrize("cut", [None, 701, 1111], ids=["whole", "cut701", "cut1111"])
def test_matches_jax_selfsync(tables, cut):
    """(bytes, end_bit) equal the JAX package's at seg_words=4, on a whole
    stream and on the first part of a cut one; the rest, resumed from
    end_bit, completes the plaintext (tests/test_selfsync.py:68-79)."""
    ref, t = tables
    data = _random(1800, 2)
    enc = th.encode(data, ref)
    head = enc if cut is None else enc[:cut]
    got = selfsync.selfsync_decode_ex(head, t, seg_words=4, device=CPU)
    assert got == jax_selfsync.selfsync_decode_ex(head, ref, seg_words=4)
    out1, end1 = got
    if cut is None:
        assert out1 == data
        return
    rest = enc[end1 // 8 : cut] + enc[cut:]
    out2, _ = selfsync.selfsync_decode_ex(rest, t, seg_words=4, start_bit=end1 % 8,
                                          device=CPU)
    assert out1 + out2 == data


@pytest.mark.parametrize("start_bit", [0, 3, 7])
def test_small_stream_matches_jax(tables, start_bit):
    """Streams too small for segments go through the sequential decode alone."""
    ref, t = tables
    enc = th.encode(b"www.example.com/index.html", ref)
    assert selfsync._plan_segments(8 * len(enc), 4) is None
    got = selfsync.selfsync_decode_ex(enc, t, seg_words=4, start_bit=start_bit, device=CPU)
    assert got == jax_selfsync.selfsync_decode_ex(enc, ref, seg_words=4, start_bit=start_bit)


def test_plan_segments_matches_jax():
    for seg_words in (1, 4, 32):
        for total_bits in range(8, 40 * 32 * seg_words, 8 * seg_words + 8):
            mine = selfsync._plan_segments(total_bits, seg_words)
            theirs = jax_selfsync._plan_segments(total_bits, seg_words)
            assert (mine is None) == (theirs is None), total_bits
            if mine is not None:
                assert mine == (theirs[0], theirs[3]), total_bits


def _walk(value, nbits, seg_start, entry, seg_bits, table):
    """One segment's decode, bit by bit on Python ints: the kernel's
    contract written out."""
    rel, syms, bad = entry, [], 0
    while rel < seg_bits:
        pos = seg_start + rel
        window = ((value << 32) >> (nbits - pos)) & 0xFFFFFFFF if pos < nbits else 0
        sym, ln = table.decode_window(window)
        if ln == 0:
            bad = bad or rel + 1
            rel += 1
        else:
            syms.append(sym)
            rel += ln
    return syms, rel, bad


@pytest.mark.parametrize("stream", ["encoded", "random_bytes"])
def test_segments_plain_matches_walk(tables, stream):
    """Pass 0 (segment-aligned entries) and the converged pass. Off the true
    chain the Kraft-incomplete static table has invalid windows, which
    advance 1 bit, take no slot and record the first bad bit."""
    _ref, t = tables
    raw = _random(900, 6)
    enc = tt.encode(raw, t, device="cpu") if stream == "encoded" else raw
    seg_bits = 128
    n_segs, _ = selfsync._plan_segments(8 * len(enc), 4)
    words = _words(enc)
    dt = DeviceTable.for_table(t, CPU)
    max_syms = selfsync.max_symbols(t, seg_bits)
    value = int.from_bytes(enc, "big")
    pass0 = torch.zeros(n_segs, dtype=torch.int32)
    converged = selfsync._fixpoint(words, n_segs, seg_bits, 0, max_syms, dt)[4]
    bad_per_pass = []
    for entries in (pass0, converged):
        syms, counts, exits, bad = selfsync.decode_segments(words, entries, seg_bits,
                                                            max_syms, dt)
        assert syms.shape == (n_segs, max_syms) and syms.dtype == torch.uint8
        for s in range(n_segs):
            want, exit_, first_bad = _walk(value, 8 * len(enc), s * seg_bits,
                                           int(entries[s]), seg_bits, t)
            assert syms[s, : len(want)].tolist() == want
            assert not syms[s, len(want):].any()
            assert (int(counts[s]), int(exits[s]), int(bad[s])) == (len(want), exit_, first_bad)
            assert exit_ >= seg_bits
        bad_per_pass.append(bool(bad.any()))
    # wrong offsets meet invalid windows; the true chain of a stream the
    # encoder wrote meets none
    assert bad_per_pass[0]
    if stream == "encoded":
        assert not bad_per_pass[1]


@pytest.mark.parametrize("kind,seg_words", [
    ("static", 4), ("static", 32), ("hpack", 4), ("one_bit", 4),
])
def test_fixpoint_finds_codeword_boundaries(kind, seg_words):
    """The converged entries are the true codeword boundaries (from the
    cumsum of the code lengths), within S + 1 passes."""
    if kind == "static":
        t, data = tt.load_static_test_table(), _random(3000, 8)
    elif kind == "hpack":
        t, data = tt.load_hpack_table(), hpack_corpus(2000)
    else:
        t, data = tt.make_canonical({65: 1, 66: 2}), _random(6000, 9, 65, 67)
    enc = tt.encode(data, t, device="cpu")
    n_segs, seg_bits = selfsync._plan_segments(8 * len(enc), seg_words)
    lens = t.lengths[np.frombuffer(data, np.uint8)].astype(np.int64)
    starts = np.cumsum(lens) - lens
    seg0 = np.arange(n_segs) * seg_bits
    first = np.searchsorted(starts, seg0)
    syms, counts, exits, bad, entries, passes = selfsync._fixpoint(
        _words(enc), n_segs, seg_bits, 0, selfsync.max_symbols(t, seg_bits),
        DeviceTable.for_table(t, CPU),
    )
    assert 1 <= passes <= n_segs + 1
    assert entries.tolist() == (starts[first] - seg0).tolist()
    assert counts.tolist() == np.diff(np.searchsorted(starts, np.append(seg0, n_segs * seg_bits))).tolist()
    assert not bad.any()
    assert (exits[:-1] - seg_bits).tolist() == entries[1:].tolist()
    body = syms.reshape(-1)[(torch.arange(syms.shape[1]) < counts[:, None]).reshape(-1)]
    assert body.numpy().tobytes() == data[: int(counts.sum())]


def test_unconverged_fixpoint_raises(tables, monkeypatch):
    """With the stitch unresolved, entries that keep changing raise after
    S + 1 fixpoint passes; there is no other path to fall back to."""
    _ref, t = tables
    enc = tt.encode(_random(1500, 4), t, device="cpu")
    real = selfsync.decode_segments
    calls = []

    def wobbling(words, entries, seg_bits, max_syms, dt, **kw):
        syms, counts, exits, bad = real(words, entries, seg_bits, max_syms, dt, **kw)
        calls.append(1)
        return syms, counts, exits + len(calls) % 2, bad

    monkeypatch.setattr(selfsync, "decode_segments", wobbling)
    monkeypatch.setattr(selfsync, "stitch", lambda *a, **k: None)
    n_segs, _ = selfsync._plan_segments(8 * len(enc), 4)
    with pytest.raises(RuntimeError, match="converge"):
        selfsync.selfsync_decode_ex(enc, t, seg_words=4, device=CPU)
    assert len(calls) == n_segs + 1


def test_arguments_checked(tables):
    _ref, t = tables
    for kw in ({"start_bit": 8}, {"start_bit": -1}, {"seg_words": 0}):
        with pytest.raises(ValueError):
            selfsync.selfsync_decode_ex(b"\x9e\x79", t, device=CPU, **kw)
    assert selfsync.supports(t) and selfsync.supports(tt.load_hpack_table())


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The segment and stream kernels equal their plain versions on the same
    CUDA tensors; so does the stitch's walk, on an 8 MiB object of the
    benchmark's canterbury class, whose zero runs keep segments out of
    phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import os

    from portbench import gen
    from tpu_huffman_torch.ops import stream_decode

    dev = torch.device("cuda")
    t = tt.load_hpack_table()
    enc = tt.encode(_random(100_000, 1), t, device="cpu")
    words = _words(enc).to(dev)
    dt = DeviceTable.for_table(t, dev)
    n_segs, seg_bits = selfsync._plan_segments(8 * len(enc), selfsync.SEG_WORDS)
    max_syms = selfsync.max_symbols(t, seg_bits)
    entries = torch.zeros(n_segs, dtype=torch.int32, device=dev)
    for a, b in zip(selfsync.decode_segments(words, entries, seg_bits, max_syms, dt),
                    selfsync.decode_segments_plain(words, entries, seg_bits, max_syms, dt)):
        assert torch.equal(a, b)
    for cap in (None, 500):
        got = stream_decode.decode_stream(words, 3, 8 * 4096, cap, dt)
        want = stream_decode.decode_stream_plain(words, 3, 8 * 4096, cap, dt)
        n = int(want[1][0])  # symbols past n are unspecified
        assert torch.equal(got[1], want[1]) and torch.equal(got[0][:n], want[0][:n])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ct = tt.HuffmanTable.from_tsv_file(os.path.join(root, "portbench", "configs",
                                                    "canterbury.tsv"))
    enc = tt.encode(gen.canterbury_like(8 << 20, 4190002011, 0).tobytes(), ct, device=dev)
    words = _words(enc).to(dev)
    dt = DeviceTable.for_table(ct, dev)
    plan = selfsync._plan_segments(8 * len(enc), selfsync.SEG_WORDS)
    m = selfsync._merge(words, 0, plan, dt)
    n_fail = int(m.fail.sum())
    seg_ids = torch.nonzero(m.fail)[:, 0].to(torch.int32)
    args = (words, seg_ids, m.entries1, m.exits0, plan[1], dt)
    claim, ends = selfsync.walk_segments(*args)
    want_claim, want_ends = selfsync.walk_segments_plain(*args)
    assert n_fail and torch.equal(claim, want_claim) and torch.equal(ends, want_ends)

"""The port's one-pass + patch stitch of the self-synchronising decode
(``ops/selfsync.py:stitch``) and the kernel forms it runs (``blast``, the
code cap, segment ids), on the CPU through their plain versions.

The stitch is held against the JAX package's numpy stitch
``selfsync._stitch_fast`` on the same pass outputs, with the port's repair
launch as its ``repair_fn``; against the fixpoint; and, through ``decode``
and both words drains, against the C++ oracle and the sequential decode,
with the stitch, the repair and the fallback to the fixpoint each forced.
No JAX selfsync kernel runs here. Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from chip_smoke import hpack_corpus  # noqa: E402
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman.ops import selfsync as jax_selfsync  # noqa: E402
from tpu_huffman_torch import stream as tstream  # noqa: E402
from tpu_huffman_torch.ops import selfsync, stream_decode  # noqa: E402
from tpu_huffman_torch.ops.bitpack import stage_words  # noqa: E402
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402

CPU = torch.device("cpu")


def _random(n, seed, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, size=n, dtype=np.uint8).tobytes()


def _words(raw):
    return stage_words(torch.frombuffer(bytearray(raw), dtype=torch.uint8))


def _tables(kind):
    """(JAX table, port table, plaintext symbols' range)."""
    if kind == "static":
        return th.load_static_test_table(), tt.load_static_test_table(), (0, 256)
    if kind == "hpack":
        return th.load_hpack_table(), tt.load_hpack_table(), None
    # codes 00, 01, 11 (10 is invalid): not range-monotone, Kraft-incomplete
    specs = [(97, 2, 0), (98, 2, 1), (99, 2, 3)]
    return (th.HuffmanTable.from_specs([th.CodeSpec(*s) for s in specs], name="gap"),
            tt.HuffmanTable.from_specs([tt.CodeSpec(*s) for s in specs], name="gap"),
            (97, 100))


def _stream(kind, n, seed, start_bit=0):
    """(JAX table, port table, plaintext, its codes from bit ``start_bit``
    after as many junk bits, padded with ones to a byte)."""
    ref, t, rng = _tables(kind)
    data = hpack_corpus(n) if rng is None else _random(n, seed, *rng)
    if not start_bit:
        return ref, t, data, th.encode(data, ref)
    total = int(ref.lengths[np.frombuffer(data, np.uint8)].astype(np.int64).sum())
    bits = np.unpackbits(np.frombuffer(th.encode(data, ref), np.uint8))[:total]
    bits = np.concatenate([np.arange(start_bit) % 2, bits, np.ones(-(start_bit + total) % 8)])
    return ref, t, data, np.packbits(bits.astype(np.uint8)).tobytes()


ENDS = ("stitched", "repaired", "walked", "fixpoint")


def _outcomes():
    return {k: selfsync.outcomes[k] for k in ENDS}


def _delta(before):
    """How many drains ended each way since ``before``."""
    return {k: selfsync.outcomes[k] - before[k] for k in ENDS}


# --- the stitch against the JAX package's _stitch_fast ---------------------


def _jax_stitch(ref, words, start_bit, plan, dt):
    """The same two passes the port's stitch runs, handed to the JAX
    package's host stitch in the TPU layout: syms and u16 starts rows padded
    to a multiple of 4 slots (starts past each count NO_START, at least
    seg_bits), and the port's repair launch as its repair_fn. Returns
    (body, tail_start) or None."""
    n_segs, seg_bits = plan
    max_syms = selfsync.max_symbols(dt.table, seg_bits)
    a = selfsync.PATCH_SYMS
    entries0 = torch.zeros(n_segs, dtype=torch.int32)
    entries0[0] = start_bit
    starts0 = torch.full((n_segs, max_syms), selfsync.NO_START, dtype=torch.int16)
    blast0 = torch.empty(n_segs, dtype=torch.int32)
    syms0, _c0, exits0, _b0 = selfsync.decode_segments(words, entries0, seg_bits, max_syms, dt,
                                                       starts=starts0, blast=blast0)
    entries1 = torch.cat([entries0[:1], exits0[:-1] - seg_bits])
    syms_a, _ca, exits_a, bad_a = selfsync.decode_segments(words, entries1, seg_bits, a, dt,
                                                           max_codes=a)
    k4 = -(-max_syms // 4)
    pad = ((0, 0), (0, 4 * k4 - max_syms))
    rows0 = np.pad(syms0.numpy(), pad).view(np.uint32)
    offs0 = np.pad(starts0.numpy().view(np.uint16), pad,
                   constant_values=selfsync.NO_START).view(np.uint32)
    fast = (rows0, syms_a.numpy(), offs0, exits0.numpy(), exits_a.numpy(), blast0.numpy(),
            bad_a.numpy(), entries1.numpy())

    def repair_fn(idx, entries_r):
        syms_r, _c, exits_r, bad_r = selfsync.decode_segments(
            words, torch.from_numpy(entries_r.astype(np.int32)), seg_bits, max_syms, dt,
            seg_ids=torch.from_numpy(idx.astype(np.int32)))
        return syms_r.numpy(), exits_r.numpy(), bad_r.numpy()

    got = jax_selfsync._stitch_fast(ref, fast, n_segs, seg_bits, start_bit, max_syms, k4,
                                    repair_fn)
    if got is None:
        return None
    syms, _starts, counts, _bad, _s, _sb, tail_start = got
    return syms[np.arange(syms.shape[1])[None, :] < counts[:, None]].tobytes(), tail_start


@pytest.mark.parametrize("kind,seg_words,patch,corrupt,want", [
    ("static", 32, 32, False, "repaired"),
    ("hpack", 32, 32, False, "repaired"),
    ("gap", 32, 32, False, "stitched"),
    ("gap", 4, 32, False, "stitched"),
    ("gap", 32, 4, False, "repaired"),
    ("static", 4, 32, False, "walked"),
    ("hpack", 32, 4, False, "repaired"),
    ("static", 32, 32, True, None),
], ids=["static-32", "hpack-32", "gap-32", "gap-4", "gap-32-patch4", "static-4-unsynced",
        "hpack-32-patch4-too-many", "static-32-corrupt"])
def test_stitch_matches_jax_stitch_fast(monkeypatch, kind, seg_words, patch, corrupt, want):
    """(body, tail start), or None, equal _stitch_fast's on the same pass
    outputs, at its failure limit max(64, S >> 5). Where _stitch_fast gives
    up (a repaired exit that differs from the full pass's, more failures
    than it repairs), the port's walk resolves the stream: its body is the
    plaintext's prefix and the fixpoint's converged body."""
    monkeypatch.setattr(selfsync, "PATCH_SYMS", patch)
    monkeypatch.setattr(jax_selfsync, "PATCH_SYMS", patch)
    start_bit = 3
    ref, t, data, enc = _stream(kind, {"static": 48_000, "hpack": 64_000, "gap": 200_000}[kind],
                                seg_words + patch, start_bit)
    if corrupt:
        enc = enc[:30_000] + bytes(6) + enc[30_006:]
    words = _words(enc)
    plan = selfsync._plan_segments(8 * len(enc), seg_words)
    dt = DeviceTable.for_table(t, CPU)
    before = _outcomes()
    got = selfsync.stitch(words, start_bit, plan, dt)
    ended = [k for k, v in _delta(before).items() if v] or [None]
    theirs = _jax_stitch(ref, words, start_bit, plan, dt)
    assert ended == [want]
    if got is None:
        assert theirs is None
        return
    body, tail_start, total, cut = got
    if theirs is None:
        n_segs, seg_bits = plan
        syms, counts, exits, _bad, _entries, _passes = selfsync._fixpoint(
            words, n_segs, seg_bits, start_bit, selfsync.max_symbols(t, seg_bits), dt)
        assert torch.equal(body, selfsync._body(syms, counts))
        assert tail_start == n_segs * seg_bits + int(exits[-1]) - seg_bits
    else:
        assert (body.numpy().tobytes(), tail_start) == theirs
    assert total == body.numel() and cut is None
    assert body.numpy().tobytes() == data[:total]
    assert tail_start == start_bit + int(_first_symbols(t, data)[total])


@pytest.mark.parametrize("kind,start_bit", [("static", 5), ("hpack", 0), ("gap", 3)])
def test_stitch_equals_fixpoint(kind, start_bit):
    """The stitched body and tail start equal the fixpoint's converged
    chain's."""
    _ref, t, data, enc = _stream(kind, 20_000, 7, start_bit)
    words = _words(enc)
    plan = selfsync._plan_segments(8 * len(enc), 32)
    dt = DeviceTable.for_table(t, CPU)
    body, tail_start, total, _cut = selfsync.stitch(words, start_bit, plan, dt)
    n_segs, seg_bits = plan
    syms, counts, exits, _bad, _entries, _passes = selfsync._fixpoint(
        words, n_segs, seg_bits, start_bit, selfsync.max_symbols(t, seg_bits), dt)
    assert torch.equal(body, selfsync._body(syms, counts))
    assert tail_start == n_segs * seg_bits + int(exits[-1]) - seg_bits
    assert total == int(counts.sum()) and body.numpy().tobytes() == data[:total]


# --- the kernel's new forms, plain --------------------------------------------


def _walk(value, nbits, seg_start, entry, seg_bits, table, max_codes=0):
    """One segment's decode, bit by bit on Python ints: (symbols, exit,
    first bad, last bad)."""
    rel, syms, first, last = entry, [], 0, 0
    while rel < seg_bits and (not max_codes or len(syms) < max_codes):
        pos = seg_start + rel
        window = ((value << 32) >> (nbits - pos)) & 0xFFFFFFFF if pos < nbits else 0
        sym, ln = table.decode_window(window)
        if ln == 0:
            first, last = first or rel + 1, rel + 1
            rel += 1
        else:
            syms.append(sym)
            rel += ln
    return syms, rel, first, last


@pytest.mark.parametrize("stream", ["encoded", "random_bytes"])
def test_blast_patch_and_repair_forms_match_walk(stream):
    """blast is the last invalid window's bit + 1; the code cap stops after
    max_codes codes; a repair lane decodes its segment id, a dead lane
    writes nothing."""
    t = tt.load_static_test_table()
    raw = _random(900, 6)
    enc = tt.encode(raw, t, device="cpu") if stream == "encoded" else raw
    seg_bits = 128
    n_segs, _ = selfsync._plan_segments(8 * len(enc), 4)
    words = _words(enc)
    dt = DeviceTable.for_table(t, CPU)
    max_syms = selfsync.max_symbols(t, seg_bits)
    value, nbits = int.from_bytes(enc, "big"), 8 * len(enc)
    entries = torch.from_numpy(np.random.default_rng(1).integers(0, 10, n_segs).astype(np.int32))
    blast = torch.full((n_segs,), -7, dtype=torch.int32)
    _s, _c, _e, bad = selfsync.decode_segments(words, entries, seg_bits, max_syms, dt,
                                               blast=blast)
    walks = [_walk(value, nbits, s * seg_bits, int(entries[s]), seg_bits, t)
             for s in range(n_segs)]
    assert blast.tolist() == [w[3] for w in walks]
    assert bad.tolist() == [w[2] for w in walks]
    assert bool((blast > bad).any()) and bool((blast >= bad).all())
    # the patch form: at most 5 codes
    syms, counts, exits, bad = selfsync.decode_segments(words, entries, seg_bits, 5, dt,
                                                        max_codes=5)
    for s in range(n_segs):
        want, exit_, first, _last = _walk(value, nbits, s * seg_bits, int(entries[s]),
                                          seg_bits, t, max_codes=5)
        assert syms[s, :len(want)].tolist() == want
        assert (int(counts[s]), int(exits[s]), int(bad[s])) == (len(want), exit_, first)
    # the repair form: lanes for segments 3, 0 and the last, two dead lanes
    ids = torch.tensor([3, -1, 0, n_segs - 1, -5], dtype=torch.int32)
    ent = torch.tensor([4, 9, 1, 2, 9], dtype=torch.int32)
    starts = torch.full((5, max_syms), 77, dtype=torch.int16)
    syms, counts, exits, bad = selfsync.decode_segments(words, ent, seg_bits, max_syms, dt,
                                                        starts=starts, seg_ids=ids)
    for lane in range(5):
        s = int(ids[lane])
        if s < 0:
            assert not syms[lane].any() and (starts[lane] == 77).all()
            assert (int(counts[lane]), int(exits[lane]), int(bad[lane])) == (0, 0, 0)
            continue
        want, exit_, first, _last = _walk(value, nbits, s * seg_bits, int(ent[lane]),
                                          seg_bits, t)
        assert syms[lane, :len(want)].tolist() == want
        assert (int(counts[lane]), int(exits[lane]), int(bad[lane])) == (len(want), exit_, first)


def test_new_forms_arguments_checked():
    t = tt.load_static_test_table()
    dt = DeviceTable.for_table(t, CPU)
    words = _words(_random(200, 2))
    entries = torch.zeros(4, dtype=torch.int32)
    for kw in ({"blast": torch.zeros(3, dtype=torch.int32)},
               {"blast": torch.zeros(4, dtype=torch.int64)},
               {"seg_ids": torch.zeros(4, dtype=torch.int16)},
               {"max_codes": 11}, {"max_codes": -1}):
        with pytest.raises(ValueError):
            selfsync.decode_segments(words, entries, 128, 10, dt, **kw)


@pytest.mark.parametrize("kind", ["static", "hpack", "gap"])
def test_walk_steps_are_the_whole_codes_of_a_window(kind):
    """The walk kernel's second table: for each value of a window's top
    WALK_STEP_BITS bits, the bits of the codes whole in them, decoded one
    by one from the first; a walk over them leaves the chain as it is."""
    _ref, t, _rng = _tables(kind)
    k = selfsync.WALK_STEP_BITS
    steps = selfsync.walk_steps(DeviceTable.for_table(t, CPU)).tolist()
    for value in range(1 << k):
        pos = 0
        while True:
            _sym, n = t.decode_window(((value << pos) & ((1 << k) - 1)) << (32 - k))
            if n == 0 or pos + n > k:
                break
            pos += n
        assert steps[value] == pos


# --- decode and the words drains: stitched, repaired, fell back --------------


MODES = {  # (PATCH_SYMS, WALK_LANES, R_MAX): the stitch resolves alone, repairs, gives up
    "stitched": (32, selfsync.WALK_LANES, 256),
    "repaired": (2, selfsync.WALK_LANES, 256),
    "fixpoint": (2, 0, 1),
}


def _set_mode(monkeypatch, mode):
    """The stitch's fallback is forced by the walk's lane cap; the fused
    drain's own repair, which the streaming entries try first, by R_MAX."""
    patch, walk_lanes, r_max = MODES[mode]
    monkeypatch.setattr(selfsync, "PATCH_SYMS", patch)
    monkeypatch.setattr(selfsync, "WALK_LANES", walk_lanes)
    monkeypatch.setattr(selfsync, "R_MAX", r_max)
    monkeypatch.setattr(tstream, "BULK_DECODE_THRESHOLD", 64)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("entry", ["decode", "words_drain", "capped_drain"])
def test_paths_equal_oracle(monkeypatch, mode, entry):
    """Each entry point gives the oracle's bytes through the stitch, the
    repair and the fixpoint fallback, and counts the one it took. 45
    segments (S >> 5 = 1, so R_MAX = 1 caps the repair at one)."""
    _set_mode(monkeypatch, mode)
    ref, t, data, enc = _stream("static", 5000, 17)
    assert selfsync._plan_segments(8 * len(enc), 32)[0] == 45
    before = _outcomes()
    if entry == "decode":
        got = selfsync.selfsync_decode(enc, t, device=CPU)
    elif entry == "words_drain":
        dec = tt.HuffmanDecoder(t, device=CPU)
        got = dec.decode_chunk(enc[:2000]).data + dec.decode_chunk(enc[2000:]).data
    else:
        dec = tt.HuffmanDecoder(t, device=CPU)
        orc = oracle.OracleDecoder(oracle.OracleTable(ref))
        got, feed, pending = b"", enc, enc
        while True:
            r = dec.decode_chunk(feed, 1200)
            o_out, o_used, _o_done = orc.decode_chunk(pending, 1200)
            pending, feed = pending[o_used:], b""
            assert r.data == o_out
            got += r.data
            if r.done:
                break
    assert got == data == oracle.oracle_decode(enc, ref)
    ended = _delta(before)
    assert ended[mode] >= 1 and sum(ended.values()) == ended[mode]


def _first_symbols(t, data):
    lens = t.lengths[np.frombuffer(data, np.uint8)].astype(np.int64)
    return np.cumsum(lens) - lens


@pytest.mark.parametrize("where", ["boundary-1", "boundary", "boundary+1", "repaired"])
def test_capped_cut_matches_sequential(monkeypatch, where):
    """A capacity cut on both sides of a segment boundary, and one inside a
    repaired segment: (symbols, end_bit, more) equal the sequential decode's
    with the same budget, and the bytes the oracle's."""
    ref, t, data, enc = _stream("static", 6000, 14)
    seg_bits = 1024
    starts = _first_symbols(t, data)
    first40 = int(np.searchsorted(starts, 40 * seg_bits))  # segment 40's first symbol
    cap = {"boundary-1": first40 - 1, "boundary": first40, "boundary+1": first40 + 1,
           "repaired": first40 + 3}[where]
    repaired_ids = []
    if where == "repaired":
        monkeypatch.setattr(selfsync, "PATCH_SYMS", 1)
        real = selfsync.decode_segments

        def spy(*args, **kw):
            if kw.get("seg_ids") is not None:
                repaired_ids.extend(i for i in kw["seg_ids"].tolist() if i >= 0)
            return real(*args, **kw)

        monkeypatch.setattr(selfsync, "decode_segments", spy)
    before = _outcomes()
    got = selfsync.selfsync_decode_capped(enc, t, cap, seg_words=32, device=CPU)
    ended = _delta(before)
    out, end_bit, more = got
    assert end_bit == starts[cap] and (end_bit // seg_bits) in (39, 40)
    n_segs, _ = selfsync._plan_segments(-(-((cap + 1) * t.max_len + 64) // 32) * 32, 32)
    assert end_bit < n_segs * seg_bits  # the cut lies in the stitched body
    assert ended["stitched" if where != "repaired" else "repaired"] == 1
    if where == "repaired":
        assert end_bit // seg_bits in repaired_ids
    syms, info = stream_decode.decode_stream_plain(
        _words(enc), 0, 8 * len(enc), cap, DeviceTable.for_table(t, CPU))
    n, s_end, status = info.tolist()
    assert got == (syms[:n].numpy().tobytes(), s_end, status == stream_decode.STATUS_OUTPUT_FULL)
    o_out, _used, _done = oracle.OracleDecoder(oracle.OracleTable(ref)).decode_chunk(enc, cap)
    assert out == o_out == data[:cap] and more


# --- the walk: runs of out-of-phase segments ----------------------------------

# codes 00 (symbol 0), 01, 100, 101, 110, 111: in a run of symbol 0 a chain
# keeps its bit's parity, so a run entered at an odd bit is out of phase with
# the full pass's chains, which enter each segment at bit 0
PHASE_SPECS = [(0, 2, 0b00), (1, 2, 0b01), (2, 3, 0b100), (3, 3, 0b101), (4, 3, 0b110),
               (5, 3, 0b111)]
PHASE_SEG_WORDS = 4
PHASE_SEG_BITS = 32 * PHASE_SEG_WORDS
# zero runs from segments 5, 12, 20 and 40 to the middle of 1, 2, 6 and 3 segments on
PHASE_RUNS = [(5, 1), (12, 2), (20, 6), (40, 3)]


def _phase_stream(zero_runs=PHASE_RUNS, n_segs=60, seed=1):
    """(JAX table, port table, plaintext, its codes): random symbols 1-5 for
    ``n_segs`` segments of PHASE_SEG_BITS, and for each (segment, span) of
    ``zero_runs`` symbol 0 from an odd bit in the last quarter of that
    segment to the middle of segment + span; the codes fill whole bytes."""
    g = np.random.default_rng(seed)
    lengths = {sym: n for sym, n, _code in PHASE_SPECS}
    out, bit = [], 0

    def put(sym):
        nonlocal bit
        out.append(sym)
        bit += lengths[sym]

    for seg, span in zero_runs:
        while bit < seg * PHASE_SEG_BITS + 3 * PHASE_SEG_BITS // 4:
            put(int(g.integers(1, 6)))
        if bit % 2 == 0:
            put(2)
        while bit < (seg + span) * PHASE_SEG_BITS + PHASE_SEG_BITS // 2:
            put(0)
    while bit < n_segs * PHASE_SEG_BITS:
        put(int(g.integers(1, 6)))
    while bit % 8:  # whole bytes: no padding bits to decode
        put(2 if bit % 2 else 1)
    ref = th.HuffmanTable.from_specs([th.CodeSpec(*c) for c in PHASE_SPECS], name="phase")
    t = tt.HuffmanTable.from_specs([tt.CodeSpec(*c) for c in PHASE_SPECS], name="phase")
    data = bytes(out)
    return ref, t, data, th.encode(data, ref)


def _runs(words, plan, dt):
    """(runs, failures): the out-of-phase runs from the fixpoint's chain,
    (first segment, length) for each failed segment of the merge that no
    earlier run holds, up to the first segment whose true exit is the full
    pass's (or the last); and the merge's failed segments."""
    n_segs, seg_bits = plan
    m = selfsync._merge(words, 0, plan, dt)
    exits = selfsync._fixpoint(words, n_segs, seg_bits, 0,
                               selfsync.max_symbols(dt.table, seg_bits), dt)[2]
    fail, ex0, ex = m.fail.tolist(), m.exits0.tolist(), exits.tolist()
    runs, k = [], 0
    while k < n_segs:
        if fail[k]:
            e = k
            while ex[e] != ex0[e] and e + 1 < n_segs:
                e += 1
            runs.append((k, e - k + 1))
            k = e
        k += 1
    return runs, sum(fail)


def _walks():
    return {k: selfsync.outcomes[k] for k in (*ENDS, "segments_repaired", "segments_walked")}


def test_walk_resolves_runs_of_out_of_phase_segments():
    """Runs of 1, 2, 6 and 3 out-of-phase segments decode through the walk
    to the oracle's bytes, with no fallback; the segments walked are the
    runs' total."""
    ref, t, data, enc = _phase_stream()
    words = _words(enc)
    plan = selfsync._plan_segments(8 * len(enc), PHASE_SEG_WORDS)
    runs, n_fail = _runs(words, plan, DeviceTable.for_table(t, CPU))
    assert sorted(n for _s, n in runs) == [1, 2, 3, 6]
    before = _walks()
    got = selfsync.selfsync_decode(enc, t, seg_words=PHASE_SEG_WORDS, device=CPU)
    delta = {k: v - before[k] for k, v in _walks().items()}
    assert got == data == oracle.oracle_decode(enc, ref)
    assert delta == {"stitched": 0, "repaired": 0, "walked": 1, "fixpoint": 0,
                     "segments_repaired": n_fail, "segments_walked": sum(n for _s, n in runs)}


def test_a_failure_inside_a_run_is_left_to_the_earlier_walk(monkeypatch):
    """A segment inside the six-segment run marked failed too: its walk,
    started from the full pass's chain, is dropped, the earlier one gives
    the segments their entries, and the bytes are the oracle's."""
    ref, t, data, enc = _phase_stream()
    words = _words(enc)
    plan = selfsync._plan_segments(8 * len(enc), PHASE_SEG_WORDS)
    runs, n_fail = _runs(words, plan, DeviceTable.for_table(t, CPU))
    first, length = next(r for r in runs if r[1] == 6)
    inside = first + 2
    merge, walk = selfsync._merge, selfsync.walk_segments
    seen = []

    def merge_failing_inside(*args, **kw):
        m = merge(*args, **kw)
        assert not bool(m.fail[inside])
        m.fail[inside] = True
        return m

    def spy(words, seg_ids, *args):
        got = walk(words, seg_ids, *args)
        seen.append((seg_ids.tolist(), got[1].tolist()))
        return got

    monkeypatch.setattr(selfsync, "_merge", merge_failing_inside)
    monkeypatch.setattr(selfsync, "walk_segments", spy)
    before = _walks()
    got = selfsync.selfsync_decode(enc, t, seg_words=PHASE_SEG_WORDS, device=CPU)
    delta = {k: v - before[k] for k, v in _walks().items()}
    assert got == data == oracle.oracle_decode(enc, ref)
    ((seg_ids, ends),) = seen
    assert ends[seg_ids.index(first)] == first + length - 1 and ends[seg_ids.index(inside)] == -1
    assert delta["walked"] == 1 and delta["fixpoint"] == 0
    assert delta["segments_repaired"] == n_fail + 1
    assert delta["segments_walked"] == sum(n for _s, n in runs)


def test_a_run_into_the_last_segment_gives_the_tail_its_walked_exit():
    """A zero run past the kernel segments: the last walk ends at the last
    segment, out of phase with the full pass, and the tail starts at that
    walk's exit, the true chain's bit."""
    ref, t, data, enc = _phase_stream([(12, 2), (50, 30)], n_segs=70)
    words = _words(enc)
    plan = selfsync._plan_segments(8 * len(enc), PHASE_SEG_WORDS)
    n_segs, seg_bits = plan
    dt = DeviceTable.for_table(t, CPU)
    runs, _n_fail = _runs(words, plan, dt)
    assert runs[-1][0] + runs[-1][1] == n_segs
    exits0 = selfsync._merge(words, 0, plan, dt).exits0
    before = _walks()
    body, tail_start, total, _cut = selfsync.stitch(words, 0, plan, dt)
    assert selfsync.outcomes["walked"] == before["walked"] + 1
    assert body.numpy().tobytes() == data[:total]
    assert tail_start == int(_first_symbols(t, data)[total])
    assert tail_start != (n_segs - 1) * seg_bits + int(exits0[-1])
    assert selfsync.selfsync_decode(enc, t, seg_words=PHASE_SEG_WORDS,
                                    device=CPU) == data == oracle.oracle_decode(enc, ref)


def test_capped_cut_inside_a_walked_segment():
    """A capacity cut in the middle of the six-segment run: (symbols,
    end_bit, more) equal the sequential decode's with the same budget, and
    the bytes the oracle's."""
    ref, t, data, enc = _phase_stream()
    words = _words(enc)
    plan = selfsync._plan_segments(8 * len(enc), PHASE_SEG_WORDS)
    runs, _n_fail = _runs(words, plan, DeviceTable.for_table(t, CPU))
    first, _length = next(r for r in runs if r[1] == 6)
    starts = _first_symbols(t, data)
    cap = int(np.searchsorted(starts, (first + 3) * PHASE_SEG_BITS + 40))
    before = _walks()
    got = selfsync.selfsync_decode_capped(enc, t, cap, seg_words=PHASE_SEG_WORDS, device=CPU)
    assert selfsync.outcomes["walked"] == before["walked"] + 1
    out, end_bit, more = got
    assert end_bit // PHASE_SEG_BITS == first + 3
    syms, info = stream_decode.decode_stream_plain(
        words, 0, 8 * len(enc), cap, DeviceTable.for_table(t, CPU))
    n, s_end, status = info.tolist()
    assert got == (syms[:n].numpy().tobytes(), s_end, status == stream_decode.STATUS_OUTPUT_FULL)
    o_out, _used, _done = oracle.OracleDecoder(oracle.OracleTable(ref)).decode_chunk(enc, cap)
    assert out == o_out == data[:cap] and more


# --- errors -------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["decode", "words_drain", "capped_drain"])
def test_corrupt_stream_raises_where_oracle_does(monkeypatch, entry):
    """Zeroed bytes mid-stream: no segment chain through them resolves, the
    fixpoint raises UnknownSymbolError, and on the capped drain at the same
    call as the oracle's decoder, after the same bytes."""
    monkeypatch.setattr(tstream, "BULK_DECODE_THRESHOLD", 64)
    monkeypatch.setattr(selfsync, "SEG_WORDS", 4)
    ref, t, _data, enc = _stream("static", 3000, 23)
    enc = enc[:1800] + bytes(5) + enc[1805:]
    before = _outcomes()
    if entry == "decode":
        with pytest.raises(tt.UnknownSymbolError):
            selfsync.selfsync_decode(enc, t, seg_words=4, device=CPU)
        with pytest.raises(th.UnknownSymbolError):
            oracle.oracle_decode(enc, ref)
    elif entry == "words_drain":
        dec = tt.HuffmanDecoder(t, device=CPU)
        with pytest.raises(tt.UnknownSymbolError):
            dec.decode_chunk(enc)
        with pytest.raises(th.UnknownSymbolError):
            oracle.OracleDecoder(oracle.OracleTable(ref)).decode_chunk(enc, 10_000)
    else:
        dec = tt.HuffmanDecoder(t, device=CPU)
        orc = oracle.OracleDecoder(oracle.OracleTable(ref))
        feed, pending, calls = enc, enc, 0
        while True:
            calls += 1
            try:
                o_out, o_used, _ = orc.decode_chunk(pending, 400)
            except th.UnknownSymbolError:
                with pytest.raises(tt.UnknownSymbolError):
                    dec.decode_chunk(feed, 400)
                break
            r = dec.decode_chunk(feed, 400)
            pending, feed = pending[o_used:], b""
            assert r.data == o_out and not r.done
        assert calls > 3
    assert _delta(before)["fixpoint"] >= 1

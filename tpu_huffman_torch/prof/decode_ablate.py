"""The port's two parallel decode loops with their stores swapped
(``csrc/probe_decode.cu`` over ``csrc/decode_loop.cuh``), the counterpart of
``scripts/prof/prof_decode_parts.py`` (pallas_call :48, which drives B3's
``_make_pallas_call``), which split B3's loop on the TPU. Here the loops are
the port's own, ``thc::chain_lane`` and ``thc::segment_lane``, which
``chain_decode_kernel`` and ``selfsync_decode_kernel`` run in ``sector``
mode. Modes, with their outputs:

* ``none``: the loop with only the per-lane results stored: (end_bits,
  bad) for a chain; (counts, exits, bad[, blast]) for segments;
* ``byte``: one store a symbol (and a start) in the lane's row, the design
  before ``sector``; the wrapper fills the segment rows with 0 and
  ``NO_START`` first, as the stitch did;
* ``sector``: the kernels' design: whole 32-byte sectors from registers,
  the rest of each segment row filled by the kernel.

``byte`` and ``sector`` return what ``decode_chains`` / ``decode_segments``
return (then ``starts`` and ``blast`` where asked for). Cases, at the main
path's shapes on P5's 8 MiB (``default_rng(2024)``, the static table):

* ``chain``: chain_decode at block_symbols 256;
* ``full``: the stitch's full pass (segment-aligned entries, ``starts`` and
  ``blast``) over the same stream;
* ``patch``: the stitch's patch (``PATCH_SYMS`` codes with starts from the
  full pass's true entries).

The ``stream`` case is ``stream_decode``'s walk (``csrc/stream_walk.cuh``)
from ``csrc/probe_decode.cu``, with modes of its own (STREAM_MODES):

* ``serial``: the one-thread loop of the design before the block walk;
* ``block``: the kernel's design, the LUT staged in shared memory;
* ``block_global``: the same with the LUT read through the cache (the
  kernel's other candidate form, slower or equal at every walk timed);
* ``none``: the block walk without its write pass (info only);

each returning what ``decode_stream`` returns ((symbols, info), or (info,)
for ``none``), at the walks of STREAM_WALKS on the same stream: a 7-byte
piece, 64 bytes, the 191-symbol tail of a ``decode``, 2, 16 and 64 KiB from the
start and a capped walk of 2^20 symbols; ``block`` also at each shape of
STREAM_SHAPES (threads, bits a slice) and each overlap of STREAM_OVERLAPS
(the bits before a slice whose walk guesses its entry), and an empty
one-block launch as the floor.

``python -m tpu_huffman_torch.prof.decode_ablate`` runs every mode of every
case against the plain version, times each (``sector`` at block sizes 64,
128 and 256, the others at the kernels' 128) and the fills the ``byte``
mode needs, and prints ms a mode.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..ops import chain_decode, selfsync, stream_decode
from ..ops.encode import DEFAULT_BLOCK_SYMBOLS, DeviceTable, _encode_device
from ..tables import load_static_test_table
from . import card, check_equal, is_cuda, kernel_ms, median_ms, on_card, require_cuda
from .pack_ablate import p5_inputs

MODES = ("none", "byte", "sector")
_MODE_ID = {"none": 0, "byte": 1, "sector": 2}
BLOCKS = (64, 128, 256)
BLOCK = 128  # the kernels' (csrc/chain_decode.cu, selfsync_decode.cu)
CASES = ("chain", "full", "patch")
STREAM_MODES = ("serial", "block", "block_global", "none")
_STREAM_MODE_ID = {"serial": 0, "block": 1, "block_global": 2, "none": 3}
_EMPTY_MODE = 4
# the block walk's re-walk counters (thc::kRewalks ... in csrc/stream_walk.cuh)
BRANCHES = ("rewalks", "joined, old record", "joined, old starts", "joined, suffix walk")
TAIL_SYMBOLS = 191  # the walk after the kernel segments of the 8 MiB stream's decode
CAP_SYMBOLS = 1 << 20
# walk -> (bytes from the start, or None: the tail or the capped walk)
STREAM_WALKS = {"piece": 7, "64b": 64, "tail": None, "2k": 2048, "16k": 16384, "64k": 65536,
                "cap1m": None}
STREAM_OVERLAPS = (0, 64, 128)  # the guess's walk before a slice, beside OVERLAP_BITS
STREAM_SHAPES = ((256, 128), (512, 128), (1024, 128), (1024, 64), (256, 256), (512, 256),
                 (1024, 256))
launches = {"decode_ablate": 0}


def _mode(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    return _MODE_ID[mode]


def chain_ablate(words, bit_offs, n_syms, out_start, n_out: int, dt, mode: str,
                 block: int = BLOCK):
    """``decode_chains`` through the probe's loop in ``mode``: (out,
    end_bits, bad), or (end_bits, bad) for ``none``."""
    m = _mode(mode)
    chain_decode._check(words, bit_offs, n_syms, out_start)
    if not is_cuda(words):
        return chain_ablate_plain(words, bit_offs, n_syms, out_start, n_out, dt, mode)
    dev = words.device
    b = bit_offs.numel()
    out = torch.empty(n_out, dtype=torch.uint8, device=dev) if m else None
    end_bits = torch.empty(b, dtype=torch.int64, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    err = _build.load().thc_probe_chain_decode(
        dev.index, words.data_ptr(), words.numel(), bit_offs.data_ptr(), n_syms.data_ptr(),
        out_start.data_ptr(), b, dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(),
        dt.l1.numel(), dt.table.max_len, None if out is None else out.data_ptr(),
        end_bits.data_ptr(), bad.data_ptr(), m, block,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("thc_probe_chain_decode", err)
    launches["decode_ablate"] += 1
    return (out, end_bits, bad) if m else (end_bits, bad)


def chain_ablate_plain(words, bit_offs, n_syms, out_start, n_out: int, dt, mode: str):
    """Plain version of :func:`chain_ablate`."""
    got = chain_decode.decode_chains_plain(words, bit_offs, n_syms, out_start, n_out, dt)
    return got if _mode(mode) else got[1:]


def segments_ablate(words, entries, seg_bits: int, max_syms: int, dt, mode: str,
                    starts: bool = False, blast: bool = False, max_codes: int = 0,
                    block: int = BLOCK):
    """``decode_segments`` through the probe's loop in ``mode``, with new
    ``starts`` / ``blast`` outputs when asked for: (syms, counts, exits,
    bad[, starts][, blast]), or (counts, exits, bad[, blast]) for
    ``none``."""
    m = _mode(mode)
    selfsync._check(words, entries, dt)
    if not 0 <= max_codes <= max_syms:
        raise ValueError(f"max_codes must be in [0, max_syms={max_syms}], got {max_codes}")
    if not is_cuda(words):
        return segments_ablate_plain(words, entries, seg_bits, max_syms, dt, mode, starts,
                                     blast, max_codes)
    dev = words.device
    t = entries.numel()
    syms = st = None
    if m:  # the byte mode writes slots only: its rows are filled first
        byte = m == _MODE_ID["byte"]
        syms = (torch.zeros if byte else torch.empty)((t, max_syms), dtype=torch.uint8,
                                                      device=dev)
        if starts:
            st = (torch.full((t, max_syms), selfsync.NO_START, dtype=torch.int16, device=dev)
                  if byte else torch.empty((t, max_syms), dtype=torch.int16, device=dev))
    counts, exits, bad = (torch.empty(t, dtype=torch.int32, device=dev) for _ in range(3))
    bl = torch.empty(t, dtype=torch.int32, device=dev) if blast else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = _build.load().thc_probe_selfsync_decode(
        dev.index, words.data_ptr(), words.numel(), entries.data_ptr(), None, t, seg_bits,
        max_syms, max_codes, dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(), dt.l1.numel(),
        dt.table.max_len, ptr(syms), ptr(st), counts.data_ptr(), exits.data_ptr(),
        bad.data_ptr(), ptr(bl), m, block, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("thc_probe_selfsync_decode", err)
    launches["decode_ablate"] += 1
    return _segment_outputs(m, syms, counts, exits, bad, st, bl)


def _segment_outputs(m, syms, counts, exits, bad, st, bl):
    outs = (syms, counts, exits, bad, st, bl) if m else (counts, exits, bad, bl)
    return tuple(x for x in outs if x is not None)


def segments_ablate_plain(words, entries, seg_bits: int, max_syms: int, dt, mode: str,
                          starts: bool = False, blast: bool = False, max_codes: int = 0):
    """Plain version of :func:`segments_ablate`."""
    m = _mode(mode)
    t = entries.numel()
    st = torch.empty((t, max_syms), dtype=torch.int16, device=words.device) if starts else None
    bl = torch.empty(t, dtype=torch.int32, device=words.device) if blast else None
    syms, counts, exits, bad = selfsync.decode_segments_plain(
        words, entries, seg_bits, max_syms, dt, st, bl, max_codes)
    return _segment_outputs(m, syms, counts, exits, bad, st if m else None, bl)


def _stream_mode(mode: str) -> int:
    if mode not in STREAM_MODES:
        raise ValueError(f"mode must be one of {STREAM_MODES}")
    return _STREAM_MODE_ID[mode]


def stream_ablate(words, start_bit: int, total_bits: int, out_capacity, dt, mode: str,
                  threads: int | None = None, sub_bits: int | None = None, stats=None,
                  cycles=None, overlap: int = stream_decode.OVERLAP_BITS, branches=None):
    """``decode_stream`` through the probe's kernel in ``mode``: (symbols,
    info), or (info,) for ``none``. ``threads`` and ``sub_bits`` (both the
    wrapper's when ``threads`` is None) and ``overlap`` shape the block modes; ``stats`` is the
    wrapper's; ``cycles`` (int64[4], block modes on the card) receives
    thread 0's clock cycles in staging, speculation, sync rounds, and scan +
    write + copy out; to ``branches`` (int64[4], block modes on the card)
    the kernel adds its re-walks, then those that joined their previous walk
    and took their first event and count from its record, from its step
    starts, or from a walk of the rest of the slice (BRANCHES)."""
    m_id = _stream_mode(mode)
    stream_decode._check(words, start_bit, dt)
    if threads is None:
        walk = stream_decode.walk_bits(start_bit, total_bits, out_capacity, dt)
        ww, sub_bits = stream_decode.card_shape(walk, dt)
        threads = stream_decode.geometry(ww, sub_bits)
    if not is_cuda(words):
        return stream_ablate_plain(words, start_bit, total_bits, out_capacity, dt, mode,
                                   threads, sub_bits, stats, overlap)
    dev = words.device
    m = stream_decode.out_size(dt, start_bit, total_bits, out_capacity)
    out = torch.empty(m, dtype=torch.uint8, device=dev) if mode != "none" else None
    info = torch.empty(3, dtype=torch.int64, device=dev)
    err = _build.load().thc_probe_stream_decode(
        dev.index, words.data_ptr(), words.numel(), start_bit, total_bits, m,
        dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(), dt.l1.numel(), int(dt.table.max_len),
        int(dt.table.min_len), threads, sub_bits, min(overlap, sub_bits),
        None if out is None else out.data_ptr(),
        info.data_ptr(), None if stats is None else stats.data_ptr(),
        None if cycles is None else cycles.data_ptr(),
        None if branches is None else branches.data_ptr(), m_id,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("thc_probe_stream_decode", err)
    launches["decode_ablate"] += 1
    return (info,) if out is None else (out, info)


def stream_ablate_plain(words, start_bit: int, total_bits: int, out_capacity, dt, mode: str,
                        threads: int = 32, sub_bits: int = 64, stats=None,
                        overlap: int = stream_decode.OVERLAP_BITS):
    """Plain version of :func:`stream_ablate`: ``serial`` is
    ``decode_stream_plain``, the block modes ``decode_stream_blocked_plain``
    at the same shape."""
    if _stream_mode(mode) == 0:
        return stream_decode.decode_stream_plain(words, start_bit, total_bits, out_capacity, dt)
    got = stream_decode.decode_stream_blocked_plain(
        words, start_bit, total_bits, out_capacity, dt, window_words=threads * sub_bits // 32,
        sub_bits=sub_bits, stats=stats, overlap_bits=overlap)
    return got[1:] if mode == "none" else got


def empty_block(dev: torch.device, threads: int) -> None:
    """One launch of an empty block of ``threads`` threads."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    err = _build.load().thc_probe_stream_decode(
        index, None, 0, 0, 0, 0, None, 0, None, 0, 0, 1, threads, 32, 0, None, None, None, None,
        None, _EMPTY_MODE, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("thc_probe_stream_decode", err)
    launches["decode_ablate"] += 1


def stream_walks(dev: torch.device, data=None) -> dict:
    """The stream case's walks on ``dev``, from ``data`` (uint8 numpy; P5's
    8 MiB when None) on the static table: {walk: (words, start_bit,
    total_bits, out_capacity, dt)}, each cut to the stream."""
    data = p5_inputs() if data is None else data
    dt = DeviceTable.for_table(load_static_test_table(), dev)
    sym = torch.from_numpy(data).to(dev)
    words, _total, padded_bits, _offs, _max = _encode_device(sym, dt, 0xFF)
    n = sym.numel()
    tail = max(n - TAIL_SYMBOLS, 0)
    tail_bit = int(dt.lengths[sym[:tail].long()].sum()) if tail else 0
    walks = {}
    for walk, nbytes in STREAM_WALKS.items():
        if walk == "tail":
            walks[walk] = (words, tail_bit, padded_bits, None, dt)
        elif walk == "cap1m":
            walks[walk] = (words, 0, padded_bits, min(CAP_SYMBOLS, n), dt)
        else:
            walks[walk] = (words, 0, min(8 * nbytes, padded_bits), None, dt)
    return walks


def _stream_equal(name: str, got, want) -> int:
    """The ``[:n]`` symbols (bytes past n are unspecified) and info of a
    stream call against the plain version's."""
    n = int(want[-1][0])
    err = check_equal(f"{name} info", got[-1], want[-1])
    if len(got) == 2:
        err = max(err, check_equal(f"{name} symbols", got[0][:n], want[0][:n]))
    return err


def run_stream(dev: torch.device) -> dict:
    """Every stream mode at every walk (``block`` also at each of
    STREAM_SHAPES and STREAM_OVERLAPS), each launch held against the blocked plain version at
    the wrapper's shape, then timed by ``kernel_ms``; the empty block at 32,
    256 and 1024 threads; and the block walk's clock cycles by
    part (staging, speculation, sync rounds, scan + write + copy out) at
    the wrapper's shape, with its re-walks by branch. Returns {"ms": {walk:
    {label: ms}}, "symbols": {walk: n}, "stats": {walk: (windows, rounds)},
    "shape": {walk: the wrapper's, "threads x sub_bits"}, "cycles": {walk:
    [4 parts]}, "branches": {walk: {BRANCHES: count}},
    "empty_ms": {threads: ms}, "max_abs_err"}."""
    res = {"ms": {}, "symbols": {}, "stats": {}, "shape": {}, "cycles": {}, "branches": {},
           "empty_ms": {}}
    err = 0
    for walk, args in stream_walks(dev).items():
        ww, sub = stream_decode.card_shape(stream_decode.walk_bits(*args[1:4], args[4]), args[4])
        threads = stream_decode.geometry(ww, sub)
        st = torch.zeros(2, dtype=torch.int64, device=dev)
        want = stream_ablate_plain(*args, "block", threads, sub, st)
        calls = {m: functools.partial(stream_ablate, *args, m) for m in STREAM_MODES}
        for t, b in STREAM_SHAPES:
            calls[f"block {t}x{b}"] = functools.partial(stream_ablate, *args, "block", t, b)
        for ov in STREAM_OVERLAPS:
            calls[f"block overlap {ov}"] = functools.partial(stream_ablate, *args, "block",
                                                             threads, sub, overlap=ov)
        for label, call in calls.items():
            err = max(err, _stream_equal(f"decode_ablate stream {walk} {label}", call(), want))
        res["ms"][walk] = kernel_ms(calls)
        cycles = torch.zeros(4, dtype=torch.int64, device=dev)
        branches = torch.zeros(len(BRANCHES), dtype=torch.int64, device=dev)
        stream_ablate(*args, "block", threads, sub, cycles=cycles, branches=branches)
        res["cycles"][walk] = cycles.tolist()
        res["branches"][walk] = dict(zip(BRANCHES, branches.tolist()))
        res["symbols"][walk] = int(want[1][0])
        res["stats"][walk] = tuple(st.tolist())
        res["shape"][walk] = f"{threads}x{sub}"
    for t in (32, 256, 1024):
        res["empty_ms"][t] = kernel_ms({"empty": functools.partial(empty_block, dev, t)})["empty"]
    res["max_abs_err"] = err
    return res


def inputs(dev: torch.device, data=None, block_symbols: int = DEFAULT_BLOCK_SYMBOLS) -> dict:
    """The three cases' arguments on ``dev``, from ``data`` (uint8 numpy;
    P5's 8 MiB when None) on the static table: {case: (fn, plain_fn, args,
    kwargs)}, fn and plain_fn taking (*args, mode, **kwargs). The patch's
    entries come from the full pass (by its plain version on the CPU)."""
    data = p5_inputs() if data is None else data
    dt = DeviceTable.for_table(load_static_test_table(), dev)
    sym = torch.from_numpy(data).to(dev)
    words, _total, padded_bits, block_offs, _max = _encode_device(sym, dt, 0xFF, block_symbols)
    n = sym.numel()
    nb = block_offs.numel()
    nsyms = torch.full((nb,), block_symbols, dtype=torch.int32, device=dev)
    nsyms[-1] = n - (nb - 1) * block_symbols
    out_start = torch.arange(nb, dtype=torch.int64, device=dev) * block_symbols
    n_segs, seg_bits = selfsync._plan_segments(padded_bits, selfsync.SEG_WORDS)
    max_syms = selfsync.max_symbols(dt.table, seg_bits)
    entries0 = torch.zeros(n_segs, dtype=torch.int32, device=dev)
    exits0 = selfsync.decode_segments(words, entries0, seg_bits, max_syms, dt)[2]
    entries1 = torch.cat([entries0[:1], exits0[:-1] - seg_bits])
    a = selfsync.PATCH_SYMS
    return {
        "chain": (chain_ablate, chain_ablate_plain,
                  (words, block_offs, nsyms, out_start, n, dt), {}),
        "full": (segments_ablate, segments_ablate_plain,
                 (words, entries0, seg_bits, max_syms, dt), {"starts": True, "blast": True}),
        "patch": (segments_ablate, segments_ablate_plain,
                  (words, entries1, seg_bits, a, dt), {"starts": True, "max_codes": a}),
    }


def run(dev: torch.device | None = None) -> dict:
    """Every mode of every case on P5's 8 MiB, each timed launch (``sector``
    at each of BLOCKS, the others at BLOCK) held against the plain version
    at its shape, then timed by ``kernel_ms``; beside them the fills that
    the ``byte`` mode's wrapper makes (its times include them) and the
    chain case's plain version. Returns {"cases": {case: {label: ms}},
    "fill_ms": {case: ms}, "lanes", "symbols", "chain_plain_ms",
    "chain_bytes" (the chain case's bytes moved, for its bound),
    "max_abs_err": {"decode_ablate": over every comparison}}."""
    dev = on_card(dev)
    cases = inputs(dev)
    res = {"cases": {}, "fill_ms": {}, "lanes": {}, "symbols": {}}
    err = 0
    for case, (fn, plain, args, kw) in cases.items():
        want = {m: plain(*args, m, **kw) for m in MODES}
        calls = {}
        for m in MODES:
            for blk in (BLOCKS if m == "sector" else (BLOCK,)):
                calls[f"{m} {blk}"] = functools.partial(fn, *args, m, block=blk, **kw)
        for label, call in calls.items():  # every timed launch, at its shape
            got, w = call(), want[label.split()[0]]
            if len(got) != len(w):
                raise AssertionError(f"decode_ablate {case} {label}: {len(got)} outputs")
            for i, (a, b) in enumerate(zip(got, w)):
                err = max(err, check_equal(f"decode_ablate {case} {label} output {i}", a, b))
        if case != "chain":
            rows = (args[1].numel(), args[3])
            calls["fill"] = lambda rows=rows: (
                torch.zeros(rows, dtype=torch.uint8, device=dev),
                torch.full(rows, selfsync.NO_START, dtype=torch.int16, device=dev))
        t = kernel_ms(calls)
        res["fill_ms"][case] = t.pop("fill", 0.0)
        res["cases"][case] = t
        res["lanes"][case] = args[1].numel()
        res["symbols"][case] = (args[4] if case == "chain"
                                else int(want["none"][0].sum()))
    fn, plain, args, kw = cases["chain"]
    res["chain_plain_ms"] = median_ms(functools.partial(plain, *args, "sector", **kw))
    words, block_offs, _nsyms, _out_start, n, dt = args
    # the chain case reads the stream, 20 bytes of index a block and level 0
    # of the LUT, and writes the symbols, 8 bytes a block and the flag
    res["chain_bytes"] = (4 * words.numel() + 28 * block_offs.numel() + n + 4
                          + 4 * dt.l0.numel())
    res["stream"] = run_stream(dev)
    res["max_abs_err"] = {"decode_ablate": max(err, res["stream"]["max_abs_err"])}
    return res


def main() -> None:
    dev = require_cuda()
    print(card())
    res = run(dev)
    for case, t in res["cases"].items():
        print(f"decode_ablate {case} ({res['lanes'][case]} lanes, {res['symbols'][case]} "
              f"symbols): " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
              + (f"; byte includes the {res['fill_ms'][case]:.4f} ms fill of its rows"
                 if case != "chain" else "") + "; every launch equal to plain")
    print(f"chain plain version: {res['chain_plain_ms']:.3f} ms")
    st = res["stream"]
    for walk, t in st["ms"].items():
        print(f"decode_ablate stream {walk} ({st['symbols'][walk]} symbols, "
              f"shape {st['shape'][walk]}, windows and most rounds {st['stats'][walk]}, "
              f"cycles in staging, speculation, sync, write {st['cycles'][walk]}, "
              f"re-walks {st['branches'][walk]}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()))
    print("empty block: " + ", ".join(f"{t} threads {ms:.4f} ms"
                                      for t, ms in st["empty_ms"].items()))


if __name__ == "__main__":
    main()

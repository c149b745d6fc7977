"""Foreign-stream decode with the reference's stop rules: the block-walk
kernel and its plain versions (replaces the JAX package's
``decode_stream_kernel`` in ``tpu_huffman/ops/decode.py``, an XLA
``lax.scan`` with one step per symbol).

From ``start_bit``, in the scan body's order (source/huffman.c:230-281): no
bits left, or no code matching with < 32 bits left, stops with
``STATUS_OK``; no code matching with >= 32 bits left stops with
``STATUS_UNKNOWN_SYMBOL``; a code longer than the bits left (trailing
padding) stops with ``STATUS_OK``; and the output-full check, before the
symbol is consumed, stops with ``STATUS_OUTPUT_FULL``. It serves small
inputs, capped calls (``max_output``), streaming drains of small
remainders and the tail of the self-synchronising decode
(``ops/selfsync.py``).

The kernel, in ``csrc/stream_decode.cu`` over ``csrc/stream_walk.cuh``, is
one thread block that walks the stream in windows of ``window_words`` words
staged in shared memory. Each thread owns ``sub_bits`` bits of a window,
decodes them from a guessed entry, and the threads resynchronise in rounds
until every entry is the previous slice's true exit; a block scan of the
counts places the symbols, and the first stop on the true walk, or the
cap, ends it. :func:`decode_stream_blocked_plain` runs the same algorithm
with torch ops, vectorised over the slices, with the same statistics;
:func:`decode_stream_plain` is the port of the scan body, one step a
symbol, and the semantics reference.

:func:`decode_stream` runs the blocked plain version for tensors on the CPU
and launches the kernel for tensors on a CUDA device; there is no fallback
from one to the other. ``launches`` counts the kernel launches.

:func:`decode_stream_dev` is the same walk with its start bit, stream
length and budget read from an int64 tensor on the device, for a caller
whose earlier launches computed them (the streaming decoder's fused drain,
``ops/selfsync.py``): the host sizes its output and shape from a bound and
never reads the scalars. :func:`decode_stream_dev_plain` is its plain
version.
"""

from __future__ import annotations

import functools

import torch

from .. import _build, metrics
from .bitpack import extract_windows, u32
from .chain_decode import lut_lookup

STATUS_OK = 0
STATUS_UNKNOWN_SYMBOL = 1
STATUS_OUTPUT_FULL = 2  # the SHORT_BUFFER stop reason (reference huffman.c:266)
NO_EVENT = -1  # a slice's walk that met no stop
# The kernel's shape on the card (PERF.md section 5: the sweep): slices of
# SUB_BITS bits, or LONG_SUB_BITS for walks of more than LONG_WALK_BITS
# bits; MIN_THREADS to MAX_THREADS threads, as many as reach the walk's end;
# fewer where a window's shared memory would not fit.
SUB_BITS = 128
LONG_SUB_BITS = 256
LONG_WALK_BITS = 1 << 17
MIN_THREADS = 256
MAX_THREADS = 1024
MAX_SMEM = 232448  # bytes a block may take on the H100, opted in
# A slice's guessed entry is where a walk from this many bits before the
# slice (at most a slice: 128 or 256 on the card) crosses into it. A whole
# slice beat half of one at 256-bit slices (PERF.md section 5).
OVERLAP_BITS = 256
# The CPU route's: small, so that the tests' walks span many windows.
CPU_WINDOW_WORDS = 64
CPU_SUB_BITS = 64
launches = metrics.register("ops.stream_decode.launches",
                            {"stream_decode": 0, "stream_decode_dev": 0})


def out_size(dt, start_bit: int, total_bits: int, out_capacity: int | None) -> int:
    """Output slots: ``out_capacity``, or fewer when the bits cannot hold
    that many symbols (each takes at least the table's shortest code). The
    output-full stop fires at the same symbol either way."""
    most = max(total_bits - start_bit, 0) // max(int(dt.table.min_len), 1) + 1
    return most if out_capacity is None else max(0, min(int(out_capacity), most))


def geometry(window_words: int, sub_bits: int) -> int:
    """Threads (slices) a window of ``window_words`` words in slices of
    ``sub_bits`` bits takes; raises for a shape the kernel refuses."""
    if sub_bits < 32 or sub_bits & (sub_bits - 1) or window_words < 1 or (
            32 * window_words) % sub_bits:
        raise ValueError(f"sub_bits must be a power of two >= 32 dividing the window's bits, "
                         f"got window_words {window_words}, sub_bits {sub_bits}")
    return 32 * window_words // sub_bits


def _check(words: torch.Tensor, start_bit: int, dt) -> None:
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError("words must be a 1-D int32 tensor")
    if start_bit < 0:
        raise ValueError(f"start_bit must be >= 0, got {start_bit}")
    if dt.l0.device != words.device:
        raise ValueError("table and words are on different devices")


def _output(out: torch.Tensor | None, m: int, dev, fresh) -> torch.Tensor:
    if out is None:
        return fresh(m, dtype=torch.uint8, device=dev)
    if out.dtype != torch.uint8 or out.dim() != 1 or out.numel() < m or out.device != dev:
        raise ValueError(f"out must be a 1-D uint8 tensor of >= {m} elements on {dev}")
    return out


def _stats(stats: torch.Tensor | None, dev) -> None:
    if stats is not None and (stats.dtype != torch.int64 or stats.numel() != 2
                              or stats.device != dev):
        raise ValueError(f"stats must be 2 int64 on {dev}")


def walk_bits(start_bit: int, total_bits: int, out_capacity: int | None, dt) -> int:
    """Bits a walk can cover: to the stream's end, or to the cap's symbol."""
    bits = max(total_bits - start_bit, 0)
    if out_capacity is not None:
        bits = min(bits, (int(out_capacity) + 1) * int(dt.table.max_len))
    return bits


def walk_smem(threads: int, sub_bits: int, root_bits: int, l1_size: int, min_len: int) -> int:
    """Bytes of shared memory the kernel's walk takes (``WalkLayout`` in
    csrc/stream_walk.cuh): the LUT, the window and two guard words, two
    bitmaps (each with a pad word a slice), three ints a thread, the scan,
    and a window's most symbols."""
    words = threads * sub_bits // 32
    l0, l1 = 4 << root_bits, 4 * l1_size
    lut = l0 + (l1 if l0 + l1 <= 48 * 1024 else 0)
    up = lambda x: (x + 15) & ~15  # noqa: E731
    return (up(lut) + 4 * (words + threads + 8) + 8 * (words + threads) + 12 * threads + 144
            + up(16 + words * 32 // min_len + 2))


@functools.lru_cache(maxsize=256)  # one entry a table shape
def _fit(threads: int, sub_bits: int, root_bits: int, l1_size: int, min_len: int) -> int:
    """``threads``, halved while the walk's shared memory does not fit."""
    while threads > 32 and walk_smem(threads, sub_bits, root_bits, l1_size,
                                     min_len) > MAX_SMEM:
        threads //= 2
    return threads


def card_shape(walk: int, dt) -> tuple[int, int]:
    """(window_words, sub_bits) of the kernel for a walk of ``walk`` bits:
    slices of SUB_BITS (LONG_SUB_BITS past LONG_WALK_BITS), and the fewest
    warps, within MIN_THREADS and MAX_THREADS, whose slices reach the walk's
    end from its first word, halved while the window does not fit."""
    sub_bits = LONG_SUB_BITS if walk > LONG_WALK_BITS else SUB_BITS
    slices = -(-(walk + 32) // sub_bits)
    threads = min(MAX_THREADS, max(MIN_THREADS, -(-slices // 32) * 32))
    threads = _fit(threads, sub_bits, dt.root_bits, dt.l1.numel(), int(dt.table.min_len))
    return threads * sub_bits // 32, sub_bits


def decode_stream(words: torch.Tensor, start_bit: int, total_bits: int,
                  out_capacity: int | None, dt, *, out: torch.Tensor | None = None,
                  stats: torch.Tensor | None = None):
    """Decode from ``start_bit`` until a stop rule fires, writing at most
    ``out_capacity`` symbols (None: no cap).

    ``total_bits`` is the stream's length in bits (the words may hold more;
    words past the tensor read as zeros). Returns (symbols uint8[m], info
    int64[3]) with info = (n_decoded, end_bit, status): ``symbols[:n_decoded]``
    are the decoded symbols and the bytes past them are unspecified (every
    caller slices). ``out`` (uint8, >= m elements) takes the symbols in place
    of a new tensor and is returned; ``stats`` (int64[2]) receives (windows
    walked, the most sync rounds a window took). The walk's shape is
    :func:`card_shape`'s on the card, CPU_WINDOW_WORDS and CPU_SUB_BITS on
    the CPU.
    """
    with metrics.span("tt.walk"):
        _check(words, start_bit, dt)
        dev = words.device
        if dev.type == "cpu":
            return decode_stream_blocked_plain(
                words, start_bit, total_bits, out_capacity, dt, window_words=CPU_WINDOW_WORDS,
                sub_bits=CPU_SUB_BITS, out=out, stats=stats)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        window_words, sub_bits = card_shape(walk_bits(start_bit, total_bits, out_capacity, dt), dt)
        return _launch(words, start_bit, total_bits, out_capacity, dt, window_words, sub_bits,
                       out, stats)


def _launch(words: torch.Tensor, start_bit: int, total_bits: int, out_capacity: int | None,
            dt, window_words: int, sub_bits: int, out: torch.Tensor | None = None,
            stats: torch.Tensor | None = None):
    """The kernel at the shape given (the words on a CUDA device), as
    :func:`decode_stream` returns it; checks at forced shapes call it."""
    threads = geometry(window_words, sub_bits)
    if threads % 32 or threads > MAX_THREADS:
        raise ValueError(f"the kernel takes 32 to {MAX_THREADS} threads in warps, not {threads}")
    dev = words.device
    m = out_size(dt, start_bit, total_bits, out_capacity)
    out = _output(out, m, dev, torch.empty)
    _stats(stats, dev)
    info = torch.empty(3, dtype=torch.int64, device=dev)
    words = words.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.load().thc_stream_decode(
        dev.index, words.data_ptr(), words.numel(), start_bit, total_bits, m,
        dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(), dt.l1.numel(),
        int(dt.table.max_len), int(dt.table.min_len), threads, sub_bits,
        min(OVERLAP_BITS, sub_bits), out.data_ptr(), info.data_ptr(),
        None if stats is None else stats.data_ptr(), stream,
    )
    _build.check("thc_stream_decode", err)
    launches["stream_decode"] += 1
    return out, info


def _check_dev(words: torch.Tensor, args: torch.Tensor, out_slots: int, dt) -> None:
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError("words must be a 1-D int32 tensor")
    if args.dtype != torch.int64 or tuple(args.shape) != (3,) or args.device != words.device:
        raise ValueError(f"args must be an int64 tensor of shape (3,) on {words.device}")
    if out_slots < 0:
        raise ValueError(f"out_slots must be >= 0, got {out_slots}")
    if dt.l0.device != words.device:
        raise ValueError("table and words are on different devices")


def decode_stream_dev(words: torch.Tensor, args: torch.Tensor, out_slots: int, dt):
    """:func:`decode_stream` with its scalars in device memory: ``args`` is
    int64[3] = (start_bit, total_bits, budget) on the words' device, a
    negative start or budget counting as 0.

    Writes at most min(budget, ``out_slots``) symbols into uint8[out_slots]
    and returns (symbols, info) as :func:`decode_stream` does. The result
    equals ``decode_stream(words, start_bit, total_bits, budget)``'s when
    ``out_slots`` covers the most symbols the bits can hold,
    ``(total_bits - start_bit) // min_len + 1``: the caller's bound. The
    kernel's shape is :func:`card_shape`'s for a walk of ``out_slots`` codes
    of the longest length; nothing waits for the device.
    """
    with metrics.span("tt.walk"):
        _check_dev(words, args, out_slots, dt)
        dev = words.device
        if dev.type == "cpu":
            return decode_stream_dev_plain(words, args, out_slots, dt)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        window_words, sub_bits = card_shape(out_slots * int(dt.table.max_len), dt)
        threads = geometry(window_words, sub_bits)
        out = torch.empty(out_slots, dtype=torch.uint8, device=dev)
        info = torch.empty(3, dtype=torch.int64, device=dev)
        words, args = words.contiguous(), args.contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.load().thc_stream_decode_dev(
            dev.index, words.data_ptr(), words.numel(), args.data_ptr(), out_slots,
            dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(), dt.l1.numel(),
            int(dt.table.max_len), int(dt.table.min_len), threads, sub_bits,
            min(OVERLAP_BITS, sub_bits), out.data_ptr(), info.data_ptr(), stream,
        )
        _build.check("thc_stream_decode_dev", err)
        launches["stream_decode_dev"] += 1
        return out, info


def decode_stream_dev_plain(words: torch.Tensor, args: torch.Tensor, out_slots: int, dt):
    """Plain version of :func:`decode_stream_dev`: reads ``args`` and runs
    :func:`decode_stream_blocked_plain` with the same clamps."""
    start_bit, total_bits, budget = args.tolist()
    out = torch.zeros(out_slots, dtype=torch.uint8, device=words.device)
    return decode_stream_blocked_plain(words, max(start_bit, 0), total_bits,
                                       min(max(budget, 0), out_slots), dt, out=out)


def decode_stream_plain(words: torch.Tensor, start_bit: int, total_bits: int,
                        out_capacity: int | None, dt):
    """Plain version of :func:`decode_stream`: the port of the scan body of
    ``decode_stream_kernel``, one step per symbol, each step a torch window
    extraction and LUT lookup in int64 and the stop rules on the host."""
    dev = words.device
    w64 = u32(words)
    m = out_size(dt, start_bit, total_bits, out_capacity)
    out = torch.zeros(m, dtype=torch.uint8, device=dev)
    off, n_out, status = start_bit, 0, STATUS_OK
    while True:
        left = total_bits - off
        if left <= 0:
            break
        pos = torch.tensor([off], dtype=torch.int64, device=dev)
        sym, ln = torch.cat(lut_lookup(extract_windows(w64, pos), dt)).tolist()
        if ln == 0:
            if left >= 32:
                status = STATUS_UNKNOWN_SYMBOL
            break
        if ln > left:
            break
        if n_out >= m:
            status = STATUS_OUTPUT_FULL
            break
        out[n_out] = sym
        n_out += 1
        off += ln
    return out, torch.tensor([n_out, off, status], dtype=torch.int64, device=dev)


def _walk(w64, base: int, rem: int, dt, entry, end, lanes, slots: int = 0):
    """Every lane in ``lanes`` walks from window bit ``entry`` to the first
    step start at or past ``end``, all at once, with ``rem`` = total_bits
    less the window's first bit. A window that matches no code steps one
    bit, and no bits left (rule 1) exits at ``end``. Returns (codes before
    the first stop, exit, the first stop's status or NO_EVENT, its bit) and,
    with ``slots``, each lane's symbols before its first stop, [lanes,
    slots]."""
    p = entry.clone()
    n = p.numel()
    count = torch.zeros(n, dtype=torch.int64, device=p.device)
    ev = torch.full((n,), NO_EVENT, dtype=torch.int64, device=p.device)
    ev_bit = torch.zeros(n, dtype=torch.int64, device=p.device)
    rows = torch.arange(n, device=p.device)
    syms = torch.zeros((n, slots), dtype=torch.uint8, device=p.device) if slots else None
    active = lanes & (p < end)
    while bool(active.any()):
        left = rem - p
        sym, ln = lut_lookup(extract_windows(w64, base + p), dt)
        past = active & (left <= 0)
        miss = active & ~past & (ln == 0)
        event = past | miss | (active & (ln > left))
        first = event & (ev == NO_EVENT)
        emit = active & ~event & (ev == NO_EVENT)
        ev = torch.where(first, torch.where(miss & (left >= 32), STATUS_UNKNOWN_SYMBOL,
                                            STATUS_OK), ev)
        ev_bit = torch.where(first, p, ev_bit)
        if slots:
            syms[rows[emit], count[emit]] = sym[emit].to(torch.uint8)
        count += emit
        p = torch.where(past, end, torch.where(active, p + torch.where(miss, 1, ln), p))
        active &= p < end
    return count, p, ev, ev_bit, syms


def _guess(w64, base: int, rem: int, dt, lo, overlap: int):
    """Each slice's guessed entry: the first step start at or past its
    first bit ``lo`` of a walk from ``overlap`` bits before it (a window
    that matches no code steps one bit; past the stream, ``lo``)."""
    p = torch.where(lo > 0, lo - overlap, lo)
    while True:
        active = p < lo
        if not bool(active.any()):
            return p
        ln = lut_lookup(extract_windows(w64, base + p), dt)[1]
        past = rem - p <= 0
        p = torch.where(active, torch.where(past, lo, p + torch.where(ln == 0, 1, ln)), p)


def decode_stream_blocked_plain(words: torch.Tensor, start_bit: int, total_bits: int,
                                out_capacity: int | None, dt, *,
                                window_words: int = CPU_WINDOW_WORDS,
                                sub_bits: int = CPU_SUB_BITS,
                                out: torch.Tensor | None = None,
                                stats: torch.Tensor | None = None,
                                overlap_bits: int = OVERLAP_BITS):
    """Plain version of :func:`decode_stream` that runs the kernel's
    algorithm with torch ops, the slices of a window as one vector: the
    guessed entries (from ``overlap_bits`` before each slice, at most a
    slice), the speculative walks, the sync rounds (a lane whose entry
    changed walks its whole slice again; the kernel stops where it joins its
    previous walk, which gives the same record), the first stop on the true
    walk, the scan, the cap, and the write walk. Returns what the kernel
    returns and fills ``stats`` the same way."""
    threads = geometry(window_words, sub_bits)
    dev = words.device
    w64 = u32(words)
    m = out_size(dt, start_bit, total_bits, out_capacity)
    out = _output(out, m, dev, torch.zeros)
    _stats(stats, dev)
    slots = sub_bits // max(int(dt.table.min_len), 1) + 2
    ids = torch.arange(threads, device=dev)
    lo = ids * sub_bits
    hi = lo + sub_bits
    every = torch.ones(threads, dtype=torch.bool, device=dev)
    overlap = min(overlap_bits, sub_bits)
    pos, n_out, windows, max_rounds = start_bit, 0, 0, 0
    while True:
        base = (pos >> 5) << 5
        rem = total_bits - base
        entry = _guess(w64, base, rem, dt, lo, overlap)
        entry[0] = pos - base
        rec = _walk(w64, base, rem, dt, entry, hi, every)[:4]
        rounds = 0
        while True:
            new = torch.cat([entry[:1], rec[1][:-1]])
            changed = new != entry
            if not bool(changed.any()):
                break
            rounds += 1
            again = _walk(w64, base, rem, dt, new, hi, changed)[:4]
            rec = tuple(torch.where(changed, a, r) for a, r in zip(again, rec))
            entry = new
        count, exit_, ev, ev_bit = rec
        windows += 1
        max_rounds = max(max_rounds, rounds)
        has_ev = ev != NO_EVENT
        te = int(torch.where(has_ev, ids, threads).min())
        c = torch.where(ids <= te, count, 0)
        total = int(c.sum())
        room = m - n_out
        cut = room < total
        n_win = room if cut else total
        syms = _walk(w64, base, rem, dt, entry, hi, c > 0, slots)[4]
        held = torch.arange(slots, device=dev)[None, :] < c[:, None]
        out[n_out:n_out + n_win] = syms[held][:n_win]
        if cut:
            # the cut symbol's start: the exit of a walk of its lane's codes before it
            lane = int((torch.cumsum(c, 0) <= room).sum())
            before = room - int(c[:lane].sum())
            p = entry[lane:lane + 1].clone()
            for _ in range(before):
                p += lut_lookup(extract_windows(w64, base + p), dt)[1]
            n_out, end_bit, status = m, base + int(p), STATUS_OUTPUT_FULL
            break
        n_out += total
        if te < threads:
            end_bit, status = base + int(ev_bit[te]), int(ev[te])
            break
        pos = base + int(exit_[-1])
    if stats is not None:
        stats.copy_(torch.tensor([windows, max_rounds], dtype=torch.int64))
    return out, torch.tensor([n_out, end_bit, status], dtype=torch.int64, device=dev)

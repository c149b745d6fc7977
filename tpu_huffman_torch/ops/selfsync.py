"""Self-synchronising parallel decode of foreign (un-indexed) streams (ports
``tpu_huffman/ops/selfsync.py``: the Pallas kernel B4 ``_make_selfsync_call``
with its fixpoint loop ``_selfsync_passes``, ``_plan_segments`` and
``selfsync_decode``/``selfsync_decode_ex``).

A stream written by another encoder (the reference C library, an HPACK
peer) carries no block index, so the serial bit-offset chain is broken
another way. The stream is cut into segments of ``seg_words * 32`` bits.
Every pass decodes all segments at once from an entry-bit estimate
(:func:`decode_segments`, one thread per segment in
``csrc/selfsync_decode.cu``), and segment s's exit becomes segment s+1's
entry. Segment 0's entry is ``start_bit``, so pass k makes segment k exact,
and prefix codes resynchronise after a few symbols, so the entries usually
stop changing after two or three passes. Each pass costs one host sync (the
convergence test); the compaction and the tail cost one each more.

The kernel segments leave out the stream's last partial segment and one
guard segment, so every codeword they decode has more than 32 bits after it:
there an invalid window is an unknown symbol, as in the reference
(source/huffman.c:246), and no code can run past the end. The rest, from
the last segment's exit, goes through the sequential kernel
(``ops/stream_decode.py``) with the reference's termination rules.

The streaming decoder (``stream.py``) drains a retained word buffer
in place: :func:`selfsync_decode_words` decodes all of it, and
:func:`selfsync_decode_capped_words` at most ``capacity`` symbols from a
prefix of ``sb + (capacity + 1) * max_len + 64`` bits, so a call costs
O(capacity), not O(remainder). The capped drain asks the kernel for each
symbol's start bit (``starts``, the TPU kernel's ``emit_offs`` form) to cut
inside the body and to count the symbols before an invalid window.

Not ported: the TPU's lane bucketing of the grid, the one-pass + patch
stitch, the dense device stitch and repair, and the fused one-dispatch
drain (``_segments_pipeline_fast``, ``_stitch_fast``, ``_dense_core``,
``_dense_repair``, ``fused_drain_words``); see ROADMAP.md.

:func:`decode_segments` runs the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; there is no fallback from
one to the other. ``launches`` counts the kernel launches (one per pass)
and, under a key of its own, those that wrote ``starts``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import UnknownSymbolError
from ..tables import MAX_CODE_BITS, HuffmanTable
from . import stream_decode
from .bitpack import extract_windows, stage_words, u32
from .chain_decode import MAX_ROOT_BITS, lut_lookup
from .encode import DeviceTable, resolve_device, stage_bytes

SEG_WORDS = 32  # 1024 bits per segment
SEG_BITS = SEG_WORDS * 32
MAX_STARTS_SEG_BITS = 32767  # starts are int16
# kernel launches; "selfsync_decode_starts" counts those that also wrote starts
launches = {"selfsync_decode": 0, "selfsync_decode_starts": 0}


def supports(table: HuffmanTable) -> bool:
    """Any prefix-free table whose level-0 LUT fits the kernels' shared
    memory (``root_bits`` <= 12, the default)."""
    return 0 < table.max_len <= MAX_CODE_BITS and table.root_bits <= MAX_ROOT_BITS


def max_symbols(table: HuffmanTable, seg_bits: int) -> int:
    """Output slots per segment: the most codes that can start in it."""
    return (seg_bits + table.max_len) // max(int(table.min_len), 1) + 1


def _plan_segments(total_bits: int, seg_words: int):
    """(S kernel segments, seg_bits) for a stream of ``total_bits`` bits, or
    None when the stream is small enough for the sequential kernel alone.
    The last (possibly partial) segment and one guard segment are left to
    the sequential tail."""
    seg_bits = seg_words * 32
    if total_bits <= 4 * seg_bits:
        return None
    n_segs = -(-total_bits // seg_bits)
    s = (n_segs - 1 if total_bits % seg_bits else n_segs) - 1
    return (s, seg_bits) if s > 0 else None


def _check(words: torch.Tensor, entries: torch.Tensor, dt) -> None:
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError("words must be a 1-D int32 tensor")
    if entries.dtype != torch.int32 or entries.dim() != 1 or entries.numel() == 0:
        raise ValueError("entries must be a non-empty 1-D int32 tensor")
    if not (words.device == entries.device == dt.l0.device):
        raise ValueError("decode inputs are on different devices")


def _check_starts(starts: torch.Tensor, shape: tuple, seg_bits: int, dev) -> None:
    if seg_bits > MAX_STARTS_SEG_BITS:
        raise ValueError(f"seg_bits {seg_bits} > {MAX_STARTS_SEG_BITS}: starts are int16")
    if (starts.dtype != torch.int16 or tuple(starts.shape) != shape
            or not starts.is_contiguous() or starts.device != dev):
        raise ValueError(f"starts must be a contiguous int16 tensor of shape {shape} on {dev}")


def decode_segments(words: torch.Tensor, entries: torch.Tensor, seg_bits: int,
                    max_syms: int, dt, starts: torch.Tensor | None = None):
    """One pass: decode segment s from bit ``s * seg_bits + entries[s]``
    (``entries`` >= 0) until the first codeword start at or past its end.

    Returns (syms uint8[S, max_syms], counts, exits, bad), each of the last
    three int32[S]: the symbols of each segment in its row (zeros past its
    count), the exit bit relative to the segment (>= seg_bits), and 0 or
    1 + the segment-relative bit of the first window no code matched. Such a
    window advances 1 bit and takes no slot.

    ``starts``, when given, is an int16 [S, max_syms] tensor that the call
    fills with each emitted symbol's segment-relative start bit, in the
    symbol's slot; slots past a segment's count are left as they were.
    """
    _check(words, entries, dt)
    dev = words.device
    s = entries.numel()
    if starts is not None:
        _check_starts(starts, (s, max_syms), seg_bits, dev)
    if dev.type == "cpu":
        return decode_segments_plain(words, entries, seg_bits, max_syms, dt, starts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dt.root_bits > MAX_ROOT_BITS:
        raise ValueError(f"root_bits {dt.root_bits} > {MAX_ROOT_BITS}")
    syms = torch.zeros((s, max_syms), dtype=torch.uint8, device=dev)
    counts, exits, bad = (torch.empty(s, dtype=torch.int32, device=dev) for _ in range(3))
    words, entries = words.contiguous(), entries.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.load().thc_selfsync_decode(
        dev.index, words.data_ptr(), words.numel(), entries.data_ptr(), s,
        seg_bits, max_syms, dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(),
        dt.l1.numel(), syms.data_ptr(), None if starts is None else starts.data_ptr(),
        counts.data_ptr(), exits.data_ptr(), bad.data_ptr(), stream,
    )
    _build.check("thc_selfsync_decode", err)
    launches["selfsync_decode"] += 1
    launches["selfsync_decode_starts"] += starts is not None
    return syms, counts, exits, bad


def decode_segments_plain(words: torch.Tensor, entries: torch.Tensor,
                          seg_bits: int, max_syms: int, dt,
                          starts: torch.Tensor | None = None):
    """Plain version of :func:`decode_segments`: every segment steps at
    once, in int64, until all have passed their end."""
    dev = words.device
    w64 = u32(words)
    s = entries.numel()
    rows = torch.arange(s, device=dev)
    seg_start = rows * seg_bits
    rel = entries.to(torch.int64)
    counts = torch.zeros(s, dtype=torch.int64, device=dev)
    bad = torch.zeros(s, dtype=torch.int64, device=dev)
    syms = torch.zeros((s, max_syms), dtype=torch.uint8, device=dev)
    while True:
        active = rel < seg_bits
        if not bool(active.any()):
            break
        sym, ln = lut_lookup(extract_windows(w64, seg_start + rel), dt)
        hit = active & (ln > 0)
        miss = active & (ln == 0)
        bad = torch.where(miss & (bad == 0), rel + 1, bad)
        put = hit & (counts < max_syms)
        syms[rows[put], counts[put]] = sym[put].to(torch.uint8)
        if starts is not None:
            starts[rows[put], counts[put]] = rel[put].to(torch.int16)
        counts += hit
        rel += torch.where(miss, 1, torch.where(active, ln, 0))
    return syms, counts.to(torch.int32), rel.to(torch.int32), bad.to(torch.int32)


def _fixpoint(words: torch.Tensor, n_segs: int, seg_bits: int, start_bit: int,
              max_syms: int, dt, starts: torch.Tensor | None = None):
    """Passes of :func:`decode_segments` until the entries stop changing.

    Returns the converged pass's (syms, counts, exits, bad), its entries and
    the number of passes; ``starts`` (optional, int16 [n_segs, max_syms])
    ends up holding the converged pass's starts, zeros past each count.
    Pass k makes segment k exact, so the entries converge within ``n_segs``
    passes; raises RuntimeError if they have not after ``n_segs + 1``.
    """
    entries = torch.zeros(n_segs, dtype=torch.int32, device=words.device)
    entries[0] = start_bit
    for passes in range(1, n_segs + 2):
        if starts is not None:
            starts.zero_()
        syms, counts, exits, bad = decode_segments(words, entries, seg_bits, max_syms, dt,
                                                   starts=starts)
        new = torch.cat([entries[:1], exits[:-1] - seg_bits])
        if torch.equal(new, entries):
            return syms, counts, exits, bad, entries, passes
        entries = new
    raise RuntimeError(f"self-sync entries did not converge in {n_segs + 1} passes")


def _body(syms: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The segments' symbols, concatenated: row s up to counts[s]."""
    cols = torch.arange(syms.shape[1], device=syms.device)
    return syms.reshape(-1)[(cols[None, :] < counts[:, None]).reshape(-1)]


def decode_tail(words: torch.Tensor, from_bit: int, total_bits: int, budget: int | None, dt):
    """``stream_decode`` from ``from_bit``: (symbols, end_bit, more), where
    ``more`` means it stopped with the budget spent and a further symbol
    decodable. Raises UnknownSymbolError where the reference would."""
    syms, info = stream_decode.decode_stream(words, from_bit, total_bits, budget, dt)
    n, end_bit, status = info.tolist()
    if status == stream_decode.STATUS_UNKNOWN_SYMBOL:
        raise UnknownSymbolError()
    return syms[:n], end_bit, status == stream_decode.STATUS_OUTPUT_FULL


def _drain(words: torch.Tensor, start_bit: int, total_bits: int, dt,
           seg_words: int) -> tuple[torch.Tensor, int]:
    """Decode all of ``words`` from ``start_bit`` (< 32) to ``total_bits``:
    (symbols uint8 on the words' device, end_bit). The kernel segments
    leave out the last partial segment and a guard segment, which go
    through ``stream_decode``."""
    plan = _plan_segments(total_bits, seg_words)
    body = torch.zeros(0, dtype=torch.uint8, device=words.device)
    tail_start = start_bit
    if plan is not None:
        n_segs, seg_bits = plan
        syms, counts, exits, bad, _entries, _passes = _fixpoint(
            words, n_segs, seg_bits, start_bit, max_symbols(dt.table, seg_bits), dt
        )
        any_bad, last_exit = torch.stack(
            [(bad != 0).any().to(torch.int64), exits[-1].to(torch.int64)]
        ).tolist()
        if any_bad:
            raise UnknownSymbolError()
        body = _body(syms, counts)
        tail_start = n_segs * seg_bits + last_exit - seg_bits
    tail, end_bit, _more = decode_tail(words, tail_start, total_bits, None, dt)
    return torch.cat([body, tail]), end_bit


def _drain_capped(words: torch.Tensor, start_bit: int, total_bits: int,
                  capacity: int, dt, seg_words: int):
    """At most ``capacity`` symbols of ``words`` from ``start_bit`` (< 32):
    (symbols, end_bit, more), the contract of the JAX package's
    ``selfsync_decode_capped_words``. Only a prefix that holds ``capacity + 1`` codes and a
    32-bit window is decoded, so the cost is O(capacity)."""
    table = dt.table
    need_bits = start_bit + (capacity + 1) * int(table.max_len) + 64
    view_words = -(-total_bits // 32)
    prefix_words = min(view_words, -(-need_bits // 32))
    full = prefix_words == view_words
    prefix_bits = total_bits if full else prefix_words * 32

    def tail(from_bit: int, budget: int):
        out, end_bit, more = decode_tail(words, from_bit, prefix_bits, budget, dt)
        if not more and not full:
            # the prefix ran out before the budget did: cannot happen given
            # its bound, but the whole stream gives the right answer anyway
            out, end_bit, more = decode_tail(words, from_bit, total_bits, budget, dt)
        return out, end_bit, more

    plan = _plan_segments(prefix_bits, seg_words)
    if plan is None:
        return tail(start_bit, capacity)
    n_segs, seg_bits = plan
    max_syms = max_symbols(table, seg_bits)
    starts = torch.zeros((n_segs, max_syms), dtype=torch.int16, device=words.device)
    syms, counts, exits, bad, _entries, _passes = _fixpoint(
        words, n_segs, seg_bits, start_bit, max_syms, dt, starts=starts
    )
    dev = words.device
    cum = torch.cumsum(counts, 0, dtype=torch.int64)
    seg = torch.arange(n_segs, device=dev)
    cols = torch.arange(max_syms, device=dev)

    def before(s):  # symbols in the segments before s
        return torch.where(s > 0, cum[(s - 1).clamp(min=0)], 0)

    # the first invalid window on the converged chain, and the symbols
    # before it, counted from the kernel's starts
    is_bad = bad != 0
    s_b = torch.where(is_bad, seg, n_segs).min().clamp(max=n_segs - 1)
    before_bad = before(s_b) + (
        (starts[s_b].to(torch.int64) < bad[s_b].to(torch.int64) - 1) & (cols < counts[s_b])
    ).sum()
    # the segment holding symbol number `capacity` (0-based), and its slot
    s_c = (cum <= capacity).sum().clamp(max=n_segs - 1)
    within = capacity - before(s_c)
    cut_rel = starts[s_c, within.clamp(0, max_syms - 1)]
    total_body, any_bad, before_bad, last_exit, s_c, cut_rel = torch.stack([
        cum[-1], is_bad.any().to(torch.int64), before_bad, exits[-1].to(torch.int64),
        s_c, cut_rel.to(torch.int64),
    ]).tolist()
    if any_bad and capacity >= before_bad:
        # the invalid window is reached within the cap or exactly at it: the
        # reference checks an unknown symbol before a full output
        raise UnknownSymbolError()
    body = _body(syms, counts)
    if total_body > capacity:
        return body[:capacity], s_c * seg_bits + cut_rel, True
    out, end_bit, more = tail(n_segs * seg_bits + last_exit - seg_bits, capacity - total_body)
    return torch.cat([body, out]), end_bit, more


def _host_bytes(symbols: torch.Tensor) -> bytes:
    return symbols.cpu().numpy().tobytes()


def _seg_words(seg_words: int | None) -> int:
    """``seg_words``, or the module's SEG_WORDS read at call time."""
    seg_words = SEG_WORDS if seg_words is None else seg_words
    if seg_words < 1:
        raise ValueError(f"seg_words must be >= 1, got {seg_words}")
    return seg_words


def words_view(buf: torch.Tensor, nbytes: int, consumed_bit: int):
    """The retained stream from its first unconsumed word: (buf[w0:], start
    bit in it, its length in bits, its first bit in buf's frame)."""
    if buf.dtype != torch.int32 or buf.dim() != 1 or 32 * buf.numel() < 8 * nbytes:
        raise ValueError("buf must be a 1-D int32 tensor holding nbytes bytes")
    if not 0 <= consumed_bit <= 8 * nbytes:
        raise ValueError(f"consumed_bit {consumed_bit} outside the stream of {nbytes} bytes")
    w0 = consumed_bit >> 5
    return buf[w0:], consumed_bit - 32 * w0, 8 * nbytes - 32 * w0, 32 * w0


def selfsync_decode_words(buf: torch.Tensor, nbytes: int, consumed_bit: int,
                          table: HuffmanTable, seg_words: int | None = None
                          ) -> tuple[bytes, int]:
    """Device-resident decode of a retained word buffer (ports
    ``selfsync.selfsync_decode_words``).

    ``buf`` (int32 words on the device) holds the stream's first ``nbytes``
    bytes, zeros after; the bits before ``consumed_bit`` are consumed. The
    stream is never uploaded again: the decode runs on a view of ``buf``
    and only the symbols come back. Returns (symbols, end_bit), ``end_bit``
    in ``buf``'s frame.
    """
    seg_words = _seg_words(seg_words)
    view, sb, total_bits, base = words_view(buf, nbytes, consumed_bit)
    if total_bits <= sb:
        return b"", consumed_bit
    out, end_bit = _drain(view, sb, total_bits, DeviceTable.for_table(table, buf.device),
                          seg_words)
    return _host_bytes(out), base + end_bit


def selfsync_decode_capped_words(buf: torch.Tensor, nbytes: int, consumed_bit: int,
                                 table: HuffmanTable, capacity: int,
                                 seg_words: int | None = None) -> tuple[bytes, int, bool]:
    """Device-resident decode of at most ``capacity`` symbols (ports
    ``selfsync.selfsync_decode_capped_words``).

    Returns (symbols, end_bit, more): ``end_bit`` (in ``buf``'s frame) is
    the resume point after the last symbol returned, and ``more`` is True
    iff a further symbol is decodable. An invalid window (with 32 or more
    bits after it) reached within the first ``capacity`` symbols, or right
    after them, raises UnknownSymbolError; one further on does not.
    """
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    seg_words = _seg_words(seg_words)
    view, sb, total_bits, base = words_view(buf, nbytes, consumed_bit)
    if total_bits <= sb:
        return b"", consumed_bit, False
    out, end_bit, more = _drain_capped(
        view, sb, total_bits, capacity, DeviceTable.for_table(table, buf.device), seg_words
    )
    return _host_bytes(out), base + end_bit, more


def selfsync_decode_capped(data, table: HuffmanTable, capacity: int,
                           seg_words: int | None = None, start_bit: int = 0,
                           device="cuda") -> tuple[bytes, int, bool]:
    """:func:`selfsync_decode_capped_words` of host bytes from ``start_bit``
    (< 8) (ports ``selfsync.selfsync_decode_capped``)."""
    if not 0 <= start_bit < 8:
        raise ValueError(f"start_bit must be in [0, 8), got {start_bit}")
    raw = stage_bytes(data, resolve_device(device))
    return selfsync_decode_capped_words(stage_words(raw), raw.numel(), start_bit, table,
                                        capacity, seg_words)


def selfsync_decode(data, table: HuffmanTable, seg_words: int = SEG_WORDS,
                    device="cuda") -> bytes:
    """Parallel decode of a foreign stream; bit-exact with the reference."""
    return selfsync_decode_ex(data, table, seg_words, device=device)[0]


def selfsync_decode_ex(data, table: HuffmanTable, seg_words: int = SEG_WORDS,
                       start_bit: int = 0, device="cuda") -> tuple[bytes, int]:
    """Parallel decode returning (symbols, end_bit).

    ``end_bit`` is the absolute bit where decoding stopped: the start of the
    first code that does not complete within the input, or of the trailing
    padding, which is the resume point of the reference decoder.
    ``start_bit`` (< 8) lets a streaming caller resume mid-byte. Raises
    UnknownSymbolError where the reference would.
    """
    if not 0 <= start_bit < 8:
        raise ValueError(f"start_bit must be in [0, 8), got {start_bit}")
    if seg_words < 1:
        raise ValueError(f"seg_words must be >= 1, got {seg_words}")
    if not supports(table):
        raise ValueError(f"table {table.name!r} is not supported by the decode kernels")
    dev = resolve_device(device)
    raw = stage_bytes(data, dev)
    total_bits = 8 * raw.numel()
    if total_bits <= start_bit:
        return b"", start_bit
    out, end_bit = _drain(stage_words(raw), start_bit, total_bits,
                          DeviceTable.for_table(table, dev), seg_words)
    return _host_bytes(out), end_bit

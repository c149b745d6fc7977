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

Not ported: the TPU's lane bucketing of the grid, the one-pass + patch
stitch, the dense device stitch and repair, the device-resident and capped
variants (``_segments_pipeline_fast``, ``_stitch_fast``, ``_dense_core``,
``_dense_repair``, ``selfsync_decode_words``, ``fused_drain_words``,
``selfsync_decode_capped*``); see ROADMAP.md.

:func:`decode_segments` runs the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; there is no fallback from
one to the other. ``launches`` counts the kernel launches, one per pass.
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
launches = {"selfsync_decode": 0}


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


def decode_segments(words: torch.Tensor, entries: torch.Tensor, seg_bits: int,
                    max_syms: int, dt):
    """One pass: decode segment s from bit ``s * seg_bits + entries[s]``
    (``entries`` >= 0) until the first codeword start at or past its end.

    Returns (syms uint8[S, max_syms], counts, exits, bad), each of the last
    three int32[S]: the symbols of each segment in its row (zeros past its
    count), the exit bit relative to the segment (>= seg_bits), and 0 or
    1 + the segment-relative bit of the first window no code matched. Such a
    window advances 1 bit and takes no slot.
    """
    _check(words, entries, dt)
    dev = words.device
    if dev.type == "cpu":
        return decode_segments_plain(words, entries, seg_bits, max_syms, dt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dt.root_bits > MAX_ROOT_BITS:
        raise ValueError(f"root_bits {dt.root_bits} > {MAX_ROOT_BITS}")
    s = entries.numel()
    syms = torch.zeros((s, max_syms), dtype=torch.uint8, device=dev)
    counts, exits, bad = (torch.empty(s, dtype=torch.int32, device=dev) for _ in range(3))
    words, entries = words.contiguous(), entries.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.load().thc_selfsync_decode(
        dev.index, words.data_ptr(), words.numel(), entries.data_ptr(), s,
        seg_bits, max_syms, dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(),
        dt.l1.numel(), syms.data_ptr(), counts.data_ptr(), exits.data_ptr(),
        bad.data_ptr(), stream,
    )
    _build.check("thc_selfsync_decode", err)
    launches["selfsync_decode"] += 1
    return syms, counts, exits, bad


def decode_segments_plain(words: torch.Tensor, entries: torch.Tensor,
                          seg_bits: int, max_syms: int, dt):
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
        counts += hit
        rel += torch.where(miss, 1, torch.where(active, ln, 0))
    return syms, counts.to(torch.int32), rel.to(torch.int32), bad.to(torch.int32)


def _fixpoint(words: torch.Tensor, n_segs: int, seg_bits: int, start_bit: int,
              max_syms: int, dt):
    """Passes of :func:`decode_segments` until the entries stop changing.

    Returns the converged pass's (syms, counts, exits, bad), its entries and
    the number of passes. Pass k makes segment k exact, so the entries
    converge within ``n_segs`` passes; raises RuntimeError if they have not
    after ``n_segs + 1``.
    """
    entries = torch.zeros(n_segs, dtype=torch.int32, device=words.device)
    entries[0] = start_bit
    for passes in range(1, n_segs + 2):
        syms, counts, exits, bad = decode_segments(words, entries, seg_bits, max_syms, dt)
        new = torch.cat([entries[:1], exits[:-1] - seg_bits])
        if torch.equal(new, entries):
            return syms, counts, exits, bad, entries, passes
        entries = new
    raise RuntimeError(f"self-sync entries did not converge in {n_segs + 1} passes")


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
    words = stage_words(raw)
    dt = DeviceTable.for_table(table, dev)
    plan = _plan_segments(total_bits, seg_words)
    body = raw.new_zeros(0)
    tail_start = start_bit
    if plan is not None:
        n_segs, seg_bits = plan
        syms, counts, exits, bad, _entries, _passes = _fixpoint(
            words, n_segs, seg_bits, start_bit, max_symbols(table, seg_bits), dt
        )
        any_bad, last_exit = torch.stack(
            [(bad != 0).any().to(torch.int64), exits[-1].to(torch.int64)]
        ).tolist()
        if any_bad:
            raise UnknownSymbolError()
        cols = torch.arange(syms.shape[1], device=dev)
        body = syms.reshape(-1)[(cols[None, :] < counts[:, None]).reshape(-1)]
        tail_start = n_segs * seg_bits + last_exit - seg_bits
    tail, info = stream_decode.decode_stream(words, tail_start, total_bits, None, dt)
    n_tail, end_bit, status = info.tolist()
    if status == stream_decode.STATUS_UNKNOWN_SYMBOL:
        raise UnknownSymbolError()
    out = torch.cat([body, tail[:n_tail]]).cpu()
    return out.numpy().tobytes(), end_bit

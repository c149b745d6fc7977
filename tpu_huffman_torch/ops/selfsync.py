"""Self-synchronising parallel decode of foreign (un-indexed) streams (ports
``tpu_huffman/ops/selfsync.py``: the Pallas kernel B4 ``_make_selfsync_call``;
the one-pass + patch stitch with its device merge, repair and assembly,
``_segments_pipeline_fast``, ``_dense_core``, ``_dense_assemble`` and the
capped cut of ``_segments_pipeline_dense_capped``; the fixpoint fallback
``_selfsync_passes``; ``_plan_segments``; ``selfsync_decode``,
``selfsync_decode_ex`` and the words drains).

A stream written by another encoder (the reference C library, an HPACK
peer) carries no block index, so the serial bit-offset chain is broken
another way. The stream is cut into segments of ``seg_words * 32`` bits,
each decoded by one thread from an entry bit (:func:`decode_segments`,
``csrc/selfsync_decode.cu``). Prefix codes resynchronise: a chain started
at a wrong bit joins the true codeword boundaries after a few symbols.

Every drain tries the stitch first (:func:`stitch`):

1. a full pass from segment-aligned entries (``start_bit`` for segment 0)
   that also writes each symbol's start bit and each segment's last
   invalid window (``starts``, ``blast``);
2. its exits, shifted by one segment, are the true entries of every
   segment whose predecessor's chain has joined by its end;
3. a patch pass of at most ``PATCH_SYMS`` codes from the true entries;
4. per segment, the first patch boundary that is also a full-pass
   boundary: from there on the full pass's chain is the true one, if no
   invalid window of it lies past that point. A segment whose patch
   reaches its end and exits where the full pass does resolves too;
5. the walk (:func:`walk_segments`, one launch, a thread an unresolved
   segment): from its true entry, each follows the chain through its
   segment and on through the next while the exit differs from the full
   pass's, so it crosses the whole run of out-of-phase segments it starts,
   stepping over the codes whole in a window's top ``WALK_STEP_BITS`` bits
   in one lookup (:func:`walk_steps`). The earliest walk that reaches a
   segment gives that segment's entry.
   Every segment walked is re-decoded whole from that entry, over its
   full-pass row (one launch, ``seg_ids``), and the chain is proved on the
   device: no re-decoded segment meets an invalid window, and every segment
   enters where its predecessor truly exits (so each run ends where the full
   pass exits, or at the last segment);
6. the body is each segment's patch head and full-pass tail (or its
   re-decoded row), in one gather on the device, cut at ``capacity`` for
   the capped drain.

A clean stream costs two launches and one host read; a walk adds two
launches and a read. The proof covers the whole chain: segment s's entry is
true once segment s-1's chain is. The earliest failure's entry is true by
induction, and a failure inside an earlier walk started from the full
pass's wrong chain, which is why the earliest walk wins. When the proof
fails (an invalid window on a true chain, as in a corrupt stream; more
failures than ``WALK_LANES``), the drain falls back to the fixpoint
(:func:`_fixpoint`): full passes, each feeding segment s's exit back as
segment s+1's entry, until the entries stop changing; pass k makes segment
k exact, and each pass costs a host sync. The fixpoint owns the error
semantics: every UnknownSymbolError of this module is raised there.
``outcomes`` counts the drains that were stitched, repaired (every walk
one segment), walked (some walk crossed more) and fell back, the
unresolved segments (``segments_repaired``) and the segments re-decoded
(``segments_walked``).

The kernel segments leave out the stream's last partial segment and one
guard segment, so every codeword they decode has more than 32 bits after it:
there an invalid window is an unknown symbol, as in the reference
(source/huffman.c:246), and no code can run past the end. The rest, from
the last segment's exit, goes through stream_decode's walk
(``ops/stream_decode.py``) with the reference's termination rules.

The streaming decoder (``stream.py``) drains a retained word buffer
in place: :func:`selfsync_decode_words` decodes all of it, and
:func:`selfsync_decode_capped_words` at most ``capacity`` symbols from a
prefix of ``sb + (capacity + 1) * max_len + 64`` bits, so a call costs
O(capacity), not O(remainder). The stitch cuts the body at the start bit
of symbol number ``capacity``, from the kernel's ``starts``.

Those two read the device two to five times a call. The decoder calls
:func:`fused_drain_words` instead, which does the same work as one
sequence of launches with one download at its end: a one-segment repair
in place of the walk, launched every time at max(``R_MAX``, S / 32) lanes
(dead on a clean stream), the body assembled at a
size the host fixes (the capacity, or a rate hint from the last call),
and the tail walked by ``stream_decode.decode_stream_dev`` from the start
bit and budget that the stitch left in device memory. A segment still
unresolved after the repair sends the call to the two classic drains,
which own the body's errors (the JAX package's ``_FusedFallback`` rule).

Not ported, because they only shape static XLA programs on the TPU: the
lane bucketing of the grid and of the download (``S_dl``), the slot-grid
rate hints (``_dl_bucket``, ``_learn_dl_rate``, ``n_dl``, ``dl_over``),
``_REPAIR_IN_INTERPRET``, the u16-pair packing of the offsets and the
split between the host stitch and the dense one (the port stitches on the
device for every table).

:func:`decode_segments` runs the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; there is no fallback from
one to the other. ``launches`` counts the kernel launches, and under keys
of their own those that wrote ``starts``, those that wrote ``blast``, the
patch launches (a code cap), the repair and re-decode launches (segment
ids) and the walks (:func:`walk_segments`, which also count as
``selfsync_decode``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build, metrics
from ..errors import UnknownSymbolError
from ..tables import MAX_CODE_BITS, HuffmanTable
from . import stream_decode
from .bitpack import download, extract_windows, stage_words, u32
from .chain_decode import lut_lookup
from .encode import DeviceTable, resolve_device, stage_bytes

SEG_WORDS = 32  # 1024 bits per segment
SEG_BITS = SEG_WORDS * 32
MAX_STARTS_SEG_BITS = 32767  # starts are int16
NO_START = MAX_STARTS_SEG_BITS  # a starts slot with no symbol: past any segment's end
# Patch-pass codes per segment (the JAX package's PATCH_SYMS): the merge
# must fall within them, or the segment goes to the repair.
PATCH_SYMS = 32
# Unresolved segments the walk takes, more fall back to the fixpoint: every
# one, as far as the kernel's 24-bit walk numbers go
WALK_LANES = (1 << 24) - 1
# The fused drain's in-graph repair (one segment a lane, no host read):
# R_MAX lanes, or S / 32 of S segments where that is more, as the JAX
# package's device stitch (R_MAX = 256) and host one (max(64, S >> 5)).
R_MAX = 256
# The walk kernel's list of the segments its walks cross: WALK_PAIRS
# entries a segment (a walk past it is not kept whole, and the proof fails)
WALK_PAIRS = 2
# The walk steps over every code that lies whole in a window's top
# WALK_STEP_BITS bits in one lookup (csrc/selfsync_decode.cu kWalkStepBits)
WALK_STEP_BITS = 12
launches = metrics.register("ops.selfsync.launches", {
    "selfsync_decode": 0, "selfsync_decode_starts": 0, "selfsync_decode_blast": 0,
    "selfsync_decode_patch": 0, "selfsync_decode_repair": 0, "selfsync_decode_walk": 0})
# drains of kernel segments by how they ended, the unresolved segments and
# the segments the walk re-decoded; the fused drains that fell back to the
# classic ones, and the fused drains whose body outgrew the first download
outcomes = metrics.register("ops.selfsync.outcomes", {
    "stitched": 0, "repaired": 0, "walked": 0, "fixpoint": 0, "segments_repaired": 0,
    "segments_walked": 0, "fallback": 0, "second_downloads": 0})


def supports(table: HuffmanTable) -> bool:
    """Any prefix-free table: ``DeviceTable`` builds the kernels' LUT at a
    level-0 width that fits shared memory."""
    return 0 < table.max_len <= MAX_CODE_BITS


ROW_SLOTS = 32  # the row pitch's multiple: a row of symbols starts on a 32-byte sector


def max_symbols(table: HuffmanTable, seg_bits: int) -> int:
    """Output slots per segment (the rows' pitch): the most codes that can
    start in it, rounded up to a multiple of ``ROW_SLOTS``, so that the
    kernel's rows start on a sector and end on a whole flush."""
    most = (seg_bits + table.max_len) // max(int(table.min_len), 1) + 1
    return -(-most // ROW_SLOTS) * ROW_SLOTS


def _plan_segments(total_bits: int, seg_words: int):
    """(S kernel segments, seg_bits) for a stream of ``total_bits`` bits, or
    None when the stream is small enough for stream_decode's walk alone.
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


def _check_lanes(name: str, t: torch.Tensor, n: int, dev) -> None:
    if (t.dtype != torch.int32 or tuple(t.shape) != (n,) or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"{name} must be a contiguous int32 tensor of shape ({n},) on {dev}")


def decode_segments(words: torch.Tensor, entries: torch.Tensor, seg_bits: int,
                    max_syms: int, dt, starts: torch.Tensor | None = None,
                    blast: torch.Tensor | None = None, max_codes: int = 0,
                    seg_ids: torch.Tensor | None = None, syms_out: torch.Tensor | None = None):
    """One pass: lane t decodes segment s = t (or ``seg_ids[t]``) from bit
    ``s * seg_bits + entries[t]`` (``entries`` >= 0) until the first
    codeword start at or past the segment's end, or, with ``max_codes`` >
    0, once it has emitted that many codes.

    Returns (syms uint8[T, max_syms], counts, exits, bad), each of the last
    three int32[T]: the symbols of each lane in its row, the exit bit
    relative to the segment (where the lane stopped), and 0 or 1 + the
    segment-relative bit of the first window no code matched. Such a window
    advances 1 bit and takes no slot.

    ``starts``, when given, is an int16 [T, max_syms] tensor that the call
    fills with each emitted symbol's segment-relative start bit, in the
    symbol's slot. ``blast``, when given, is an int32 [T] tensor that the
    call fills with 0 or 1 + the segment-relative bit of the last invalid
    window.

    The row contract: a live lane writes its whole rows, its symbols then 0
    in ``syms`` and its start bits then ``NO_START`` in ``starts``, up to
    ``max_syms``, so every row of ``starts`` ascends and neither tensor
    needs a fill before the call (the kernel's rows come from
    ``torch.empty``). A negative ``seg_ids`` entry is a dead lane: it writes
    nothing, so its syms row is undefined (zeros from the plain version),
    its counts, exits and bad are 0, and its starts and blast are left as
    they were. ``syms_out``, when given, is the uint8 [T, max_syms] tensor
    the rows go to (and the one returned), so that the rows of a launch with
    dead lanes land over another pass's.
    """
    with metrics.span("tt.selfsync.pass"):
        _check(words, entries, dt)
        dev = words.device
        t = entries.numel()
        if starts is not None:
            _check_starts(starts, (t, max_syms), seg_bits, dev)
        if blast is not None:
            _check_lanes("blast", blast, t, dev)
        if syms_out is not None and (
                syms_out.dtype != torch.uint8 or tuple(syms_out.shape) != (t, max_syms)
                or not syms_out.is_contiguous() or syms_out.device != dev):
            raise ValueError(f"syms_out must be a contiguous uint8 tensor of shape "
                             f"{(t, max_syms)} on {dev}")
        if seg_ids is not None:
            _check_lanes("seg_ids", seg_ids, t, dev)
        if not 0 <= max_codes <= max_syms:
            raise ValueError(f"max_codes must be in [0, max_syms={max_syms}], got {max_codes}")
        if dev.type == "cpu":
            return decode_segments_plain(words, entries, seg_bits, max_syms, dt, starts, blast,
                                         max_codes, seg_ids, syms_out)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        syms = syms_out if syms_out is not None else torch.empty(
            (t, max_syms), dtype=torch.uint8, device=dev)
        new = torch.empty if seg_ids is None else torch.zeros  # dead lanes write nothing
        counts, exits, bad = (new(t, dtype=torch.int32, device=dev) for _ in range(3))
        words, entries = words.contiguous(), entries.contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream

        def ptr(x):
            return None if x is None else x.data_ptr()

        err = _build.load().thc_selfsync_decode(
            dev.index, words.data_ptr(), words.numel(), entries.data_ptr(), ptr(seg_ids), t,
            seg_bits, max_syms, max_codes, dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(),
            dt.l1.numel(), dt.table.max_len, syms.data_ptr(), ptr(starts), counts.data_ptr(),
            exits.data_ptr(), bad.data_ptr(), ptr(blast), stream,
        )
        _build.check("thc_selfsync_decode", err)
        launches["selfsync_decode"] += 1
        launches["selfsync_decode_starts"] += starts is not None
        launches["selfsync_decode_blast"] += blast is not None
        launches["selfsync_decode_patch"] += max_codes > 0
        launches["selfsync_decode_repair"] += seg_ids is not None
        return syms, counts, exits, bad


def decode_segments_plain(words: torch.Tensor, entries: torch.Tensor,
                          seg_bits: int, max_syms: int, dt,
                          starts: torch.Tensor | None = None,
                          blast: torch.Tensor | None = None, max_codes: int = 0,
                          seg_ids: torch.Tensor | None = None,
                          syms_out: torch.Tensor | None = None):
    """Plain version of :func:`decode_segments`, with the same row contract:
    every lane steps at once, in int64, until all have stopped."""
    dev = words.device
    w64 = u32(words)
    t = entries.numel()
    rows = torch.arange(t, device=dev)
    seg = rows if seg_ids is None else seg_ids.to(torch.int64)
    live = seg >= 0
    seg_start = seg.clamp(min=0) * seg_bits
    rel = entries.to(torch.int64)
    counts = torch.zeros(t, dtype=torch.int64, device=dev)
    bad = torch.zeros(t, dtype=torch.int64, device=dev)
    last_bad = torch.zeros(t, dtype=torch.int64, device=dev)
    syms = torch.zeros((t, max_syms), dtype=torch.uint8, device=dev)
    if starts is not None:
        starts[live] = NO_START
    while True:
        active = live & (rel < seg_bits)
        if max_codes:
            active &= counts < max_codes
        if not bool(active.any()):
            break
        sym, ln = lut_lookup(extract_windows(w64, seg_start + rel), dt)
        hit = active & (ln > 0)
        miss = active & (ln == 0)
        bad = torch.where(miss & (bad == 0), rel + 1, bad)
        last_bad = torch.where(miss, rel + 1, last_bad)
        put = hit & (counts < max_syms)
        syms[rows[put], counts[put]] = sym[put].to(torch.uint8)
        if starts is not None:
            starts[rows[put], counts[put]] = rel[put].to(torch.int16)
        counts += hit
        rel += torch.where(miss, 1, torch.where(active, ln, 0))
    if blast is not None:
        blast.copy_(torch.where(live, last_bad, blast.to(torch.int64)))
    exits = torch.where(live, rel, 0)
    if syms_out is not None:
        syms_out[live] = syms[live]
        syms = syms_out
    return syms, counts.to(torch.int32), exits.to(torch.int32), bad.to(torch.int32)


def walk_steps(dt) -> torch.Tensor:
    """The walk kernel's second table, uint8 [2^WALK_STEP_BITS] on ``dt``'s
    device, built once a DeviceTable: for each value of a window's top
    WALK_STEP_BITS bits, the bits of the codes that lie whole in them, taken
    from the first while each is whole; 0 where the first is longer or no
    code matches."""
    got = getattr(dt, "walk_steps", None)
    if got is None:
        k, t = WALK_STEP_BITS, dt.table
        head = np.zeros(1 << k, np.int64)  # the length of the code each k-bit value starts with
        for sym in np.flatnonzero((t.lengths > 0) & (t.lengths <= k)):
            n, code = int(t.lengths[sym]), int(t.patterns[sym])
            head[code << (k - n):(code + 1) << (k - n)] = n
        window = np.arange(1 << k)
        pos = np.zeros_like(window)
        whole = np.ones(window.size, bool)
        for _ in range(k):
            n = head[(window << pos) & ((1 << k) - 1)]
            whole &= (n > 0) & (pos + n <= k)
            pos = np.where(whole, pos + n, pos)
        with metrics.h2d(pos.size):
            got = dt.walk_steps = torch.as_tensor(pos.astype(np.uint8)).to(dt.l0.device)
    return got


def walk_segments(words: torch.Tensor, seg_ids: torch.Tensor, entries: torch.Tensor,
                  exits0: torch.Tensor, seg_bits: int, dt):
    """The stitch's walk (step 5). Lane t follows the chain from segment
    f = ``seg_ids[t]``'s entry bit ``entries[f]`` to the end of that
    segment, and on through the next while its exit differs from
    ``exits0[k]``; it stops at an invalid window and at the last segment.
    ``entries`` and ``exits0`` are int32 [S], the true entries and the full
    pass's exits; ``seg_ids`` ascend, >= 0. The walks are kept in order, each
    that starts past the last kept one's end: a later one started from the
    full pass's wrong chain.

    Returns (claim int32 [S], ends int32 [T]): each segment's entry bit on
    the kept walk that crossed it, -1 where none did; each kept walk's last
    segment, -1 for a dropped walk. No rows are written: a walk keeps only
    its chain's state, and the stitch re-decodes the segments claimed.
    """
    with metrics.span("tt.selfsync.walk"):
        _check(words, entries, dt)
        dev = words.device
        n = seg_ids.numel()
        n_segs = exits0.numel()
        _check_lanes("seg_ids", seg_ids, n, dev)
        _check_lanes("entries", entries, n_segs, dev)
        _check_lanes("exits0", exits0, n_segs, dev)
        if not 0 < n < 1 << 24:
            raise ValueError(f"{n} walks: 1 to 2^24 - 1")
        if dev.type == "cpu":
            return walk_segments_plain(words, seg_ids, entries, exits0, seg_bits, dt)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        steps = walk_steps(dt)
        claim = torch.full((n_segs,), -1, dtype=torch.int32, device=dev)
        ends = torch.empty(n, dtype=torch.int32, device=dev)
        cap = WALK_PAIRS * n_segs
        pairs = torch.empty(cap, dtype=torch.int64, device=dev)
        counters = torch.zeros(2, dtype=torch.int32, device=dev)
        words, entries = words.contiguous(), entries.contiguous()
        err = _build.load().thc_selfsync_walk(
            dev.index, words.data_ptr(), words.numel(), seg_ids.data_ptr(), entries.data_ptr(),
            n, exits0.data_ptr(), n_segs, seg_bits, dt.l0.data_ptr(), dt.root_bits,
            dt.l1.data_ptr(), dt.l1.numel(), dt.table.max_len, steps.data_ptr(),
            ends.data_ptr(), pairs.data_ptr(), cap, counters.data_ptr(), claim.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check("thc_selfsync_walk", err)
        launches["selfsync_decode"] += 1
        launches["selfsync_decode_walk"] += 1
        return claim, ends


def walk_segments_plain(words: torch.Tensor, seg_ids: torch.Tensor, entries: torch.Tensor,
                        exits0: torch.Tensor, seg_bits: int, dt):
    """Plain version of :func:`walk_segments`: the walks step a segment at
    a time together, each segment through :func:`decode_segments_plain`
    with no rows; then the walks are kept in order on the host. The kernel
    steps over runs of whole codes in one lookup (:func:`walk_steps`), which
    leaves every chain as it is; it lists (segment, walk, entry) with an
    atomic counter and keeps the walks in its last block. Its list holds
    ``WALK_PAIRS`` entries a segment; the walks of a stream that fill it are
    not kept whole there, and the stitch falls back."""
    n_segs = exits0.numel()
    lane = torch.arange(seg_ids.numel(), device=words.device)
    seg = seg_ids.to(torch.int64)
    rel = entries[seg].to(torch.int64)
    ends = seg.clone()
    crossed = []  # (walk, segment, entry) a step
    while lane.numel():
        crossed.append((lane, seg, rel))
        ends[lane] = seg
        _syms, _counts, exits, bad = decode_segments_plain(
            words, rel.to(torch.int32), seg_bits, 0, dt, seg_ids=seg.to(torch.int32))
        on = (bad == 0) & (exits != exits0[seg]) & (seg + 1 < n_segs)
        lane, seg, rel = lane[on], seg[on] + 1, exits[on].to(torch.int64) - seg_bits
    reach, kept = -1, []
    for first, end in zip(seg_ids.tolist(), ends.tolist()):
        kept.append(first > reach)
        reach = end if kept[-1] else reach
    kept = torch.tensor(kept, dtype=torch.bool, device=words.device)
    claim = torch.full((n_segs,), -1, dtype=torch.int32, device=words.device)
    for lane, seg, rel in crossed:
        claim[seg[kept[lane]]] = rel[kept[lane]].to(torch.int32)
    return claim, torch.where(kept, ends, -1).to(torch.int32)


def _fixpoint(words: torch.Tensor, n_segs: int, seg_bits: int, start_bit: int,
              max_syms: int, dt, starts: torch.Tensor | None = None):
    """Passes of :func:`decode_segments` until the entries stop changing.

    Returns the converged pass's (syms, counts, exits, bad), its entries and
    the number of passes; ``starts`` (optional, int16 [n_segs, max_syms])
    ends up holding the converged pass's starts, NO_START past each count.
    Pass k makes segment k exact, so the entries converge within ``n_segs``
    passes; raises RuntimeError if they have not after ``n_segs + 1``.
    """
    entries = torch.zeros(n_segs, dtype=torch.int32, device=words.device)
    entries[:1].fill_(start_bit)
    for passes in range(1, n_segs + 2):
        syms, counts, exits, bad = decode_segments(words, entries, seg_bits, max_syms, dt,
                                                   starts=starts)
        new = torch.cat([entries[:1], exits[:-1] - seg_bits])
        with metrics.d2h(1):
            same = torch.equal(new, entries)
        if same:
            return syms, counts, exits, bad, entries, passes
        entries = new
    raise RuntimeError(f"self-sync entries did not converge in {n_segs + 1} passes")


def _body(syms: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The segments' symbols, concatenated: row s up to counts[s]."""
    cols = torch.arange(syms.shape[1], device=syms.device)
    return syms.reshape(-1)[(cols[None, :] < counts[:, None]).reshape(-1)]


def _assemble(head: torch.Tensor, tail: torch.Tensor, i_eff: torch.Tensor,
              j_s: torch.Tensor, counts: torch.Tensor, n_out: int) -> torch.Tensor:
    """The first ``n_out`` symbols of the stitched chains: per segment s,
    ``head[s, :i_eff[s]]`` then ``tail[s, j_s[s]:]`` up to ``counts[s]``
    symbols in all. One masked gather over the two row sets side by side;
    the mask's count is known, so ``nonzero_static`` needs no sync."""
    dev = head.device
    cols_a = torch.arange(head.shape[1], device=dev)
    cols = torch.arange(tail.shape[1], device=dev)
    tail_end = j_s + counts - i_eff
    keep = torch.cat([cols_a < i_eff[:, None],
                      (cols >= j_s[:, None]) & (cols < tail_end[:, None])], 1)
    idx = torch.nonzero_static(keep.reshape(-1), size=n_out)[:, 0]
    return torch.cat([head, tail], 1).reshape(-1)[idx]


@dataclasses.dataclass
class _Merge:
    """Steps 1-4 of the stitch, on the device: the full pass's rows, the
    true entries, the patch's rows, and per segment the merge's head length
    (``i_eff``), tail start (``j_s``), symbol count and failure flag."""

    max_syms: int
    syms0: torch.Tensor
    starts0: torch.Tensor
    exits0: torch.Tensor
    entries1: torch.Tensor
    syms_a: torch.Tensor
    starts_a: torch.Tensor
    i_eff: torch.Tensor
    j_s: torch.Tensor
    counts: torch.Tensor
    fail: torch.Tensor


def _merge(words: torch.Tensor, start_bit: int, plan: tuple, dt) -> _Merge:
    """The full pass, the patch from the true entries and the merge (steps
    1-4 of the module's docstring): two launches and torch ops, no host
    read."""
    n_segs, seg_bits = plan
    dev = words.device
    a = PATCH_SYMS
    max_syms = max_symbols(dt.table, seg_bits)

    # 1. the full pass, from segment-aligned entries
    entries0 = torch.zeros(n_segs, dtype=torch.int32, device=dev)
    entries0[:1].fill_(start_bit)  # a fill kernel: no host-to-device copy
    starts0 = torch.empty((n_segs, max_syms), dtype=torch.int16, device=dev)
    blast0 = torch.empty(n_segs, dtype=torch.int32, device=dev)
    syms0, count0, exits0, _bad0 = decode_segments(words, entries0, seg_bits, max_syms, dt,
                                                   starts=starts0, blast=blast0)
    # 2. the true entries, and 3. the patch from them
    entries1 = torch.cat([entries0[:1], exits0[:-1] - seg_bits])
    starts_a = torch.empty((n_segs, a), dtype=torch.int16, device=dev)
    syms_a, count_a, exits_a, bad_a = decode_segments(words, entries1, seg_bits, a, dt,
                                                      starts=starts_a, max_codes=a)
    count0, count_a, blast0 = count0.long(), count_a.long(), blast0.long()

    # 4. merge: the first patch boundary that is also one of pass 0's
    # (rows of starts0 ascend, NO_START past each count)
    pos = torch.searchsorted(starts0, starts_a)
    j = pos.clamp(max=max_syms - 1)
    hit = ((starts0.gather(1, j) == starts_a) & (pos < count0[:, None])
           & (torch.arange(a, device=dev) < count_a[:, None]))
    any_hit = hit.any(1)
    i_s = torch.where(any_hit, hit.to(torch.uint8).argmax(1), 0)
    j_s = torch.where(any_hit, j.gather(1, i_s[:, None])[:, 0], 0)
    merge_bit = torch.where(any_hit, starts_a.gather(1, i_s[:, None])[:, 0].long(), 0)
    # _dense_core's resolution rule (tpu_huffman/ops/selfsync.py:1006-1011)
    tail_clean = (blast0 == 0) | (blast0 - 1 < merge_bit)
    use_tail = any_hit & tail_clean
    reached_end = count_a < a
    resolved = (bad_a == 0) & (use_tail | (reached_end & (exits_a == exits0)))
    i_eff = torch.where(use_tail, i_s, count_a)
    counts = i_eff + torch.where(use_tail, count0 - j_s, 0)
    return _Merge(max_syms, syms0, starts0, exits0, entries1, syms_a, starts_a, i_eff, j_s,
                  counts, ~resolved)


def _repair_lanes(fail: torch.Tensor, lanes: int):
    """The repair's segment ids: the failed segments in lanes 0.., in order
    (a scatter by their rank among the failures), the other lanes dead
    (-1); failures past ``lanes`` are left out. Returns (seg_ids int32
    [lanes], rank int64 [n_segs])."""
    n_segs = fail.numel()
    rank = torch.cumsum(fail, 0) - 1
    lane = torch.where(fail & (rank < lanes), rank, lanes)  # slot `lanes` takes the rest
    seg_ids = torch.full((lanes + 1,), -1, dtype=torch.int32, device=fail.device)
    seg_ids.scatter_(0, lane, torch.arange(n_segs, dtype=torch.int32, device=fail.device))
    return seg_ids[:lanes], rank


def stitch(words: torch.Tensor, start_bit: int, plan: tuple, dt,
           capacity: int | None = None):
    """The one-pass + patch stitch and the walk over the plan's segments,
    on the words' device (see the module's docstring).

    Returns None when a segment stays unresolved, else (body, tail_start,
    total, cut): the first min(total, capacity) symbols of the segments'
    true chains (uint8, on the device), the bit where the sequential tail
    starts, the segments' symbol count, and the start bit of symbol number
    ``capacity`` when ``capacity`` < total (else None). Raises nothing for
    the stream's content: a true chain with an invalid window never
    resolves.
    """
    with metrics.span("tt.selfsync.stitch"):
        n_segs, seg_bits = plan
        if seg_bits > MAX_STARTS_SEG_BITS:
            return None  # no int16 starts to merge at
        dev = words.device
        m = _merge(words, start_bit, plan, dt)
        max_syms, syms0, starts0, exits0 = m.max_syms, m.syms0, m.starts0, m.exits0
        syms_a, starts_a, i_eff, j_s, counts, fail = (m.syms_a, m.starts_a, m.i_eff, m.j_s,
                                                      m.counts, m.fail)

        def read(counts, last_exit, *flags):
            """One host read: (total, last exit, the cut's bit or 0, *flags)."""
            cum = torch.cumsum(counts, 0)
            cut_bit = torch.zeros((), dtype=torch.int64, device=dev)
            if capacity is not None:
                cut_bit = _cut_bit(cum, capacity, seg_bits, i_eff, j_s, starts_a, starts0)
            with metrics.d2h(8 * (3 + len(flags))):
                return torch.stack([cum[-1], last_exit.long(), cut_bit,
                                    *(f.long() for f in flags)]).tolist()

        total, last_exit, cut_bit, n_fail = read(counts, exits0[-1], fail.sum())
        n_walked = crossed = 0
        if n_fail:
            if n_fail > WALK_LANES:
                return None
            # 5. the walk from each failed segment's true entry, then every
            # segment it crossed re-decoded over its full-pass row (lane s
            # is segment s, dead where no walk crossed), then the proof
            seg_ids = torch.nonzero_static(fail, size=n_fail)[:, 0].to(torch.int32)
            claim, ends = walk_segments(words, seg_ids, m.entries1, exits0, seg_bits, dt)
            seg = torch.arange(n_segs, device=dev)
            walked = claim >= 0
            _syms, count_w, exits_w, bad_w = decode_segments(
                words, claim, seg_bits, max_syms, dt, starts=starts0,
                seg_ids=torch.where(walked, seg, -1).to(torch.int32), syms_out=syms0)
            # the chain: each segment enters (at its claim where walked, else
            # where the full pass's exit put it) at its predecessor's true exit
            exit_t = torch.where(walked, exits_w, exits0)
            enter_t = torch.cat([m.entries1[:1], exit_t[:-1] - seg_bits])
            ok = ((torch.where(walked, claim, m.entries1) == enter_t) & (bad_w == 0)
                  & (walked | ~fail)).all()
            # a walked segment is its re-decoded row whole: no head, all tail
            i_eff.masked_fill_(walked, 0)
            j_s.masked_fill_(walked, 0)
            counts = torch.where(walked, count_w.long(), counts)
            total, last_exit, cut_bit, ok, n_walked, n_runs = read(
                counts, exit_t[-1], ok, walked.sum(), (ends >= 0).sum())
            if not ok:
                return None
            crossed = n_walked > n_runs
        # 6. the body, cut at `capacity`
        n_out = total if capacity is None else min(total, capacity)
        body = _assemble(syms_a, syms0, i_eff, j_s, counts, n_out)
        outcomes["walked" if crossed else "repaired" if n_fail else "stitched"] += 1
        outcomes["segments_repaired"] += n_fail
        outcomes["segments_walked"] += n_walked
        cut = cut_bit if capacity is not None and total > capacity else None
        return body, n_segs * seg_bits + last_exit - seg_bits, total, cut


def _cut_bit(cum: torch.Tensor, capacity: int, seg_bits: int, i_eff: torch.Tensor,
             j_s: torch.Tensor, starts_a: torch.Tensor, starts0: torch.Tensor,
             repaired: tuple | None = None) -> torch.Tensor:
    """The start bit (0-d int64, in the words' frame) of symbol number
    ``capacity`` (0-based) of the stitched chains, whose segments' symbol
    counts have the inclusive prefix ``cum``: its segment, then its slot in
    the patch's head or the full pass's tail. ``repaired`` = (flag per
    segment, its repair lane, the repair's starts) takes the repaired
    segments' starts from their lanes instead."""
    n_segs, max_syms = starts0.shape
    a = starts_a.shape[1]
    # one-element index tensors: indexing by a 0-d tensor reads it on the host
    s_c = (cum <= capacity).sum().clamp(max=n_segs - 1).reshape(1)
    within = capacity - torch.where(s_c > 0, cum[(s_c - 1).clamp(min=0)], 0)
    ie = i_eff[s_c]
    bit = torch.where(within < ie, starts_a[s_c, within.clamp(0, a - 1)],
                      starts0[s_c, (j_s[s_c] + within - ie).clamp(0, max_syms - 1)])
    if repaired is not None:
        take, lane_of, starts_r = repaired
        bit = torch.where(take[s_c], starts_r[lane_of[s_c], within.clamp(0, max_syms - 1)], bit)
    return (s_c * seg_bits + bit.long()).reshape(())


def _fixpoint_body(words: torch.Tensor, start_bit: int, plan: tuple, dt,
                   capacity: int | None = None):
    """:func:`stitch`'s result by the fixpoint. Raises UnknownSymbolError
    where the reference would: on any invalid window of the converged chain
    or, with ``capacity``, on one reached within the first ``capacity``
    symbols or right after them (the reference checks an unknown symbol
    before a full output)."""
    with metrics.span("tt.selfsync.fixpoint"):
        n_segs, seg_bits = plan
        dev = words.device
        max_syms = max_symbols(dt.table, seg_bits)
        if capacity is None:
            syms, counts, exits, bad, _entries, _passes = _fixpoint(
                words, n_segs, seg_bits, start_bit, max_syms, dt)
            with metrics.d2h(24):
                any_bad, last_exit, total = torch.stack([
                    (bad != 0).any().to(torch.int64), exits[-1].to(torch.int64),
                    counts.sum(dtype=torch.int64),
                ]).tolist()
            if any_bad:
                raise UnknownSymbolError()
            return _body(syms, counts), n_segs * seg_bits + last_exit - seg_bits, total, None
        starts = torch.empty((n_segs, max_syms), dtype=torch.int16, device=dev)
        syms, counts, exits, bad, _entries, _passes = _fixpoint(
            words, n_segs, seg_bits, start_bit, max_syms, dt, starts=starts)
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
        with metrics.d2h(48):
            total, any_bad, before_bad, last_exit, s_c, cut_rel = torch.stack([
                cum[-1], is_bad.any().to(torch.int64), before_bad, exits[-1].to(torch.int64),
                s_c, cut_rel.to(torch.int64),
            ]).tolist()
        if any_bad and capacity >= before_bad:
            raise UnknownSymbolError()
        cut = s_c * seg_bits + cut_rel if total > capacity else None
        return (_body(syms, counts)[:capacity], n_segs * seg_bits + last_exit - seg_bits, total,
                cut)


def _segments(words: torch.Tensor, start_bit: int, plan: tuple, dt,
              capacity: int | None = None):
    """The kernel segments' (body, tail_start, total, cut): the stitch, or
    the fixpoint when it leaves a segment unresolved."""
    got = stitch(words, start_bit, plan, dt, capacity)
    if got is None:
        outcomes["fixpoint"] += 1
        got = _fixpoint_body(words, start_bit, plan, dt, capacity)
    return got


def decode_tail(words: torch.Tensor, from_bit: int, total_bits: int, budget: int | None, dt):
    """``stream_decode`` from ``from_bit``: (symbols, end_bit, more), where
    ``more`` means it stopped with the budget spent and a further symbol
    decodable. Raises UnknownSymbolError where the reference would."""
    syms, info = stream_decode.decode_stream(words, from_bit, total_bits, budget, dt)
    with metrics.d2h(24):
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
        body, tail_start, _total, _cut = _segments(words, start_bit, plan, dt)
    tail, end_bit, _more = decode_tail(words, tail_start, total_bits, None, dt)
    return torch.cat([body, tail]), end_bit


def _prefix(start_bit: int, total_bits: int, capacity: int | None,
            table: HuffmanTable) -> tuple[int, bool]:
    """(bits, whole stream?) that a drain of at most ``capacity`` symbols
    decodes: a prefix that holds ``capacity + 1`` codes and a 32-bit
    window, in whole words, or the whole stream."""
    if capacity is None:
        return total_bits, True
    need_bits = start_bit + (capacity + 1) * int(table.max_len) + 64
    view_words = -(-total_bits // 32)
    prefix_words = min(view_words, -(-need_bits // 32))
    full = prefix_words == view_words
    return (total_bits if full else prefix_words * 32), full


def _drain_capped(words: torch.Tensor, start_bit: int, total_bits: int,
                  capacity: int, dt, seg_words: int):
    """At most ``capacity`` symbols of ``words`` from ``start_bit`` (< 32):
    (symbols, end_bit, more), the contract of the JAX package's
    ``selfsync_decode_capped_words``. Only a prefix that holds ``capacity + 1`` codes and a
    32-bit window is decoded, so the cost is O(capacity)."""
    prefix_bits, full = _prefix(start_bit, total_bits, capacity, dt.table)

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
    body, tail_start, total, cut = _segments(words, start_bit, plan, dt, capacity)
    if cut is not None:
        return body, cut, True
    out, end_bit, more = tail(tail_start, capacity - total)
    return torch.cat([body, out]), end_bit, more


def _host_bytes(symbols: torch.Tensor) -> bytes:
    with metrics.d2h(symbols.numel()):
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


# The fused streaming calls' uncapped downloads: RATE_MARGIN times what the
# last call took (the drain: symbols a segment bit, and HINT_SLACK symbols
# more; the encoder, stream.py: bits a symbol), the JAX package's margin
# (tpu_huffman/stream.py:455-457).
RATE_MARGIN = 1.15
HINT_SLACK = 64


def _walk_fused(words: torch.Tensor, start_bit: int, limit_bit: int, capacity: int | None,
                dt):
    """A drain too short for kernel segments: the walk alone, (symbols,
    end_bit, more) from one download. Raises UnknownSymbolError where the
    reference would."""
    syms, info = stream_decode.decode_stream(words, start_bit, limit_bit, capacity, dt)
    with metrics.d2h(8 * info.numel() + syms.numel()):
        (n, end_bit, status), (host,) = download(info, syms)
    if status == stream_decode.STATUS_UNKNOWN_SYMBOL:
        raise UnknownSymbolError()
    return host[:n].tobytes(), end_bit, status == stream_decode.STATUS_OUTPUT_FULL


def _segments_fused(words: torch.Tensor, start_bit: int, limit_bit: int, plan: tuple,
                    capacity: int | None, rate: float | None, dt):
    """Steps 1-6 of the stitch and the sequential tail with no host read,
    then one download: (symbols, end_bit, more, rate), or None when a
    segment is left unresolved after the repair.

    The repair is launched every time, at max(R_MAX, S / 32) lanes with
    its segment ids built on the device (all dead on a clean stream). The
    body is assembled at a size fixed on the host: at most ``capacity``
    symbols, or ``rate`` times the segments' bits. The tail walk
    (:func:`stream_decode.decode_stream_dev`) reads its start bit and
    budget from the device; its output covers the last two segments."""
    n_segs, seg_bits = plan
    dev = words.device
    table = dt.table
    min_len = max(int(table.min_len), 1)
    m = _merge(words, start_bit, plan, dt)
    # 5. the repair
    lanes = max(R_MAX, n_segs >> 5)
    seg_ids, rank = _repair_lanes(m.fail, lanes)
    live = seg_ids >= 0
    ids = seg_ids.clamp(min=0).long()
    starts_r = torch.empty((lanes, m.max_syms), dtype=torch.int16, device=dev)
    syms_r, count_r, exits_r, bad_r = decode_segments(
        words, torch.where(live, m.entries1[ids], 0), seg_bits, m.max_syms, dt,
        starts=starts_r, seg_ids=seg_ids)
    n_fail = m.fail.sum()
    ok = (n_fail <= lanes) & (~live | ((bad_r == 0) & (exits_r == m.exits0[ids]))).all()
    # a repaired segment is its repaired row whole: no head, all tail
    take = m.fail & (rank < lanes)
    lane_of = torch.where(take, rank, 0)
    tail_rows = torch.where(take[:, None], syms_r[lane_of], m.syms0)
    i_eff = torch.where(take, 0, m.i_eff)
    j_s = torch.where(take, 0, m.j_s)
    counts = torch.where(take, count_r.long()[lane_of], m.counts)
    cum = torch.cumsum(counts, 0)
    total = cum[-1]
    # 6. the body, at a size fixed on the host
    most = (n_segs * seg_bits + int(table.max_len)) // min_len + 1
    if capacity is not None:
        n_body = min(capacity, most)
    elif rate is None:
        n_body = most
    else:
        n_body = min(most, int(rate * n_segs * seg_bits) + HINT_SLACK)
    body = _assemble(m.syms_a, tail_rows, i_eff, j_s, counts, n_body)
    cut_bit = torch.zeros_like(total)
    if capacity is not None:
        cut_bit = _cut_bit(cum, capacity, seg_bits, i_eff, j_s, m.starts_a, m.starts0,
                           (take, lane_of, starts_r))
    # 7. the tail, from the last segment's exit with the budget left; it
    # holds at most the last two segments' bits (_plan_segments)
    slots = 2 * seg_bits // min_len + 1
    budget = capacity - total if capacity is not None else torch.full_like(total, slots)
    tail_start = (n_segs - 1) * seg_bits + m.exits0[-1].long()
    args = torch.stack([tail_start, torch.full_like(total, limit_bit), budget])
    tail, info = stream_decode.decode_stream_dev(words, args, slots, dt)
    with metrics.d2h(8 * (4 + info.numel()) + body.numel() + tail.numel()):
        scalars = torch.cat([torch.stack([total, ok.long(), n_fail, cut_bit]), info])
        (total, ok, n_fail, cut_bit, n_tail, end_bit, status), (body_h, tail_h) = download(
            scalars, body, tail)
    if not ok:
        return None
    outcomes["repaired" if n_fail else "stitched"] += 1
    outcomes["segments_repaired"] += n_fail
    if capacity is not None and total > capacity:
        return body_h[:capacity].tobytes(), cut_bit, True, rate
    if status == stream_decode.STATUS_UNKNOWN_SYMBOL:
        raise UnknownSymbolError()
    out = body_h[:total].tobytes()
    if total > n_body:  # the rate hint fell short: the rest of the body
        outcomes["second_downloads"] += 1
        out += _host_bytes(_assemble(m.syms_a, tail_rows, i_eff, j_s, counts, total)[n_body:])
    if capacity is None:
        rate = RATE_MARGIN * total / (n_segs * seg_bits)
    return (out + tail_h[:n_tail].tobytes(), end_bit,
            status == stream_decode.STATUS_OUTPUT_FULL, rate)


def fused_drain_words(buf: torch.Tensor, nbytes: int, consumed_bit: int, table: HuffmanTable,
                      capacity: int | None, rate: float | None = None,
                      seg_words: int | None = None):
    """The streaming decoder's bulk drain as one sequence of launches and
    one download (ports the JAX package's ``fused_drain_words`` and its
    ``_FusedFallback`` rule).

    The same contract as :func:`selfsync_decode_capped_words` (uncapped
    with ``capacity`` None, ``more`` then False), plus ``rate``: the symbols
    a segment bit held in the last uncapped call, with a margin, which
    sizes this call's download (None: the most the bits can hold). Returns
    (symbols, end_bit, more, rate), the rate this call saw or the one it
    was given. A body longer than the download takes a second one
    (``outcomes["second_downloads"]``).

    A segment left unresolved after the repair (a corrupt stream, more
    failures than the repair's lanes), or a capped prefix that ran short
    (which its bound rules out), runs the classic drain on the same buffer
    instead (``outcomes["fallback"]``); it owns the errors of the body. An
    unknown symbol in the tail raises UnknownSymbolError here.
    """
    with metrics.span("tt.selfsync.stitch"):
        if capacity is not None and capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        seg_words = _seg_words(seg_words)
        view, sb, total_bits, base = words_view(buf, nbytes, consumed_bit)
        if total_bits <= sb:
            return b"", consumed_bit, False, rate
        dt = DeviceTable.for_table(table, buf.device)
        prefix_bits, full = _prefix(sb, total_bits, capacity, table)
        plan = _plan_segments(prefix_bits, seg_words)
        got = None
        if plan is None:
            got = (*_walk_fused(view, sb, prefix_bits, capacity, dt), rate)
        elif plan[1] <= MAX_STARTS_SEG_BITS:
            got = _segments_fused(view, sb, prefix_bits, plan, capacity, rate, dt)
        if got is None or (capacity is not None and not got[2] and not full):
            outcomes["fallback"] += 1
            if capacity is None:
                return (*selfsync_decode_words(buf, nbytes, consumed_bit, table, seg_words), False,
                        rate)
            return (*selfsync_decode_capped_words(buf, nbytes, consumed_bit, table, capacity,
                                                  seg_words), rate)
        out, end_bit, more, rate = got
        return out, base + end_bit, more, rate


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

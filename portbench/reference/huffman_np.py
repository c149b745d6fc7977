"""The plain reference: static-Huffman coding with aws-c-compression's rules,
in NumPy. It parses the table file itself and imports nothing of the
program under test.

Encode: each symbol's code, MSB-first, at the running bit offset; the last
byte's free low bits take the low bits of ``eos_padding``. The stream's
bits are the concatenation, whatever chunking the caller asks for.

Decode: from a bit position, the code whose bits begin the stream there
(a table is prefix-free, so at most one does) is emitted if it ends
within the stream; decoding stops at the first position where none does
(trailing padding shorter than the code it would begin). A window that
begins no code raises :class:`UnknownSymbol` when at least the longest
code's length remains.

``decode_lanes`` decodes many independent runs at once, a step of every
lane at a time; ``decode_at`` splits a stream into segments, decodes each
as a lane from its first bit, and joins the lanes where the true path
meets them (Huffman codes re-synchronise).
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

SEGMENT_BITS = 4096
OVERLAP_BITS = 2048  # a lane decodes this far into the next segment, to meet its lane


class UnknownSymbol(ValueError):
    """A window that begins no code, with the longest code's bits left."""


@dataclasses.dataclass(frozen=True)
class Table:
    lengths: np.ndarray  # int64[256], 0 = no code
    patterns: np.ndarray  # uint64[256], right-aligned
    lefts: np.ndarray  # uint64[k]: each code's bits at the top of 32, sorted
    spans: np.ndarray  # uint64[k]: 2^(32 - length)
    symbols: np.ndarray  # uint8[k]
    code_lens: np.ndarray  # int64[k]
    max_len: int
    min_len: int


def parse_tsv(path: str) -> Table:
    """Lines ``symbol<TAB>bits<TAB>pattern_hex``; ``#`` starts a comment."""
    lengths = np.zeros(256, dtype=np.int64)
    patterns = np.zeros(256, dtype=np.uint64)
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            sym, bits, pat = line.split("\t")
            sym, bits, pat = int(sym), int(bits), int(pat, 16)
            if lengths[sym] or not 1 <= bits <= 32 or pat >> bits:
                raise ValueError(f"bad table line {line!r}")
            lengths[sym], patterns[sym] = bits, pat
    return make_table(lengths, patterns)


def make_table(lengths: np.ndarray, patterns: np.ndarray) -> Table:
    lengths = np.asarray(lengths, dtype=np.int64)
    patterns = np.asarray(patterns, dtype=np.uint64)
    syms = np.flatnonzero(lengths)
    lens = lengths[syms]
    lefts = patterns[syms] << (32 - lens).astype(np.uint64)
    order = np.argsort(lefts, kind="stable")
    return Table(lengths, patterns, lefts[order], np.uint64(1) << (32 - lens[order]).astype(
        np.uint64), syms[order].astype(np.uint8), lens[order], int(lens.max()), int(lens.min()))


def code_bits(data: np.ndarray, table: Table) -> np.ndarray:
    """Each symbol's code length (int64); raises UnknownSymbol at a symbol
    without a code."""
    lens = table.lengths[data]
    if data.size and not lens.all():
        i = int(np.argmin(lens))
        raise UnknownSymbol(f"symbol {int(data[i])} at {i} has no code")
    return lens


def pack(data: np.ndarray, table: Table, start_bit: int = 0, eos_padding: int = 0xFF,
         block: int = 1 << 22) -> bytes:
    """The codes of ``data`` from bit ``start_bit`` of the first byte (the
    bits before it zero), padded to a whole byte with the low bits of
    ``eos_padding``."""
    data = np.asarray(data, dtype=np.uint8).reshape(-1)
    lens = code_bits(data, table)
    ends = np.cumsum(lens) + start_bit
    total = int(ends[-1]) if data.size else start_bit
    words = np.zeros(-(-total // 32) + 1, dtype=np.float64)  # disjoint bit fields: sums are ORs
    for a in range(0, data.size, block):
        ln = lens[a:a + block]
        st = ends[a:a + block] - ln
        val = table.patterns[data[a:a + block]] << (64 - (st & 31) - ln).astype(np.uint64)
        w = st >> 5
        lo, span = int(w[0]), int(w[-1] - w[0]) + 2
        words[lo:lo + span] += np.bincount(
            w - lo, weights=(val >> np.uint64(32)).astype(np.float64), minlength=span
        ) + np.bincount(w - lo + 1, weights=(val & np.uint64(0xFFFFFFFF)).astype(np.float64),
                        minlength=span)
    out = bytearray(words.astype(np.uint64).astype(">u4").tobytes()[: -(-total // 8)])
    pad = -total % 8
    if pad:
        out[-1] |= int(eos_padding) & ((1 << pad) - 1)
    return bytes(out)


def as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8).reshape(-1)


def encode(data, table: Table, eos_padding: int = 0xFF) -> bytes:
    return pack(as_u8(data), table, 0, eos_padding)


def block_index(data, table: Table, block_symbols: int) -> dict:
    """The index of ``encode_with_index``: every ``block_symbols``-th
    symbol's start bit, the blocks' symbol counts, the totals and the
    longest code in the data."""
    lens = code_bits(as_u8(data), table)
    n = lens.size
    starts = np.concatenate([[0], np.cumsum(lens)])
    counts = np.full(-(-n // block_symbols), block_symbols, dtype=np.int64)
    counts[-1] = n - (counts.size - 1) * block_symbols
    return {"bit_offsets": starts[:-1:block_symbols], "n_symbols": counts,
            "total_symbols": n, "total_bits": int(starts[-1]),
            "max_code_len": int(lens.max()) if n else 0}


def _padded(stream: bytes) -> np.ndarray:
    """The 8 bytes from each byte of ``stream`` on, as big-endian uint64
    (zeros past its end)."""
    raw = np.frombuffer(bytes(stream) + bytes(8), dtype=np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(raw, 8)[: len(stream) + 1]
    return np.ascontiguousarray(win).view(">u8").reshape(-1).astype(np.uint64)


def _windows(buf: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The 32 bits at each bit position, MSB-first, as uint64."""
    return (buf[pos >> 3] << (pos & 7).astype(np.uint64)) >> np.uint64(32) & np.uint64(0xFFFFFFFF)


def decode_lanes(buf: np.ndarray, total_bits: int, starts: np.ndarray, stops: np.ndarray,
                 counts: np.ndarray | None, table: Table, resync: bool = False):
    """Decode lane i from bit ``starts[i]`` until its next code would start
    at or past ``stops[i]``, after ``counts[i]`` symbols (None: no limit),
    or where no code ends within ``total_bits``. A window that begins no
    code, with the longest code's bits left, stops the lane as bad; with
    ``resync`` it moves the lane on by one bit instead, unrecorded.

    Returns (symbols uint8[L, S], start bits int64[L, S] (-1 past a
    lane's end), symbols a lane decoded, each lane's end bit, whether the
    lane stopped at a window that begins no code)."""
    lanes = starts.size
    pos = np.asarray(starts, dtype=np.int64).copy()
    stops = np.asarray(stops, dtype=np.int64)
    cols = int(counts.max()) if counts is not None and lanes else int(
        ((stops - pos).max() if lanes else 0) // max(table.min_len, 1) + 1)
    syms = np.zeros((lanes, max(cols, 1)), dtype=np.uint8)
    at = np.full((lanes, max(cols, 1)), -1, dtype=np.int64)
    n = np.zeros(lanes, dtype=np.int64)
    bad = np.zeros(lanes, dtype=bool)
    live = np.flatnonzero(pos < stops) if counts is None else np.flatnonzero(counts > 0)
    while live.size:
        p = pos[live]
        w = _windows(buf, p)
        k = np.searchsorted(table.lefts, w, side="right") - 1
        kc = np.maximum(k, 0)
        match = (k >= 0) & (w < table.lefts[kc] + table.spans[kc])
        ln = table.code_lens[kc]
        fits = match & (p + ln <= total_bits)
        skip = ~match & (total_bits - p >= table.max_len)
        if resync:
            pos[live[skip]] += 1
        else:
            bad[live[skip]] = True
        nxt = live[skip] if resync else live[:0]
        live, p, kc, ln = live[fits], p[fits], kc[fits], ln[fits]
        col = n[live]
        syms[live, col] = table.symbols[kc]
        at[live, col] = p
        n[live] += 1
        pos[live] = p + ln
        more = pos[live] < stops[live]
        if counts is not None:
            more &= n[live] < counts[live]
        live = np.concatenate([live[more], nxt[pos[nxt] < stops[nxt]]])
    return syms, at, n, pos, bad


def decode_at(stream: bytes, table: Table, start_bit: int = 0, max_symbols: int | None = None):
    """Decode from ``start_bit`` (to at most ``max_symbols`` symbols).
    Returns (symbols uint8, the end bit of the last, the number of symbols
    the stream holds from ``start_bit``). Raises UnknownSymbol where the
    reference does.

    Lane i starts at segment i's first bit, re-synchronises, and decodes
    ``OVERLAP_BITS`` into the next segment. The true path runs along a lane
    up to the first code start that the next lane also decoded, and goes
    on along that lane; where the two never meet, one lane decodes on from
    the true path's last code."""
    buf = _padded(stream)
    total = 8 * len(stream)
    walk = _Walker(stream, table)
    seg0 = np.arange(start_bit, max(total, start_bit + 1), SEGMENT_BITS, dtype=np.int64)
    stops = np.minimum(seg0 + SEGMENT_BITS + OVERLAP_BITS, total)
    syms, at, n, end, _bad = decode_lanes(buf, total, seg0, stops, None, table, resync=True)
    pieces = []
    cur = _true_lane(walk, syms[0, : n[0]], at[0, : n[0]], int(end[0]), start_bit, int(stops[0]))
    for i in range(1, seg0.size):
        c_syms, c_at, c_end, c_stop = cur
        k0 = int(np.searchsorted(c_at, seg0[i]))
        row = at[i, : n[i]]
        meet = np.flatnonzero(np.isin(c_at[k0:], row))
        if meet.size:
            q = int(c_at[k0 + meet[0]])
            pieces.append(c_syms[: k0 + meet[0]])
            j = int(np.searchsorted(row, q))
            cur = _true_lane(walk, syms[i, j: n[i]], row[j:], int(end[i]), q, int(stops[i]))
        elif c_end < c_stop:
            break  # the stream ended on the current lane
        else:
            pieces.append(c_syms)
            cur = _true_lane(walk, c_syms[:0], c_at[:0], c_end, c_end, int(stops[i]))
    pieces.append(cur[0])
    s = np.concatenate(pieces)
    held = s.size
    if max_symbols is not None:
        s = s[:max_symbols]
    return s, start_bit + int(table.lengths[s].sum()), held


def _joined(at: np.ndarray, syms: np.ndarray, end: int, table: Table) -> bool:
    """Whether each code starts where the one before it ends (a lane that
    skipped a bit left the path there)."""
    return bool((at + table.lengths[syms] == np.append(at[1:], end)).all())


def _true_lane(walk: "_Walker", syms, at, end: int, entry: int, stop: int):
    """(symbols, start bits, end bit, stop) of the true path from ``entry``
    (a code start) up to ``stop``, from a lane's decode that starts there;
    where the lane left the path (it skipped a bit), walked again from
    ``entry``. Raises UnknownSymbol where the path meets a window that
    begins no code."""
    if not (at.size and at[0] == entry and _joined(at, syms, end, walk.table)):
        syms, at, end = walk(entry, stop)
    return syms, at, end, stop


class _Walker:
    """One path decoded a code at a time in plain Python, which beats a
    NumPy step on a single lane."""

    def __init__(self, stream: bytes, table: Table):
        self.stream = bytes(stream) + bytes(8)
        self.total = 8 * len(stream)
        self.table = table
        self.lefts = [int(x) for x in table.lefts]
        self.ends = [int(x + y) for x, y in zip(table.lefts, table.spans)]
        self.syms = table.symbols.tolist()
        self.lens = table.code_lens.tolist()

    def __call__(self, pos: int, stop: int):
        out, at, data, total, mx = [], [], self.stream, self.total, self.table.max_len
        while pos < stop:
            b = pos >> 3
            w = (int.from_bytes(data[b:b + 5], "big") >> (8 - (pos & 7))) & 0xFFFFFFFF
            k = bisect.bisect_right(self.lefts, w) - 1
            if k < 0 or w >= self.ends[k]:
                if total - pos >= mx:
                    raise UnknownSymbol(f"no code at bit {pos}")
                break
            if pos + self.lens[k] > total:
                break
            out.append(self.syms[k])
            at.append(pos)
            pos += self.lens[k]
        return np.array(out, dtype=np.uint8), np.array(at, dtype=np.int64), pos


def decode(stream: bytes, table: Table) -> bytes:
    """One-shot decode of a whole stream."""
    return decode_at(stream, table)[0].tobytes()


def decode_indexed(stream: bytes, index: dict, table: Table) -> bytes:
    """Decode every block of the index from its start bit, all at once."""
    offs = np.asarray(index["bit_offsets"], dtype=np.int64)
    counts = np.asarray(index["n_symbols"], dtype=np.int64)
    syms, _at, n, _end, bad = decode_lanes(_padded(stream), 8 * len(stream), offs,
                                           np.full(offs.size, 8 * len(stream)), counts, table)
    if (n < counts).any() or bad.any():
        raise UnknownSymbol("a block ends early")
    return syms[np.arange(syms.shape[1]) < counts[:, None]].tobytes()


def decode_sequential(stream: bytes, table: Table, start_bit: int = 0) -> tuple[bytes, int]:
    """The same decode one symbol at a time, in Python, for small inputs:
    the tests' check of :func:`decode_at`. Returns (symbols, end bit)."""
    codes = {(int(table.lengths[s]), int(table.patterns[s])): s
             for s in range(256) if table.lengths[s]}
    value = int.from_bytes(bytes(stream), "big")
    total, pos, out = 8 * len(stream), start_bit, bytearray()
    while True:
        for ln in range(1, min(table.max_len, total - pos) + 1):
            s = codes.get((ln, (value >> (total - pos - ln)) & ((1 << ln) - 1)))
            if s is not None:
                out.append(s)
                pos += ln
                break
        else:
            if total - pos >= table.max_len:
                raise UnknownSymbol(f"no code at bit {pos}")
            return bytes(out), pos


def padding_is_all_ones(stream: bytes, end_bit: int) -> bool:
    """HPACK's check of the bits after the last decoded code: fewer than 8,
    and all ones."""
    left = 8 * len(stream) - end_bit
    value = int.from_bytes(bytes(stream), "big") & ((1 << left) - 1)
    return left < 8 and value == (1 << left) - 1

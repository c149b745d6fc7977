"""Streaming codec: the chunked, resumable protocol (ports
``tpu_huffman/stream.py``).

:class:`HuffmanEncoder` and :class:`HuffmanDecoder` are the reference's
persistent ``aws_huffman_encoder``/``aws_huffman_decoder`` with its
SHORT_BUFFER resume protocol (reference huffman.h:63-84, README.md:110-174).
A call that runs out of output room returns ``done=False`` with the partial
output, and the next call goes on where it stopped. The state between calls
is plain data: ``state()`` gives the JAX package's dicts with the same keys
and meaning, so a stream saved by one package continues in the other.

Encoder (ports the JAX package's fused ``_encode_chunk_bulk``). One
``encode_chunk`` call is one sequence of launches on the device and one
download: it stages at most ``8 * capacity // min_len + 2`` symbols (no
more can fit), runs the count kernel, takes the tiles' int64 prefix with
``torch.cumsum``, finds the capacity cut (the tile holding it from the
prefix, the symbol from an exact cumsum over that tile's <= 4096 codes),
packs every staged symbol behind the carry with the pack's device-total
form (``ops/pack_encode.py``: the tile offsets move by the carry's length,
the total is read from device memory, and the carry is OR-ed into word
0), and downloads the scalars with the words. A capped call downloads
``capacity // 4 + 2`` words, whose first ``capacity`` bytes are the
carry and the codes the reference writes; an uncapped one as many as the
table's rate hint says, and a second download fetches the rest when the
hint falls short (``encode_outcomes``). A code that straddles the cut
leaves its low bits as the next carry (the reference's ``overflow_bits``,
huffman.c:88-99). Bit offsets are int64, so one call takes any input:
nothing segments past 2^31 bits.

Unknown symbols follow the reference (huffman.c:148-164, the C++ oracle's
``Encoder::encode``): the carry goes out first, and the output-full check
comes before each symbol. So a capped call raises
``UnknownSymbolError(index, symbol)`` if and only if the first unknown
symbol starts before the cut (its start bit counts the carry and the codes
before it; the count of staged symbols that start before the cut comes
from the cut's tile on the device, with the other scalars). Otherwise the
call returns as if the input ended at that symbol, with ``done=False``.
An uncapped call raises at the first unknown symbol. The JAX package
raises for any unknown symbol that a capped call stages; the port does
not copy that.

Decoder. The retained stream lives on the device as words
(:class:`_DeviceRemainder`): a call uploads only its new bytes and
downloads only the symbols it emits. Up to ``BULK_DECODE_THRESHOLD``
unconsumed bytes go through one block's walk (``stream_decode``); more
take ``selfsync.fused_drain_words`` (ports the JAX package's
``_drain_fused``): the compaction slide, decided on the host before the
call, the append, the self-sync decode with its repair and the tail walk
as one sequence of launches with one download, O(capacity) when capped.
A segment left unresolved falls back to the classic drains of
``ops/selfsync.py`` over the same buffer.

Not ported: the JAX package's auto-segmenting of one-shot encodes at 2^31
bits (the port has no int32 bit offsets to protect).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import metrics
from .errors import ShortBufferError, UnknownSymbolError
from .ops import pack_encode, selfsync
from .ops.bitpack import (MASK32, download, merge_words, slide_words, stage_words,
                          words_to_bytes)
from .ops.encode import DEFAULT_EOS_PADDING, DeviceTable, resolve_device, stage_bytes
from .tables import HuffmanTable

# Retained streams of more unconsumed bytes than this take the self-sync
# drains; smaller ones stream_decode's walk (as in the JAX package).
BULK_DECODE_THRESHOLD = 65536

_TILE = pack_encode.TILE  # symbols per count tile
# fused encode_chunk calls whose words outgrew the first download
encode_outcomes = metrics.register("stream.encode_outcomes", {"second_downloads": 0})


@dataclasses.dataclass
class EncodeResult:
    data: bytes  # bytes produced by this call (always complete bytes)
    consumed: int  # input symbols consumed (reference: cursor advance)
    done: bool  # False == reference AWS_ERROR_SHORT_BUFFER


@dataclasses.dataclass
class DecodeResult:
    data: bytes  # symbols produced by this call
    done: bool  # False == reference AWS_ERROR_SHORT_BUFFER


def _as_u8(data) -> np.ndarray:
    """The input as a 1-D uint8 array, without copying bytes-like inputs."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8).reshape(-1)


def _i32(value: int) -> int:
    """An unsigned 32-bit value as the int32 with the same bits."""
    return value - (1 << 32) if value >= 1 << 31 else value


class HuffmanEncoder:
    """Persistent streaming encoder (reference: aws_huffman_encoder).

    State between calls is the carry: the low bits of a code that crossed
    the last capacity boundary (== reference overflow_bits, huffman.h:69).
    Every call that finishes the stream pads the final partial byte with
    the low bits of ``eos_padding`` (reference huffman.c:178-184), so, as
    in the reference, chunking the *input* across successful calls pads
    each chunk, while chunking the *output* through ``done=False`` resumes
    gives one continuous bit stream.
    """

    def __init__(self, table: HuffmanTable, eos_padding: int = DEFAULT_EOS_PADDING,
                 device="cuda"):
        self.table = table
        self.eos_padding = eos_padding
        self.device = resolve_device(device)
        self._carry_pattern = 0
        self._carry_len = 0

    def reset(self) -> None:
        """Clear the resume state (reference: aws_huffman_encoder_reset)."""
        self._carry_pattern = 0
        self._carry_len = 0

    @property
    def overflow_bits(self) -> tuple[int, int]:
        """(pattern, num_bits) carry, bit-identical to the reference field."""
        return self._carry_pattern, self._carry_len

    def state(self) -> dict:
        """Serialisable checkpoint of the stream state."""
        return {"carry_pattern": self._carry_pattern, "carry_len": self._carry_len}

    def load_state(self, state: dict) -> None:
        self._carry_pattern = int(state["carry_pattern"])
        self._carry_len = int(state["carry_len"])

    def encoded_length(self, data) -> int:
        """Dry-run byte length (reference: aws_huffman_get_encoded_length).
        Ignores the carry, as the reference does."""
        bits = int(self.table.lengths[_as_u8(data)].astype(np.int64).sum())
        return (bits + 7) // 8

    def encode(self, data) -> bytes:
        """One-shot convenience; includes any pending carry."""
        return self.encode_chunk(data, None).data

    def encode_chunk(self, data, capacity: int | None = None) -> EncodeResult:
        """Encode into at most ``capacity`` output bytes; resume-safe.

        ``capacity=None`` means unbounded (always completes). Raises
        UnknownSymbolError(index, symbol) at the first symbol without a
        code, before any output and with the carry kept (the reference
        writes the bytes before it first, huffman.c:62-64); when capped,
        only if that symbol starts before the cut (carry and codes before
        it < 8 * capacity bits), as the reference's output-full check
        comes before each symbol (huffman.c:162-164). Otherwise the call
        returns the bytes before the cut, ``done=False`` and the carry,
        consuming no symbol from the unknown one on.

        One sequence of launches and one download (see the module's
        docstring); a call whose budget the carry alone spends, or with no
        symbols, runs on the host.
        """
        metrics.calls["stream.encode_chunk"] += 1
        with metrics.span("tt.stream.encode_chunk"):
            symbols, writable = self._staged(data, capacity)
            if symbols.size and (writable is None or writable > self._carry_len):
                return self._encode_fused(symbols, writable)
            return self._encode_host(symbols, writable)

    def _staged(self, data, capacity: int | None) -> tuple[np.ndarray, int | None]:
        """The input's symbols, cut to those that can fit ``capacity``, and
        the writable bits (None: unbounded)."""
        symbols = _as_u8(data)
        if capacity is None:
            return symbols, None
        capacity = int(capacity)
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        writable = 8 * capacity
        # no more than this many codes can fit: stage O(capacity) bytes,
        # not the rest of the caller's input
        return symbols[: writable // max(int(self.table.min_len), 1) + 2], writable

    def _encode_host(self, symbols: np.ndarray, writable: int | None) -> EncodeResult:
        """The calls that write no code: no symbols, or a budget that the
        carry alone spends. They never raise: with symbols, the first
        unknown one starts at or past the cut."""
        n = symbols.size
        carry_pat, carry_len = self._carry_pattern, self._carry_len
        if n == 0 and carry_len == 0:
            return EncodeResult(b"", 0, True)
        if n == 0 and (writable is None or carry_len <= writable):
            # the carry alone, padded
            nbytes = -(-carry_len // 8)
            pad_len = 8 * nbytes - carry_len
            value = (carry_pat << pad_len) | (self.eos_padding & ((1 << pad_len) - 1))
            self.reset()
            return EncodeResult(value.to_bytes(nbytes, "big"), 0, True)
        if writable == 0:
            return EncodeResult(b"", 0, False)
        # The pending carry fills the budget alone: emit its top bits and
        # carry the rest, consuming no input (reference: the overflow flush
        # of huffman.c:148-159 meets the short-buffer path of
        # huffman.c:88-99).
        over = carry_len - writable
        self._carry_pattern = carry_pat & ((1 << over) - 1)
        self._carry_len = over
        return EncodeResult((carry_pat >> over).to_bytes(writable // 8, "big"), 0, False)

    def _count(self, symbols: np.ndarray, writable: int | None):
        """Stage the symbols and count their tiles; with ``writable``, find
        the capacity cut. Returns (symbols on the device, the table on the
        device, the tiles' bits, their int64 inclusive prefix, scalars):
        scalars is [first unknown symbol (n if none), total bits] and, when
        capped, [symbols that start before the cut] and the cut's
        [consumed, bits of the consumed codes, straddle, over, carry
        pattern] in the frame without the carry, all one-element int64
        tensors on the device: nothing here waits for it."""
        n = symbols.size
        dev = self.device
        dt = DeviceTable.for_table(self.table, dev)
        sym = stage_bytes(symbols, dev)
        tile_bits, stats = pack_encode.count(sym, dt)
        incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
        first_bad = stats[:1]
        scalars = [first_bad, incl[-1:]]
        if writable is not None:
            wbp = writable - self._carry_len  # the cut in the frame without the carry
            # the first tile that ends at or past the cut, and its codes' ends (one-element
            # index tensors: indexing by a 0-d tensor reads it on the host)
            j = (incl < wbp).sum().clamp(max=incl.numel() - 1).reshape(1)
            base = j * _TILE
            idx = base + torch.arange(_TILE, device=dev)
            valid = idx < n
            sym_j = sym[idx.clamp(max=n - 1)].to(torch.int64)
            lens_j = torch.where(valid, dt.lengths[sym_j].to(torch.int64), 0)
            start_j = incl[j] - tile_bits[j]
            ends = start_j + torch.cumsum(lens_j, 0)
            # every symbol of the tiles before j starts before the cut (they end before
            # it), and none after j: an unknown symbol among these raises
            before_cut = base + ((ends - lens_j < wbp) & valid).sum()
            k_w = ((ends <= wbp) & valid).sum().reshape(1)  # codes of tile j that fit whole
            kc = k_w.clamp(max=_TILE - 1)
            start_k = torch.where(k_w > 0, ends[(k_w - 1).clamp(min=0)], start_j)
            consumed = base + k_w
            straddle = (consumed < n) & (start_k < wbp)
            over = torch.where(straddle, ends[kc] - wbp, 0)
            pattern = (dt.patterns[sym_j[kc]].to(torch.int64) & MASK32) & (
                (torch.ones_like(over) << over) - 1)
            # an unknown symbol has no bits, so one at the cut ends there and counts as
            # a code that fits; the reference stops before it (then start_k is the
            # cut and nothing straddles)
            consumed = torch.minimum(consumed, first_bad)
            scalars += [before_cut, consumed + straddle.to(torch.int64),
                        torch.where(straddle, ends[kc], start_k), straddle.to(torch.int64),
                        over, pattern]
        return sym, dt, tile_bits, incl, scalars

    def _check_known(self, symbols: np.ndarray, vals: list, writable: int | None) -> bool:
        """Raise UnknownSymbolError(index, symbol) where the reference does:
        at the first unknown symbol of an uncapped call, and of a capped one
        only if the symbol starts before the cut (huffman.c:148-164: the
        carry goes out first, and the output-full check comes before each
        symbol). Returns whether every staged symbol has a code."""
        first_bad, n = vals[0], symbols.size
        if first_bad < (n if writable is None else vals[2]):
            raise UnknownSymbolError(index=first_bad, symbol=int(symbols[first_bad]))
        return first_bad == n

    def _encode_fused(self, symbols: np.ndarray, writable: int | None) -> EncodeResult:
        """Count, prefix, cut, the device-total pack of every staged symbol
        behind the carry, then one download of the scalars and the words'
        bytes: ``capacity // 4 + 2`` words when capped, else as many as the
        table's rate hint says (a second download fetches the rest)."""
        n = symbols.size
        carry_pat, carry_len = self._carry_pattern, self._carry_len
        with metrics.span("tt.encode.count"):
            sym, dt, tile_bits, incl, scalars = self._count(symbols, writable)
        # the device-total pack's buffer: n codes of the longest length, the
        # carry and the pad (the download below is what the host fixes)
        n_words = -(-(n * int(self.table.max_len) + carry_len + 7) // 32)
        with metrics.span("tt.encode.pack"):
            words, _, _ = pack_encode.pack_device_total(
                sym, dt, incl - tile_bits + carry_len, incl[-1:] + carry_len,
                self.eos_padding & 0xFF, n_words)
            if carry_len:
                words[:1] |= _i32((carry_pat << (32 - carry_len)) & MASK32)
        if writable is not None:
            k = writable // 32 + 2
        elif dt.encode_rate is None:
            k = n_words
        else:
            k = (int(dt.encode_rate * n) + carry_len + 7) // 32 + 2
        k = min(k, n_words)
        with metrics.d2h(8 * len(scalars) + 4 * k):
            vals, (head,) = download(torch.cat(scalars), words_to_bytes(words[:k]))
        known = self._check_known(symbols, vals, writable)
        total = vals[1]
        total_bits = total + carry_len
        if known and (writable is None or total_bits <= writable):
            nbytes = -(-total_bits // 8)
            out = head[:nbytes].tobytes()
            if nbytes > head.size:  # the rate hint fell short: the rest of the words
                encode_outcomes["second_downloads"] += 1
                with metrics.d2h(nbytes - head.size):
                    out += words_to_bytes(words[k:-(-nbytes // 4)])[: nbytes - head.size].cpu(
                    ).numpy().tobytes()
            if writable is None:
                dt.encode_rate = selfsync.RATE_MARGIN * total / n
            self.reset()
            return EncodeResult(out, n, True)
        consumed, _cut_bits, straddle, over, pattern = vals[3:]
        self._carry_pattern, self._carry_len = (pattern, over) if straddle else (0, 0)
        return EncodeResult(head[: writable // 8].tobytes(), consumed, False)

    def _encode_chunk_classic(self, data, capacity: int | None = None) -> EncodeResult:
        """:meth:`encode_chunk` as two downloads: the scalars, then the
        consumed symbols packed with their length by value. The form the
        fused call replaced, with the same results; the tests and
        chip_smoke.py hold the fused call against it."""
        symbols, writable = self._staged(data, capacity)
        n = symbols.size
        if not n or (writable is not None and writable <= self._carry_len):
            return self._encode_host(symbols, writable)
        with metrics.span("tt.encode.count"):
            sym, _dt, tile_bits, incl, scalars = self._count(symbols, writable)
        with metrics.d2h(8 * len(scalars)):
            vals = torch.cat(scalars).tolist()
        known = self._check_known(symbols, vals, writable)
        offs, total_bits = incl - tile_bits, vals[1] + self._carry_len
        if known and (writable is None or total_bits <= writable):
            out = self._pack(sym, offs, n, total_bits, self.eos_padding)
            self.reset()
            return EncodeResult(out, n, True)
        consumed, cut_bits, straddle, over, pattern = vals[3:]
        out = self._pack(sym, offs, consumed, cut_bits + self._carry_len, 0)[: writable // 8]
        self._carry_pattern, self._carry_len = (pattern, over) if straddle else (0, 0)
        return EncodeResult(out, consumed, False)

    def _pack(self, sym, offs, n: int, total_bits: int, eos_padding: int) -> bytes:
        """The carry, then the first ``n`` staged symbols (``sym``, with
        their tiles' offsets ``offs``), padded with the low bits of
        ``eos_padding`` to a whole byte; ``total_bits`` counts the carry."""
        carry_pat, carry_len = self._carry_pattern, self._carry_len
        sym, offs = sym[:n], offs[: pack_encode.n_tiles(n)] + carry_len
        dt = DeviceTable.for_table(self.table, self.device)
        with metrics.span("tt.encode.pack"):
            pad_len = pack_encode.pad_code(total_bits, eos_padding)[1]
            words, _ = pack_encode.pack(sym, dt, offs, total_bits, eos_padding & 0xFF,
                                        -(-(total_bits + pad_len) // 32))
            if carry_len:
                words[:1] |= _i32((carry_pat << (32 - carry_len)) & MASK32)
        with metrics.d2h(-(-total_bits // 8)):
            return words_to_bytes(words)[: -(-total_bits // 8)].cpu().numpy().tobytes()


class _DeviceRemainder:
    """The decoder's retained stream, as words on the device (ports
    ``stream._DeviceRemainder``).

    The reference decoder's window (working_bits/num_bits, huffman.h:82-83)
    becomes (word buffer, ``consumed_bit``): the buffer holds the stream
    since the last compaction, zeros after its ``nbytes`` bytes, and the
    cursor marks the resume point. A feed uploads only the new bytes; the
    retained stream is never uploaded again.
    """

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.clear()

    def clear(self) -> None:
        self.buf = None  # int32 words; bits past nbytes * 8 are zero
        self.nbytes = 0
        self.consumed_bit = 0

    def _ensure_capacity(self, need_words: int) -> None:
        # 2x headroom, as the JAX package sizes it: few regrowths
        cap = max(2 << max(need_words - 1, 1).bit_length(), 1 << 12)
        if self.buf is None:
            self.buf = torch.zeros(cap, dtype=torch.int32, device=self.dev)
        elif self.buf.numel() < need_words:
            grown = torch.zeros(cap, dtype=torch.int32, device=self.dev)
            grown[: self.buf.numel()] = self.buf
            self.buf = grown

    def append(self, new: np.ndarray) -> None:
        if new.size == 0:
            if self.buf is None:
                self._ensure_capacity(1)
            return
        nb = self.nbytes
        with metrics.span("tt.stage.upload"):
            up = stage_words(stage_bytes(new, self.dev))
            self._ensure_capacity(nb // 4 + up.numel() + 1)  # +1: the shift's spill word
            merge_words(self.buf, up, nb // 4, 8 * (nb % 4))
        self.nbytes = nb + new.size

    def truncate(self, nbytes: int) -> None:
        """Drop the bytes past ``nbytes`` (the undo of an append)."""
        if nbytes >= self.nbytes:
            return
        w, keep = divmod(nbytes, 4)
        if keep:
            self.buf[w : w + 1] &= _i32((MASK32 << (32 - 8 * keep)) & MASK32)
            w += 1
        self.buf[w : -(-self.nbytes // 4)] = 0
        self.nbytes = nbytes

    def compact(self) -> None:
        """Slide the consumed whole words off the front once they are at
        least 1024 and a quarter of the buffer (the JAX package's rule)."""
        cw = self.consumed_bit >> 5
        if self.buf is None or cw < 1024 or cw < self.buf.numel() // 4:
            return
        self.buf = slide_words(self.buf, cw)
        self.consumed_bit -= 32 * cw
        self.nbytes -= 4 * cw

    def to_host(self) -> tuple[np.ndarray, int]:
        """The unconsumed remainder as (bytes, start bit < 8): one download
        from its first unconsumed word."""
        if self.buf is None or self.nbytes == 0:
            return np.zeros(0, np.uint8), self.consumed_bit & 7
        start_byte = self.consumed_bit >> 3
        w = start_byte // 4
        with metrics.d2h(self.nbytes - start_byte):
            raw = words_to_bytes(self.buf[w : -(-self.nbytes // 4)])
            data = raw[start_byte - 4 * w : self.nbytes - 4 * w].cpu().numpy().copy()
        return data, self.consumed_bit & 7


class HuffmanDecoder:
    """Persistent streaming decoder (reference: aws_huffman_decoder).

    ``allow_growth=True`` makes plain :meth:`decode` ignore capacity and
    always finish (reference: aws_huffman_decoder_allow_growth,
    source/huffman.c:44-46). A call that raises leaves the decoder as it
    was before the call.
    """

    def __init__(self, table: HuffmanTable, allow_growth: bool = False, device="cuda"):
        self.table = table
        self.allow_growth = allow_growth
        self.device = resolve_device(device)
        self._rem = _DeviceRemainder(self.device)
        self._rate = None  # the bulk drain's rate hint (selfsync.fused_drain_words)

    def reset(self) -> None:
        """Reference: aws_huffman_decoder_reset (source/huffman.c:38-42)."""
        self._rem.clear()

    def state(self) -> dict:
        rem, start_bit = self._rem.to_host()
        return {"rem": rem.tobytes(), "rem_start_bit": start_bit}

    def load_state(self, state: dict) -> None:
        self._rem.clear()
        self._rem.append(np.frombuffer(state["rem"], dtype=np.uint8))
        self._rem.consumed_bit = int(state["rem_start_bit"])

    @property
    def leftover_bits(self) -> tuple[int, int]:
        """(value, num_bits) of the unconsumed tail bits, MSB-first: the
        reference leaves trailing padding in working_bits for the caller to
        inspect (reference README.md:176-183)."""
        rem, start_bit = self._rem.to_host()
        total = rem.size * 8 - start_bit
        value = int.from_bytes(rem.tobytes(), "big")
        value &= (1 << total) - 1 if total else 0
        return value, total

    def padding_is_all_ones(self) -> bool:
        """HPACK's check of the trailing padding (RFC 7541 §5.2), the
        caller's job in the reference (README.md:176-183): True iff fewer
        than 8 bits are left and all are 1 (also for no bits)."""
        value, total = self.leftover_bits
        return total < 8 and value == (1 << total) - 1

    def decode_chunk(self, data, capacity: int | None = None) -> DecodeResult:
        """Decode; stops after ``capacity`` symbols (done=False) or when the
        input is exhausted (done=True). Takes all of ``data`` into the
        retained stream either way."""
        metrics.calls["stream.decode_chunk"] += 1
        with metrics.span("tt.stream.decode_chunk"):
            if capacity is not None and int(capacity) < 0:
                raise ValueError(f"capacity must be >= 0, got {capacity}")
            rem = self._rem
            rem.compact()  # decided on the host, before the append (as the JAX package's)
            old_nbytes = rem.nbytes
            rem.append(_as_u8(data))
            try:
                out, end_bit, more = self._drain(None if capacity is None else int(capacity))
            except UnknownSymbolError:
                rem.truncate(old_nbytes)
                raise
            rem.consumed_bit = end_bit
            return DecodeResult(out, not more)

    def _drain(self, capacity: int | None) -> tuple[bytes, int, bool]:
        rem = self._rem
        if 8 * rem.nbytes <= rem.consumed_bit:
            return b"", rem.consumed_bit, False
        if (rem.nbytes - (rem.consumed_bit >> 3) > BULK_DECODE_THRESHOLD
                and selfsync.supports(self.table)):
            out, end_bit, more, self._rate = selfsync.fused_drain_words(
                rem.buf, rem.nbytes, rem.consumed_bit, self.table, capacity, self._rate)
            return out, end_bit, more
        with metrics.span("tt.walk"):
            view, start_bit, total_bits, base = selfsync.words_view(rem.buf, rem.nbytes,
                                                                    rem.consumed_bit)
            syms, end_bit, more = selfsync.decode_tail(
                view, start_bit, total_bits, capacity,
                DeviceTable.for_table(self.table, self.device))
        with metrics.d2h(syms.numel()):
            out = syms.cpu().numpy().tobytes()
        return out, base + end_bit, more

    def decode(self, data, capacity: int | None = None) -> bytes:
        """Reference-shaped decode: raises ShortBufferError(partial) when
        capacity stops the decode and growth is off (reference
        huffman.c:257-266)."""
        if capacity is None or self.allow_growth:
            return self.decode_chunk(data, None).data
        res = self.decode_chunk(data, capacity)
        if not res.done:
            # the state has advanced: the caller calls again with b""
            raise ShortBufferError(res.data)
        return res.data

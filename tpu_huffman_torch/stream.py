"""Streaming codec: the chunked, resumable protocol (ports
``tpu_huffman/stream.py``).

:class:`HuffmanEncoder` and :class:`HuffmanDecoder` are the reference's
persistent ``aws_huffman_encoder``/``aws_huffman_decoder`` with its
SHORT_BUFFER resume protocol (reference huffman.h:63-84, README.md:110-174).
A call that runs out of output room returns ``done=False`` with the partial
output, and the next call goes on where it stopped. The state between calls
is plain data: ``state()`` gives the JAX package's dicts with the same keys
and meaning, so a stream saved by one package continues in the other.

Encoder. One ``encode_chunk`` call stages at most ``8 * capacity // min_len
+ 2`` symbols on the device (no more can fit), runs the count kernel, takes
the tiles' int64 prefix with ``torch.cumsum``, finds the capacity cut (the
tile holding it from the prefix, the symbol from an exact cumsum over that
tile's <= 4096 codes), reads the scalars back in one transfer and packs the
consumed symbols behind the carry (``ops/pack_encode.py``): the tile
offsets move by the carry's length and the carry is OR-ed into word 0. A
code that straddles the cut leaves its low bits as the next carry (the
reference's ``overflow_bits``, huffman.c:88-99). Bit offsets are int64, so
one call takes any input: nothing segments past 2^31 bits.

Decoder. The retained stream lives on the device as words
(:class:`_DeviceRemainder`): a call uploads only its new bytes and
downloads only the symbols it emits. Up to ``BULK_DECODE_THRESHOLD``
unconsumed bytes go through one block's walk (``stream_decode``);
more take the self-sync drains of ``ops/selfsync.py``, uncapped or capped,
whose cost is O(capacity) when capped.

Not ported: the JAX package's fused one-dispatch drain (``_drain_fused``,
``fused_drain_words``, ``_FusedFallback``), which fuses four dispatches
into one against a TPU dispatch floor and gives the same results, and its
auto-segmenting of one-shot encodes at 2^31 bits (the port has no int32
bit offsets to protect).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .errors import ShortBufferError, UnknownSymbolError
from .ops import pack_encode, selfsync
from .ops.bitpack import MASK32, merge_words, slide_words, stage_words, words_to_bytes
from .ops.encode import DEFAULT_EOS_PADDING, DeviceTable, resolve_device, stage_bytes
from .tables import HuffmanTable

# Retained streams of more unconsumed bytes than this take the self-sync
# drains; smaller ones stream_decode's walk (as in the JAX package).
BULK_DECODE_THRESHOLD = 65536

_TILE = pack_encode.TILE  # symbols per count tile


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
        code, before any output (the reference writes the bytes before it
        first, huffman.c:62-64).
        """
        symbols = _as_u8(data)
        writable = None
        if capacity is not None:
            capacity = int(capacity)
            if capacity < 0:
                raise ValueError(f"capacity must be >= 0, got {capacity}")
            writable = 8 * capacity
            # no more than this many codes can fit: stage O(capacity) bytes,
            # not the rest of the caller's input
            symbols = symbols[: writable // max(int(self.table.min_len), 1) + 2]
        n = symbols.size
        carry_pat, carry_len = self._carry_pattern, self._carry_len
        sym = offs = cut = None
        packed_bits = 0
        if n:
            sym, offs, packed_bits, cut = self._stage_and_cut(symbols, writable)
        total_bits = packed_bits + carry_len
        if total_bits == 0:
            return EncodeResult(b"", 0, True)
        if writable is None or total_bits <= writable:
            out = self._pack(sym, offs, n, total_bits, self.eos_padding)
            self.reset()
            return EncodeResult(out, n, True)
        if writable == 0:
            return EncodeResult(b"", 0, False)
        if carry_len >= writable:
            # The pending carry fills the budget alone: emit its top bits and
            # carry the rest, consuming no input (reference: the overflow
            # flush of huffman.c:148-159 meets the short-buffer path of
            # huffman.c:88-99).
            over = carry_len - writable
            self._carry_pattern = carry_pat & ((1 << over) - 1)
            self._carry_len = over
            return EncodeResult((carry_pat >> over).to_bytes(capacity, "big"), 0, False)
        consumed, cut_bits, straddle, over, pattern = cut
        out = self._pack(sym, offs, consumed, cut_bits + carry_len, 0)[:capacity]
        self._carry_pattern, self._carry_len = (pattern, over) if straddle else (0, 0)
        return EncodeResult(out, consumed, False)

    def _stage_and_cut(self, symbols: np.ndarray, writable: int | None):
        """Stage the symbols, count their tiles, and find the capacity cut.

        Returns (symbols on the device, tile offsets int64, total bits,
        cut) with cut = (consumed, bits of the consumed codes, straddle,
        over, carry pattern) in the frame without the carry, or None when
        uncapped. One host transfer brings back every scalar.
        """
        n = symbols.size
        dev = self.device
        dt = DeviceTable.for_table(self.table, dev)
        sym = stage_bytes(symbols, dev)
        tile_bits, stats = pack_encode.count(sym, dt)
        incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
        scalars = [stats[0], incl[-1]]
        if writable is not None:
            wbp = writable - self._carry_len  # the cut in the frame without the carry
            # the first tile that ends past the cut, and its codes' ends
            j = (incl <= wbp).sum().clamp(max=incl.numel() - 1)
            idx = j * _TILE + torch.arange(_TILE, device=dev)
            valid = idx < n
            sym_j = sym[idx.clamp(max=n - 1)].to(torch.int64)
            lens_j = torch.where(valid, dt.lengths[sym_j].to(torch.int64), 0)
            ends = incl[j] - tile_bits[j] + torch.cumsum(lens_j, 0)
            k_w = ((ends <= wbp) & valid).sum()  # codes of tile j that fit whole
            kc = k_w.clamp(max=_TILE - 1)
            start_k = torch.where(k_w > 0, ends[(k_w - 1).clamp(min=0)], incl[j] - tile_bits[j])
            consumed = j * _TILE + k_w
            straddle = (consumed < n) & (start_k < wbp)
            over = torch.where(straddle, ends[kc] - wbp, 0)
            pattern = (dt.patterns[sym_j[kc]].to(torch.int64) & MASK32) & (
                (torch.ones_like(over) << over) - 1)
            scalars += [consumed + straddle.to(torch.int64),
                        torch.where(straddle, ends[kc], start_k), straddle.to(torch.int64),
                        over, pattern]
        vals = torch.stack(scalars).tolist()
        first_bad, total = vals[0], vals[1]
        if first_bad < n:
            raise UnknownSymbolError(index=first_bad, symbol=int(symbols[first_bad]))
        cut = None if writable is None else (vals[2], vals[3], bool(vals[4]), vals[5], vals[6])
        return sym, incl - tile_bits, total, cut

    def _pack(self, sym, offs, n: int, total_bits: int, eos_padding: int) -> bytes:
        """The carry, then the first ``n`` staged symbols (``sym``, with
        their tiles' offsets ``offs``), padded with the low bits of
        ``eos_padding`` to a whole byte; ``total_bits`` counts the carry."""
        carry_pat, carry_len = self._carry_pattern, self._carry_len
        if n == 0:  # the carry alone
            nbytes = -(-carry_len // 8)
            pad_len = 8 * nbytes - carry_len
            value = (carry_pat << pad_len) | (eos_padding & ((1 << pad_len) - 1))
            return value.to_bytes(nbytes, "big")
        sym, offs = sym[:n], offs[: pack_encode.n_tiles(n)] + carry_len
        dt = DeviceTable.for_table(self.table, self.device)
        pad_len = pack_encode.pad_code(total_bits, eos_padding)[1]
        words, _ = pack_encode.pack(sym, dt, offs, total_bits, eos_padding & 0xFF,
                                    -(-(total_bits + pad_len) // 32))
        if carry_len:
            words[:1] |= _i32((carry_pat << (32 - carry_len)) & MASK32)
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
        if capacity is not None and int(capacity) < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        rem = self._rem
        old_nbytes = rem.nbytes
        rem.append(_as_u8(data))
        try:
            out, end_bit, more = self._drain(None if capacity is None else int(capacity))
        except UnknownSymbolError:
            rem.truncate(old_nbytes)
            raise
        rem.consumed_bit = end_bit
        rem.compact()
        return DecodeResult(out, not more)

    def _drain(self, capacity: int | None) -> tuple[bytes, int, bool]:
        rem = self._rem
        if 8 * rem.nbytes <= rem.consumed_bit:
            return b"", rem.consumed_bit, False
        args = (rem.buf, rem.nbytes, rem.consumed_bit, self.table)
        if (rem.nbytes - (rem.consumed_bit >> 3) > BULK_DECODE_THRESHOLD
                and selfsync.supports(self.table)):
            if capacity is None:
                return (*selfsync.selfsync_decode_words(*args), False)
            return selfsync.selfsync_decode_capped_words(*args, capacity)
        view, start_bit, total_bits, base = selfsync.words_view(rem.buf, rem.nbytes,
                                                                rem.consumed_bit)
        syms, end_bit, more = selfsync.decode_tail(
            view, start_bit, total_bits, capacity, DeviceTable.for_table(self.table, self.device)
        )
        return syms.cpu().numpy().tobytes(), base + end_bit, more

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

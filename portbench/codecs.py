"""What the patterns call: the program, or the control in its place.

``PortCodec`` is the program under test, ``tpu_huffman_torch``, bound to
one device. ``ControlCodec`` is the plain reference with one guarantee
that the configuration states broken (a mix names which, as its
``control``); put in the program's place it has to come out not correct:

- ``eos_zero``: the last byte's free bits padded with zeros, not with the
  low bits of ``eos_padding`` (HPACK's all-ones padding, RFC 7541 5.2);
- ``no_tail``: a decode of a stream with no index that leaves out the
  symbols whose codes start in the stream's last ``TAIL_BITS`` (the
  stitch's tail walk skipped);
- ``no_carry``: a capped ``encode_chunk`` that writes only the codes that
  fit whole and pads its chunk, so that the chunks no longer form one
  continuous stream (the carry of the SHORT_BUFFER protocol dropped).
"""

from __future__ import annotations

import types

import numpy as np

from .reference import huffman_np as R

TAIL_BITS = 2048
CONTROLS = ("eos_zero", "no_tail", "no_carry")


class PortCodec:
    def __init__(self, tt, device):
        self.tt, self.device = tt, device

    def load_table(self, path: str):
        return self.tt.HuffmanTable.from_tsv_file(path)

    def encode_with_index(self, data, table, eos_padding: int, block_symbols: int):
        return self.tt.encode_with_index(data, table, eos_padding=eos_padding,
                                         block_symbols=block_symbols, device=self.device)

    def decode_indexed(self, data, index, table):
        return self.tt.decode_indexed(data, index, table, device=self.device)

    def decode(self, data, table):
        return self.tt.decode(data, table, device=self.device)

    def HuffmanEncoder(self, table, eos_padding: int):
        return self.tt.HuffmanEncoder(table, eos_padding=eos_padding, device=self.device)

    def HuffmanDecoder(self, table):
        return self.tt.HuffmanDecoder(table, device=self.device)


class ControlCodec:
    def __init__(self, broken: str):
        if broken not in CONTROLS:
            raise ValueError(f"unknown control {broken!r}: one of {CONTROLS}")
        self.broken = broken

    def load_table(self, path: str):
        return R.parse_tsv(path)

    def _eos(self, eos_padding: int) -> int:
        return 0 if self.broken == "eos_zero" else eos_padding

    def encode_with_index(self, data, table, eos_padding: int, block_symbols: int):
        d = R.as_u8(data)
        idx = R.block_index(d, table, block_symbols)
        return R.pack(d, table, 0, self._eos(eos_padding)), types.SimpleNamespace(**idx)

    def decode_indexed(self, data, index, table):
        return R.decode_indexed(data, vars(index), table)

    def decode(self, data, table):
        syms = R.decode_at(data, table)[0]
        if self.broken == "no_tail":
            starts = np.cumsum(table.lengths[syms]) - table.lengths[syms]
            syms = syms[starts < 8 * len(data) - TAIL_BITS]
        return syms.tobytes()

    def HuffmanEncoder(self, table, eos_padding: int):
        return RefEncoder(table, self._eos(eos_padding), carry=self.broken != "no_carry")

    def HuffmanDecoder(self, table):
        return RefDecoder(table)


class RefEncoder:
    """The reference's streaming encoder: the SHORT_BUFFER protocol, with
    the low bits of a code that the capacity cuts carried to the next
    call (or, without ``carry``, only whole codes a chunk)."""

    def __init__(self, table, eos_padding: int, carry: bool = True):
        self.table, self.eos, self.carry = table, eos_padding, carry
        self.reset()

    def reset(self) -> None:
        self._pat, self._len = 0, 0

    def encode(self, data) -> bytes:
        return self.encode_chunk(data, None).data

    def encode_chunk(self, data, capacity):
        sy = R.as_u8(data)
        if capacity is not None:  # no more codes than these can start before the cut
            sy = sy[: 8 * capacity // self.table.min_len + 2]
        lens = R.code_bits(sy, self.table)
        ends = self._len + np.cumsum(lens)
        total = int(ends[-1]) if sy.size else self._len
        if capacity is None or total <= 8 * capacity:
            out = self._with_carry(R.pack(sy, self.table, self._len, self.eos))
            self.reset()
            return types.SimpleNamespace(data=out, consumed=sy.size, done=True)
        cut = 8 * capacity
        if self.carry:
            n = int(np.searchsorted(ends - lens, cut))  # the codes that start before the cut
            body = R.pack(sy[:n], self.table, self._len, 0)
            out = self._with_carry(body)[:capacity]
            over = int(ends[n - 1]) - cut if n else 0
            code = int(self.table.patterns[sy[n - 1]]) if n else 0
            self._pat, self._len = (code & ((1 << over) - 1), over) if over > 0 else (0, 0)
            return types.SimpleNamespace(data=out, consumed=n, done=False)
        n = int(np.searchsorted(ends, cut, side="right"))  # the codes that fit whole
        out = self._with_carry(R.pack(sy[:n], self.table, self._len, self.eos))
        self.reset()
        return types.SimpleNamespace(data=out, consumed=n, done=False)

    def _with_carry(self, body: bytes) -> bytes:
        if not self._len:
            return body
        head = min(len(body), 8)
        v = int.from_bytes(body[:head], "big") | (self._pat << (8 * head - self._len))
        return v.to_bytes(head, "big") + body[head:]


class RefDecoder:
    """The reference's streaming decoder: the retained bytes and the bit
    where decoding resumes; a call emits at most ``capacity`` symbols and
    is done unless more were decodable."""

    def __init__(self, table):
        self.table = table
        self.reset()

    def reset(self) -> None:
        self._rem, self._bit = b"", 0

    def decode_chunk(self, data, capacity=None):
        self._rem += bytes(data)
        syms, end_bit, held = R.decode_at(self._rem, self.table, self._bit, capacity)
        drop = end_bit >> 3
        self._rem, self._bit = self._rem[drop:], end_bit - 8 * drop
        return types.SimpleNamespace(data=syms.tobytes(),
                                     done=capacity is None or held <= capacity)

    def padding_is_all_ones(self) -> bool:
        return R.padding_is_all_ones(self._rem, self._bit)

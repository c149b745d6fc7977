"""Data-parallel codec over a mesh of torch devices (ports
``tpu_huffman/shard.py``).

Block data parallelism, with the same bytes and index as the one-device
path:

  encode:  the input is cut into contiguous shards, one a mesh entry. Each
           shard counts its bits on its device (the count kernel); one host
           read of every shard's totals gives each shard's global first bit
           as an int64 exclusive prefix; each shard then packs its codes at
           its own phase within a word (the pack kernel, its tile offsets
           shifted by the phase), so no shard's words need a funnel shift;
           the shards' words are ORed into one stream at their word bases
           on the first mesh device (shards own disjoint bits, so only the
           edge words overlap). Only the last non-empty shard packs the EOS
           pad.
  decode:  the index's blocks are striped across the shards; each shard
           gets only the words its blocks touch and decodes them with the
           chain kernel; the outputs concatenate in block order.

A mesh entry is a ``torch.device``, and entries may repeat a device (eight
shards on the CPU, four on ``cuda:0``). A 2-D ('dcn', 'ici') mesh flattens
to one data axis in row-major order, as in the JAX package. Across
processes (``distributed.py``) every process owns the entries of its row
and the coordination is ``torch.distributed.all_gather`` of small tensors:
lengths, bit totals, flags, the compressed words and the block offsets.

Not carried over from the JAX module: its TPU planners (the pack pipeline's
plans, the dual-chain pairing, the row staging), the hi/lo split of the
global prefix (TPU jit has no int64; here it is int64 end to end), and its
guards at 2^31 bits a shard and 2^36 in all, which protect TPU int32
arithmetic: this module encodes past both, as ``encode`` does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .errors import UnknownSymbolError
from .ops import chain_decode, pack_encode
from .ops.bitpack import stage_words
from .ops.decode import BlockIndex, check_offsets, index_arrays
from .ops.encode import (
    DEFAULT_EOS_PADDING,
    DeviceTable,
    _to_bytes,
    resolve_device,
    stage_bytes,
)
from .tables import HuffmanTable


def _bucket_pow2(per_dev: int, block_symbols: int) -> int:
    """A shard's size: ``per_dev`` rounded up to a power-of-two multiple of
    block_symbols (the JAX package's rule, kept because
    ``encode_sharded``'s index layout depends on it)."""
    units = -(-per_dev // block_symbols)
    return block_symbols * (1 << (units - 1).bit_length() if units > 1 else 1)


def _phase_base(totals) -> tuple[np.ndarray, np.ndarray]:
    """(phase, word_base) of every shard's global first bit: the int64
    exclusive prefix of the shards' bit totals, split at the word."""
    totals = np.asarray(totals, dtype=np.int64).reshape(-1)
    offs = np.cumsum(totals) - totals
    return offs & 31, offs >> 5


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An array of torch devices, one a shard, with named axes.

    ``n_processes`` > 1 makes it a mesh across processes: the entries are
    in process order and each process owns an equal run of them, its
    local devices (``distributed.global_data_mesh``, ``dcn_ici_mesh``).
    """

    devices: np.ndarray
    axis_names: tuple[str, ...]
    n_processes: int = 1

    def __post_init__(self):
        devs = np.frompyfunc(torch.device, 1, 1)(np.asarray(self.devices, dtype=object))
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if devs.size == 0:
            raise ValueError("a mesh needs at least one device")
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"{devs.ndim}-D devices with axes {self.axis_names}")
        if self.n_processes < 1 or devs.size % self.n_processes:
            raise ValueError(
                f"{devs.size} devices do not split over {self.n_processes} processes"
            )

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> tuple[int, ...]:
        return self.devices.shape

    def local_devices(self, rank: int = 0) -> list[torch.device]:
        """The entries that process ``rank`` owns, in order."""
        per = self.size // self.n_processes
        return list(self.devices.reshape(-1)[rank * per:(rank + 1) * per])


def default_mesh(devices=None, axis: str = "data") -> Mesh:
    """A 1-D data mesh over every visible CUDA device, or over ``devices``.
    With no card and no ``devices`` it raises: it never falls back to the
    CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "default_mesh() needs a CUDA device (torch.cuda.is_available() "
                "is False); pass devices=[...] for a mesh of CPU shards"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(list(devices), (axis,))


def _all_gather(t: torch.Tensor, comm_dev: torch.device) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), stacked in rank order,
    on ``t``'s device. The collective runs on ``comm_dev`` under NCCL and on
    the CPU under any other backend (gloo takes no CUDA tensors)."""
    via = comm_dev if dist.get_backend() == "nccl" else torch.device("cpu")
    x = t.to(via).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.stack(parts).to(t.device)


def _as_symbols(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8).reshape(-1)


def _n_words(phase: int, bits: int) -> int:
    """Words of a shard stream from bit ``phase``: its bits and the pad to
    the next byte."""
    end = phase + bits
    return -(-(end + pack_encode.pad_code(end, 0)[1]) // 32)


class _Shard(NamedTuple):
    """One counted shard of an encode."""

    start: int  # its first symbol's index in the input
    symbols: torch.Tensor  # uint8, staged on its device
    tile_bits: torch.Tensor  # the count's per-tile bit totals
    incl: torch.Tensor  # their inclusive int64 prefix
    stats: torch.Tensor  # [first unknown symbol (its length if none), longest code]


@dataclasses.dataclass
class MeshCodec:
    """Data-parallel encoder/decoder bound to a mesh and a table.

    Its bytes equal ``encode``'s (and the reference's); it emits and takes
    the same BlockIndex.
    """

    table: HuffmanTable
    mesh: Mesh
    block_symbols: int = 256  # BlockIndex granularity for decode striping
    eos_padding: int = DEFAULT_EOS_PADDING

    def __post_init__(self):
        if self.block_symbols < 1:
            raise ValueError(f"block_symbols must be >= 1, got {self.block_symbols}")
        self._ndev = self.mesh.size
        self._rank = dist.get_rank() if self.mesh.n_processes > 1 else 0
        if self.mesh.n_processes > 1 and dist.get_world_size() != self.mesh.n_processes:
            raise ValueError(
                f"a mesh over {self.mesh.n_processes} processes in a group of "
                f"{dist.get_world_size()}"
            )
        self._local = [resolve_device(d) for d in self.mesh.local_devices(self._rank)]
        self._out_dev = self._local[0]

    def _dt(self, dev: torch.device) -> DeviceTable:
        return DeviceTable.for_table(self.table, dev)

    # ---- encode ----

    def _count(self, symbols: np.ndarray, per_dev: int) -> list:
        """Stage and count this process's shards of ``symbols``, ``per_dev``
        a shard: one :class:`_Shard` a local shard, None for an empty one
        (no launch)."""
        shards = []
        for j, dev in enumerate(self._local):
            lo, hi = j * per_dev, min(symbols.size, (j + 1) * per_dev)
            if lo >= hi:
                shards.append(None)
                continue
            sym = stage_bytes(symbols[lo:hi], dev)
            tile_bits, stats = pack_encode.count(sym, self._dt(dev))
            incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
            shards.append(_Shard(lo, sym, tile_bits, incl, stats))
        return shards

    def _read_counts(self, shards: list) -> np.ndarray:
        """One host read of every local shard's [first unknown symbol (its
        shard length if none), longest code, bit total]; zeros for an empty
        shard."""
        rows = [
            torch.zeros(3, dtype=torch.int64, device=self._out_dev) if s is None
            else torch.cat([s.stats, s.incl[-1:]]).to(self._out_dev)
            for s in shards
        ]
        return torch.stack(rows).cpu().numpy()

    def _pack(self, s: _Shard, phase: int, bits: int, eos: int, with_index: bool):
        """Pack one counted shard from bit ``phase`` of its first word.
        Returns (words, block offsets from that word's bit 0, or None)."""
        return pack_encode.pack(
            s.symbols, self._dt(s.symbols.device), s.incl - s.tile_bits + phase,
            phase + bits, eos, _n_words(phase, bits),
            self.block_symbols if with_index else None,
        )

    def _stitch(self, n_words: int, parts) -> torch.Tensor:
        """OR each (word base, words) part into one int32[n_words] stream on
        the output device (a copy to it where a part lies elsewhere)."""
        out = torch.zeros(n_words, dtype=torch.int32, device=self._out_dev)
        for base, words in parts:
            out[base:base + words.numel()] |= words.to(self._out_dev)
        return out

    def encode(self, data, with_index: bool = True):
        """Returns (encoded_bytes, BlockIndex | None); the bytes equal
        ``encode(data)``'s and the index ``encode_with_index``'s. Raises
        UnknownSymbolError at the first symbol with no code. Runs on one
        process's mesh: across processes, call :meth:`encode_sharded`."""
        if self.mesh.n_processes > 1:
            raise ValueError("encode runs on one process's mesh; across processes "
                             "call encode_sharded (distributed.encode_global)")
        symbols = _as_symbols(data)
        n = symbols.size
        bs = self.block_symbols
        if n == 0:
            empty = BlockIndex(bs, np.zeros(0, np.int64), np.zeros(0, np.int32), 0, 0)
            return b"", (empty if with_index else None)
        per_dev = _bucket_pow2(-(-n // self._ndev), bs)
        shards = self._count(symbols, per_dev)
        counts = self._read_counts(shards)
        for s, row in zip(shards, counts):
            if s is not None and row[0] < s.symbols.numel():
                i = s.start + int(row[0])
                raise UnknownSymbolError(index=i, symbol=int(symbols[i]))
        totals = counts[:, 2]
        phase, word_base = _phase_base(totals)
        total_bits = int(totals.sum())
        last = max(j for j, s in enumerate(shards) if s is not None)
        parts, offs = [], []
        for j, s in enumerate(shards):
            if s is None:
                continue
            eos = self.eos_padding & 0xFF if j == last else 0
            words, block_offs = self._pack(s, int(phase[j]), int(totals[j]), eos, with_index)
            parts.append((int(word_base[j]), words))
            if with_index:
                offs.append(block_offs.to(self._out_dev) + 32 * int(word_base[j]))
        out = self._stitch(_n_words(0, total_bits), parts)
        encoded = _to_bytes(out, 8 * -(-total_bits // 8))
        if not with_index:
            return encoded, None
        n_blocks = -(-n // bs)
        n_sym = np.full(n_blocks, bs, dtype=np.int32)
        n_sym[-1] = n - (n_blocks - 1) * bs
        index = BlockIndex(
            symbols_per_block=bs,
            bit_offsets=torch.cat(offs).cpu().numpy(),
            n_symbols=n_sym,
            total_symbols=n,
            total_bits=total_bits,
            max_code_len=int(counts[:, 1].max()),
        )
        return encoded, index

    # ---- multi-process collective encode ----

    def encode_sharded(self, local_data, with_index: bool = True):
        """Collective encode where each process contributes only its own
        bytes; every process of the mesh must call it.

        Every process returns the same (encoded_bytes, BlockIndex): the bytes
        of the processes' data concatenated in process order. No input-sized
        payload travels: the collectives carry the lengths, the shards' bit
        totals and flags, the compressed words and the block offsets. Local
        lengths may differ; the index covers the padded global positions
        (``per_dev`` symbols a shard) and its padding blocks have
        n_symbols == 0. A symbol with no code raises UnknownSymbolError with
        its local (index, symbol) on the process that holds it, and a bare
        UnknownSymbolError on the others.
        """
        local = _as_symbols(local_data)
        nproc = self.mesh.n_processes
        if nproc == 1:
            return self.encode(local, with_index=with_index)
        gather = lambda t: _all_gather(t, self._out_dev)  # noqa: E731
        ld = len(self._local)
        bs = self.block_symbols
        lens = gather(torch.tensor([local.size], dtype=torch.int64)).reshape(-1).numpy()
        per_dev = _bucket_pow2(max(bs, -(-int(lens.max()) // ld)), bs)

        shards = self._count(local, per_dev)
        counts = self._read_counts(shards)
        bad = [s is not None and row[0] < s.symbols.numel() for s, row in zip(shards, counts)]
        mine = torch.tensor(np.stack([counts[:, 2], bad], 1), dtype=torch.int64)
        every = gather(mine).reshape(-1, 2).numpy()
        if every[:, 1].any():
            for s, row, b in zip(shards, counts, bad):
                if b:
                    i = s.start + int(row[0])
                    raise UnknownSymbolError(index=i, symbol=int(local[i]))
            raise UnknownSymbolError()
        totals = every[:, 0]
        phase, word_base = _phase_base(totals)
        total_bits = int(totals.sum())
        nonempty = np.flatnonzero(totals)
        last = int(nonempty[-1]) if nonempty.size else -1
        n_words = [_n_words(int(p), int(t)) if t else 0 for p, t in zip(phase, totals)]
        wmax = max(1, max(n_words))
        bpd = per_dev // bs

        my_words = torch.zeros((ld, wmax), dtype=torch.int32, device=self._out_dev)
        my_offs = torch.zeros((ld, bpd), dtype=torch.int64, device=self._out_dev)
        for j, s in enumerate(shards):
            g = self._rank * ld + j
            end = int(32 * word_base[g] + phase[g] + totals[g])  # the shard's last bit + 1
            if s is None:
                my_offs[j] = end
                continue
            eos = self.eos_padding & 0xFF if g == last else 0
            words, block_offs = self._pack(s, int(phase[g]), int(totals[g]), eos, with_index)
            my_words[j, : words.numel()] = words.to(self._out_dev)
            if with_index:
                my_offs[j] = end
                my_offs[j, : block_offs.numel()] = block_offs.to(self._out_dev) + 32 * int(
                    word_base[g])
        all_words = gather(my_words).reshape(-1, wmax)
        out = self._stitch(_n_words(0, total_bits), [
            (int(word_base[g]), all_words[g, : n_words[g]]) for g in nonempty])
        encoded = _to_bytes(out, 8 * -(-total_bits // 8))
        if not with_index:
            return encoded, None

        counts_dev = np.clip(
            np.repeat(lens, ld) - per_dev * np.tile(np.arange(ld, dtype=np.int64), nproc),
            0, per_dev,
        )
        n_sym = np.clip(counts_dev[:, None] - bs * np.arange(bpd)[None, :], 0, bs)
        index = BlockIndex(
            symbols_per_block=bs,
            bit_offsets=gather(my_offs).reshape(-1).cpu().numpy(),
            n_symbols=n_sym.astype(np.int32).reshape(-1),
            total_symbols=int(lens.sum()),
            total_bits=total_bits,
        )
        return encoded, index

    # ---- decode ----

    def _decode_args(self, raw: np.ndarray, offs: np.ndarray, counts: np.ndarray,
                     g: int, dev: torch.device):
        """``chain_decode.decode_chains``'s arguments for shard ``g``'s
        stripe of ceil(B / shards) blocks, on ``dev``, or None when the
        stripe holds no symbol. The shard gets the words from its first
        block's to the last bit any of its symbols can read (codes are
        <= max_len bits), and bit offsets relative to them."""
        bpd = -(-offs.size // self._ndev)
        b0, b1 = g * bpd, min(offs.size, (g + 1) * bpd)
        if b0 >= b1 or not counts[b0:b1].any():
            return None
        o, c = offs[b0:b1], counts[b0:b1]
        w0 = int(o[0]) >> 5
        w1 = -(-int((o + c * self.table.max_len).max()) // 32)
        out_start = np.zeros_like(c)
        np.cumsum(c[:-1], out=out_start[1:])
        return (
            stage_words(stage_bytes(raw[4 * w0: 4 * w1], dev)),
            torch.tensor(o - 32 * w0, device=dev),
            torch.tensor(c.astype(np.int32), device=dev),
            torch.tensor(out_start, device=dev),
            int(c.sum()),
            self._dt(dev),
        )

    def decode(self, data, index: BlockIndex) -> bytes:
        """Block-parallel decode striped over the mesh: ceil(B / shards)
        blocks a shard, each shard decoding the words its blocks touch on
        its own device. Across processes each process decodes its own
        shards and every process returns the whole plaintext. Raises
        UnknownSymbolError when a window inside a block matches no code."""
        raw = _as_symbols(data)
        offs, counts = index_arrays(index)
        if index.total_symbols == 0:
            return b""
        check_offsets(offs, raw.size)
        outs = []
        for j, dev in enumerate(self._local):
            args = self._decode_args(raw, offs, counts, self._rank * len(self._local) + j, dev)
            if args is not None:
                out, _end, bad = chain_decode.decode_chains(*args)
                outs.append((out, bad))
        bad = torch.zeros(1, dtype=torch.int32, device=self._out_dev)
        if outs:
            bad = torch.cat([b.to(self._out_dev) for _out, b in outs]).max().reshape(1)
        if self.mesh.n_processes > 1:  # every process raises, or none
            bad = _all_gather(bad, self._out_dev).max()
        if int(bad.max()):
            raise UnknownSymbolError()
        plain = torch.zeros(0, dtype=torch.uint8)
        if outs:
            plain = torch.cat([out.to(self._out_dev) for out, _bad in outs]).cpu()
        if self.mesh.n_processes > 1:
            # every process returns the whole plaintext: gather the others'
            # (padded to the longest) in process order
            sizes = _all_gather(torch.tensor([plain.numel()]), self._out_dev).reshape(-1)
            padded = torch.zeros(int(sizes.max()), dtype=torch.uint8)
            padded[: plain.numel()] = plain
            rows = _all_gather(padded, self._out_dev)
            plain = torch.cat([rows[r, : int(k)] for r, k in enumerate(sizes)])
        return plain.numpy().tobytes()

"""One-shot Huffman encode (ports ``tpu_huffman/ops/encode.py``).

``encode`` and ``encode_with_index`` stage the input bytes on the device,
run the count kernel, take the exclusive prefix of tile bit totals with an
int64 ``torch.cumsum``, read the stream's length and the first unknown
symbol back in one transfer, and run the pack kernel
(``ops/pack_encode.py``). The bytes are bit-identical to the reference
encoder's, including the EOS padding of the final partial byte; the block
index is the pack's block offsets, from its own scan over each tile.

``best_encode_step`` is the fixed-size device step the bench times (the
JAX package's bench seam): the same count, prefix and pack with the
stream's length left on the device (``pack_encode.pack_device_total``),
so that nothing waits for the host.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from .. import metrics
from ..errors import UnknownSymbolError
from ..tables import NUM_SYMBOLS, HuffmanTable, _build_decode_lut
from . import pack_encode
from .bitpack import words_to_bytes
from .chain_decode import MAX_ROOT_BITS

DEFAULT_EOS_PADDING = 0xFF
# One index block per 256 symbols: the granularity the TPU path picks for
# the static table (pallas_encode.index_granularity).
DEFAULT_BLOCK_SYMBOLS = 256


def resolve_device(device) -> torch.device:
    """The device a public call runs on. A CUDA device that is not there is
    an error, never a reason to run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def stage_bytes(data, dev: torch.device) -> torch.Tensor:
    """``data`` (bytes, bytearray, uint8 numpy array or uint8 tensor) as a
    contiguous 1-D uint8 tensor on ``dev``."""
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8:
            raise ValueError("a tensor input must be uint8")
        flat = data.reshape(-1)
        if flat.device.type == "cpu" and dev.type == "cuda":
            with metrics.h2d(flat.numel()):
                return flat.to(dev).contiguous()
        return flat.to(dev).contiguous()
    if isinstance(data, (bytes, bytearray, memoryview)):
        src = np.frombuffer(data, dtype=np.uint8)
    else:
        src = np.asarray(data, dtype=np.uint8).reshape(-1)
    with metrics.h2d(src.size):
        if dev.type != "cuda":
            # a private, writable copy: torch.from_numpy shares the buffer
            return torch.from_numpy(src.copy())
        # through a pinned buffer, so that the upload does not block the host
        # (a copy from pageable memory waits for the device)
        staged = torch.empty(src.size, dtype=torch.uint8, pin_memory=True)
        staged.numpy()[:] = src
        return staged.to(dev, non_blocking=True)


# Each table set-up (``DeviceTable``): the count, its host ns from the read
# of the table's file to the staged upload (``HuffmanTable.build_ns`` and
# the staging), and the bytes uploaded.
outcomes = metrics.register(
    "ops.encode.outcomes", {"device_tables": 0, "device_table_ns": 0, "device_table_h2d_bytes": 0}
)
_ALIGN = 64  # int32s: each array of the upload starts on 256 bytes, as an allocation would


class DeviceTable:
    """A table's arrays staged on one device, kept in the table's ``staged``
    and freed with it: the device holds the set-ups of the tables the
    caller holds.

    Encode: ``patterns`` (uint32 bits in int32) and ``lengths`` (int32).
    Decode: the LUT at ``root_bits`` = min(the table's, ``MAX_ROOT_BITS``)
    so that level 0 fits the kernels' shared memory: the table's own LUT,
    rebuilt only for a table built wider. ``root_bits`` is a layout: the
    decoded symbols are the same at any width. For the kernels: ``l0``/``l1``,
    each entry packed into one int32 (see csrc/lut.cuh). The four arrays go
    up in one upload (pinned and non-blocking to a card). The plain
    versions' ``l0_bits``, ``l0_val``, ``l1_bits``, ``l1_val`` (int64) are
    the host LUT's, independent of the packing, put on the device when one
    first reads them. ``table`` is a copy of the table that shares its
    arrays, so that the table's ``staged`` makes no cycle.
    """

    def __init__(self, table: HuffmanTable, dev: torch.device):
        t0 = time.perf_counter_ns()
        with metrics.span("tt.setup.table"):
            self.table = dataclasses.replace(table)
            # bits a symbol of the last uncapped streaming encode, with a margin:
            # sizes the next one's download (stream.HuffmanEncoder)
            self.encode_rate = None
            with metrics.span("tt.setup.table.lut"):
                self.root_bits = min(int(table.root_bits), MAX_ROOT_BITS)
                if self.root_bits == table.root_bits:
                    lut = (table.l0_bits, table.l0_val, table.l1_bits, table.l1_val)
                else:
                    lut = _build_decode_lut(table.lengths, table.patterns, self.root_bits)[:4]
                self._host_lut = l0_bits, l0_val, l1_bits, l1_val = lut
                if l1_bits.size >= 1 << 23:
                    raise ValueError("level-1 LUT too large for the packed entry form")
            with metrics.span("tt.setup.table.upload"):
                sizes = (NUM_SYMBOLS, NUM_SYMBOLS, l0_bits.size, l1_bits.size)
                starts = np.cumsum((0,) + tuple(-(-n // _ALIGN) * _ALIGN for n in sizes))
                nbytes = 4 * int(starts[-1])
                with metrics.h2d(nbytes):
                    if dev.type == "cuda":  # pinned, so that the upload does not block the host
                        host = torch.empty(int(starts[-1]), dtype=torch.int32, pin_memory=True)
                    else:
                        host = torch.zeros(int(starts[-1]), dtype=torch.int32)
                    pat, lens, l0, l1 = (host.numpy()[a:a + n] for a, n in zip(starts, sizes))
                    pat[:] = table.patterns.astype(np.uint32, copy=False).view(np.int32)
                    lens[:] = table.lengths
                    np.left_shift(l0_val, 8, out=l0)  # packed in place: see csrc/lut.cuh
                    l0 |= l0_bits & 0xFF
                    np.left_shift(l1_val, 8, out=l1)
                    l1 |= l1_bits
                    buf = host.to(dev, non_blocking=True)
                self.patterns, self.lengths, self.l0, self.l1 = (
                    buf[a:a + n] for a, n in zip(starts, sizes))
        outcomes["device_tables"] += 1
        outcomes["device_table_ns"] += table.build_ns + time.perf_counter_ns() - t0
        outcomes["device_table_h2d_bytes"] += nbytes

    def _plain(self, k: int) -> torch.Tensor:
        """The host LUT's array ``k`` (l0_bits, l0_val, l1_bits, l1_val) as
        int64 on the device."""
        a = torch.as_tensor(self._host_lut[k], dtype=torch.int64)
        dev = self.l0.device
        if dev.type == "cpu":
            return a
        with metrics.h2d(8 * a.numel()):
            return a.to(dev)

    @functools.cached_property
    def l0_bits(self) -> torch.Tensor:
        return self._plain(0)

    @functools.cached_property
    def l0_val(self) -> torch.Tensor:
        return self._plain(1)

    @functools.cached_property
    def l1_bits(self) -> torch.Tensor:
        return self._plain(2)

    @functools.cached_property
    def l1_val(self) -> torch.Tensor:
        return self._plain(3)

    @staticmethod
    def for_table(table: HuffmanTable, dev: torch.device) -> "DeviceTable":
        dt = table.staged.get(str(dev))
        if dt is None:
            dt = table.staged[str(dev)] = DeviceTable(table, dev)
        return dt


def _encode_device(symbols: torch.Tensor, dt: DeviceTable, eos_padding: int,
                   block_symbols: int | None = None):
    """Count, prefix, check, pack. Returns (words int32, total_bits,
    padded_bits, block offsets int64 (None without block_symbols), longest
    code in the data)."""
    n = symbols.numel()
    with metrics.span("tt.encode.count"):
        tile_bits, stats = pack_encode.count(symbols, dt)
        incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
    with metrics.d2h(8 * (stats.numel() + 1)):
        first_bad, max_len, total_bits = torch.cat([stats, incl[-1:]]).tolist()
    if first_bad < n:
        raise UnknownSymbolError(index=first_bad, symbol=int(symbols[first_bad]))
    with metrics.span("tt.encode.pack"):
        _pad, pad_len = pack_encode.pad_code(total_bits, eos_padding)
        padded_bits = total_bits + pad_len
        words, block_offs = pack_encode.pack(
            symbols, dt, incl - tile_bits, total_bits, eos_padding,
            -(-padded_bits // 32), block_symbols,
        )
    return words, total_bits, padded_bits, block_offs, max_len


def _to_bytes(words: torch.Tensor, padded_bits: int) -> bytes:
    with metrics.d2h(padded_bits // 8):
        return words_to_bytes(words)[: padded_bits // 8].cpu().numpy().tobytes()


def encode(data, table: HuffmanTable, eos_padding: int = DEFAULT_EOS_PADDING,
           device="cuda") -> bytes:
    """One-shot encode: bytes in, reference-bit-identical compressed bytes out.

    Raises UnknownSymbolError (with the input index and symbol of the first
    symbol that has no code).
    """
    metrics.calls["encode"] += 1
    with metrics.record("encode", len(data)) as m:
        out = _encode_impl(data, table, eos_padding, device)
        m[0] = len(out)
    return out


def _encode_impl(data, table, eos_padding, device) -> bytes:
    dev = resolve_device(device)
    symbols = stage_bytes(data, dev)
    if symbols.numel() == 0:
        return b""
    dt = DeviceTable.for_table(table, dev)
    words, _total, padded_bits, _offs, _max = _encode_device(
        symbols, dt, int(eos_padding) & 0xFF
    )
    return _to_bytes(words, padded_bits)


def _block_symbols(block_symbols: int | None) -> int:
    """None picks DEFAULT_BLOCK_SYMBOLS (the JAX package's None picks a
    planner's granularity, which is not a contract)."""
    if block_symbols is None:
        return DEFAULT_BLOCK_SYMBOLS
    if block_symbols < 1:
        raise ValueError(f"block_symbols must be >= 1, got {block_symbols}")
    return block_symbols


def encode_with_index(data, table: HuffmanTable,
                      eos_padding: int = DEFAULT_EOS_PADDING,
                      block_symbols: int | None = DEFAULT_BLOCK_SYMBOLS,
                      device="cuda"):
    """Encode and return (bytes, BlockIndex) for block-parallel decode.

    The bytes are identical to :func:`encode`; the index is side metadata:
    the starting bit of every ``block_symbols`` symbols (None: 256).
    """
    metrics.calls["encode_with_index"] += 1
    with metrics.span("tt.encode_with_index"):
        return _encode_with_index(data, table, eos_padding, block_symbols, device)


def _encode_with_index(data, table, eos_padding, block_symbols, device):
    from .decode import BlockIndex  # decode imports this module

    dev = resolve_device(device)
    block_symbols = _block_symbols(block_symbols)
    symbols = stage_bytes(data, dev)
    n = symbols.numel()
    if n == 0:
        return b"", BlockIndex(
            block_symbols, np.zeros(0, np.int64), np.zeros(0, np.int32), 0, 0
        )
    dt = DeviceTable.for_table(table, dev)
    words, total_bits, padded_bits, block_offs, max_len = _encode_device(
        symbols, dt, int(eos_padding) & 0xFF, block_symbols
    )
    n_blocks = -(-n // block_symbols)
    n_syms = np.full(n_blocks, block_symbols, dtype=np.int32)
    n_syms[-1] = n - (n_blocks - 1) * block_symbols
    with metrics.d2h(8 * block_offs.numel()):
        bit_offsets = block_offs.cpu().numpy()
    index = BlockIndex(
        symbols_per_block=block_symbols,
        bit_offsets=bit_offsets,
        n_symbols=n_syms,
        total_symbols=n,
        total_bits=total_bits,
        max_code_len=max_len,
    )
    return _to_bytes(words, padded_bits), index


def best_encode_step(table: HuffmanTable, n: int,
                     block_symbols: int | None = DEFAULT_BLOCK_SYMBOLS, device="cuda"):
    """The device encode of ``n`` symbols at a fixed size (the bench seam).

    Returns ``(encode_fn, finalize_fn)``:
      encode_fn(symbols uint8[n] on the device) -> (words int32[W],
          total_bits, padded_bits), the two lengths 0-d int64 tensors on the
          device. The first ceil(padded_bits / 32) words are the stream (the
          bytes of ``encode``), the rest zeros; W = ceil(n * table.max_len /
          32) + 1 is fixed by n and the table. It launches the count and the
          pack (which also writes the block offsets every ``block_symbols``
          symbols, None: 256, the index's work) and never synchronises
          with the host, so a CUDA graph can capture it. An unknown symbol
          adds no bits and raises nothing here.
      finalize_fn(symbols) -> the same triple, after reading the count's
          stats: raises UnknownSymbolError(index, symbol) at the first
          unknown symbol.

    On ``device="cpu"`` both run the kernels' plain versions.
    """
    dev = resolve_device(device)
    block_symbols = _block_symbols(block_symbols)
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    dt = DeviceTable.for_table(table, dev)
    n_words = -(-n * int(table.max_len) // 32) + 1

    def step(symbols: torch.Tensor):
        if symbols.shape != (n,) or symbols.device != dt.lengths.device:
            raise ValueError(f"symbols must be uint8[{n}] on {dt.lengths.device}")
        tile_bits, stats = pack_encode.count(symbols, dt)
        incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
        total_bits = incl[-1]
        words, _offs, padded_bits = pack_encode.pack_device_total(
            symbols, dt, incl - tile_bits, total_bits, DEFAULT_EOS_PADDING, n_words,
            block_symbols,
        )
        return words, total_bits, padded_bits, stats

    def encode_fn(symbols: torch.Tensor):
        return step(symbols)[:3]

    def finalize_fn(symbols: torch.Tensor):
        words, total_bits, padded_bits, stats = step(symbols)
        first_bad = int(stats[0])
        if first_bad < n:
            raise UnknownSymbolError(index=first_bad, symbol=int(symbols[first_bad]))
        return words, total_bits, padded_bits

    return encode_fn, finalize_fn


def encoded_length_bits(symbols: torch.Tensor, n_valid, table_or_dt) -> torch.Tensor:
    """Sum of the code lengths of the first ``n_valid`` symbols (an int or a
    0-d tensor) as a 0-d int64 tensor on the symbols' device; unknown
    symbols add 0 (the reference's dry run). Ports the JAX package's
    ``encoded_length_bits_kernel``, in int64 where that one sums in int32."""
    dt = table_or_dt
    if isinstance(table_or_dt, HuffmanTable):
        dt = DeviceTable.for_table(table_or_dt, symbols.device)
    symbols = symbols.reshape(-1)
    pos = torch.arange(symbols.numel(), device=symbols.device)
    lens = dt.lengths.to(torch.int64)[symbols.to(torch.int64)]
    return torch.where(pos < n_valid, lens, 0).sum()


def get_encoded_length(data, table: HuffmanTable) -> int:
    """Byte length of ``data`` once encoded. Unknown symbols add 0 bits, as
    in the reference's dry run (it never raises). Host-side, like the JAX
    package's."""
    if isinstance(data, torch.Tensor):
        symbols = data.reshape(-1).cpu().numpy()
    elif isinstance(data, (bytes, bytearray, memoryview)):
        symbols = np.frombuffer(data, dtype=np.uint8)
    else:
        symbols = np.asarray(data, dtype=np.uint8)
    bits = int(table.lengths[symbols].astype(np.int64).sum())
    return (bits + 7) // 8

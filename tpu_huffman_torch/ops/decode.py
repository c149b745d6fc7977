"""Decode (ports ``tpu_huffman/ops/decode.py``: ``BlockIndex``,
``decode_indexed``, ``decode`` and the ``STATUS_*`` stop reasons).

Two ways to break the serial bit-offset dependency of Huffman decode:

1. **Indexed** (:func:`decode_indexed`): the encoder's :class:`BlockIndex`
   gives every block's starting bit, so the blocks decode independently
   (``ops/chain_decode.py``). The index lives outside the byte stream,
   which stays bit-identical to the reference's.
2. **Foreign streams** (:func:`decode`), which carry no index: small inputs
   and capped calls go through one block's walk of the stream with the
   reference's termination rules (``ops/stream_decode.py``); larger ones
   decode in self-synchronising segments (``ops/selfsync.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import metrics
from ..errors import UnknownSymbolError
from ..tables import HuffmanTable
from . import chain_decode, selfsync, stream_decode
from .bitpack import stage_words
from .chain_decode import lut_lookup  # noqa: F401  (public, as in the JAX package)
from .encode import DeviceTable, resolve_device, stage_bytes
from .stream_decode import (  # noqa: F401  (public, as in the JAX package)
    STATUS_OK,
    STATUS_OUTPUT_FULL,
    STATUS_UNKNOWN_SYMBOL,
)

# Inputs up to this many bytes are decoded by stream_decode's walk alone,
# as in the JAX package's ``_decode_impl``.
SEQUENTIAL_MAX_BYTES = 2048


@dataclasses.dataclass(frozen=True)
class BlockIndex:
    """Parallel-decode metadata emitted alongside an encoded stream (the same
    fields as the JAX package's)."""

    symbols_per_block: int
    bit_offsets: np.ndarray  # int64[B]: absolute start bit of each block
    n_symbols: np.ndarray  # int32[B]: symbol count per block
    total_symbols: int
    total_bits: int  # unpadded bit length of the stream
    max_code_len: int = 0  # the data's longest code (0 = unknown)


def index_arrays(index: BlockIndex) -> tuple[np.ndarray, np.ndarray]:
    """The index's (bit_offsets, n_symbols) as int64 arrays, checked
    against each other and against total_symbols."""
    offs = np.asarray(index.bit_offsets, dtype=np.int64).reshape(-1)
    counts = np.asarray(index.n_symbols, dtype=np.int64).reshape(-1)
    if offs.size != counts.size:
        raise ValueError("index bit_offsets and n_symbols differ in length")
    if (counts < 0).any() or int(counts.sum()) != index.total_symbols:
        raise ValueError("index n_symbols do not add up to total_symbols")
    return offs, counts


def check_offsets(offs: np.ndarray, n_bytes: int) -> None:
    """Raise unless every block's entry bit lies within a stream of
    ``n_bytes`` bytes."""
    if offs.min() < 0 or offs.max() > 8 * n_bytes:
        raise ValueError("index bit offsets lie outside the stream")


def decode_indexed(data, index: BlockIndex, table: HuffmanTable,
                   device="cuda") -> bytes:
    """Block-parallel decode of ``data`` with a trusted BlockIndex.

    Blocks may hold any number of symbols (ragged indexes included); block b
    fills the output after the symbols of blocks 0..b-1. Raises
    UnknownSymbolError when a window inside a block matches no code.
    """
    metrics.calls["decode_indexed"] += 1
    with metrics.span("tt.decode_indexed"):
        return _decode_indexed(data, index, table, device)


def _decode_indexed(data, index, table, device) -> bytes:
    dev = resolve_device(device)
    with metrics.span("tt.decode.index"):
        offs, counts = index_arrays(index)
    if index.total_symbols == 0:
        return b""
    raw = stage_bytes(data, dev)
    with metrics.span("tt.decode.index"):
        check_offsets(offs, raw.numel())
        words = stage_words(raw)
        out_start = np.zeros_like(counts)
        np.cumsum(counts[:-1], out=out_start[1:])
        counts32 = counts.astype(np.int32)
    with metrics.h2d(offs.nbytes):
        offs_d = torch.tensor(offs, device=dev)
    with metrics.h2d(counts32.nbytes):
        counts_d = torch.tensor(counts32, device=dev)
    with metrics.h2d(out_start.nbytes):
        out_start_d = torch.tensor(out_start, device=dev)
    with metrics.span("tt.decode.chain"):
        out, _end, bad = chain_decode.decode_chains(
            words, offs_d, counts_d, out_start_d, index.total_symbols,
            DeviceTable.for_table(table, dev),
        )
    with metrics.d2h(out.numel()):
        out_host = out.cpu()
    with metrics.d2h(bad.element_size()):
        if int(bad.item()):
            raise UnknownSymbolError()
        return out_host.numpy().tobytes()


def decode(data, table: HuffmanTable, max_output: int | None = None,
           device="cuda") -> bytes:
    """One-shot decode of a foreign (un-indexed) stream.

    Raises UnknownSymbolError exactly where the reference would
    (source/huffman.c:246); trailing padding is skipped by the reference's
    rules. With ``max_output``, decoding stops after that many symbols.
    Inputs of any size decode in one call: absolute bit positions are int64.
    """
    metrics.calls["decode"] += 1
    with metrics.record("decode", len(data)) as m:
        out = _decode_impl(data, table, max_output, device)
        m[0] = len(out)
    return out


def _decode_impl(data, table, max_output, device) -> bytes:
    dev = resolve_device(device)
    raw = stage_bytes(data, dev)
    if raw.numel() == 0:
        return b""
    if max_output is None and raw.numel() > SEQUENTIAL_MAX_BYTES:
        return selfsync.selfsync_decode(raw, table, device=dev)
    syms, info = stream_decode.decode_stream(
        stage_words(raw), 0, 8 * raw.numel(), max_output,
        DeviceTable.for_table(table, dev),
    )
    with metrics.d2h(8 * info.numel()):
        n, _end_bit, status = info.tolist()
    if status == STATUS_UNKNOWN_SYMBOL:
        raise UnknownSymbolError()
    with metrics.d2h(n):
        return syms[:n].cpu().numpy().tobytes()

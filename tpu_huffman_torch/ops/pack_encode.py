"""Encode kernels and their plain versions (replaces the Pallas pack kernel
B1 of ``tpu_huffman/ops/pallas_encode.py``: ``_make_pack_call`` with its
XLA half ``_encode_pipeline`` and ``_pad_code``; the kernels take any table,
as B1 does).

Two kernels, in ``csrc/pack_encode.cu``, over tiles of :data:`TILE`
consecutive symbols (one CUDA block each, whatever the index's
block_symbols):

* :func:`count` — the bit total of every tile, plus ``stats = [first
  unknown symbol's index (n if none), longest code]``;
* :func:`pack` — the codes MSB-first from each tile's first bit, the EOS
  pad code at ``total_bits``, and the index's block offsets. Every output
  word is written once (the output is never filled first).
  :func:`pack_device_total` launches the same kernel with the stream's
  length read from device memory (the inclusive prefix's last element),
  so that the host need not know it: the fixed-size step of
  ``best_encode_step``, which never synchronises.

Between them the caller takes the exclusive prefix over tiles with
``torch.cumsum`` in int64, as the JAX package takes it in XLA glue
(``_exclusive_cumsum_blocks``). The TPU planners (``_plan``, ``pack_k``,
``_sub_block``, the span hints and re-runs) only pick static VMEM shapes
and have no counterpart here.

Each wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device; there is no fallback
from one to the other. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .bitpack import MASK32, i32, u32

# symbols a tile: one block of 256 threads, 16 symbols (one uint4) each
# (csrc/pack.cuh kTile)
TILE = 4096
launches = {"encode_count": 0, "encode_pack": 0}


def n_tiles(n: int) -> int:
    return -(-n // TILE)


def _check(symbols: torch.Tensor, dt) -> None:
    if symbols.dtype != torch.uint8 or symbols.dim() != 1 or not symbols.is_contiguous():
        raise ValueError("symbols must be a contiguous 1-D uint8 tensor")
    if symbols.numel() == 0:
        raise ValueError("symbols must not be empty")
    if dt.lengths.device != symbols.device:
        raise ValueError("table and symbols are on different devices")


def _cuda(symbols: torch.Tensor) -> bool:
    if symbols.device.type == "cpu":
        return False
    if symbols.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {symbols.device}")


def count(symbols: torch.Tensor, dt):
    """Per-tile bit totals (int32[ceil(n / TILE)]) and stats (int64[2])."""
    _check(symbols, dt)
    if not _cuda(symbols):
        return count_plain(symbols, dt)
    n = symbols.numel()
    tile_bits = torch.empty(n_tiles(n), dtype=torch.int32, device=symbols.device)
    # [n (no unknown symbol yet), 0] by two fills: setting an element from a
    # Python int would copy it from pageable host memory and block the host
    stats = torch.full((2,), n, dtype=torch.int64, device=symbols.device)
    stats[1:].zero_()
    stream = torch.cuda.current_stream(symbols.device).cuda_stream
    err = _build.load().thc_encode_count(
        symbols.device.index, symbols.data_ptr(), n, dt.lengths.data_ptr(),
        tile_bits.data_ptr(), stats.data_ptr(), stream,
    )
    _build.check("thc_encode_count", err)
    launches["encode_count"] += 1
    return tile_bits, stats


def group_lengths(symbols: torch.Tensor, dt, group: int) -> torch.Tensor:
    """Code lengths (int64) as rows of ``group`` symbols, zeros past n."""
    n = symbols.numel()
    rows = -(-n // group)
    padded = torch.zeros(rows * group, dtype=torch.int64, device=symbols.device)
    padded[:n] = dt.lengths.to(torch.int64)[symbols.to(torch.int64)]
    return padded.view(rows, group)


def count_plain(symbols: torch.Tensor, dt):
    """Plain version of :func:`count`."""
    n = symbols.numel()
    grid = group_lengths(symbols, dt, TILE)
    lens = grid.view(-1)[:n]
    pos = torch.arange(n, device=symbols.device)
    first_bad = torch.where(lens == 0, pos, n).min()
    return grid.sum(1).to(torch.int32), torch.stack([first_bad, lens.max()])


def pad_code(total_bits, eos_padding: int):
    """EOS padding as one left-aligned code at total_bits: the low pad_len
    bits of eos_padding, pad_len = (8 - total_bits % 8) % 8. Returns
    (left-aligned pattern, pad_len), ints for an int ``total_bits`` and
    int64 tensors for a tensor (no pad: both 0)."""
    pad_len = (8 - total_bits % 8) % 8
    low = eos_padding & ((1 << pad_len) - 1)
    return (low << (32 - pad_len)) & MASK32, pad_len


def _check_pack(symbols: torch.Tensor, dt, tile_offs: torch.Tensor, n_words: int,
                block_symbols: int | None, out: torch.Tensor | None) -> None:
    _check(symbols, dt)
    if tile_offs.dtype != torch.int64 or tile_offs.numel() != n_tiles(symbols.numel()):
        raise ValueError("tile_offs must be int64[ceil(n / TILE)]")
    if block_symbols is not None and block_symbols < 1:
        raise ValueError(f"block_symbols must be >= 1, got {block_symbols}")
    if out is not None and (out.dtype != torch.int32 or out.shape != (n_words,)
                            or not out.is_contiguous() or out.device != symbols.device):
        raise ValueError("out must be a contiguous int32[n_words] tensor on the symbols' device")


def _launch(symbols: torch.Tensor, dt, tile_offs: torch.Tensor, total_bits: int,
            total_dev: torch.Tensor | None, eos_padding: int, n_words: int,
            block_symbols: int | None, out: torch.Tensor | None,
            padded_out: torch.Tensor | None):
    """One launch of the pack kernel, the total by value or (``total_dev``)
    from device memory. Returns (words, block_offs or None)."""
    n = symbols.numel()
    tile_offs = tile_offs.contiguous()
    words = torch.empty(n_words, dtype=torch.int32, device=symbols.device) if out is None else out
    block_offs = None
    if block_symbols is not None:
        block_offs = torch.empty(-(-n // block_symbols), dtype=torch.int64,
                                 device=symbols.device)
    stream = torch.cuda.current_stream(symbols.device).cuda_stream
    err = _build.load().thc_encode_pack(
        symbols.device.index, symbols.data_ptr(), n, dt.patterns.data_ptr(),
        dt.lengths.data_ptr(), tile_offs.data_ptr(), total_bits, eos_padding & 0xFF,
        words.data_ptr(), n_words, block_symbols or 0,
        None if block_offs is None else block_offs.data_ptr(),
        None if total_dev is None else total_dev.data_ptr(),
        None if padded_out is None else padded_out.data_ptr(), stream,
    )
    _build.check("thc_encode_pack", err)
    launches["encode_pack"] += 1
    return words, block_offs


def pack(symbols: torch.Tensor, dt, tile_offs: torch.Tensor, total_bits: int,
         eos_padding: int, n_words: int, block_symbols: int | None = None,
         out: torch.Tensor | None = None):
    """Pack the stream into int32[n_words] words (bit patterns of uint32).

    ``tile_offs`` (int64) is every tile's first bit: the exclusive prefix of
    :func:`count`'s totals, shifted by any bits the caller puts before the
    stream (they stay zero here); ``total_bits`` is where the codes end and
    the EOS pad code goes; ``n_words`` must cover the padded length. Every
    word is written, zeros past the pad. ``out`` (int32[n_words]) takes the
    words in place of a new tensor. Returns (words, block_offs): the first
    bit of every ``block_symbols``-th symbol (int64[ceil(n / block_symbols)]),
    or None without ``block_symbols``.
    """
    _check_pack(symbols, dt, tile_offs, n_words, block_symbols, out)
    if 32 * n_words < total_bits + pad_code(total_bits, eos_padding)[1]:
        raise ValueError("n_words does not cover the padded stream")
    if not _cuda(symbols):
        words, block_offs = pack_plain(symbols, dt, tile_offs, total_bits, eos_padding,
                                       n_words, block_symbols)
        return (words if out is None else out.copy_(words)), block_offs
    return _launch(symbols, dt, tile_offs, total_bits, None, eos_padding, n_words,
                   block_symbols, out, None)


def pack_device_total(symbols: torch.Tensor, dt, tile_offs: torch.Tensor,
                      total_bits: torch.Tensor, eos_padding: int, n_words: int,
                      block_symbols: int | None = None, out: torch.Tensor | None = None):
    """:func:`pack` with the stream's length as a one-element int64 tensor on
    the symbols' device (the inclusive prefix's last element), which the
    kernel reads there: nothing waits for the device. Returns (words,
    block_offs or None, padded_bits), ``padded_bits`` a 0-d int64 tensor on
    the device.

    The host cannot check ``n_words`` against a length it does not read:
    it must cover n codes of the table's longest length and the pad, as
    ``best_encode_step``'s fixed word count does (the kernel writes no
    word past ``n_words`` whatever the length).
    """
    _check_pack(symbols, dt, tile_offs, n_words, block_symbols, out)
    if (total_bits.dtype != torch.int64 or total_bits.numel() != 1
            or total_bits.device != symbols.device):
        raise ValueError("total_bits must be a one-element int64 tensor on the symbols' device")
    if 32 * n_words < symbols.numel() * int(dt.table.max_len) + 7:
        raise ValueError("n_words does not cover n codes of the longest length and the pad")
    total_bits = total_bits.reshape(())
    if not _cuda(symbols):
        words, block_offs = pack_plain(symbols, dt, tile_offs, total_bits, eos_padding,
                                       n_words, block_symbols)
        padded = total_bits + pad_code(total_bits, eos_padding)[1]
        return (words if out is None else out.copy_(words)), block_offs, padded
    padded = torch.empty((), dtype=torch.int64, device=symbols.device)
    words, block_offs = _launch(symbols, dt, tile_offs, 0, total_bits, eos_padding, n_words,
                                block_symbols, out, padded)
    return words, block_offs, padded


def symbol_starts(symbols: torch.Tensor, dt, offs: torch.Tensor, group: int) -> torch.Tensor:
    """Each symbol's first bit (int64): ``offs[i // group]`` plus the code
    lengths before it in its group of ``group`` symbols."""
    grid = group_lengths(symbols, dt, group)
    return (offs[:, None] + torch.cumsum(grid, 1) - grid).reshape(-1)[: symbols.numel()]


def place_codes(symbols: torch.Tensor, dt, starts: torch.Tensor, total_bits,
                eos_padding: int, n_words: int) -> torch.Tensor:
    """The int32[n_words] words of each symbol's code at its first bit
    ``starts`` and the EOS pad code at ``total_bits`` (an int, or a 0-d
    int64 tensor): a gather, a hi/lo split at the word boundary, and an
    int64 ``index_add_`` (codes never share bits, so adding is OR)."""
    dev = symbols.device
    idx = symbols.to(torch.int64)
    lens = dt.lengths.to(torch.int64)[idx]
    pats = u32(dt.patterns)[idx]
    p32 = torch.where(lens > 0, (pats << (32 - lens)) & MASK32, 0)
    pad_p32, _ = pad_code(total_bits, eos_padding)

    def one(v):
        return torch.as_tensor(v, dtype=torch.int64, device=dev).reshape(1)

    p32 = torch.cat([p32, one(pad_p32)])
    starts = torch.cat([starts, one(total_bits)])
    widx = starts >> 5
    sh = starts & 31
    hi = p32 >> sh
    lo = (p32 << (32 - sh)) & MASK32
    # Two spare words take the zero `lo` halves of codes ending on the last
    # word boundary.
    words = torch.zeros(n_words + 2, dtype=torch.int64, device=dev)
    words.index_add_(0, widx, hi)
    words.index_add_(0, widx + 1, lo)
    return i32(words[:n_words])


def pack_plain(symbols: torch.Tensor, dt, tile_offs: torch.Tensor, total_bits,
               eos_padding: int, n_words: int, block_symbols: int | None = None):
    """Plain version of :func:`pack` and, with ``total_bits`` a 0-d int64
    tensor, of :func:`pack_device_total`'s words: the port of the JAX package's
    ``encode_block_kernel_indexed`` (ops/encode.py): each symbol's first bit
    from the tile offsets and an int64 cumsum, the codes placed by
    :func:`place_codes`, and the block offsets sampled every
    ``block_symbols`` symbols."""
    starts = symbol_starts(symbols, dt, tile_offs, TILE)
    words = place_codes(symbols, dt, starts, total_bits, eos_padding, n_words)
    return words, None if block_symbols is None else starts[::block_symbols].clone()

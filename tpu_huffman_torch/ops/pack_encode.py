"""Encode kernels and their plain versions (replaces the Pallas pack kernel
B1 of ``tpu_huffman/ops/pallas_encode.py``: ``_make_pack_call`` with its
XLA half ``_encode_pipeline`` and ``_pad_code``; the kernels take any table,
as B1 does).

Two kernels, in ``csrc/pack_encode.cu``:

* :func:`count` — the bit total of every chunk of ``chunk`` symbols, plus
  ``stats = [first unknown symbol's index (n if none), longest code]``;
* :func:`pack` — each chunk's codes MSB-first at its global bit offset, and
  the EOS pad code at ``total_bits``.

Between them the caller takes the exclusive prefix over chunks with
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

THREADS = 256  # CUDA threads (chunks) per grid block, as in the .cu source
launches = {"encode_count": 0, "encode_pack": 0}


def chunk_symbols(block_symbols: int) -> int:
    """Symbols per kernel thread: the largest of 32, 16, ..., 1 that divides
    ``block_symbols``, so every index block starts on a chunk."""
    if block_symbols < 1:
        raise ValueError(f"block_symbols must be >= 1, got {block_symbols}")
    return next(c for c in (32, 16, 8, 4, 2, 1) if block_symbols % c == 0)


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


def count(symbols: torch.Tensor, dt, chunk: int):
    """Per-chunk bit totals (int32[ceil(n/chunk)]) and stats (int64[2])."""
    _check(symbols, dt)
    if not _cuda(symbols):
        return count_plain(symbols, dt, chunk)
    n = symbols.numel()
    n_chunks = -(-n // chunk)
    chunk_bits = torch.empty(n_chunks, dtype=torch.int32, device=symbols.device)
    stats = torch.zeros(2, dtype=torch.int64, device=symbols.device)
    stats[0] = n  # no unknown symbol yet; a fill, not a host copy
    stream = torch.cuda.current_stream(symbols.device).cuda_stream
    err = _build.load().thc_encode_count(
        symbols.device.index, symbols.data_ptr(), n, chunk, dt.lengths.data_ptr(),
        chunk_bits.data_ptr(), stats.data_ptr(), stream,
    )
    _build.check("thc_encode_count", err)
    launches["encode_count"] += 1
    return chunk_bits, stats


def count_plain(symbols: torch.Tensor, dt, chunk: int):
    """Plain version of :func:`count`."""
    n = symbols.numel()
    n_chunks = -(-n // chunk)
    lens = dt.lengths.to(torch.int64)[symbols.to(torch.int64)]
    padded = torch.zeros(n_chunks * chunk, dtype=torch.int64, device=symbols.device)
    padded[:n] = lens
    chunk_bits = padded.view(n_chunks, chunk).sum(1).to(torch.int32)
    pos = torch.arange(n, device=symbols.device)
    first_bad = torch.where(lens == 0, pos, n).min()
    stats = torch.stack([first_bad, lens.max()])
    return chunk_bits, stats


def pad_code(total_bits: int, eos_padding: int) -> tuple[int, int]:
    """EOS padding as one left-aligned code at total_bits: the low pad_len
    bits of eos_padding, pad_len = (8 - total_bits % 8) % 8. Returns
    (left-aligned pattern, pad_len)."""
    pad_len = (8 - total_bits % 8) % 8
    if pad_len == 0:
        return 0, 0
    low = eos_padding & ((1 << pad_len) - 1)
    return (low << (32 - pad_len)) & MASK32, pad_len


def pack(symbols: torch.Tensor, dt, chunk: int, chunk_offs: torch.Tensor,
         total_bits: int, eos_padding: int, n_words: int) -> torch.Tensor:
    """Pack the stream into int32[n_words] words (bit patterns of uint32).

    ``chunk_offs`` (int64) is every chunk's exclusive starting bit;
    ``total_bits`` is the stream's unpadded length; ``n_words`` must cover
    the padded length.
    """
    _check(symbols, dt)
    n = symbols.numel()
    if chunk_offs.dtype != torch.int64 or chunk_offs.numel() != -(-n // chunk):
        raise ValueError("chunk_offs must be int64[ceil(n / chunk)]")
    if 32 * n_words < total_bits + pad_code(total_bits, eos_padding)[1]:
        raise ValueError("n_words does not cover the padded stream")
    if not _cuda(symbols):
        return pack_plain(symbols, dt, chunk, chunk_offs, total_bits, eos_padding, n_words)
    chunk_offs = chunk_offs.contiguous()
    words = torch.zeros(n_words, dtype=torch.int32, device=symbols.device)
    stream = torch.cuda.current_stream(symbols.device).cuda_stream
    err = _build.load().thc_encode_pack(
        symbols.device.index, symbols.data_ptr(), n, chunk, dt.patterns.data_ptr(),
        dt.lengths.data_ptr(), chunk_offs.data_ptr(), total_bits,
        eos_padding & 0xFF, words.data_ptr(), n_words, stream,
    )
    _build.check("thc_encode_pack", err)
    launches["encode_pack"] += 1
    return words


def pack_plain(symbols: torch.Tensor, dt, chunk: int, chunk_offs: torch.Tensor,
               total_bits: int, eos_padding: int, n_words: int) -> torch.Tensor:
    """Plain version of :func:`pack`: the port of the JAX package's
    ``encode_block_kernel_indexed`` (ops/encode.py) — a gather, an int64
    cumsum, a hi/lo split at the word boundary, and an int64 ``index_add_``
    (codes never share bits, so adding is OR)."""
    dev = symbols.device
    n = symbols.numel()
    n_chunks = chunk_offs.numel()
    idx = symbols.to(torch.int64)
    lens = dt.lengths.to(torch.int64)[idx]
    pats = u32(dt.patterns)[idx]
    padded = torch.zeros(n_chunks * chunk, dtype=torch.int64, device=dev)
    padded[:n] = lens
    grid = padded.view(n_chunks, chunk)
    starts = (chunk_offs[:, None] + torch.cumsum(grid, 1) - grid).reshape(-1)[:n]
    p32 = torch.where(lens > 0, (pats << (32 - lens)) & MASK32, 0)
    pad_p32, _ = pad_code(total_bits, eos_padding)
    p32 = torch.cat([p32, torch.tensor([pad_p32], dtype=torch.int64, device=dev)])
    starts = torch.cat([starts, torch.tensor([total_bits], dtype=torch.int64, device=dev)])
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

"""Peaks of the card and the bytes each stage of a request needs.

The codec's kernels are bound by memory traffic (every count, pack and
decode kernel reads and writes a few bytes a symbol and computes a few
integer operations on them), so a stage's least time is the bytes the
request needs over the card's memory bandwidth. The bytes count the work
the request asks for, not what a kernel happens to do: each input byte
read once, each output byte written once, whatever implements them.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (HBM3) data sheet: memory bandwidth at the card's
# full 700 W power limit. The run's line records the card's name and the
# PERF.md entry its power limit.
HBM_BYTES_PER_S = 3.35e12
INDEX_BYTES_PER_BLOCK = 12  # a BlockIndex entry: int64 start bit + int32 count


def encode_bytes(plain: int, compressed: int, blocks: int = 0) -> int:
    """Encode: the plaintext read, the stream written, and the index."""
    return plain + compressed + INDEX_BYTES_PER_BLOCK * blocks


def decode_bytes(compressed: int, plain: int, blocks: int = 0) -> int:
    """Decode: the stream (and the index) read, the plaintext written."""
    return compressed + INDEX_BYTES_PER_BLOCK * blocks + plain


def roofline_pct(nbytes: int, device_s: float) -> float | None:
    """The share of the least time that the device time reaches, in %."""
    if not nbytes or device_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s

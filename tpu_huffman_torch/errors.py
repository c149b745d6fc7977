"""Error types of the PyTorch port (ports ``tpu_huffman/errors.py``).

The same four classes with the same constructor signatures, so callers can
treat both packages alike. Kernels report these conditions through device
flags that the host wrappers turn into raises.
"""

from __future__ import annotations


class CompressionError(Exception):
    """Base class for all codec errors."""


class UnknownSymbolError(CompressionError):
    """A symbol with no code in the table was met (on encode), or a window
    that no code matches was met inside an indexed block, or with 32 or more
    bits left in a stream with no index (on decode)."""

    def __init__(self, index: int | None = None, symbol: int | None = None):
        self.index = index
        self.symbol = symbol
        loc = "" if index is None else f" at input index {index}"
        sym = "" if symbol is None else f" (symbol {symbol})"
        super().__init__(f"unknown symbol{sym}{loc}")


class ShortBufferError(CompressionError):
    """Output buffer capacity exhausted; call again with more room."""


class TableError(CompressionError):
    """A symbol table failed validation (not prefix-free, bad lengths...)."""

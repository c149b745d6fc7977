"""Symbol tables of the PyTorch port (ports ``tpu_huffman/tables.py``).

A :class:`HuffmanTable` holds the encode arrays (``patterns``: uint32
right-aligned code bits, ``lengths``: int32, 0 = no code) and the two-level
decode LUT, all as numpy arrays: tables are host data, staged on a device
by the ops that use them.

Decode LUT layout (the same as the JAX package's):
  Level 0 is indexed by the top ``root_bits`` bits of a 32-bit MSB-aligned
  window. Each entry is a pair ``(bits, val)``:
    * ``bits > 0``  — leaf: ``val`` is the symbol, ``bits`` is bits_read.
    * ``bits == 0`` — invalid: no code has this prefix (unknown symbol).
    * ``bits < 0``  — pointer: ``-bits`` is the subtable width ``w``; the
      subtable occupies ``l1[val : val + 2**w]`` and is indexed by the
      ``w`` window bits that follow the root bits.
  Level-1 entries are ``(bits_read, symbol)`` leaves or 0 = invalid.

The table data files are read from ``tpu_huffman/data/`` by path; this
module imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Sequence

import numpy as np

from .errors import TableError

MAX_CODE_BITS = 32
NUM_SYMBOLS = 256
DEFAULT_ROOT_BITS = 12

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tpu_huffman",
    "data",
)


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """One symbol's code: right-aligned ``pattern`` spanning ``num_bits``."""

    symbol: int
    num_bits: int
    pattern: int

    def __post_init__(self):
        if not 0 <= self.symbol < NUM_SYMBOLS:
            raise TableError(f"symbol {self.symbol} out of range")
        if not 1 <= self.num_bits <= MAX_CODE_BITS:
            raise TableError(f"code length {self.num_bits} out of range [1,32]")
        if self.pattern >> self.num_bits:
            raise TableError(
                f"pattern {self.pattern:#x} wider than num_bits={self.num_bits}"
            )


def parse_tsv(text: str) -> list[CodeSpec]:
    """Parse the native TSV table artifact: ``symbol\\tnum_bits\\thex``."""
    specs = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        sym, nbits, pat = line.split("\t")
        specs.append(CodeSpec(int(sym), int(nbits), int(pat, 16)))
    return specs


def _build_decode_lut(
    lengths: np.ndarray, patterns: np.ndarray, root_bits: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Build the two-level decode LUT, validating that the code is prefix-free.

    Returns (l0_bits, l0_val, l1_bits, l1_val, root_bits).
    """
    max_len = int(lengths.max()) if lengths.any() else 1
    root_bits = min(root_bits, max(max_len, 1))
    size0 = 1 << root_bits
    l0_bits = np.zeros(size0, dtype=np.int32)
    l0_val = np.zeros(size0, dtype=np.int32)

    # Long codes are grouped by their root prefix to size the subtables.
    long_by_prefix: dict[int, list[int]] = {}
    for sym in range(NUM_SYMBOLS):
        ln = int(lengths[sym])
        if ln == 0:
            continue
        pat = int(patterns[sym])
        if ln <= root_bits:
            lo = pat << (root_bits - ln)
            hi = (pat + 1) << (root_bits - ln)
            if l0_bits[lo:hi].any():
                raise TableError(f"table is not prefix-free at symbol {sym}")
            l0_bits[lo:hi] = ln
            l0_val[lo:hi] = sym
        else:
            long_by_prefix.setdefault(pat >> (ln - root_bits), []).append(sym)

    l1_bits_parts: list[np.ndarray] = []
    l1_val_parts: list[np.ndarray] = []
    base = 0
    for prefix, syms in sorted(long_by_prefix.items()):
        if l0_bits[prefix] != 0:
            raise TableError(
                f"table is not prefix-free: prefix {prefix:0{root_bits}b} is both "
                f"a code and a prefix of longer codes"
            )
        width = max(int(lengths[s]) for s in syms) - root_bits
        sub_bits = np.zeros(1 << width, dtype=np.int32)
        sub_val = np.zeros(1 << width, dtype=np.int32)
        for sym in syms:
            ln = int(lengths[sym])
            rest = int(patterns[sym]) & ((1 << (ln - root_bits)) - 1)
            lo = rest << (width - (ln - root_bits))
            hi = (rest + 1) << (width - (ln - root_bits))
            if sub_bits[lo:hi].any():
                raise TableError(f"table is not prefix-free at symbol {sym}")
            sub_bits[lo:hi] = ln
            sub_val[lo:hi] = sym
        l0_bits[prefix] = -width
        l0_val[prefix] = base
        l1_bits_parts.append(sub_bits)
        l1_val_parts.append(sub_val)
        base += 1 << width

    if l1_bits_parts:
        l1_bits = np.concatenate(l1_bits_parts)
        l1_val = np.concatenate(l1_val_parts)
    else:  # keep shapes non-empty so gathers stay trivially valid
        l1_bits = np.zeros(1, dtype=np.int32)
        l1_val = np.zeros(1, dtype=np.int32)
    return l0_bits, l0_val, l1_bits.astype(np.int32), l1_val.astype(np.int32), root_bits


@dataclasses.dataclass(frozen=True)
class HuffmanTable:
    """A compiled symbol table: encode arrays + flattened decode LUT."""

    patterns: np.ndarray  # uint32[256], right-aligned code bits
    lengths: np.ndarray  # int32[256], 0 = no code for this symbol
    l0_bits: np.ndarray  # int32[2^root_bits]
    l0_val: np.ndarray
    l1_bits: np.ndarray
    l1_val: np.ndarray
    root_bits: int
    max_len: int
    min_len: int
    name: str = "table"

    @staticmethod
    def from_specs(
        specs: Iterable[CodeSpec],
        name: str = "table",
        root_bits: int = DEFAULT_ROOT_BITS,
    ) -> "HuffmanTable":
        patterns = np.zeros(NUM_SYMBOLS, dtype=np.uint32)
        lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
        for spec in specs:
            if lengths[spec.symbol]:
                raise TableError(f"symbol {spec.symbol} defined twice")
            patterns[spec.symbol] = spec.pattern
            lengths[spec.symbol] = spec.num_bits
        if not lengths.any():
            raise TableError("table defines no codes")
        l0b, l0v, l1b, l1v, rb = _build_decode_lut(lengths, patterns, root_bits)
        nz = lengths[lengths > 0]
        return HuffmanTable(
            patterns=patterns,
            lengths=lengths,
            l0_bits=l0b,
            l0_val=l0v,
            l1_bits=l1b,
            l1_val=l1v,
            root_bits=rb,
            max_len=int(nz.max()),
            min_len=int(nz.min()),
            name=name,
        )

    @staticmethod
    def from_tsv_file(path: str, name: str | None = None) -> "HuffmanTable":
        with open(path) as f:
            specs = parse_tsv(f.read())
        return HuffmanTable.from_specs(
            specs, name=name or os.path.splitext(os.path.basename(path))[0]
        )

    def specs(self) -> list[CodeSpec]:
        return [
            CodeSpec(s, int(self.lengths[s]), int(self.patterns[s]))
            for s in range(NUM_SYMBOLS)
            if self.lengths[s]
        ]

    def decode_window(self, bits32: int) -> tuple[int, int]:
        """Decode a 32-bit MSB-aligned window. Returns (symbol, bits_read);
        bits_read == 0 means no code matches."""
        idx = (bits32 >> (32 - self.root_bits)) & ((1 << self.root_bits) - 1)
        b = int(self.l0_bits[idx])
        v = int(self.l0_val[idx])
        if b >= 0:
            return (v, b) if b else (0, 0)
        width = -b
        shifted = (bits32 << self.root_bits) & 0xFFFFFFFF
        sub = shifted >> (32 - width)
        b1 = int(self.l1_bits[v + sub])
        return (int(self.l1_val[v + sub]), b1) if b1 else (0, 0)


def from_reference(table) -> HuffmanTable:
    """The port's table for a JAX-package ``HuffmanTable``.

    Reads only the reference's numpy arrays (``patterns``, ``lengths``) and
    its ``name`` and ``root_bits``, and rebuilds (and re-validates) the
    decode LUT, so the JAX package is never imported here.
    """
    lengths = np.asarray(table.lengths, dtype=np.int32)
    patterns = np.asarray(table.patterns, dtype=np.uint32)
    specs = [
        CodeSpec(s, int(lengths[s]), int(patterns[s]))
        for s in range(NUM_SYMBOLS)
        if lengths[s]
    ]
    return HuffmanTable.from_specs(
        specs, name=str(table.name), root_bits=int(table.root_bits)
    )


def make_canonical(
    code_lengths: Sequence[int] | dict[int, int], name: str = "canonical"
) -> HuffmanTable:
    """Build a canonical prefix code from per-symbol code lengths (0 = absent):
    codes are assigned in (length, symbol) order. Validates Kraft's
    inequality."""
    if isinstance(code_lengths, dict):
        lens = [0] * NUM_SYMBOLS
        for s, l in code_lengths.items():
            lens[s] = l
    else:
        lens = list(code_lengths) + [0] * (NUM_SYMBOLS - len(code_lengths))
    kraft = sum(2.0 ** -l for l in lens if l > 0)
    if kraft > 1.0 + 1e-12:
        raise TableError(f"code lengths violate Kraft inequality (sum={kraft})")
    specs = []
    code = 0
    prev_len = 0
    for l, s in sorted((l, s) for s, l in enumerate(lens) if l > 0):
        code <<= l - prev_len
        specs.append(CodeSpec(s, l, code))
        code += 1
        prev_len = l
    return HuffmanTable.from_specs(specs, name=name)


def load_static_test_table() -> HuffmanTable:
    """The 256-symbol static test table (max code length 10)."""
    return HuffmanTable.from_tsv_file(
        os.path.join(_DATA_DIR, "static_table.tsv"), name="static_test"
    )


def load_hpack_table() -> HuffmanTable:
    """The RFC 7541 (HPACK) Appendix B static Huffman table, symbols 0-255
    (max code length 30). Its EOS padding is all ones, the default
    ``eos_padding=0xFF``."""
    return HuffmanTable.from_tsv_file(
        os.path.join(_DATA_DIR, "hpack_rfc7541.tsv"), name="hpack_rfc7541"
    )

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
import re
from typing import Iterable, Sequence

import numpy as np

from .errors import TableError

MAX_CODE_BITS = 32
NUM_SYMBOLS = 256
DEFAULT_ROOT_BITS = 12

_DEF_CODE_RE = re.compile(
    r'HUFFMAN_CODE\(\s*(\d+)\s*,\s*"([01]*)"\s*,\s*(0[xX][0-9a-fA-F]+|\d+)\s*,\s*(\d+)\s*\)'
)

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


def parse_def(text: str) -> list[CodeSpec]:
    """Parse the reference ``.def`` table format: lines of
    ``HUFFMAN_CODE(symbol, "bitstring", hex_pattern, num_bits)``, ignoring
    ``#`` preprocessor lines and ``/* ... */`` comments. A bit string that
    disagrees with its pattern, or a symbol defined twice, raises
    TableError."""
    stripped = re.sub(r"/\*.*?\*/", " ", text, flags=re.DOTALL)
    specs: list[CodeSpec] = []
    seen: set[int] = set()
    for line in stripped.splitlines():
        if line.lstrip().startswith("#"):
            continue
        for m in _DEF_CODE_RE.finditer(line):
            sym = int(m.group(1))
            bit_str = m.group(2)
            pattern = int(m.group(3), 0)
            num_bits = int(m.group(4))
            if bit_str and (len(bit_str) != num_bits or int(bit_str, 2) != pattern):
                raise TableError(
                    f"symbol {sym}: bit string {bit_str!r} disagrees with "
                    f"pattern={pattern:#x} num_bits={num_bits}"
                )
            if sym in seen:
                raise TableError(f"symbol {sym} defined twice")
            seen.add(sym)
            specs.append(CodeSpec(sym, num_bits, pattern))
    return specs


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
    def from_def_file(path: str, name: str | None = None) -> "HuffmanTable":
        with open(path) as f:
            specs = parse_def(f.read())
        return HuffmanTable.from_specs(
            specs, name=name or os.path.splitext(os.path.basename(path))[0]
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

    def to_tsv(self) -> str:
        lines = ["# symbol\tnum_bits\tpattern_hex"]
        for spec in self.specs():
            lines.append(f"{spec.symbol}\t{spec.num_bits}\t{spec.pattern:x}")
        return "\n".join(lines) + "\n"

    def save(self, path: str) -> None:
        """Persist as an .npz artifact, with the JAX package's keys, so each
        package loads the other's files."""
        np.savez(
            path,
            patterns=self.patterns,
            lengths=self.lengths,
            l0_bits=self.l0_bits,
            l0_val=self.l0_val,
            l1_bits=self.l1_bits,
            l1_val=self.l1_val,
            root_bits=np.int32(self.root_bits),
            name=np.array(self.name),
        )

    @staticmethod
    def load(path: str) -> "HuffmanTable":
        z = np.load(path, allow_pickle=False)
        lengths = z["lengths"]
        nz = lengths[lengths > 0]
        return HuffmanTable(
            patterns=z["patterns"],
            lengths=lengths,
            l0_bits=z["l0_bits"],
            l0_val=z["l0_val"],
            l1_bits=z["l1_bits"],
            l1_val=z["l1_val"],
            root_bits=int(z["root_bits"]),
            max_len=int(nz.max()),
            min_len=int(nz.min()),
            name=str(z["name"]),
        )

    def encode_symbol(self, symbol: int) -> tuple[int, int]:
        """Return (pattern, num_bits); num_bits == 0 means unknown symbol."""
        return int(self.patterns[symbol]), int(self.lengths[symbol])

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


def optimal_code_lengths(
    freqs: Sequence[int] | np.ndarray, max_len: int = MAX_CODE_BITS
) -> np.ndarray:
    """Optimal length-limited prefix-code lengths by package-merge.

    Returns int32[256] lengths (0 for zero-frequency symbols), minimising
    the encoded size subject to ``max_len``, ready for
    :func:`make_canonical`. Raises TableError when no frequency is nonzero
    or the alphabet cannot fit in ``max_len`` bits.
    """
    f = np.zeros(NUM_SYMBOLS, dtype=np.int64)
    fin = np.asarray(freqs, dtype=np.int64)
    f[: fin.size] = fin
    active = np.flatnonzero(f > 0)
    n = active.size
    if n == 0:
        raise TableError("no symbols with nonzero frequency")
    if n == 1:
        lens = np.zeros(NUM_SYMBOLS, dtype=np.int32)
        lens[active[0]] = 1
        return lens
    if (1 << max_len) < n:
        raise TableError(f"{n} symbols cannot fit in {max_len}-bit codes")

    # Level l holds items of width 2^-l; adjacent pairs of a level's items
    # make the packages of the level above. Each item counts how often each
    # leaf takes part in it; a leaf's code length is its count over the
    # cheapest 2n - 2 items of the top level.
    leaves = sorted((int(f[s]), s) for s in active)
    leaf_weights = [w for w, _ in leaves]
    leaf_syms = [s for _, s in leaves]

    def merge_level(packages):
        """Merge the leaves with the packages (both sorted by weight)."""
        items = []
        i = j = 0
        while i < n or j < len(packages):
            take_leaf = j >= len(packages) or (
                i < n and leaf_weights[i] <= packages[j][0]
            )
            if take_leaf:
                cnt = np.zeros(n, dtype=np.int32)
                cnt[i] = 1
                items.append((leaf_weights[i], cnt))
                i += 1
            else:
                items.append(packages[j])
                j += 1
        return items

    packages: list = []
    for _ in range(max_len):
        items = merge_level(packages)
        packages = [
            (items[2 * k][0] + items[2 * k + 1][0],
             items[2 * k][1] + items[2 * k + 1][1])
            for k in range(len(items) // 2)
        ]
    counts = np.zeros(n, dtype=np.int32)
    for _w, cnt in items[: 2 * n - 2]:
        counts += cnt
    lens = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    for k in range(n):
        lens[leaf_syms[k]] = int(counts[k])
    return lens


def build_table(
    data: bytes | np.ndarray | None = None,
    freqs: Sequence[int] | np.ndarray | None = None,
    max_len: int = 16,
    name: str = "built",
) -> HuffmanTable:
    """An optimal length-limited canonical table from ``data``'s histogram
    or from ``freqs`` (pass exactly one). Symbols absent from the corpus
    get no code: encoding them raises UnknownSymbolError."""
    if (data is None) == (freqs is None):
        raise TableError("pass exactly one of data / freqs")
    if data is not None:
        arr = (
            np.frombuffer(bytes(data), dtype=np.uint8)
            if isinstance(data, (bytes, bytearray))
            else np.asarray(data, dtype=np.uint8)
        )
        freqs = np.bincount(arr, minlength=NUM_SYMBOLS)
    lens = optimal_code_lengths(freqs, max_len=max_len)
    return make_canonical(lens.tolist(), name=name)


def safe_eos_padding(table: HuffmanTable) -> int | None:
    """An eos_padding byte whose padding bits can never decode as a symbol.

    The reference pads the final partial byte with the low ``8 - (bits %
    8)`` bits of ``eos_padding`` and leaves validating them to the caller,
    so where all-ones padding completes a short code, a decode with no
    index emits spurious tail symbols. This returns the first byte whose
    every padding tail (1..7 bits, MSB-first) matches no complete code, or
    None when there is none (e.g. Kraft-complete tables whose codes are all
    <= 7 bits).
    """
    for eos in range(256):
        ok = True
        for k in range(1, 8):
            pad = eos & ((1 << k) - 1)
            window = (pad << (32 - k)) & 0xFFFFFFFF
            _sym, bits_read = table.decode_window(window)
            if 0 < bits_read <= k:
                ok = False
                break
        if ok:
            return eos
    return None


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

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
import time
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


def _tsv_rows(text: str) -> list[tuple[int, int, int]]:
    """The ``(symbol, num_bits, pattern)`` rows of a TSV table, each checked
    as :class:`CodeSpec` checks it (the first bad row raises its error)."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        sym, nbits, pat = line.split("\t")
        rows.append((int(sym), int(nbits), int(pat, 16)))
    for row in rows:
        s, n, p = row
        if not (0 <= s < NUM_SYMBOLS and 1 <= n <= MAX_CODE_BITS) or p >> n:
            CodeSpec(*row)  # raises
    return rows


def parse_tsv(text: str) -> list[CodeSpec]:
    """Parse the native TSV table artifact: ``symbol\\tnum_bits\\thex``."""
    return [CodeSpec(*row) for row in _tsv_rows(text)]


def _fill(size: int, lo: np.ndarray, count: np.ndarray, *values: np.ndarray) -> list:
    """For each of ``values``: an int32 array of ``size`` entries holding
    ``values[k]`` over ``[lo[k], lo[k] + count[k])`` and 0 elsewhere. The
    ranges are disjoint and ``lo`` ascending."""
    gaps = lo - np.concatenate(([0], lo[:-1] + count[:-1]))
    runs = np.empty(2 * lo.size + 1, dtype=np.int64)
    runs[0:-1:2], runs[1::2], runs[-1] = gaps, count, size - (lo[-1] + count[-1] if lo.size else 0)
    out = []
    for v in values:
        run_values = np.zeros(runs.size, dtype=np.int32)
        run_values[1::2] = v
        out.append(np.repeat(run_values, runs))
    return out


def _build_decode_lut(
    lengths: np.ndarray, patterns: np.ndarray, root_bits: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Build the two-level decode LUT, validating that the code is prefix-free.

    Each code is a range of windows: at level 0 the root prefixes it
    covers, or, for a code longer than ``root_bits``, one entry of its
    prefix pointing at a subtable as wide as the longest code under that
    prefix; the subtables lie in ``l1`` in prefix order. The arrays are
    runs of those ranges (no loop over symbols).

    Returns (l0_bits, l0_val, l1_bits, l1_val, root_bits).
    """
    max_len = int(lengths.max()) if lengths.any() else 1
    root_bits = min(root_bits, max(max_len, 1))
    syms = np.flatnonzero(lengths)
    ln = lengths[syms].astype(np.int64)
    pat = patterns[syms].astype(np.int64)

    # prefix-free: the codes' ranges of max_len-bit windows are disjoint
    order = np.lexsort((syms, pat << (max_len - ln)))
    lo = pat[order] << (max_len - ln[order])
    clash = np.flatnonzero(lo[1:] < (lo[:-1] + (np.int64(1) << (max_len - ln[order][:-1]))))
    if clash.size:
        sym = int(np.max(syms[order][clash[:, None] + [0, 1]], axis=1).min())
        raise TableError(f"table is not prefix-free at symbol {sym}")

    short = ln <= root_bits
    width0 = root_bits - ln[short]
    entries = [(pat[short] << width0, np.int64(1) << width0, ln[short], syms[short])]
    l1_bits = l1_val = np.zeros(1, dtype=np.int32)  # keep shapes non-empty for gathers
    if not short.all():
        lng, lln, lpat = syms[~short], ln[~short], pat[~short]
        prefix, which = np.unique(lpat >> (lln - root_bits), return_inverse=True)
        width = np.zeros(prefix.size, dtype=np.int64)
        np.maximum.at(width, which, lln - root_bits)
        base = np.cumsum(np.int64(1) << width) - (np.int64(1) << width)
        entries.append((prefix, np.ones_like(prefix), -width, base))
        spare = width[which] - (lln - root_bits)  # subtable bits below each code's end
        rest = lpat & ((np.int64(1) << (lln - root_bits)) - 1)
        lo1 = base[which] + (rest << spare)
        o = np.argsort(lo1)
        l1_bits, l1_val = _fill(int(base[-1] + (1 << int(width[-1]))), lo1[o],
                                (np.int64(1) << spare)[o], lln[o], lng[o])
    lo0, count0, bits0, val0 = (np.concatenate(a) for a in zip(*entries))
    o = np.argsort(lo0)
    l0_bits, l0_val = _fill(1 << root_bits, lo0[o], count0[o], bits0[o], val0[o])
    return l0_bits, l0_val, l1_bits, l1_val, root_bits


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
    # host ns of its making, from the read of its file to the built LUT
    build_ns: int = dataclasses.field(default=0, compare=False, repr=False)
    # its ``DeviceTable`` per device (ops/encode.py), made at the first use
    # there and gone with the table
    staged: dict = dataclasses.field(default_factory=dict, init=False, compare=False,
                                     repr=False)

    @staticmethod
    def from_specs(
        specs: Iterable[CodeSpec],
        name: str = "table",
        root_bits: int = DEFAULT_ROOT_BITS,
    ) -> "HuffmanTable":
        t0 = time.perf_counter_ns()
        rows = [(spec.symbol, spec.num_bits, spec.pattern) for spec in specs]
        return HuffmanTable._from_rows(rows, name, root_bits, t0)

    @staticmethod
    def _from_rows(
        rows: list[tuple[int, int, int]], name: str, root_bits: int, t0: int
    ) -> "HuffmanTable":
        """The table of checked ``(symbol, num_bits, pattern)`` rows; ``t0``
        the clock (``perf_counter_ns``) at which its making began."""
        sym, nbits, pat = np.array(rows, dtype=np.int64).reshape(-1, 3).T
        order = np.argsort(sym, kind="stable")
        again = order[1:][sym[order][1:] == sym[order][:-1]]
        if again.size:
            raise TableError(f"symbol {int(sym[again.min()])} defined twice")
        if not sym.size:
            raise TableError("table defines no codes")
        patterns = np.zeros(NUM_SYMBOLS, dtype=np.uint32)
        lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
        patterns[sym] = pat
        lengths[sym] = nbits
        l0b, l0v, l1b, l1v, rb = _build_decode_lut(lengths, patterns, root_bits)
        return HuffmanTable(
            patterns=patterns,
            lengths=lengths,
            l0_bits=l0b,
            l0_val=l0v,
            l1_bits=l1b,
            l1_val=l1v,
            root_bits=rb,
            max_len=int(nbits.max()),
            min_len=int(nbits.min()),
            name=name,
            build_ns=time.perf_counter_ns() - t0,
        )

    @staticmethod
    def from_def_file(path: str, name: str | None = None) -> "HuffmanTable":
        t0 = time.perf_counter_ns()
        with open(path) as f:
            specs = parse_def(f.read())
        rows = [(spec.symbol, spec.num_bits, spec.pattern) for spec in specs]
        return HuffmanTable._from_rows(
            rows, name or os.path.splitext(os.path.basename(path))[0], DEFAULT_ROOT_BITS, t0
        )

    @staticmethod
    def from_tsv_file(path: str, name: str | None = None) -> "HuffmanTable":
        t0 = time.perf_counter_ns()
        with open(path) as f:
            rows = _tsv_rows(f.read())
        return HuffmanTable._from_rows(
            rows, name or os.path.splitext(os.path.basename(path))[0], DEFAULT_ROOT_BITS, t0
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

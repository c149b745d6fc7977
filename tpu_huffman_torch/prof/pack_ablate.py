"""The port's pack loops with parts removed (``csrc/probe_pack.cu``), the
counterpart of P5 ``scripts/prof/prof_pack_ablate.py:make_call`` (:38,
pallas_call :187), which ablated B1's loop on the TPU. Here the loops are
the port's own, in ``csrc/pack.cuh``. Modes, with their outputs:

* ``nop``: nothing read; (0, 0) per chunk;
* ``extract``: the sum of the chunk's symbol bytes, 0;
* ``lut``: the sum of the symbols' code lengths, the XOR of their
  patterns;
* ``lut4``: the same values from four interleaved accumulators;
* ``thread``: the stream's words by the earlier per-thread loop (one thread a
  chunk, chunk offsets, edge words ORed with global atomics into a zeroed
  output): the design the tile loop replaced;
* ``tile_scan``: the tile loop up to its block scan (the table in shared
  memory, the ``uint4`` loads, the lookups, the scan; the compiler drops
  the word buffer, which nothing reads there): each tile's bit total,
  int32 (as ``count``'s);
* ``full``: the stream's words by the tile loop, equal to ``encode_pack``'s.

The first four and ``thread`` run one thread a chunk of ``chunk`` symbols
(:data:`CHUNK` = 32, the chunk the per-thread design took at block_symbols
256); ``tile_scan`` and ``full`` run one block a 4096-symbol tile.

``python -m tpu_huffman_torch.prof.pack_ablate`` runs every mode on P5's
8 MiB (``default_rng(2024)``, the static table) against the plain version,
``thread`` and ``full`` against the pack kernel's words, ``thread`` at
chunks 32 and 4, and prints ms and GB/s a mode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..ops import pack_encode
from ..ops.bitpack import i32, u32
from ..ops.encode import DEFAULT_EOS_PADDING, DeviceTable
from ..tables import load_static_test_table
from . import card, check_equal, is_cuda, kernel_ms, median_ms, on_card, require_cuda

MODES = ("nop", "extract", "lut4", "lut", "thread", "tile_scan", "full")  # P5's (:211), then ours
_MODE_ID = {"nop": 0, "extract": 1, "lut": 2, "lut4": 3, "full": 4, "thread": 5, "tile_scan": 6}
CHUNK = 32  # symbols a thread in the per-thread modes
THREAD_CHUNKS = (32, 4)  # the per-thread design's chunk at block_symbols 256 and at 100
N = 8 << 20  # P5's symbols
launches = {"pack_ablate": 0}


def p5_inputs(n: int = N) -> np.ndarray:
    """prof_pack_ablate.py: n bytes from default_rng(2024)."""
    return np.random.default_rng(2024).integers(0, 256, size=n, dtype=np.uint8)


def layout(symbols: torch.Tensor, dt: DeviceTable, chunk: int | None = None):
    """(offsets int64, total_bits, n_words) of the stream: with no ``chunk``
    the tile offsets, by the count kernel (or its plain version) and
    torch.cumsum as the encoder takes them; with a ``chunk``, every chunk's
    first bit, by torch ops (the count of the per-thread design)."""
    if chunk is None:
        bits, _stats = pack_encode.count(symbols, dt)
    else:
        bits = pack_encode.group_lengths(symbols, dt, chunk).sum(1)
    incl = torch.cumsum(bits, 0, dtype=torch.int64)
    total = int(incl[-1])
    pad = pack_encode.pad_code(total, DEFAULT_EOS_PADDING)[1]
    return incl - bits, total, -(-(total + pad) // 32)


def _check(symbols: torch.Tensor, dt: DeviceTable, mode: str, chunk: int) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if symbols.dtype != torch.uint8 or symbols.dim() != 1 or not symbols.is_contiguous():
        raise ValueError("symbols must be a contiguous 1-D uint8 tensor")
    if symbols.numel() == 0 or dt.lengths.device != symbols.device:
        raise ValueError("symbols must be non-empty and on the table's device")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def pack_ablate(symbols: torch.Tensor, dt: DeviceTable, mode: str, lay=None,
                chunk: int = CHUNK) -> torch.Tensor:
    """Run the pack loop in ``mode`` over ``symbols`` (uint8, 1-D).

    Returns int32 (n_chunks, 2) of (sum, xor) per chunk, int32[n_tiles] for
    ``tile_scan``, or for ``thread`` and ``full`` the stream's int32 words
    (EOS padding 0xFF). These two take the stream's :func:`layout` (at
    ``chunk`` for ``thread``), computed here when ``lay`` is None.
    """
    _check(symbols, dt, mode, chunk)
    if mode in ("thread", "full") and lay is None:
        lay = layout(symbols, dt, chunk if mode == "thread" else None)
    if not is_cuda(symbols):
        return pack_ablate_plain(symbols, dt, mode, lay, chunk)
    n = symbols.numel()
    offs, total, n_words = lay if lay is not None else (None, 0, 0)
    if mode in ("thread", "full"):
        # the per-thread loop ORs its edge words: its output starts zeroed
        out = (torch.zeros if mode == "thread" else torch.empty)(
            n_words, dtype=torch.int32, device=symbols.device)
        words, sums = out.data_ptr(), None
    elif mode == "tile_scan":
        n_words = pack_encode.n_tiles(n)
        out = torch.empty(n_words, dtype=torch.int32, device=symbols.device)
        words, sums = out.data_ptr(), None
    else:
        out = torch.empty((-(-n // chunk), 2), dtype=torch.int32, device=symbols.device)
        words, sums = None, out.data_ptr()
    err = _build.load().thc_probe_pack(
        symbols.device.index, symbols.data_ptr(), n, chunk, dt.patterns.data_ptr(),
        dt.lengths.data_ptr(), offs.contiguous().data_ptr() if offs is not None else None,
        total, DEFAULT_EOS_PADDING, words, n_words, sums, _MODE_ID[mode],
        torch.cuda.current_stream(symbols.device).cuda_stream,
    )
    _build.check("thc_probe_pack", err)
    launches["pack_ablate"] += 1
    return out


def _xor_rows(v: torch.Tensor) -> torch.Tensor:
    """XOR over each row of an int64 (rows, k) tensor."""
    acc = v[:, 0].clone()
    for c in range(1, v.shape[1]):
        acc ^= v[:, c]
    return acc


def pack_ablate_plain(symbols: torch.Tensor, dt: DeviceTable, mode: str, lay=None,
                      chunk: int = CHUNK):
    """Plain version of :func:`pack_ablate`; ``thread`` places the codes at
    the chunk offsets, ``full`` is ``pack_plain`` at the tile offsets."""
    n = symbols.numel()
    n_chunks = -(-n // chunk)
    dev = symbols.device
    if mode == "full":
        offs, total, n_words = lay
        return pack_encode.pack_plain(symbols, dt, offs, total, DEFAULT_EOS_PADDING, n_words)[0]
    if mode == "tile_scan":
        return pack_encode.count_plain(symbols, dt)[0]
    if mode == "thread":
        offs, total, n_words = lay
        starts = pack_encode.symbol_starts(symbols, dt, offs, chunk)
        return pack_encode.place_codes(symbols, dt, starts, total, DEFAULT_EOS_PADDING, n_words)
    out = torch.zeros((n_chunks, 2), dtype=torch.int64, device=dev)
    if mode != "nop":
        idx = torch.zeros(n_chunks * chunk, dtype=torch.int64, device=dev)
        idx[:n] = symbols.to(torch.int64)
        live = (torch.arange(n_chunks * chunk, device=dev) < n).view(n_chunks, chunk)
        idx = idx.view(n_chunks, chunk)
        if mode == "extract":
            out[:, 0] = idx.sum(1)
        else:
            out[:, 0] = torch.where(live, dt.lengths.to(torch.int64)[idx], 0).sum(1)
            out[:, 1] = _xor_rows(torch.where(live, u32(dt.patterns)[idx], 0))
    return i32(out)


def run(dev: torch.device | None = None) -> dict:
    """Every mode on P5's 8 MiB against the plain version (``thread``, at
    each of THREAD_CHUNKS, and ``full`` also against ``encode_pack``'s
    words), then timed at that shape. ``thread``'s times include the fill
    of its output words, which is also timed alone; ``full`` and
    ``encode_pack`` fill nothing. Returns {"modes": {label: {"ms",
    "plain_ms"}}} with labels the modes, ``thread`` as "thread 32" and
    "thread 4"; "n", "n_tiles", "n_words", "pack_ms": encode_pack's time
    beside ``full``, "fill_ms", "max_abs_err": {"pack_ablate": over every
    comparison}."""
    dev = on_card(dev)
    sym = torch.from_numpy(p5_inputs()).to(dev)
    dt = DeviceTable.for_table(load_static_test_table(), dev)
    lay = layout(sym, dt)
    offs, total, n_words = lay
    words = pack_encode.pack(sym, dt, offs, total, DEFAULT_EOS_PADDING, n_words)[0]
    res = {"modes": {}, "n": sym.numel(), "n_tiles": offs.numel(), "n_words": n_words}
    runs = {}
    for m in MODES:
        if m == "thread":
            runs.update({f"thread {c}": (m, c, layout(sym, dt, c)) for c in THREAD_CHUNKS})
        else:
            runs[m] = (m, CHUNK, lay)
    err = 0
    calls = {}
    for label, (mode, chunk, lay_m) in runs.items():
        got = pack_ablate(sym, dt, mode, lay_m, chunk)
        plain = functools.partial(pack_ablate_plain, sym, dt, mode, lay_m, chunk)
        err = max(err, check_equal(f"pack_ablate {label}", got, plain()))
        if mode in ("thread", "full"):
            err = max(err, check_equal(f"pack_ablate {label} vs encode_pack", got, words))
        res["modes"][label] = {"plain_ms": median_ms(plain)}
        calls[label] = functools.partial(pack_ablate, sym, dt, mode, lay_m, chunk)
    calls["encode_pack"] = functools.partial(pack_encode.pack, sym, dt, offs, total,
                                             DEFAULT_EOS_PADDING, n_words)
    calls["fill"] = functools.partial(torch.zeros, n_words, dtype=torch.int32, device=dev)
    t = kernel_ms(calls)
    for label in runs:
        res["modes"][label]["ms"] = t[label]
    res["pack_ms"], res["fill_ms"] = t["encode_pack"], t["fill"]
    res["max_abs_err"] = {"pack_ablate": err}
    return res


def main() -> None:
    dev = require_cuda()
    print(card())
    res = run(dev)
    for label, r in res["modes"].items():
        print(f"pack_ablate {label:9s}: {r['ms']:.4f} ms ({N / r['ms'] / 1e6:.1f} GB/s of "
              f"symbols; plain {r['plain_ms']:.3f} ms); equal to plain")
    print(f"encode_pack beside it: {res['pack_ms']:.4f} ms; thread's and full's words equal "
          f"its words; thread includes the {res['fill_ms']:.4f} ms fill of the output words")


if __name__ == "__main__":
    main()

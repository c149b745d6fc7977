"""The port's pack loop with parts removed (``csrc/probe_pack.cu``), the
counterpart of P5 ``scripts/prof/prof_pack_ablate.py:make_call`` (:38,
pallas_call :187), which ablated B1's loop on the TPU. Here the loop is
the port's own, ``thc::pack_chunk`` in ``csrc/pack.cuh``, which the encode
pack kernel runs as its ``full`` mode. One thread a chunk of 32 symbols, as
``encode_pack`` at block_symbols 256. Modes, with their outputs:

* ``nop``: nothing read; (0, 0) per chunk;
* ``extract``: the sum of the chunk's symbol bytes, 0;
* ``lut``: the sum of the symbols' code lengths, the XOR of their
  patterns;
* ``lut4``: the same values from four interleaved accumulators;
* ``full``: the stream's words, equal to ``encode_pack``'s.

``python -m tpu_huffman_torch.prof.pack_ablate`` runs every mode on P5's
8 MiB (``default_rng(2024)``, the static table) against the plain version,
``full`` against the pack kernel's words, and prints ms and GB/s a mode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..ops import pack_encode
from ..ops.bitpack import i32, u32
from ..ops.encode import DEFAULT_BLOCK_SYMBOLS, DEFAULT_EOS_PADDING, DeviceTable
from ..tables import load_static_test_table
from . import card, check_equal, is_cuda, kernel_ms, median_ms, on_card, require_cuda

MODES = ("nop", "extract", "lut4", "lut", "full")  # P5's order (:211)
_MODE_ID = {"nop": 0, "extract": 1, "lut": 2, "lut4": 3, "full": 4}
CHUNK = pack_encode.chunk_symbols(DEFAULT_BLOCK_SYMBOLS)
N = 8 << 20  # P5's symbols
launches = {"pack_ablate": 0}


def p5_inputs(n: int = N) -> np.ndarray:
    """prof_pack_ablate.py: n bytes from default_rng(2024)."""
    return np.random.default_rng(2024).integers(0, 256, size=n, dtype=np.uint8)


def layout(symbols: torch.Tensor, dt: DeviceTable):
    """(chunk_offs int64, total_bits, n_words) of the stream, by the count
    kernel (or its plain version) and torch.cumsum, as the encoder takes
    them."""
    chunk_bits, _stats = pack_encode.count(symbols, dt, CHUNK)
    incl = torch.cumsum(chunk_bits, 0, dtype=torch.int64)
    total = int(incl[-1])
    pad = pack_encode.pad_code(total, DEFAULT_EOS_PADDING)[1]
    return incl - chunk_bits, total, -(-(total + pad) // 32)


def pack_ablate(symbols: torch.Tensor, dt: DeviceTable, mode: str, lay=None) -> torch.Tensor:
    """Run the pack loop in ``mode`` over ``symbols`` (uint8, 1-D).

    Returns int32 (n_chunks, 2) of (sum, xor) per chunk, or for ``full``
    the stream's int32 words (EOS padding 0xFF). ``full`` takes the
    stream's :func:`layout`, computed here when ``lay`` is None.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if symbols.dtype != torch.uint8 or symbols.dim() != 1 or not symbols.is_contiguous():
        raise ValueError("symbols must be a contiguous 1-D uint8 tensor")
    if symbols.numel() == 0 or dt.lengths.device != symbols.device:
        raise ValueError("symbols must be non-empty and on the table's device")
    if mode == "full" and lay is None:
        lay = layout(symbols, dt)
    if not is_cuda(symbols):
        return pack_ablate_plain(symbols, dt, mode, lay)
    n = symbols.numel()
    n_chunks = -(-n // CHUNK)
    offs, total, n_words = lay if mode == "full" else (None, 0, 0)
    if mode == "full":
        out = torch.zeros(n_words, dtype=torch.int32, device=symbols.device)
        words, sums = out.data_ptr(), None
    else:
        out = torch.empty((n_chunks, 2), dtype=torch.int32, device=symbols.device)
        words, sums = None, out.data_ptr()
    err = _build.load().thc_probe_pack(
        symbols.device.index, symbols.data_ptr(), n, CHUNK, dt.patterns.data_ptr(),
        dt.lengths.data_ptr(), offs.contiguous().data_ptr() if offs is not None else None,
        total, DEFAULT_EOS_PADDING, words, n_words, sums, _MODE_ID[mode],
        torch.cuda.current_stream(symbols.device).cuda_stream,
    )
    _build.check("thc_probe_pack", err)
    launches["pack_ablate"] += 1
    return out


def _xor_rows(v: torch.Tensor) -> torch.Tensor:
    """XOR over each row of an int64 (rows, 2^k) tensor."""
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] ^ v[:, h:]
    return v[:, 0]


def pack_ablate_plain(symbols: torch.Tensor, dt: DeviceTable, mode: str, lay=None):
    """Plain version of :func:`pack_ablate`."""
    n = symbols.numel()
    n_chunks = -(-n // CHUNK)
    dev = symbols.device
    if mode == "full":
        offs, total, n_words = lay
        return pack_encode.pack_plain(symbols, dt, CHUNK, offs, total, DEFAULT_EOS_PADDING,
                                      n_words)
    out = torch.zeros((n_chunks, 2), dtype=torch.int64, device=dev)
    if mode != "nop":
        idx = torch.zeros(n_chunks * CHUNK, dtype=torch.int64, device=dev)
        idx[:n] = symbols.to(torch.int64)
        live = (torch.arange(n_chunks * CHUNK, device=dev) < n).view(n_chunks, CHUNK)
        idx = idx.view(n_chunks, CHUNK)
        if mode == "extract":
            out[:, 0] = idx.sum(1)
        else:
            out[:, 0] = torch.where(live, dt.lengths.to(torch.int64)[idx], 0).sum(1)
            out[:, 1] = _xor_rows(torch.where(live, u32(dt.patterns)[idx], 0))
    return i32(out)


def run(dev: torch.device | None = None) -> dict:
    """Every mode on P5's 8 MiB against the plain version (``full`` also
    against ``encode_pack``'s words), then timed at that shape. ``full``
    and ``encode_pack`` each zero their output words before the kernel,
    and their times include that fill, which is also timed alone. Returns
    {"modes": {mode: {"ms", "plain_ms"}}, "n", "n_chunks", "n_words",
    "pack_ms": encode_pack's time beside ``full``, "fill_ms",
    "max_abs_err": {"pack_ablate": over every comparison}}."""
    dev = on_card(dev)
    sym = torch.from_numpy(p5_inputs()).to(dev)
    dt = DeviceTable.for_table(load_static_test_table(), dev)
    lay = layout(sym, dt)
    offs, total, n_words = lay
    words = pack_encode.pack(sym, dt, CHUNK, offs, total, DEFAULT_EOS_PADDING, n_words)
    res = {"modes": {}, "n": sym.numel(), "n_chunks": offs.numel(),
           "n_words": n_words}
    err = 0
    for mode in MODES:
        got = pack_ablate(sym, dt, mode, lay)
        err = max(err, check_equal(f"pack_ablate {mode}", got,
                                   pack_ablate_plain(sym, dt, mode, lay)))
        if mode == "full":
            err = max(err, check_equal("pack_ablate full vs encode_pack", got, words))
        res["modes"][mode] = {"plain_ms": median_ms(
            functools.partial(pack_ablate_plain, sym, dt, mode, lay))}
    calls = {m: functools.partial(pack_ablate, sym, dt, m, lay) for m in MODES}
    calls["encode_pack"] = functools.partial(pack_encode.pack, sym, dt, CHUNK, offs, total,
                                             DEFAULT_EOS_PADDING, n_words)
    calls["fill"] = functools.partial(torch.zeros, n_words, dtype=torch.int32, device=dev)
    t = kernel_ms(calls)
    for mode in MODES:
        res["modes"][mode]["ms"] = t[mode]
    res["pack_ms"], res["fill_ms"] = t["encode_pack"], t["fill"]
    res["max_abs_err"] = {"pack_ablate": err}
    return res


def main() -> None:
    dev = require_cuda()
    print(card())
    res = run(dev)
    for mode, r in res["modes"].items():
        print(f"pack_ablate {mode:7s}: {r['ms']:.4f} ms ({N / r['ms'] / 1e6:.1f} GB/s of "
              f"symbols; plain {r['plain_ms']:.3f} ms); equal to plain")
    print(f"encode_pack beside it: {res['pack_ms']:.4f} ms; full's words equal its words; "
          f"full and encode_pack include the {res['fill_ms']:.4f} ms fill of the output words")


if __name__ == "__main__":
    main()

"""The port's two parallel decode loops with their stores swapped
(``csrc/probe_decode.cu`` over ``csrc/decode_loop.cuh``), the counterpart of
``scripts/prof/prof_decode_parts.py`` (pallas_call :48, which drives B3's
``_make_pallas_call``), which split B3's loop on the TPU. Here the loops are
the port's own, ``thc::chain_lane`` and ``thc::segment_lane``, which
``chain_decode_kernel`` and ``selfsync_decode_kernel`` run in ``sector``
mode. Modes, with their outputs:

* ``none``: the loop with only the per-lane results stored: (end_bits,
  bad) for a chain; (counts, exits, bad[, blast]) for segments;
* ``byte``: one store a symbol (and a start) in the lane's row, the design
  before ``sector``; the wrapper fills the segment rows with 0 and
  ``NO_START`` first, as the stitch did;
* ``sector``: the kernels' design: whole 32-byte sectors from registers,
  the rest of each segment row filled by the kernel.

``byte`` and ``sector`` return what ``decode_chains`` / ``decode_segments``
return (then ``starts`` and ``blast`` where asked for). Cases, at the main
path's shapes on P5's 8 MiB (``default_rng(2024)``, the static table):

* ``chain``: chain_decode at block_symbols 256;
* ``full``: the stitch's full pass (segment-aligned entries, ``starts`` and
  ``blast``) over the same stream;
* ``patch``: the stitch's patch (``PATCH_SYMS`` codes with starts from the
  full pass's true entries).

``python -m tpu_huffman_torch.prof.decode_ablate`` runs every mode of every
case against the plain version, times each (``sector`` at block sizes 64,
128 and 256, the others at the kernels' 128) and the fills the ``byte``
mode needs, and prints ms a mode.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..ops import chain_decode, selfsync
from ..ops.encode import DEFAULT_BLOCK_SYMBOLS, DeviceTable, _encode_device
from ..tables import load_static_test_table
from . import card, check_equal, is_cuda, kernel_ms, median_ms, on_card, require_cuda
from .pack_ablate import p5_inputs

MODES = ("none", "byte", "sector")
_MODE_ID = {"none": 0, "byte": 1, "sector": 2}
BLOCKS = (64, 128, 256)
BLOCK = 128  # the kernels' (csrc/chain_decode.cu, selfsync_decode.cu)
CASES = ("chain", "full", "patch")
launches = {"decode_ablate": 0}


def _mode(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    return _MODE_ID[mode]


def chain_ablate(words, bit_offs, n_syms, out_start, n_out: int, dt, mode: str,
                 block: int = BLOCK):
    """``decode_chains`` through the probe's loop in ``mode``: (out,
    end_bits, bad), or (end_bits, bad) for ``none``."""
    m = _mode(mode)
    chain_decode._check(words, bit_offs, n_syms, out_start)
    if not is_cuda(words):
        return chain_ablate_plain(words, bit_offs, n_syms, out_start, n_out, dt, mode)
    dev = words.device
    b = bit_offs.numel()
    out = torch.empty(n_out, dtype=torch.uint8, device=dev) if m else None
    end_bits = torch.empty(b, dtype=torch.int64, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    err = _build.load().thc_probe_chain_decode(
        dev.index, words.data_ptr(), words.numel(), bit_offs.data_ptr(), n_syms.data_ptr(),
        out_start.data_ptr(), b, dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(),
        dt.l1.numel(), dt.table.max_len, None if out is None else out.data_ptr(),
        end_bits.data_ptr(), bad.data_ptr(), m, block,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("thc_probe_chain_decode", err)
    launches["decode_ablate"] += 1
    return (out, end_bits, bad) if m else (end_bits, bad)


def chain_ablate_plain(words, bit_offs, n_syms, out_start, n_out: int, dt, mode: str):
    """Plain version of :func:`chain_ablate`."""
    got = chain_decode.decode_chains_plain(words, bit_offs, n_syms, out_start, n_out, dt)
    return got if _mode(mode) else got[1:]


def segments_ablate(words, entries, seg_bits: int, max_syms: int, dt, mode: str,
                    starts: bool = False, blast: bool = False, max_codes: int = 0,
                    block: int = BLOCK):
    """``decode_segments`` through the probe's loop in ``mode``, with new
    ``starts`` / ``blast`` outputs when asked for: (syms, counts, exits,
    bad[, starts][, blast]), or (counts, exits, bad[, blast]) for
    ``none``."""
    m = _mode(mode)
    selfsync._check(words, entries, dt)
    if not 0 <= max_codes <= max_syms:
        raise ValueError(f"max_codes must be in [0, max_syms={max_syms}], got {max_codes}")
    if not is_cuda(words):
        return segments_ablate_plain(words, entries, seg_bits, max_syms, dt, mode, starts,
                                     blast, max_codes)
    dev = words.device
    t = entries.numel()
    syms = st = None
    if m:  # the byte mode writes slots only: its rows are filled first
        byte = m == _MODE_ID["byte"]
        syms = (torch.zeros if byte else torch.empty)((t, max_syms), dtype=torch.uint8,
                                                      device=dev)
        if starts:
            st = (torch.full((t, max_syms), selfsync.NO_START, dtype=torch.int16, device=dev)
                  if byte else torch.empty((t, max_syms), dtype=torch.int16, device=dev))
    counts, exits, bad = (torch.empty(t, dtype=torch.int32, device=dev) for _ in range(3))
    bl = torch.empty(t, dtype=torch.int32, device=dev) if blast else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = _build.load().thc_probe_selfsync_decode(
        dev.index, words.data_ptr(), words.numel(), entries.data_ptr(), None, t, seg_bits,
        max_syms, max_codes, dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(), dt.l1.numel(),
        dt.table.max_len, ptr(syms), ptr(st), counts.data_ptr(), exits.data_ptr(),
        bad.data_ptr(), ptr(bl), m, block, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("thc_probe_selfsync_decode", err)
    launches["decode_ablate"] += 1
    return _segment_outputs(m, syms, counts, exits, bad, st, bl)


def _segment_outputs(m, syms, counts, exits, bad, st, bl):
    outs = (syms, counts, exits, bad, st, bl) if m else (counts, exits, bad, bl)
    return tuple(x for x in outs if x is not None)


def segments_ablate_plain(words, entries, seg_bits: int, max_syms: int, dt, mode: str,
                          starts: bool = False, blast: bool = False, max_codes: int = 0):
    """Plain version of :func:`segments_ablate`."""
    m = _mode(mode)
    t = entries.numel()
    st = torch.empty((t, max_syms), dtype=torch.int16, device=words.device) if starts else None
    bl = torch.empty(t, dtype=torch.int32, device=words.device) if blast else None
    syms, counts, exits, bad = selfsync.decode_segments_plain(
        words, entries, seg_bits, max_syms, dt, st, bl, max_codes)
    return _segment_outputs(m, syms, counts, exits, bad, st if m else None, bl)


def inputs(dev: torch.device, data=None, block_symbols: int = DEFAULT_BLOCK_SYMBOLS) -> dict:
    """The three cases' arguments on ``dev``, from ``data`` (uint8 numpy;
    P5's 8 MiB when None) on the static table: {case: (fn, plain_fn, args,
    kwargs)}, fn and plain_fn taking (*args, mode, **kwargs). The patch's
    entries come from the full pass (by its plain version on the CPU)."""
    data = p5_inputs() if data is None else data
    dt = DeviceTable.for_table(load_static_test_table(), dev)
    sym = torch.from_numpy(data).to(dev)
    words, _total, padded_bits, block_offs, _max = _encode_device(sym, dt, 0xFF, block_symbols)
    n = sym.numel()
    nb = block_offs.numel()
    nsyms = torch.full((nb,), block_symbols, dtype=torch.int32, device=dev)
    nsyms[-1] = n - (nb - 1) * block_symbols
    out_start = torch.arange(nb, dtype=torch.int64, device=dev) * block_symbols
    n_segs, seg_bits = selfsync._plan_segments(padded_bits, selfsync.SEG_WORDS)
    max_syms = selfsync.max_symbols(dt.table, seg_bits)
    entries0 = torch.zeros(n_segs, dtype=torch.int32, device=dev)
    exits0 = selfsync.decode_segments(words, entries0, seg_bits, max_syms, dt)[2]
    entries1 = torch.cat([entries0[:1], exits0[:-1] - seg_bits])
    a = selfsync.PATCH_SYMS
    return {
        "chain": (chain_ablate, chain_ablate_plain,
                  (words, block_offs, nsyms, out_start, n, dt), {}),
        "full": (segments_ablate, segments_ablate_plain,
                 (words, entries0, seg_bits, max_syms, dt), {"starts": True, "blast": True}),
        "patch": (segments_ablate, segments_ablate_plain,
                  (words, entries1, seg_bits, a, dt), {"starts": True, "max_codes": a}),
    }


def run(dev: torch.device | None = None) -> dict:
    """Every mode of every case on P5's 8 MiB, each timed launch (``sector``
    at each of BLOCKS, the others at BLOCK) held against the plain version
    at its shape, then timed by ``kernel_ms``; beside them the fills that
    the ``byte`` mode's wrapper makes (its times include them) and the
    chain case's plain version. Returns {"cases": {case: {label: ms}},
    "fill_ms": {case: ms}, "lanes", "symbols", "chain_plain_ms",
    "chain_bytes" (the chain case's bytes moved, for its bound),
    "max_abs_err": {"decode_ablate": over every comparison}}."""
    dev = on_card(dev)
    cases = inputs(dev)
    res = {"cases": {}, "fill_ms": {}, "lanes": {}, "symbols": {}}
    err = 0
    for case, (fn, plain, args, kw) in cases.items():
        want = {m: plain(*args, m, **kw) for m in MODES}
        calls = {}
        for m in MODES:
            for blk in (BLOCKS if m == "sector" else (BLOCK,)):
                calls[f"{m} {blk}"] = functools.partial(fn, *args, m, block=blk, **kw)
        for label, call in calls.items():  # every timed launch, at its shape
            got, w = call(), want[label.split()[0]]
            if len(got) != len(w):
                raise AssertionError(f"decode_ablate {case} {label}: {len(got)} outputs")
            for i, (a, b) in enumerate(zip(got, w)):
                err = max(err, check_equal(f"decode_ablate {case} {label} output {i}", a, b))
        if case != "chain":
            rows = (args[1].numel(), args[3])
            calls["fill"] = lambda rows=rows: (
                torch.zeros(rows, dtype=torch.uint8, device=dev),
                torch.full(rows, selfsync.NO_START, dtype=torch.int16, device=dev))
        t = kernel_ms(calls)
        res["fill_ms"][case] = t.pop("fill", 0.0)
        res["cases"][case] = t
        res["lanes"][case] = args[1].numel()
        res["symbols"][case] = (args[4] if case == "chain"
                                else int(want["none"][0].sum()))
    fn, plain, args, kw = cases["chain"]
    res["chain_plain_ms"] = median_ms(functools.partial(plain, *args, "sector", **kw))
    words, block_offs, _nsyms, _out_start, n, dt = args
    # the chain case reads the stream, 20 bytes of index a block and level 0
    # of the LUT, and writes the symbols, 8 bytes a block and the flag
    res["chain_bytes"] = (4 * words.numel() + 28 * block_offs.numel() + n + 4
                          + 4 * dt.l0.numel())
    res["max_abs_err"] = {"decode_ablate": err}
    return res


def main() -> None:
    dev = require_cuda()
    print(card())
    res = run(dev)
    for case, t in res["cases"].items():
        print(f"decode_ablate {case} ({res['lanes'][case]} lanes, {res['symbols'][case]} "
              f"symbols): " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
              + (f"; byte includes the {res['fill_ms'][case]:.4f} ms fill of its rows"
                 if case != "chain" else "") + "; every launch equal to plain")
    print(f"chain plain version: {res['chain_plain_ms']:.3f} ms")


if __name__ == "__main__":
    main()

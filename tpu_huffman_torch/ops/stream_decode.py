"""Sequential foreign-stream decode kernel and its plain version (replaces
the JAX package's ``decode_stream_kernel`` in ``tpu_huffman/ops/decode.py``,
an XLA ``lax.scan`` with one step per symbol).

The kernel, in ``csrc/stream_decode.cu``, walks the stream on one thread
from ``start_bit`` with the reference's termination rules
(source/huffman.c:230-281), in the scan body's order: no bits left, or no
code matching with < 32 bits left, stops with ``STATUS_OK``; no code
matching with >= 32 bits left stops with ``STATUS_UNKNOWN_SYMBOL``; a code
longer than the bits left (trailing padding) stops with ``STATUS_OK``; and
the output-full check, before the symbol is consumed, stops with
``STATUS_OUTPUT_FULL``. It serves small inputs, capped calls
(``max_output``) and the tail of the self-synchronising decode
(``ops/selfsync.py``).

:func:`decode_stream` runs the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; there is no fallback from
one to the other. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .bitpack import extract_windows, u32
from .chain_decode import lut_lookup

STATUS_OK = 0
STATUS_UNKNOWN_SYMBOL = 1
STATUS_OUTPUT_FULL = 2  # the SHORT_BUFFER stop reason (reference huffman.c:266)
launches = {"stream_decode": 0}


def out_size(dt, start_bit: int, total_bits: int, out_capacity: int | None) -> int:
    """Output slots: ``out_capacity``, or fewer when the bits cannot hold
    that many symbols (each takes at least the table's shortest code). The
    output-full stop fires at the same symbol either way."""
    most = max(total_bits - start_bit, 0) // max(int(dt.table.min_len), 1) + 1
    return most if out_capacity is None else max(0, min(int(out_capacity), most))


def _check(words: torch.Tensor, start_bit: int, dt) -> None:
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError("words must be a 1-D int32 tensor")
    if start_bit < 0:
        raise ValueError(f"start_bit must be >= 0, got {start_bit}")
    if dt.l0.device != words.device:
        raise ValueError("table and words are on different devices")


def decode_stream(words: torch.Tensor, start_bit: int, total_bits: int,
                  out_capacity: int | None, dt):
    """Decode from ``start_bit`` until a stop rule fires, writing at most
    ``out_capacity`` symbols (None: no cap).

    ``total_bits`` is the stream's length in bits (the words may hold more,
    as zeros). Returns (symbols uint8[m], info int64[3]) with info =
    (n_decoded, end_bit, status); symbols past n_decoded are 0.
    """
    _check(words, start_bit, dt)
    dev = words.device
    if dev.type == "cpu":
        return decode_stream_plain(words, start_bit, total_bits, out_capacity, dt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    m = out_size(dt, start_bit, total_bits, out_capacity)
    out = torch.zeros(m, dtype=torch.uint8, device=dev)
    info = torch.empty(3, dtype=torch.int64, device=dev)
    words = words.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.load().thc_stream_decode(
        dev.index, words.data_ptr(), words.numel(), start_bit, total_bits, m,
        dt.l0.data_ptr(), dt.root_bits, dt.l1.data_ptr(), dt.l1.numel(),
        out.data_ptr(), info.data_ptr(), stream,
    )
    _build.check("thc_stream_decode", err)
    launches["stream_decode"] += 1
    return out, info


def decode_stream_plain(words: torch.Tensor, start_bit: int, total_bits: int,
                        out_capacity: int | None, dt):
    """Plain version of :func:`decode_stream`: the port of the scan body of
    ``decode_stream_kernel``, one step per symbol, each step a torch window
    extraction and LUT lookup in int64 and the stop rules on the host."""
    dev = words.device
    w64 = u32(words)
    m = out_size(dt, start_bit, total_bits, out_capacity)
    out = torch.zeros(m, dtype=torch.uint8, device=dev)
    off, n_out, status = start_bit, 0, STATUS_OK
    while True:
        left = total_bits - off
        if left <= 0:
            break
        pos = torch.tensor([off], dtype=torch.int64, device=dev)
        sym, ln = torch.cat(lut_lookup(extract_windows(w64, pos), dt)).tolist()
        if ln == 0:
            if left >= 32:
                status = STATUS_UNKNOWN_SYMBOL
            break
        if ln > left:
            break
        if n_out >= m:
            status = STATUS_OUTPUT_FULL
            break
        out[n_out] = sym
        n_out += 1
        off += ln
    return out, torch.tensor([n_out, off, status], dtype=torch.int64, device=dev)

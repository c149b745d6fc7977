"""Indexed-decode kernel and its plain version (replaces the Pallas decode
kernels B2 ``_make_pallas_call_dual`` and B3 ``_make_pallas_call`` of
``tpu_huffman/ops/pallas_decode.py``, with their host-side entry
``decode_indexed_pallas``).

One kernel, in ``csrc/chain_decode.cu``, decodes every index block as one
chain on one thread, from the block's int64 entry bit, for any prefix-free
table and any block size: ``DeviceTable`` builds the LUT at ``root_bits``
<= ``MAX_ROOT_BITS``, so level 0 fits shared memory whatever width the
table was built at. The TPU's dual-chain pairing, row staging and window plans
(``pair_dual_inputs``, ``plan_wb``, ``capped_intervals``) only shape VMEM
tiles and have no counterpart here.

:func:`decode_chains` runs the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; there is no fallback from
one to the other. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .bitpack import extract_windows, u32

MAX_ROOT_BITS = 12  # the decode LUT's level-0 width: it fits the kernels' shared memory
launches = {"chain_decode": 0}


def lut_lookup(window: torch.Tensor, dt):
    """Two-level LUT decode of 32-bit MSB-aligned windows (int64 values).

    Returns (symbol, bits_read), int64; bits_read == 0 means no code
    matches. Port of the JAX package's ``ops/decode.py:lut_lookup``.
    """
    rb = dt.root_bits
    idx0 = window >> (32 - rb)
    b0 = dt.l0_bits[idx0]
    v0 = dt.l0_val[idx0]
    is_ptr = b0 < 0
    width = torch.where(is_ptr, -b0, 1)
    sub = ((window << rb) & 0xFFFFFFFF) >> (32 - width)
    idx1 = torch.where(is_ptr, v0 + sub, 0)
    bits = torch.where(is_ptr, dt.l1_bits[idx1], b0)
    sym = torch.where(is_ptr, dt.l1_val[idx1], v0)
    return sym, bits


def _check(words, bit_offs, n_syms, out_start):
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError("words must be a 1-D int32 tensor")
    if bit_offs.dtype != torch.int64 or out_start.dtype != torch.int64:
        raise ValueError("bit_offs and out_start must be int64")
    if n_syms.dtype != torch.int32:
        raise ValueError("n_syms must be int32")
    b = bit_offs.numel()
    if n_syms.numel() != b or out_start.numel() != b:
        raise ValueError("bit_offs, n_syms and out_start differ in length")
    devs = {t.device for t in (words, bit_offs, n_syms, out_start)}
    if len(devs) != 1:
        raise ValueError("decode inputs are on different devices")


def decode_chains(words: torch.Tensor, bit_offs: torch.Tensor,
                  n_syms: torch.Tensor, out_start: torch.Tensor, n_out: int,
                  dt):
    """Decode ``n_syms[b]`` symbols from bit ``bit_offs[b]`` into
    ``out[out_start[b]:]`` for every block b.

    Returns (out uint8[n_out], end_bits int64[B], bad int32[1]); ``bad`` is
    1 when any active window matched no code.
    """
    _check(words, bit_offs, n_syms, out_start)
    dev = words.device
    if dev.type == "cpu":
        return decode_chains_plain(words, bit_offs, n_syms, out_start, n_out, dt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b = bit_offs.numel()
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    end_bits = torch.empty(b, dtype=torch.int64, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    if b == 0:
        return out, end_bits, bad
    words, bit_offs, n_syms, out_start = (
        t.contiguous() for t in (words, bit_offs, n_syms, out_start)
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.load().thc_chain_decode(
        dev.index, words.data_ptr(), words.numel(), bit_offs.data_ptr(),
        n_syms.data_ptr(), out_start.data_ptr(), b, dt.l0.data_ptr(),
        dt.root_bits, dt.l1.data_ptr(), dt.l1.numel(), dt.table.max_len, out.data_ptr(),
        end_bits.data_ptr(), bad.data_ptr(), stream,
    )
    _build.check("thc_chain_decode", err)
    launches["chain_decode"] += 1
    return out, end_bits, bad


def decode_chains_plain(words, bit_offs, n_syms, out_start, n_out: int, dt):
    """Plain version of :func:`decode_chains`: the port of the JAX package's
    ``decode_blocks_kernel`` (ops/decode.py) — one step per symbol position,
    each step advancing every block by one symbol."""
    dev = words.device
    w64 = u32(words)
    ns = n_syms.to(torch.int64)
    b = bit_offs.numel()
    steps = int(ns.max()) if b else 0
    off = bit_offs.clone()
    syms = torch.zeros((b, steps), dtype=torch.int64, device=dev)
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(steps):
        sym, nbits = lut_lookup(extract_windows(w64, off), dt)
        active = i < ns
        bad |= active & (nbits == 0)
        syms[:, i] = sym
        off = torch.where(active, off + nbits, off)
    col = torch.arange(steps, device=dev)
    live = col[None, :] < ns[:, None]
    out = torch.zeros(n_out, dtype=torch.uint8, device=dev)
    out[(out_start[:, None] + col[None, :])[live]] = syms[live].to(torch.uint8)
    return out, off, bad.any().to(torch.int32).reshape(1)

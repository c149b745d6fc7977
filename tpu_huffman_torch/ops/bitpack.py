"""Bit stream <-> word tensors (ports ``tpu_huffman/ops/bitpack.py`` and the
on-device byteswap ``selfsync._words_from_u8_dev``), and the same on the
host in numpy (``words_from_bytes_np``, ``bytes_from_words_np``).

Stream bit ``j`` lives in word ``j >> 5`` at bit ``31 - (j & 31)``, and the
words serialise big-endian, as in the JAX package. torch's ``uint32`` lacks
most operators, so a word tensor is ``int32`` holding the 32 bits as they
are; the plain versions widen it to ``int64`` (:func:`u32`) and mask every
result back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import metrics

MASK32 = 0xFFFFFFFF


def words_from_bytes_np(data) -> tuple[np.ndarray, int]:
    """Pack bytes into big-endian uint32 words (host side). Returns
    (words, nbytes); the last word is zero-padded."""
    if isinstance(data, (bytes, bytearray)):
        b = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        b = np.asarray(data, dtype=np.uint8)
    nbytes = b.size
    pad = (-nbytes) % 4
    if pad:
        b = np.concatenate([b, np.zeros(pad, dtype=np.uint8)])
    words = b.reshape(-1, 4).astype(np.uint32)
    return (words[:, 0] << 24) | (words[:, 1] << 16) | (words[:, 2] << 8) | words[:, 3], nbytes


def bytes_from_words_np(words, nbytes: int) -> bytes:
    """The first ``nbytes`` bytes of big-endian uint32 words (host side).
    int32 words, as the port's tensors hold them, give the same bytes."""
    w = np.asarray(words).astype(np.uint32)
    out = np.empty((w.size, 4), dtype=np.uint8)
    out[:, 0] = (w >> 24) & 0xFF
    out[:, 1] = (w >> 16) & 0xFF
    out[:, 2] = (w >> 8) & 0xFF
    out[:, 3] = w & 0xFF
    return out.reshape(-1)[:nbytes].tobytes()


def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """Big-endian pack: uint8[4W] -> int32[W] (the length must be 4-aligned)."""
    return b.reshape(-1, 4).flip(-1).contiguous().view(torch.int32).reshape(-1)


def stage_words(raw: torch.Tensor) -> torch.Tensor:
    """uint8 stream bytes -> int32 words, the last word zero-padded. The
    decoders read words past the last one as zeros too."""
    with metrics.span("tt.stage.upload"):
        pad = (-raw.numel()) % 4
        if pad:
            raw = torch.cat([raw, raw.new_zeros(pad)])
        return bytes_to_words(raw)


def words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """Big-endian unpack: int32[W] -> uint8[4W]."""
    return w.contiguous().view(torch.uint8).reshape(-1, 4).flip(-1).reshape(-1)


def u32(w: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned values in int64."""
    return w.to(torch.int64) & MASK32


def i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> int32 words, bit for bit."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def merge_words(buf: torch.Tensor, up: torch.Tensor, w0b: int, sh: int) -> None:
    """OR-append new words into ``buf`` at word ``w0b``, in place (ports
    ``stream._merge_words``).

    ``up`` holds the new bytes as words packed from bit 0; ``sh`` = 8 *
    (appended bytes so far % 4) is the byte phase of the append point. Bits
    past the valid stream are zero on both sides, so only the boundary word
    needs an OR; the rest overwrite zeros. ``buf`` must hold ``w0b +
    up.numel() + 1`` words when ``sh`` > 0, else ``w0b + up.numel()``.
    """
    u = u32(up)
    if sh:
        prev = torch.cat([u.new_zeros(1), u])
        nxt = torch.cat([u, u.new_zeros(1)])
        u = ((prev << (32 - sh)) & MASK32) | (nxt >> sh)
    u[:1] |= u32(buf[w0b : w0b + 1])
    buf[w0b : w0b + u.numel()] = i32(u)


def slide_words(buf: torch.Tensor, cw: int) -> torch.Tensor:
    """``buf`` with its first ``cw`` words dropped and zeros after, the same
    length (ports ``stream._slide_words``)."""
    return torch.cat([buf[cw:], buf.new_zeros(cw)])


def download(scalars: torch.Tensor, *parts: torch.Tensor):
    """One device-to-host copy of a 1-D int64 tensor ``scalars`` and 1-D
    uint8 ``parts``: (the scalars as a list of ints, each part as a numpy
    uint8 array)."""
    blob = torch.cat([scalars.view(torch.uint8), *parts]).cpu().numpy()
    at = 8 * scalars.numel()
    vals, arrays = blob[:at].view(np.int64).tolist(), []
    for part in parts:
        arrays.append(blob[at:at + part.numel()])
        at += part.numel()
    return vals, arrays


def extract_windows(words64: torch.Tensor, bit_offsets: torch.Tensor) -> torch.Tensor:
    """32-bit MSB-aligned windows starting at ``bit_offsets`` (int64).

    ``words64`` holds the stream's words as unsigned values in int64 (see
    :func:`u32`). Words past its end read as zero, so windows near the tail
    see zero padding, as the reference decoder does.
    """
    n = words64.numel()
    idx = bit_offsets >> 5
    sh = bit_offsets & 31

    def at(i):
        return torch.where(i < n, words64[i.clamp(max=n - 1)], 0)

    return ((at(idx) << sh) | (at(idx + 1) >> (32 - sh))) & MASK32

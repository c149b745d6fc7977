"""The call patterns a traffic mix names, and the check of what each
produced.

Each pattern makes its inputs from the seed, warms every call it will
make, runs one request at a time (``request(i)``: a closed loop with one
caller, as the library is called), keeps what the check needs, and after
the window compares what the program returned with the reference
(``check()``). The public calls go through ``rec.call(span, fn, ...)``,
which times each, names its span, and counts its host syncs.

- ``oneshot_index``: ``encode_with_index`` then ``decode_indexed``, one
  object a request.
- ``oneshot_foreign``: ``decode`` of a stream with no index (the reference
  encoder makes the streams in set-up, and its seconds are kept out of
  ``setup_s``), one object a request.
- ``stream_pipe``: one object through ``HuffmanEncoder.encode_chunk`` at
  ``capacity`` bytes a call, each piece fed to ``HuffmanDecoder.decode_chunk``
  at ``capacity`` symbols a call and drained with ``b""`` until done.
- ``strings``: one string a request on one connection's encoder and
  decoder, each reset first: ``encode``, one ``decode_chunk`` of the whole
  string, ``padding_is_all_ones``.

Every answer's sizes are checked; an answer's bytes are kept and compared
for the first request of each input and for requests drawn from the seed
at ``sample_share`` (all of them for ``strings``).

A mix's ``pattern`` names one of ``PATTERNS`` or a file
``portbench/calls/<pattern>.py`` of its own (:func:`pattern`), which
defines a class ``Pattern(ctx: Context)`` with the four methods above:
``warm(rec)``, ``request(i) -> int`` (the request's plaintext bytes),
``release()`` and ``check() -> (checks, counts)``. It reaches the program
only through ``ctx.codec``'s entries, so that the control can stand in
its place, and its inputs through ``ctx.objects()`` or
``ctx.inputs.fields``.
"""

from __future__ import annotations

import os
import time

import numpy as np

from . import gen, named, roofline
from .reference import huffman_np as R

CALLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "calls")


class Context:
    def __init__(self, codec, table, ref, cfg: dict, mix: dict, seed: int, rec):
        self.codec, self.table, self.ref = codec, table, ref
        self.cfg, self.mix, self.seed, self.rec = cfg, mix, seed, rec
        self.eos = int(cfg["eos_padding"])
        self.inputs = gen.inputs(cfg)
        self.ref_s = 0.0  # set-up seconds spent in the reference, kept out of setup_s
        self._keep = gen.rng(seed, 1 << 30, 0).random(1 << 16)

    def keep(self, i: int) -> bool:
        """Whether request i's answers are kept for the byte check."""
        return i < int(self.mix["pool"]) or self._keep[i % self._keep.size] < float(
            self.mix.get("sample_share", 1.0))

    def objects(self) -> list[bytes]:
        n, make = int(self.mix["object_bytes"]), self.inputs.make
        return [make(n, self.seed, i).tobytes() for i in range(int(self.mix["pool"]))]


def _check(name: str, value: int, limit: int = 0) -> tuple:
    return (name, int(value), limit)


class OneshotIndex:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.objs = ctx.objects()
        self.bs = int(ctx.mix["block_symbols"])
        self.seen, self.kept = [], {}

    def _round_trip(self, obj: bytes, rec):
        c, t = self.ctx.codec, self.ctx.table
        enc, idx = rec.call("encode_with_index", c.encode_with_index, obj, t,
                            eos_padding=self.ctx.eos, block_symbols=self.bs)
        nb = len(idx.bit_offsets)
        rec.work("encode_with_index", roofline.encode_bytes(len(obj), len(enc), nb))
        dec = rec.call("decode_indexed", c.decode_indexed, enc, idx, t)
        rec.work("decode_indexed", roofline.decode_bytes(len(enc), len(dec), nb))
        return enc, idx, dec

    def warm(self, rec) -> None:
        for obj in self.objs:
            self._round_trip(obj, rec)

    def request(self, i: int) -> int:
        k = i % len(self.objs)
        enc, idx, dec = self._round_trip(self.objs[k], self.ctx.rec)
        self.seen.append((k, len(enc), int(idx.total_bits), int(idx.total_symbols),
                          int(idx.max_code_len), len(idx.bit_offsets), len(dec)))
        if self.ctx.keep(i):
            self.kept[i] = (k, enc, np.asarray(idx.bit_offsets), np.asarray(idx.n_symbols), dec)
        return len(self.objs[k])

    def release(self) -> None:
        pass

    def check(self) -> list:
        ref, eos = self.ctx.ref, self.ctx.eos
        want = {}
        for k in sorted({s[0] for s in self.seen} | {v[0] for v in self.kept.values()}):
            obj = self.objs[k]
            want[k] = (R.encode(obj, ref, eos), R.block_index(obj, ref, self.bs))
        sizes = sum((len(want[k][0]), want[k][1]["total_bits"], want[k][1]["total_symbols"],
                     want[k][1]["max_code_len"], want[k][1]["bit_offsets"].size,
                     len(self.objs[k])) != tuple(rest) for k, *rest in self.seen)
        enc_w = idx_w = dec_w = 0
        for k, enc, offs, counts, dec in self.kept.values():
            w_enc, w_idx = want[k]
            enc_w += enc != w_enc
            idx_w += not (np.array_equal(offs, w_idx["bit_offsets"])
                          and np.array_equal(counts, w_idx["n_symbols"]))
            dec_w += dec != self.objs[k]
        return [_check("sizes_wrong", sizes), _check("encode_wrong", enc_w),
                _check("index_wrong", idx_w), _check("decode_wrong", dec_w)], {
                    "answers": len(self.seen), "kept": len(self.kept)}


class OneshotForeign:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.objs = ctx.objects()
        t0 = time.perf_counter()
        self.streams = [R.encode(obj, ctx.ref, ctx.eos) for obj in self.objs]
        ctx.ref_s += time.perf_counter() - t0
        self.seen, self.kept = [], {}

    def _decode(self, k: int, rec) -> bytes:
        dec = rec.call("decode", self.ctx.codec.decode, self.streams[k], self.ctx.table)
        rec.work("decode", roofline.decode_bytes(len(self.streams[k]), len(dec)))
        return dec

    def warm(self, rec) -> None:
        for k in range(len(self.objs)):
            self._decode(k, rec)

    def request(self, i: int) -> int:
        k = i % len(self.objs)
        dec = self._decode(k, self.ctx.rec)
        self.seen.append((k, len(dec)))
        if self.ctx.keep(i):
            self.kept[i] = (k, dec)
        return len(self.objs[k])

    def release(self) -> None:
        pass

    def check(self) -> list:
        # the streams are the reference encoder's: decoding one gives back its object
        sizes = sum(n != len(self.objs[k]) for k, n in self.seen)
        dec_w = sum(dec != self.objs[k] for k, dec in self.kept.values())
        return [_check("sizes_wrong", sizes), _check("decode_wrong", dec_w)], {
            "answers": len(self.seen), "kept": len(self.kept)}


def stream_model(obj: bytes, ref, cap: int, eos: int) -> list:
    """Every call of one object through the pipe, as the reference's
    SHORT_BUFFER protocol makes it: (kind, length, consumed, done, (a, b)),
    kind 0 an ``encode_chunk`` whose bytes are ``stream[a:b]``, kind 1 a
    ``decode_chunk`` whose symbols are ``obj[a:b]`` (consumed -1).

    An encode call writes the next ``cap`` bytes of the one continuous
    stream and consumes the symbols whose codes start in them (a code cut
    by the end goes on in the next call); the call that holds the stream's
    end writes the rest, padded, and is done. A decode call emits the next
    symbols whose codes end within the bytes fed so far, at most ``cap``,
    and is done unless more than ``cap`` were left."""
    data = np.frombuffer(obj, dtype=np.uint8)
    lens = R.code_bits(data, ref)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    starts, ends, total, n = bounds[:-1], bounds[1:], int(bounds[-1]), data.size
    nbytes = -(-total // 8)
    calls, out, k = [], 0, 0
    while True:
        lo, hi = 8 * cap * k, 8 * cap * (k + 1)
        done = total <= hi
        a, b = cap * k, nbytes if done else cap * (k + 1)
        first = int(np.searchsorted(starts, lo))
        consumed = (n if done else int(np.searchsorted(starts, hi))) - first
        calls.append((0, b - a, consumed, done, (a, b)))
        avail = int(np.searchsorted(ends, 8 * b, side="right"))
        while True:
            m = min(cap, avail - out)
            calls.append((1, m, -1, avail - out <= cap, (out, out + m)))
            out += m
            if calls[-1][3]:
                break
        if done:
            return calls
        k += 1


class StreamPipe:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.objs = ctx.objects()
        self.cap = int(ctx.mix["capacity"])
        c = ctx.codec
        self.enc = c.HuffmanEncoder(ctx.table, eos_padding=ctx.eos)
        self.dec = c.HuffmanDecoder(ctx.table)
        self.seen, self.kept = [], {}

    def _pipe(self, obj: bytes, rec, keep: bool):
        enc, dec, cap = self.enc, self.dec, self.cap
        enc.reset()
        dec.reset()
        view, pos, calls, datas = memoryview(obj), 0, [], []
        limit = 4 * (len(obj) // cap) + 64  # a pipe that never ends is a failed request
        while True:
            r = rec.call("encode_chunk", enc.encode_chunk, view[pos:], cap)
            rec.work("encode_chunk", roofline.encode_bytes(r.consumed, len(r.data)))
            pos += r.consumed
            calls.append((0, len(r.data), r.consumed, r.done))
            datas.append(r.data if keep else None)
            piece = r.data
            while True:
                d = rec.call("decode_chunk", dec.decode_chunk, piece, cap)
                rec.work("decode_chunk", roofline.decode_bytes(len(piece), len(d.data)))
                calls.append((1, len(d.data), -1, d.done))
                datas.append(d.data if keep else None)
                piece = b""
                if d.done or len(calls) > limit:
                    break
            if r.done or len(calls) > limit:
                break
        if len(calls) > limit:
            raise RuntimeError(f"the pipe made {len(calls)} calls for {len(obj)} bytes")
        return calls, datas

    def warm(self, rec) -> None:
        for obj in self.objs:
            self._pipe(obj, rec, False)

    def request(self, i: int) -> int:
        k = i % len(self.objs)
        keep = self.ctx.keep(i)
        calls, datas = self._pipe(self.objs[k], self.ctx.rec, keep)
        self.seen.append((k, calls))
        if keep:
            self.kept[i] = (k, datas)
        return len(self.objs[k])

    def release(self) -> None:
        self.enc = self.dec = None

    def check(self) -> list:
        ref, eos, cap = self.ctx.ref, self.ctx.eos, self.cap
        models, streams = {}, {}
        for k in sorted({k for k, _ in self.seen} | {k for k, _ in self.kept.values()}):
            models[k] = stream_model(self.objs[k], ref, cap, eos)
            streams[k] = R.encode(self.objs[k], ref, eos)
        calls_w = n_calls = 0
        for k, calls in self.seen:
            want = [m[:4] for m in models[k]]
            n_calls += len(calls)
            calls_w += sum(a != b for a, b in zip(calls, want)) + abs(len(calls) - len(want))
        bytes_w = 0
        for k, datas in self.kept.values():
            for (kind, *_x, (a, b)), got in zip(models[k], datas):
                src = streams[k] if kind == 0 else self.objs[k]
                bytes_w += got != src[a:b]
            bytes_w += abs(len(datas) - len(models[k]))
        return [_check("calls_wrong", calls_w), _check("bytes_wrong", bytes_w)], {
            "answers": n_calls, "kept": sum(len(d) for _, d in self.kept.values())}


class Strings:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        if ctx.inputs.fields is None:
            raise ValueError(f"data {ctx.cfg['data']!r} makes no strings for the strings pattern")
        self.fields = ctx.inputs.fields(int(ctx.mix["pool"]), ctx.seed)
        c = ctx.codec
        self.enc = c.HuffmanEncoder(ctx.table, eos_padding=ctx.eos)
        self.dec = c.HuffmanDecoder(ctx.table)
        self.seen = []

    def _encode(self, s: bytes) -> bytes:
        self.enc.reset()
        return self.enc.encode(s)

    def _decode(self, e: bytes):
        self.dec.reset()
        return self.dec.decode_chunk(e).data, self.dec.padding_is_all_ones()

    def _string(self, s: bytes, rec):
        e = rec.call("hpack.encode", self._encode, s)
        d, ok = rec.call("hpack.decode", self._decode, e)
        return e, d, ok

    def warm(self, rec) -> None:
        for s in self.fields[: int(self.ctx.mix.get("warm_strings", 256))]:
            self._string(s, rec)

    def request(self, i: int) -> int:
        k = i % len(self.fields)
        self.seen.append((k, *self._string(self.fields[k], self.ctx.rec)))
        return len(self.fields[k])

    def release(self) -> None:
        self.enc = self.dec = None

    def check(self) -> list:
        ref, eos = self.ctx.ref, self.ctx.eos
        want = {}
        for k in {s[0] for s in self.seen}:
            s = self.fields[k]
            e = R.encode(s, ref, eos)
            want[k] = (e, R.padding_is_all_ones(e, int(R.code_bits(R.as_u8(s), ref).sum())))
        enc_w = sum(e != want[k][0] for k, e, _d, _ok in self.seen)
        dec_w = sum(d != self.fields[k] for k, _e, d, _ok in self.seen)
        pad_w = sum(ok != want[k][1] for k, _e, _d, ok in self.seen)
        return [_check("encode_wrong", enc_w), _check("decode_wrong", dec_w),
                _check("padding_wrong", pad_w)], {"answers": len(self.seen),
                                                  "kept": len(self.seen)}


PATTERNS = {"oneshot_index": OneshotIndex, "oneshot_foreign": OneshotForeign,
            "stream_pipe": StreamPipe, "strings": Strings}


def pattern(name: str) -> type:
    """The class that a mix's ``pattern`` names: one of ``PATTERNS``, or
    the ``Pattern`` of ``portbench/calls/<name>.py``."""
    found = named.find("pattern", name, PATTERNS, "patterns.PATTERNS", CALLS)
    if name in PATTERNS:
        return found
    if not isinstance(getattr(found, "Pattern", None), type):
        raise ValueError(f"{found.__file__} defines no class Pattern(ctx)")
    return found.Pattern

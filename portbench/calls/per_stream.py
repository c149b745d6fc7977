"""Each stream with its own table: request ``i`` takes stream ``k = i %
pool``, parses that stream's table (``load_table``, a public call of the
program, timed as one), then ``encode_with_index`` and ``decode_indexed``
of object ``k`` with that table object, as a receiver that gets a table
with each stream sets it up and codes the stream.

What is kept and checked is ``oneshot_index``'s: every answer's sizes, and
the bytes of each object's first answer and of ``sample_share`` of the
rest, against the reference on the stream's own table.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import gen, named, patterns, roofline
from portbench.reference import huffman_np as R


def _tables(cfg: dict) -> list[str]:
    data = named.find("data", cfg["data"], gen.DATA, "gen.DATA", gen.INPUTS)
    return data.table_paths(cfg)


class Pattern:
    def __init__(self, ctx: patterns.Context):
        self.ctx = ctx
        self.objs = ctx.objects()
        self.bs = int(ctx.mix["block_symbols"])
        self.paths = _tables(ctx.cfg)
        t0 = time.perf_counter()
        self.refs = [R.parse_tsv(p) for p in self.paths]
        ctx.ref_s += time.perf_counter() - t0
        self.seen, self.kept = [], {}

    def _round_trip(self, k: int, rec):
        c, obj = self.ctx.codec, self.objs[k]
        t = rec.call("load_table", c.load_table, self.paths[k % len(self.paths)])
        enc, idx = rec.call("encode_with_index", c.encode_with_index, obj, t,
                            eos_padding=self.ctx.eos, block_symbols=self.bs)
        nb = len(idx.bit_offsets)
        rec.work("encode_with_index", roofline.encode_bytes(len(obj), len(enc), nb))
        dec = rec.call("decode_indexed", c.decode_indexed, enc, idx, t)
        rec.work("decode_indexed", roofline.decode_bytes(len(enc), len(dec), nb))
        return enc, idx, dec

    def warm(self, rec) -> None:
        # the objects have one shape, and every request sets its table up anew
        for k in range(min(2, len(self.objs))):
            self._round_trip(k, rec)

    def request(self, i: int) -> int:
        k = i % len(self.objs)
        enc, idx, dec = self._round_trip(k, self.ctx.rec)
        self.seen.append((k, len(enc), int(idx.total_bits), int(idx.total_symbols),
                          int(idx.max_code_len), len(idx.bit_offsets), len(dec)))
        if self.ctx.keep(i):
            self.kept[i] = (k, enc, np.asarray(idx.bit_offsets), np.asarray(idx.n_symbols), dec)
        return len(self.objs[k])

    def release(self) -> None:
        pass

    def check(self) -> list:
        eos, want = self.ctx.eos, {}
        for k in sorted({s[0] for s in self.seen} | {v[0] for v in self.kept.values()}):
            obj, ref = self.objs[k], self.refs[k % len(self.refs)]
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
        return [patterns._check("sizes_wrong", sizes), patterns._check("encode_wrong", enc_w),
                patterns._check("index_wrong", idx_w), patterns._check("decode_wrong", dec_w)], {
                    "answers": len(self.seen), "kept": len(self.kept)}

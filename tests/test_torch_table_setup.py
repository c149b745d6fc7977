"""A table's set-up in the PyTorch port: the vectorised decode LUT against
the JAX package's builder, bit for bit, and the lookups of both tables on
the same windows, on seeded random prefix-free tables; the codec on those
tables against the benchmark's NumPy reference; a staged table freed with
its table; and the set-up's counters (``ops.encode.outcomes``,
``copies``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_table_setup.py
"""

from __future__ import annotations

import gc
import importlib
import weakref

import numpy as np
import pytest
import torch

import tpu_huffman as th
import tpu_huffman_torch as tt
from portbench.reference import huffman_np as R
from tpu_huffman import tables as th_tables
from tpu_huffman_torch import metrics, tables
from tpu_huffman_torch.errors import TableError
from tpu_huffman_torch.ops import lut_lookup
from tpu_huffman_torch.ops.chain_decode import MAX_ROOT_BITS
from tpu_huffman_torch.ops.encode import DeviceTable

CPU = torch.device("cpu")
encode_mod = importlib.import_module("tpu_huffman_torch.ops.encode")  # ops.encode is the function


KINDS = ("1-32", "5-30", "one-length")


def random_table(kind: str, seed: int) -> tt.HuffmanTable:
    """A random prefix-free table, not canonical: a random binary tree
    (one chain to the longest length first, then random splits), some
    leaves dropped so that it is not always complete, its leaves given to
    random symbols. ``one-length``: a random subset of the codes of one
    length."""
    g = np.random.default_rng(seed)
    if kind == "one-length":
        length = int(g.integers(1, 9))
        n = int(g.integers(1, min(256, 1 << length) + 1))
        codes = [(int(c), length) for c in g.choice(1 << length, size=n, replace=False)]
    else:
        lo, hi = (1, 32) if kind == "1-32" else (5, 30)
        leaves = [(c, lo) for c in range(1 << lo)]
        n = int(g.integers(max(len(leaves), 40), 257))

        def split(k):
            code, length = leaves.pop(k)
            leaves.extend([(code << 1, length + 1), ((code << 1) | 1, length + 1)])

        k = int(g.integers(len(leaves)))
        for _ in range(hi - lo):  # a chain down to the longest length
            split(k)
            k = len(leaves) - int(g.integers(1, 3))
        while len(leaves) < n:
            open_ = [i for i, (_, length) in enumerate(leaves) if length < hi]
            # mostly shallow splits, so that level 1 stays a few subtables
            split(open_[int(g.integers(len(open_)))] if g.random() < 0.3 else
                  min(open_, key=lambda i: (leaves[i][1], g.random())))
        drop = g.choice(len(leaves), size=int(g.integers(0, len(leaves) // 8 + 1)), replace=False)
        codes = [c for i, c in enumerate(leaves) if i not in set(drop.tolist())]
        codes = codes if len(codes) >= 2 else leaves[:2]
    syms = g.permutation(256)[: len(codes)]
    specs = [tt.CodeSpec(int(s), length, code) for s, (code, length) in zip(syms, codes)]
    return tt.HuffmanTable.from_specs(specs, name=f"{kind}-{seed}")


CASES = [(KINDS[i % 3], 2300 + i) for i in range(16)]


def _windows(table, seed: int) -> list[int]:
    """Every code followed by all-zero and all-one tails, the windows one
    below and one above each code's range, and 4,096 random windows."""
    out = []
    for sym in np.flatnonzero(table.lengths):
        ln = int(table.lengths[sym])
        lo = int(table.patterns[sym]) << (32 - ln)
        hi = lo | ((1 << (32 - ln)) - 1)
        out += [lo, hi, (lo - 1) & 0xFFFFFFFF, (hi + 1) & 0xFFFFFFFF]
    rng = np.random.default_rng(seed)
    return out + [int(x) for x in rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)]


@pytest.mark.parametrize("kind,seed", CASES)
def test_the_lut_is_the_reference_packages_bit_for_bit(kind, seed):
    t = random_table(kind, seed)
    ref_specs = [th.CodeSpec(s.symbol, s.num_bits, s.pattern) for s in t.specs()]
    for root in (12, 9, 16):
        want = th_tables._build_decode_lut(t.lengths, t.patterns, root)
        got = tables._build_decode_lut(t.lengths, t.patterns, root)
        assert got[4] == want[4]
        for g, w in zip(got[:4], want[:4]):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        # both packages' tables at this root decode the same windows alike
        ref = th.HuffmanTable.from_specs(ref_specs, root_bits=root)
        port = tt.HuffmanTable.from_specs(t.specs(), root_bits=root)
        windows = _windows(ref, seed)
        decoded = [ref.decode_window(w) for w in windows]
        assert [port.decode_window(w) for w in windows] == decoded
        # staged at min(root, 12): packed for the kernels, and the plain
        # versions' arrays, each against the reference's LUT at that root
        l0b, l0v, l1b, l1v, rb = th_tables._build_decode_lut(
            t.lengths, t.patterns, min(root, MAX_ROOT_BITS))
        if l1b.size >= 1 << 23:  # more than the packed entry holds
            with pytest.raises(ValueError, match="too large"):
                DeviceTable(port, CPU)
            continue
        dt = DeviceTable(port, CPU)
        assert dt.root_bits == rb
        np.testing.assert_array_equal(dt.l0.numpy(), (l0v.astype(np.int64) << 8) | (l0b & 0xFF))
        np.testing.assert_array_equal(dt.l1.numpy(), (l1v.astype(np.int64) << 8) | l1b)
        for name, w in zip(("l0_bits", "l0_val", "l1_bits", "l1_val"), (l0b, l0v, l1b, l1v)):
            np.testing.assert_array_equal(getattr(dt, name).numpy(), w)
        sym, bits = lut_lookup(torch.tensor(windows, dtype=torch.int64), dt)
        assert list(zip(sym.tolist(), bits.tolist())) == [(s if b else 0, b) for s, b in decoded]


def _matched(ref: R.Table, n: int, seed: int) -> bytes:
    """``n`` symbols, each drawn with weight 2^-length over the table's codes."""
    syms = np.flatnonzero(ref.lengths)
    w = np.exp2(-ref.lengths[syms].astype(np.float64))
    return np.random.default_rng(seed).choice(syms, size=n, p=w / w.sum()).astype(
        np.uint8).tobytes()


@pytest.mark.parametrize("kind,seed", CASES)
def test_the_codec_on_the_table_matches_the_reference(kind, seed, tmp_path):
    t = random_table(kind, seed)
    (tmp_path / "t.tsv").write_text(t.to_tsv())
    t = tt.HuffmanTable.from_tsv_file(str(tmp_path / "t.tsv"))
    ref = R.parse_tsv(str(tmp_path / "t.tsv"))
    data = _matched(ref, 12000, seed)
    enc, idx = tt.encode_with_index(data, t, eos_padding=0xFF, block_symbols=512, device=CPU)
    assert enc == R.encode(data, ref, 0xFF)
    want = R.block_index(np.frombuffer(data, np.uint8), ref, 512)
    np.testing.assert_array_equal(np.asarray(idx.bit_offsets), want["bit_offsets"])
    np.testing.assert_array_equal(np.asarray(idx.n_symbols), want["n_symbols"])
    assert tt.decode_indexed(enc, idx, t, device=CPU) == data
    try:
        plain = R.decode(enc, ref)
    except R.UnknownSymbol:  # the padding begins no code and the longest code fits in it
        with pytest.raises(tt.UnknownSymbolError):
            tt.decode(enc, t, device=CPU)
    else:
        assert tt.decode(enc, t, device=CPU) == plain
        assert plain[: len(data)] == data


def test_a_wide_root_stages_the_lut_at_twelve_bits():
    t = random_table("5-30", 7)
    wide = tt.HuffmanTable.from_specs(t.specs(), root_bits=16)
    assert wide.root_bits == 16
    a, b = DeviceTable(t, CPU), DeviceTable(wide, CPU)
    assert a.root_bits == b.root_bits == 12
    assert torch.equal(a.l0, b.l0) and torch.equal(a.l1, b.l1)


def test_a_staged_table_goes_with_its_table():
    """200 fresh tables one after another, each dropped after its use: each
    is staged once while held, and its staging is freed with it."""
    text = random_table("5-30", 11).to_tsv()
    n = encode_mod.outcomes["device_tables"]
    gone = []
    for i in range(200):
        t = tt.HuffmanTable._from_rows(tables._tsv_rows(text), "fresh", 12, 0)
        dt = DeviceTable.for_table(t, CPU)
        assert DeviceTable.for_table(t, CPU) is dt and list(t.staged) == ["cpu"]
        assert dt.table.max_len == 30 and dt.table.lengths is t.lengths  # a copy, no cycle
        gone.append(weakref.ref(dt))
        del t, dt  # freed at once, without a collection: no cycle holds it
        assert gone[-1]() is None
    assert encode_mod.outcomes["device_tables"] == n + 200
    gc.collect()
    assert not [r for r in gone if r() is not None]


def test_each_set_up_counts_once_with_its_time_and_uploads(tmp_path):
    (tmp_path / "t.tsv").write_text(random_table("1-32", 5).to_tsv())
    before = metrics.counters_snapshot()
    t = tt.HuffmanTable.from_tsv_file(str(tmp_path / "t.tsv"))
    assert t.build_ns > 0
    data = _matched(R.parse_tsv(str(tmp_path / "t.tsv")), 5000, 5)
    enc, idx = tt.encode_with_index(data, t, device=CPU)
    assert tt.decode_indexed(enc, idx, t, device=CPU) == data
    tt.encode(data, t, device=CPU)
    after = metrics.counters_snapshot()
    grew = {k: v - before.get(k, 0) for k, v in after.items()}
    assert grew["ops.encode.outcomes.device_tables"] == 1
    assert grew["ops.encode.outcomes.device_table_ns"] >= t.build_ns
    dt = DeviceTable.for_table(t, CPU)
    table_bytes = grew["ops.encode.outcomes.device_table_h2d_bytes"]
    assert table_bytes >= 4 * (256 + 256 + dt.l0.numel() + dt.l1.numel())
    assert table_bytes < 4 * (256 + 256 + dt.l0.numel() + dt.l1.numel() + 4 * 64)
    # the table's one upload is among the copies: with the plaintext twice,
    # the stream and the index's three arrays
    assert grew["copies.h2d"] == 1 + 2 + 1 + 3
    assert grew["copies.h2d_bytes"] == (table_bytes + 2 * len(data) + len(enc)
                                        + len(idx.bit_offsets) * (8 + 4 + 8))


def test_the_plain_arrays_are_made_only_when_read():
    dt = DeviceTable(random_table("5-30", 3), CPU)
    assert not {"l0_bits", "l0_val", "l1_bits", "l1_val"} & set(vars(dt))
    assert dt.l1_val.dtype == torch.int64 and "l1_val" in vars(dt)


@pytest.mark.parametrize("row,words", [
    ("300\t5\t1", "symbol 300 out of range"),
    ("3\t0\t0", "code length 0 out of range"),
    ("3\t33\t0", "code length 33 out of range"),
    ("3\t2\t7", "wider than num_bits=2"),
])
def test_a_bad_tsv_row_raises_as_the_code_spec_does(row, words, tmp_path):
    (tmp_path / "t.tsv").write_text(f"# a table\n1\t1\t0\n{row}\n")
    for parse in (lambda: tables.parse_tsv((tmp_path / "t.tsv").read_text()),
                  lambda: tt.HuffmanTable.from_tsv_file(str(tmp_path / "t.tsv"))):
        with pytest.raises(TableError, match=words):
            parse()


def test_a_symbol_twice_and_a_prefix_clash_raise(tmp_path):
    (tmp_path / "twice.tsv").write_text("1\t1\t0\n2\t2\t2\n1\t2\t3\n")
    with pytest.raises(TableError, match="symbol 1 defined twice"):
        tt.HuffmanTable.from_tsv_file(str(tmp_path / "twice.tsv"))
    (tmp_path / "clash.tsv").write_text("1\t1\t0\n2\t3\t1\n3\t1\t1\n")
    with pytest.raises(TableError, match="not prefix-free at symbol 2"):
        tt.HuffmanTable.from_tsv_file(str(tmp_path / "clash.tsv"))

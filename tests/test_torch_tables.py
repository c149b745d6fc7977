"""The PyTorch port's tables against the JAX package's (exact: tables are
integer data, so the tolerance is zero)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from tpu_huffman_torch.ops import DeviceTable, lut_lookup  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("patterns", "lengths", "l0_bits", "l0_val", "l1_bits", "l1_val")
CANONICAL = {s: 6 + s % 8 for s in range(0, 256, 3)}  # lengths 6..13, Kraft < 1


def _pair(kind):
    if kind == "static":
        return th.load_static_test_table(), tt.load_static_test_table()
    if kind == "hpack":
        return th.load_hpack_table(), tt.load_hpack_table()
    return th.make_canonical(CANONICAL), tt.make_canonical(CANONICAL)


@pytest.mark.parametrize("kind", ["static", "hpack", "canonical"])
def test_table_equals_reference(kind):
    ref, port = _pair(kind)
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("root_bits", "min_len", "max_len", "name"):
        assert getattr(ref, f) == getattr(port, f), f
    conv = tt.from_reference(ref)
    for f in FIELDS:
        assert np.array_equal(getattr(conv, f), getattr(port, f)), f
    assert (conv.root_bits, conv.min_len, conv.max_len, conv.name) == (
        port.root_bits, port.min_len, port.max_len, port.name)
    assert [(s.symbol, s.num_bits, s.pattern) for s in conv.specs()] == [
        (s.symbol, s.num_bits, s.pattern) for s in ref.specs()]


def _windows_at_boundaries(table):
    """Every code followed by all-zero and all-one tails, and the windows
    one below and one above each code's range."""
    out = []
    for s in range(256):
        ln = int(table.lengths[s])
        if not ln:
            continue
        lo = int(table.patterns[s]) << (32 - ln)
        hi = lo | ((1 << (32 - ln)) - 1)
        out += [lo, hi, (lo - 1) & 0xFFFFFFFF, (hi + 1) & 0xFFFFFFFF]
    return out


@pytest.mark.parametrize("kind", ["static", "hpack", "canonical"])
def test_decode_window_equals_reference(kind):
    ref, port = _pair(kind)
    rng = np.random.default_rng(11)
    windows = _windows_at_boundaries(ref) + [
        int(x) for x in rng.integers(0, 1 << 32, size=1 << 16, dtype=np.uint64)
    ]
    want = [ref.decode_window(w) for w in windows]
    assert [port.decode_window(w) for w in windows] == want
    # the vectorised lookup the plain decode runs
    dt = DeviceTable.for_table(port, torch.device("cpu"))
    sym, bits = lut_lookup(torch.tensor(windows, dtype=torch.int64), dt)
    assert list(zip(sym.tolist(), bits.tolist())) == [
        (s if b else 0, b) for s, b in want
    ]


def test_table_validation_matches_reference():
    not_prefix_free = [(97, 2, 0b01), (98, 3, 0b010)]
    with pytest.raises(th.TableError):
        th.HuffmanTable.from_specs([th.CodeSpec(*s) for s in not_prefix_free])
    with pytest.raises(tt.TableError):
        tt.HuffmanTable.from_specs([tt.CodeSpec(*s) for s in not_prefix_free])
    with pytest.raises(tt.TableError):
        tt.make_canonical({0: 1, 1: 1, 2: 1})  # Kraft sum 1.5
    with pytest.raises(tt.TableError):
        tt.CodeSpec(1, 3, 0b1000)  # pattern wider than its length


def test_import_leaves_jax_out():
    code = (
        "import sys, tpu_huffman_torch, tpu_huffman_torch.ops, tpu_huffman_torch.stream,"
        " tpu_huffman_torch.testing, tpu_huffman_torch.prof, tpu_huffman_torch.prof.lut,"
        " tpu_huffman_torch.prof.mma_lut, tpu_huffman_torch.prof.latency,"
        " tpu_huffman_torch.prof.pack_ablate, tpu_huffman_torch.shard,"
        " tpu_huffman_torch.distributed, tpu_huffman_torch.corpora,"
        " tpu_huffman_torch.metrics, tpu_huffman_torch.huffgen, tpu_huffman_torch.oracle,"
        " tpu_huffman_torch.entry, tpu_huffman_torch.examples.hpack_headers,"
        " tpu_huffman_torch.examples.mesh_pipeline;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_huffman')];"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)

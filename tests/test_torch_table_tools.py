"""The port's table tools and corpora against the JAX package's.

Tables are integer data, so every comparison is exact: code lengths,
every table field, artifacts byte for byte, errors by type and message.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from tpu_huffman import corpora as th_corpora  # noqa: E402
from tpu_huffman import tables as th_tables  # noqa: E402
from tpu_huffman_torch import corpora as tt_corpora  # noqa: E402
from tpu_huffman_torch import tables as tt_tables  # noqa: E402

from test_huffgen_cli import SAMPLE_DEF  # noqa: E402

FIELDS = ("patterns", "lengths", "l0_bits", "l0_val", "l1_bits", "l1_val")


def assert_same_table(port, ref):
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("root_bits", "min_len", "max_len", "name"):
        assert getattr(ref, f) == getattr(port, f), f
    assert_same_table_arrays(tt.from_reference(ref), port)


def assert_same_table_arrays(a, b):
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _raises_alike(fn_ref, fn_port, *args, **kw):
    with pytest.raises(th.TableError) as want:
        fn_ref(*args, **kw)
    with pytest.raises(tt.TableError) as got:
        fn_port(*args, **kw)
    assert str(got.value) == str(want.value)


def test_public_surface_covers_the_jax_package():
    assert set(th.__all__) <= set(tt.__all__)


@pytest.mark.parametrize("max_len", [8, 14, 16, 32])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_optimal_code_lengths(seed, max_len):
    rng = np.random.default_rng(seed)
    uniform = rng.integers(1, 10_000, size=200) * (rng.random(200) < 0.8)
    skewed = np.round(2.0 ** rng.uniform(0, 24, size=90)).astype(np.int64)  # deep codes
    for freqs in (uniform, skewed):
        got = tt.optimal_code_lengths(freqs, max_len=max_len)
        want = th.optimal_code_lengths(freqs, max_len=max_len)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert got.max() <= max_len


def test_optimal_code_lengths_edges():
    one = np.zeros(256, np.int64)
    one[200] = 5
    assert np.array_equal(tt.optimal_code_lengths(one), th.optimal_code_lengths(one))
    assert tt.optimal_code_lengths(one)[200] == 1
    _raises_alike(th.optimal_code_lengths, tt.optimal_code_lengths, np.ones(256), max_len=7)
    _raises_alike(th.optimal_code_lengths, tt.optimal_code_lengths, np.zeros(256))


def test_build_table():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=30_000, dtype=np.uint8) % 97
    freqs = np.bincount(rng.integers(0, 40, size=5000), minlength=256)
    for kw in ({"data": data.tobytes(), "max_len": 14}, {"data": data, "max_len": 8},
               {"freqs": freqs, "max_len": 16, "name": "f"}):
        assert_same_table(tt.build_table(**kw), th.build_table(**kw))
    _raises_alike(th.build_table, tt.build_table)
    _raises_alike(th.build_table, tt.build_table, data=b"ab", freqs=freqs)


def test_safe_eos_padding():
    pairs = [
        (th.load_static_test_table(), tt.load_static_test_table()),
        (th.load_hpack_table(), tt.load_hpack_table()),
    ]
    corpus = th_corpora.canterbury_like(20_000)
    pairs.append((th.build_table(corpus, max_len=14), tt.build_table(corpus, max_len=14)))
    # Kraft-complete, codes <= 7 bits: every padding tail completes a code
    complete = {s: 7 for s in range(128)}
    pairs.append((th.make_canonical(complete), tt.make_canonical(complete)))
    got = [tt.safe_eos_padding(port) for _ref, port in pairs]
    assert got == [th.safe_eos_padding(ref) for ref, _port in pairs]
    assert got[-1] is None


def _def_text(table):
    """A .def file of every code of ``table``, bit strings included."""
    lines = ["/* written from the table's specs */", "#ifndef X"]
    for s in table.specs():
        bits = format(s.pattern, f"0{s.num_bits}b")
        lines.append(f'HUFFMAN_CODE({s.symbol}, "{bits}", 0x{s.pattern:x}, {s.num_bits})')
    return "\n".join(lines + ["#endif"]) + "\n"


def test_parse_def_and_from_def_file(tmp_path):
    static = th.load_static_test_table()
    for text in (SAMPLE_DEF, _def_text(static)):
        want = [(s.symbol, s.num_bits, s.pattern) for s in th_tables.parse_def(text)]
        got = [(s.symbol, s.num_bits, s.pattern) for s in tt_tables.parse_def(text)]
        assert got == want and got
        path = tmp_path / "t.def"
        path.write_text(text)
        assert_same_table(tt.HuffmanTable.from_def_file(str(path)),
                          th.HuffmanTable.from_def_file(str(path)))
    assert_same_table_arrays(
        tt.HuffmanTable.from_def_file(str(path)), tt.load_static_test_table())
    mismatch = 'HUFFMAN_CODE(65, "01", 0x2, 2)\n'
    twice = 'HUFFMAN_CODE(65, "0", 0x0, 1)\nHUFFMAN_CODE(65, "1", 0x1, 1)\n'
    for bad in (mismatch, twice):
        _raises_alike(th_tables.parse_def, tt_tables.parse_def, bad)


def test_artifacts_cross_load(tmp_path):
    for ref, port in ((th.load_static_test_table(), tt.load_static_test_table()),
                      (th.load_hpack_table(), tt.load_hpack_table())):
        assert port.to_tsv() == ref.to_tsv()
        ref.save(str(tmp_path / "ref"))
        port.save(str(tmp_path / "port"))
        assert_same_table(tt.HuffmanTable.load(str(tmp_path / "ref.npz")), ref)
        assert_same_table(port, th.HuffmanTable.load(str(tmp_path / "port.npz")))
        with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        for s in (0, 65, 255):
            assert port.encode_symbol(s) == ref.encode_symbol(s)
    sparse = tt.make_canonical({65: 1, 66: 2})
    assert sparse.encode_symbol(65) == (0, 1) and sparse.encode_symbol(67) == (0, 0)


@pytest.mark.parametrize("name", sorted(th_corpora.CATEGORIES) + ["canterbury_like"])
def test_corpora_same_bytes(name):
    ref = getattr(th_corpora, name)
    port = getattr(tt_corpora, name)
    for n, seed in ((1, 0), (1000, 3), (20_000, 42)):
        got = port(n, seed)
        assert got == ref(n, seed) and len(got) == n
    assert port(5000) == ref(5000)  # each generator's default seed

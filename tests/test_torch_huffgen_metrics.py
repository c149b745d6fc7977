"""The port's huffgen CLI and metrics against the JAX package's.

The CLIs must write the same artifacts (TSV text and .npz arrays, exactly)
and exit alike; the counters must count the same calls and bytes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from tpu_huffman import metrics as th_metrics  # noqa: E402
from tpu_huffman.huffgen import main as th_huffgen  # noqa: E402
from tpu_huffman_torch import metrics  # noqa: E402
from tpu_huffman_torch.huffgen import main as tt_huffgen  # noqa: E402

from test_huffgen_cli import SAMPLE_DEF  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def def_file(tmp_path):
    p = tmp_path / "sample.def"
    p.write_text(SAMPLE_DEF)
    return str(p)


def test_same_artifacts(def_file, tmp_path):
    for name, main in (("ref", th_huffgen), ("port", tt_huffgen)):
        assert main([def_file, "--tsv", str(tmp_path / f"{name}.tsv"),
                     "--npz", str(tmp_path / f"{name}.npz")]) == 0
    assert (tmp_path / "port.tsv").read_text() == (tmp_path / "ref.tsv").read_text()
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # run as a module, from a TSV input
    out = tmp_path / "again.tsv"
    subprocess.run([sys.executable, "-m", "tpu_huffman_torch.huffgen",
                    str(tmp_path / "port.tsv"), "--tsv", str(out)],
                   cwd=REPO, check=True, timeout=120)
    assert out.read_text() == (tmp_path / "ref.tsv").read_text()


def test_check_and_bad_table(def_file, tmp_path, capsys):
    assert th_huffgen([def_file, "--check"]) == 0
    want = capsys.readouterr().out
    assert tt_huffgen([def_file, "--check"]) == 0
    got = capsys.readouterr().out
    prefix = "ok: 6 codes, lengths 2..3, root_bits=3"
    assert want.startswith(prefix) and got.startswith(prefix)
    assert "lut=3-bit root, 1 level" in got
    bad = tmp_path / "bad.def"
    bad.write_text('HUFFMAN_CODE(65, "0", 0x0, 1)\n'
                   'HUFFMAN_CODE(66, "1", 0x1, 1)\n'
                   'HUFFMAN_CODE(67, "10", 0x2, 2)\n')
    assert th_huffgen([str(bad), "--check"]) == tt_huffgen([str(bad), "--check"]) == 1
    hpack = tmp_path / "hpack.tsv"
    hpack.write_text(tt.load_hpack_table().to_tsv())
    assert tt_huffgen([str(hpack), "--check"]) == 0
    assert "lut=12-bit root, 2 levels" in capsys.readouterr().out


def test_counters_off_by_default():
    metrics.counters.reset()
    tt.encode(b"no counting", tt.load_static_test_table(), device="cpu")
    assert metrics.counters.encode_calls == 0


def test_counters_record_when_enabled():
    """The same calls as tests/test_metrics.py, on both packages."""
    snaps = []
    for pkg, mod, kw in ((th, th_metrics, {}), (tt, metrics, {"device": "cpu"})):
        mod.counters.reset()
        mod.enable(True)
        try:
            t = pkg.load_static_test_table()
            enc = pkg.encode(b"count me", t, **kw)
            assert pkg.decode(enc, t, **kw) == b"count me"
            pkg.encode_with_index(b"not counted", t, **kw)  # only encode and decode count
            snaps.append(mod.counters.snapshot())
        finally:
            mod.enable(False)
            mod.counters.reset()
    want, got = snaps
    assert set(got) == set(want)
    for k in ("encode_calls", "decode_calls", "bytes_in", "bytes_out", "blocks"):
        assert got[k] == want[k], k
    assert got["encode_calls"] == got["decode_calls"] == 1
    assert got["encode_seconds"] > 0 and got["decode_seconds"] > 0


def test_trace_writes_a_file(tmp_path):
    t = tt.load_static_test_table()
    with metrics.trace(str(tmp_path / "trace")):
        tt.encode(b"traced", t, device="cpu")
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(tmp_path / "trace" / files[0]) > 0

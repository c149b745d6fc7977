"""CPU tests of the ``table_5_30`` configuration and its cell
``table_5_30.per_stream``: the cell runs correct in a copy of the
benchmark (as ``test_harness_files.py`` runs an added cell), its control
does not, the 64 tables are what their script writes, each object is
matched to its own table, and the table set-up's readers read the
program's counters, or nothing where it has none.

    python -m pytest portbench/tests/test_table_5_30.py
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_harness_files import PB, _copy, _run_in  # noqa: E402

from portbench import gen, harness, named  # noqa: E402
from portbench.reference import huffman_np as R  # noqa: E402

CELL = "table_5_30.per_stream"
SEED = 2**33 + 23
SMALL = {"object_bytes": 65536, "pool": 4}
CONFIGS = os.path.join(PB, "configs")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cell in a copy of the benchmark at a small size: with the
    program, with the control, and with the control's codec with nothing
    broken."""
    root = tmp_path_factory.mktemp("table_5_30")
    _copy(root)
    return _run_in(root, f"""
r = harness.resolve(harness.load_spec(ROOT), {CELL!r}, ROOT)
def run(codec):
    return harness.run({CELL!r}, {SEED}, 0.5, False, time.time(), device="cpu", codec=codec,
                       mix_override={SMALL!r}, root=ROOT)[0]
ok = codecs.ControlCodec(r["mix"]["control"])
ok.broken = None
print(json.dumps({{"program": run(None), "control": run(codecs.ControlCodec(r["mix"]["control"])),
                  "reference": run(ok)}}))
""")


def test_the_cell_runs_correct_on_the_cpu(runs):
    prog = runs["program"]
    assert prog["correct"], prog["checks"]
    assert prog["failed"] == 0 and prog["attempted"] >= 1
    assert prog["checked"]["answers"] == prog["attempted"]
    assert set(prog["metrics"]) == {"plaintext_GBps", "call_p95_ms", "setup_s"}
    # a table set up for every request
    assert prog["counters"]["ops.encode.outcomes.device_tables"] == prog["attempted"]


def test_the_control_in_the_programs_place_is_not_correct(runs):
    assert not runs["control"]["correct"], runs["control"]["checks"]
    assert runs["control"]["checks"]["encode_wrong"]["value"] > 0
    assert runs["reference"]["correct"], runs["reference"]["checks"]


def test_the_tables_are_what_their_script_writes(tmp_path):
    subprocess.run([sys.executable, os.path.join(CONFIGS, "fit_table_5_30.py"), str(tmp_path)],
                   check=True, timeout=300)
    cfg = json.loads((tmp_path / "table_5_30.json").read_text())
    with open(os.path.join(CONFIGS, "table_5_30.json")) as f:
        assert cfg == json.load(f)
    assert len(cfg["tables"]) == 64 and cfg["table"] == cfg["tables"][0]["file"]
    for t in cfg["tables"]:
        with open(os.path.join(CONFIGS, t["file"]), "rb") as f:
            committed = hashlib.sha256(f.read()).hexdigest()
        written = hashlib.sha256((tmp_path / t["file"]).read_bytes()).hexdigest()
        assert committed == written == t["sha256"], t["file"]


def _cell():
    r = harness.resolve(harness.load_spec(), CELL)
    data = named.find("data", r["cfg"]["data"], gen.DATA, "gen.DATA", gen.INPUTS)
    return r, [R.parse_tsv(p) for p in data.table_paths(r["cfg"])]


def test_every_table_has_the_lengths_of_config_3():
    _r, refs = _cell()
    want = np.bincount(refs[0].lengths[refs[0].lengths > 0], minlength=31)
    assert want[5] == 30 and want[30] == 182 and all(1 <= want[n] <= 2 for n in range(6, 30))
    assert len({r.lengths.tobytes() for r in refs}) == 64  # each its own permutation
    for r in refs:
        assert np.array_equal(np.bincount(r.lengths[r.lengths > 0], minlength=31), want)
        assert (r.min_len, r.max_len) == (5, 30) and int(r.spans.sum()) == 1 << 32


def test_object_k_decodes_under_table_k_only():
    r, refs = _cell()
    n = 20000
    objs = [r["inputs"].make(n, SEED, k) for k in range(4)]
    for k, obj in enumerate(objs):
        # drawn with weight 2^-length over its own table's codes: 30 of 32
        # symbols take its 5-bit codes
        share5 = np.mean(refs[k].lengths[obj] == 5)
        assert 0.92 < share5 < 0.955
        stream = R.encode(obj.tobytes(), refs[k], 0xFF)
        for j in range(4):
            try:
                got = R.decode(stream, refs[j])
            except R.UnknownSymbol:
                got = None
            assert (got == obj.tobytes()) == (j == k), (k, j)


def test_the_inputs_are_a_function_of_the_seed():
    r, _refs = _cell()
    make = r["inputs"].make
    a = make(4096, SEED, 1).tobytes()
    assert a == make(4096, SEED, 1).tobytes()
    assert a != make(4096, SEED + 1, 1).tobytes() and a != make(4096, SEED, 2).tobytes()
    assert make(4096, SEED, 65).tobytes() != a  # object 65 is table 1's too, but its own draw


@pytest.mark.parametrize("name,scale", [("device_tables_per_request", 1),
                                        ("table_setup_ms_per_request", 1e-6),
                                        ("table_upload_kib_per_request", 1 / 1024)])
def test_the_table_set_up_readers(name, scale):
    read = harness.reader(name)
    key = {"device_tables_per_request": "device_tables",
           "table_setup_ms_per_request": "device_table_ns",
           "table_upload_kib_per_request": "device_table_h2d_bytes"}[name]
    counters = {f"ops.encode.outcomes.{key}": 3000}
    assert read({"requests": 3, "counters": counters}) == pytest.approx(1000 * scale)
    assert read({"requests": 3, "counters": {}}) is None  # a program without the counter
    assert read({"requests": 0, "counters": counters}) is None

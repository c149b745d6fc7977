"""CPU tests of the inputs and call patterns that a configuration or a mix
brings as files of its own (``portbench/inputs/<data>.py``,
``portbench/calls/<pattern>.py``): a cell added so runs and is checked,
the built-in names resolve as they did, and a bad name is refused before
set-up. Each test on added files runs in a copy of ``portbench/``.

    python -m pytest portbench/tests/test_harness_files.py
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
ADDED = os.path.join(HERE, "added")  # the files a test adds to its copy
sys.path.insert(0, ROOT)

from portbench import gen, harness, patterns  # noqa: E402

SEED = 2**31 + 21
# SHA-256 of each built-in generator's first input at SEED, from gen.py as
# it was before inputs could come from files: 8 MiB of canterbury_like,
# 1 MiB of hpack_stream, and the 8192 header strings of header_fields,
# each after its length as 4 little-endian bytes.
DIGESTS = {
    "canterbury_like": "19e5d4448a5794a5b4130c42c16a7078b522c7393da4b84b0246aca106416ffc",
    "hpack_stream": "aa01f1085341ea02c5c0f75883fb7293751e4a8e04806ac5b115a3a0282df129",
    "header_fields": "1fdccc9933c360517c65c97055b0ef99fc4e414f2625a253edf0edfeed3f0e50",
}


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _strings_sha(strings: list[bytes]) -> str:
    return _sha(b"".join(struct.pack("<I", len(s)) + s for s in strings))


def _copy(root) -> dict:
    """A copy of the benchmark under ``root``; the SHA-256 of each file."""
    shutil.copytree(PB, root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return _files(root)


def _files(root) -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = _sha(fh.read())
    return out


def _add(root, spec: dict, config: dict, mix_name: str, mix: dict) -> str:
    """A configuration and a mix added to the copy as files, and their
    cell to ``spec``; the cell's name."""
    conf_dir = root / "portbench" / "configs"
    (conf_dir / (config["name"] + ".json")).write_text(json.dumps(config))
    (root / "portbench" / "traffic" / (mix_name + ".json")).write_text(json.dumps(mix))
    if all(c["name"] != config["name"] for c in spec["configs"]):
        spec["configs"].append({"name": config["name"], "source": "a test",
                                "file": f"portbench/configs/{config['name']}.json",
                                "reduced": [], "why": "a test"})
    cell = f"{config['name']}.{mix_name}"
    spec["workloads"].append({"name": cell, "config": config["name"], "traffic": mix_name,
                              "chips": 1, "why": "a test"})
    return cell


def _run_in(root, body: str) -> dict:
    """``body`` in a fresh process whose ``portbench`` is the copy's; the
    JSON object it prints last."""
    code = ("import sys, time, json\n"
            f"sys.path[:0] = [{str(root)!r}, {ROOT!r}]\n"
            "from portbench import codecs, harness, patterns\n"
            f"assert harness.__file__.startswith({str(root)!r}), harness.__file__\n"
            f"ROOT = {str(root)!r}\n" + body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# -- a configuration with its own inputs and a mix with its own calls -----------------------


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """A copy with ``inputs/matched.py`` and ``calls/pieces.py`` added, and
    the cell ``matched.pieces`` on a copy of the HPACK table, run once with
    the program, once with the control and once with the control's codec
    with nothing broken."""
    root = tmp_path_factory.mktemp("added")
    before = _copy(root)
    pb = root / "portbench"
    for kind, name in (("inputs", "matched"), ("calls", "pieces")):
        os.makedirs(pb / kind, exist_ok=True)
        shutil.copy(os.path.join(ADDED, kind, name + ".py"), pb / kind / (name + ".py"))
    shutil.copy(pb / "configs" / "hpack.tsv", pb / "configs" / "matched.tsv")
    spec = harness.load_spec()
    cell = _add(root, spec, {"name": "matched", "table": "matched.tsv", "eos_padding": 255,
                             "data": "matched"},
                "pieces", {"pattern": "pieces", "pool": 24, "warm_strings": 4,
                           "piece_bytes": 7, "control": "eos_zero"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = _run_in(root, f"""
r = harness.resolve(harness.load_spec(ROOT), {cell!r}, ROOT)
make, fields = r["inputs"]
def run(codec):
    return harness.run({cell!r}, {SEED}, 0.3, False, time.time(), device="cpu", codec=codec,
                       root=ROOT)[0]
ok = codecs.ControlCodec(r["mix"]["control"])
ok.broken = None
print(json.dumps({{
    "files": sorted(m.__file__ for n, m in sys.modules.items()
                    if n.startswith(("portbench_inputs_", "portbench_calls_"))),
    "program": run(None), "control": run(codecs.ControlCodec(r["mix"]["control"])),
    "reference": run(ok),
    "make": [make(4096, s, i).tobytes().hex() for s, i in
             (({SEED}, 0), ({SEED}, 0), ({SEED} + 1, 0), ({SEED}, 1))],
    "fields": [[f.hex() for f in fields(16, s, i)] for s, i in
               (({SEED}, 0), ({SEED}, 0), ({SEED} + 1, 0), ({SEED}, 1))],
}}))
""")
    return {"root": root, "before": before, "res": res}


def test_a_cell_with_its_own_inputs_and_calls_runs_correct_on_the_cpu(added):
    res, pb = added["res"], str(added["root"] / "portbench")
    prog = res["program"]
    assert prog["correct"], prog["checks"]
    assert prog["failed"] == 0 and prog["attempted"] >= 1
    assert prog["checked"]["answers"] == prog["attempted"]
    assert res["files"] == [os.path.join(pb, "calls", "pieces.py"),
                            os.path.join(pb, "inputs", "matched.py")]
    before, after = added["before"], _files(added["root"])
    assert {f: after[f] for f in before if f != "BENCHMARK.json"} == {
        f: h for f, h in before.items() if f != "BENCHMARK.json"}  # no file of it edited
    assert set(after) - set(before) == {
        "portbench/inputs/matched.py", "portbench/calls/pieces.py",
        "portbench/configs/matched.tsv", "portbench/configs/matched.json",
        "portbench/traffic/pieces.json"}


def test_the_control_in_the_added_cell_is_not_correct(added):
    ctl, ref = added["res"]["control"], added["res"]["reference"]
    assert not ctl["correct"], ctl["checks"]
    assert ref["correct"], ref["checks"]  # what fails the control is its broken guarantee


def test_a_file_generator_is_a_function_of_the_seed(added):
    for key in ("make", "fields"):
        same, again, other_seed, other_index = added["res"][key]
        assert same == again and same != other_seed and same != other_index
    assert len(bytes.fromhex(added["res"]["make"][0])) == 4096
    assert all(1 <= len(bytes.fromhex(f)) <= 64 for f in added["res"]["fields"][0])


# -- the built-in names --------------------------------------------------------------------


@pytest.mark.parametrize("cell,make,fields,pattern", [
    ("canterbury.roundtrip", gen.canterbury_like, None, patterns.OneshotIndex),
    ("canterbury.foreign_decode", gen.canterbury_like, None, patterns.OneshotForeign),
    ("hpack.headers", gen.hpack_stream, gen.header_fields, patterns.Strings),
])
def test_each_cell_resolves_to_the_objects_it_did(cell, make, fields, pattern):
    r = harness.resolve(harness.load_spec(), cell)
    assert r["inputs"].make is make and r["inputs"].fields is fields and r["pattern"] is pattern
    ctx = patterns.Context(None, None, None, r["cfg"], {**r["mix"], "pool": 1}, SEED, None)
    assert ctx.inputs == r["inputs"]


@pytest.mark.parametrize("config", ["canterbury", "hpack"])
def test_the_first_input_of_each_configuration_keeps_its_bytes(config):
    spec = harness.load_spec()
    cell = next(c["name"] for c in spec["workloads"] if c["config"] == config)
    r = harness.resolve(spec, cell)
    ctx = patterns.Context(None, None, None, r["cfg"], {**r["mix"], "pool": 1}, SEED, None)
    if config == "canterbury":
        assert _sha(ctx.objects()[0]) == DIGESTS["canterbury_like"]
    else:
        assert _sha(ctx.inputs.make(1 << 20, SEED, 0).tobytes()) == DIGESTS["hpack_stream"]
        strings = ctx.inputs.fields(int(r["mix"]["pool"]), SEED)  # as Strings draws them
        assert _strings_sha(strings) == DIGESTS["header_fields"]


# -- bad names -----------------------------------------------------------------------------

BAD = [  # (what names it, the name, the error's words)
    ("data", "nowhere", "neither"),
    ("data", "hpack_stream", "both"),
    ("data", "inputs/matched", "not of"),
    ("data", "..", "not of"),
    ("pattern", "nowhere", "neither"),
    ("pattern", "strings", "both"),
    ("pattern", "../calls/pieces", "not of"),
]


@pytest.fixture(scope="module")
def refused(tmp_path_factory):
    """A copy in which ``data`` or ``pattern`` names each of ``BAD``;
    what ``resolve`` and ``run`` raise on each."""
    root = tmp_path_factory.mktemp("refused")
    _copy(root)
    pb = root / "portbench"
    for kind, name in (("inputs", "hpack_stream"), ("calls", "strings")):
        os.makedirs(pb / kind, exist_ok=True)
        (pb / kind / (name + ".py")).write_text("")
    spec, cells = harness.load_spec(), []
    for k, (what, name, _words) in enumerate(BAD):
        config = {**json.loads((pb / "configs" / "canterbury.json").read_text()),
                  "name": f"bad{k}", "table": "canterbury.tsv"}
        mix = json.loads((pb / "traffic" / "roundtrip.json").read_text())
        (config if what == "data" else mix)[what] = name
        cells.append(_add(root, spec, config, f"bad{k}", mix))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return _run_in(root, f"""
class Untouched:
    def __getattr__(self, name):
        raise AssertionError("set-up began: codec." + name)
out = {{}}
for cell in {cells!r}:
    got = []
    for call in (lambda: harness.resolve(harness.load_spec(ROOT), cell, ROOT),
                 lambda: harness.run(cell, 1, 0.1, False, time.time(), device="cpu",
                                     codec=Untouched(), root=ROOT)):
        try:
            call()
            got.append(None)
        except Exception as e:
            got.append([type(e).__name__, str(e)])
    out[cell] = got
print(json.dumps(out))
""")


@pytest.mark.parametrize("k", range(len(BAD)))
def test_a_bad_name_fails_in_resolve_before_set_up(refused, k):
    what, name, words = BAD[k]
    in_resolve, in_run = refused[f"bad{k}.bad{k}"]
    assert in_resolve is not None and in_resolve[0] == "ValueError", in_resolve
    assert in_run == in_resolve
    msg = in_resolve[1]
    assert words in msg and repr(name) in msg, msg
    places = (("gen.DATA", "portbench/inputs/") if what == "data"
              else ("patterns.PATTERNS", "portbench/calls/"))
    assert all(p in msg for p in places), msg

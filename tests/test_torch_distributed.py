"""The port's multi-process layer: two gloo processes x 4 CPU shards.

The twin of tests/test_distributed.py. Each worker imports only torch,
numpy and tpu_huffman_torch, joins a gloo group, and runs
``distributed.encode_global``/``decode_global`` on its own, unequal, part
of the input (12,032 and 7,968 of 20,000 bytes of ``default_rng(77)``).
The parent computes what they must return with the JAX package and numpy:
the JAX encode of the whole, and the index layout of
``tpu_huffman/shard.py``'s ``encode_sharded`` (padded global positions,
``per_dev`` symbols a shard, padding blocks with n_symbols == 0). Every
comparison is exact; a corrupt stream and an unknown symbol raise on both
ranks. A spy on ``torch.distributed.all_gather`` checks that
no encode collective carries an input-sized payload.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SPLIT, LOCAL, BS = 20_000, 12_032, 4, 256

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as tdist

import tpu_huffman_torch as tt
from tpu_huffman_torch import distributed as dist

rank, store, meshkind, want_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.initialize(f"file://{store}", world_size=2, rank=rank, backend="gloo")
dist.initialize()  # idempotent
assert tdist.get_backend() == "gloo"

want = np.load(want_path)
full = want["full"].tobytes()
mine = full[: want["split"]] if rank == 0 else full[want["split"]:]
local = [torch.device("cpu")] * int(want["local"])
mesh = (dist.dcn_ici_mesh(local_devices=local) if meshkind == "dcn_ici"
        else dist.global_data_mesh(local_devices=local))
assert mesh.size == 2 * len(local) and mesh.n_processes == 2
table = tt.load_static_test_table()
codec = tt.MeshCodec(table, mesh, block_symbols=int(want["bs"]))

# every all_gather's payload, in bytes: the encode must move no input-sized one
orig_ag = tdist.all_gather
gathered = []

def spy(parts, x, *a, **kw):
    gathered.append(x.numel() * x.element_size())
    return orig_ag(parts, x, *a, **kw)

tdist.all_gather = spy
encoded, index = dist.encode_global(codec, mine)
tdist.all_gather = orig_ag
assert encoded == want["encoded"].tobytes(), "two-process encode != the JAX encode of the whole"
assert gathered and max(gathered) <= max(2 * len(encoded), 4096), gathered
assert index.symbols_per_block == want["bs"] and index.max_code_len == 0
assert (index.total_symbols, index.total_bits) == (len(full), int(want["total_bits"]))
assert index.bit_offsets.dtype == np.int64 and index.n_symbols.dtype == np.int32
assert np.array_equal(index.bit_offsets, want["bit_offsets"]), "index bit_offsets"
assert np.array_equal(index.n_symbols, want["n_symbols"]), "index n_symbols"
assert dist.decode_global(codec, encoded, index) == full
# a corrupt block that only rank 1's shards decode: both ranks raise
corrupt = bytearray(encoded)
corrupt[-len(encoded) // 4: -len(encoded) // 4 + 64] = bytes(64)  # zeros match no static code
try:
    dist.decode_global(codec, bytes(corrupt), index)
except tt.UnknownSymbolError:
    pass
else:
    raise AssertionError("a corrupt stream did not raise")

# a symbol with no code, held by rank 1 only: its (index, symbol) there,
# a bare error on rank 0
sparse = tt.make_canonical({65: 1, 66: 2})
part = b"AB" * 300 if rank == 0 else b"AB" * 50 + b"C" + b"AB"
try:
    dist.encode_global(tt.MeshCodec(sparse, mesh, block_symbols=int(want["bs"])), part)
except tt.UnknownSymbolError as e:
    assert (e.index, e.symbol) == ((100, 67) if rank == 1 else (None, None)), (e.index, e.symbol)
else:
    raise AssertionError("unknown symbol did not raise")
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_huffman")]
# leave the group together: a gloo group torn down at exit after its peer
# has gone aborts the process
tdist.barrier()
tdist.destroy_process_group()
print(f"rank {rank} OK {meshkind} gathers={len(gathered)}", flush=True)
"""


def _expected(tmp_path):
    """The worker's inputs and what both ranks must return, from the JAX
    package and numpy (``tpu_huffman/shard.py:470-584``'s layout)."""
    table = th.load_static_test_table()
    full = np.random.default_rng(77).integers(0, 256, size=N, dtype=np.uint8)
    lens = np.array([SPLIT, N - SPLIT], dtype=np.int64)
    units = -(-max(BS, -(-int(lens.max()) // LOCAL)) // BS)
    per_dev = BS * (1 << (units - 1).bit_length() if units > 1 else 1)
    bpd = per_dev // BS
    parts = np.split(full, [SPLIT])
    code_lens = table.lengths.astype(np.int64)
    offsets, n_symbols, base = [], [], 0
    for part in parts:
        for j in range(LOCAL):
            shard = np.zeros(per_dev, dtype=np.int64)
            live = part[j * per_dev:(j + 1) * per_dev]
            shard[: live.size] = code_lens[live]
            starts = base + np.cumsum(shard) - shard
            offsets.append(starts[::BS])
            n_symbols.append(np.clip(live.size - BS * np.arange(bpd), 0, BS))
            base += int(shard.sum())
    path = tmp_path / "want.npz"
    np.savez(
        path, full=full, split=SPLIT, local=LOCAL, bs=BS, total_bits=base,
        encoded=np.frombuffer(th.encode(full.tobytes(), table), dtype=np.uint8),
        bit_offsets=np.concatenate(offsets).astype(np.int64),
        n_symbols=np.concatenate(n_symbols).astype(np.int32),
    )
    return str(path)


def _run(tmp_path, meshkind, want_path, attempt):
    # the group meets through a file: no port is picked, so none can clash
    store = tmp_path / f"store_{meshkind}_{attempt}"
    worker = tmp_path / f"worker_{meshkind}.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(rank), str(store), meshkind, want_path],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        return None  # the caller retries once, then fails
    return list(zip(procs, outs))


@pytest.mark.parametrize("meshkind", ["data", "dcn_ici"])
def test_two_process_gloo(tmp_path, meshkind):
    want_path = _expected(tmp_path)
    results = _run(tmp_path, meshkind, want_path, 0)
    if results is None:  # one retry for a slow start, then fail
        results = _run(tmp_path, meshkind, want_path, 1)
    assert results is not None, "the two-process run timed out twice"
    for rank, (p, out) in enumerate(results):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank} OK {meshkind}" in out


# --- the default devices of a process (no group, no card: all faked) ----------


@pytest.mark.parametrize("env, cards, backend, want", [
    # torchrun, one process a card: this process's card, made current for NCCL
    ({"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "2"}, 4, "nccl", [2]),
    # one process on the host: every visible card
    ({}, 3, "nccl", [0, 1, 2]),
    ({"LOCAL_WORLD_SIZE": "1", "LOCAL_RANK": "0"}, 2, "gloo", [0, 1]),
])
def test_default_devices_per_process(monkeypatch, env, cards, backend, want):
    """``global_data_mesh()`` with no ``local_devices``: ``cuda:LOCAL_RANK``
    under a process-per-card launch, else every card; under NCCL the first
    is made the current device before the first collective."""
    from tpu_huffman_torch import distributed as dist

    for key in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    events = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: events.append(("set_device", torch.device(d))))
    monkeypatch.setattr(dist.tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist.tdist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist.tdist, "get_backend", lambda: backend)

    def gather(x, dev):
        events.append(("all_gather", dev))
        return x.repeat(2)

    monkeypatch.setattr(dist, "_all_gather", gather)
    mesh = dist.global_data_mesh()
    local = [torch.device("cuda", i) for i in want]
    assert list(mesh.devices) == local * 2 and mesh.n_processes == 2
    first = [("set_device", local[0])] if backend == "nccl" else []
    assert events == first + [("all_gather", local[0])]

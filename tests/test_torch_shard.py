"""The PyTorch port's MeshCodec against the JAX package's and the C++ oracle.

Meshes of CPU shards: on the CPU each shard's count, pack and
chain_decode run their plain versions. Every comparison is exact (the
codec is integer): bytes, every BlockIndex field and error (type, index,
symbol).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman_torch.ops import chain_decode, pack_encode  # noqa: E402
from tpu_huffman_torch.shard import Mesh, _bucket_pow2, _phase_base  # noqa: E402

CPU = torch.device("cpu")
SIZES = [1, 7, 255, 4096, 12345]  # tests/test_shard.py's ragged sizes


def _index_fields(idx):
    return (idx.symbols_per_block, idx.total_symbols, idx.total_bits, idx.max_code_len)


def assert_same_index(port, ref):
    assert _index_fields(port) == _index_fields(ref)
    assert port.bit_offsets.dtype == ref.bit_offsets.dtype == np.int64
    assert port.n_symbols.dtype == ref.n_symbols.dtype
    assert np.array_equal(port.bit_offsets, ref.bit_offsets)
    assert np.array_equal(port.n_symbols, ref.n_symbols)


def cpu_mesh(shape=(8,)):
    axes = ("data",) if len(shape) == 1 else ("dcn", "ici")
    return Mesh(np.full(shape, CPU, dtype=object), axes)


@pytest.fixture(scope="module")
def tables():
    return th.load_static_test_table(), tt.load_static_test_table()


def _data(n, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("shape", [(8,), (2, 4)], ids=["data", "dcn_ici"])
def test_equals_jax_mesh_codec(tables, shape):
    """The same mesh shape as the JAX MeshCodec on the 8 virtual CPU
    devices: the same bytes and index."""
    ref, t = tables
    data = _data(50_000, seed=42)
    devs = np.asarray(jax.devices()[:8]).reshape(shape)
    jmesh = JaxMesh(devs, ("data",) if len(shape) == 1 else ("dcn", "ici"))
    want, want_idx = th.MeshCodec(ref, jmesh, block_symbols=512).encode(data)
    mc = tt.MeshCodec(t, cpu_mesh(shape), block_symbols=512)
    enc, idx = mc.encode(data)
    assert enc == want
    assert_same_index(idx, want_idx)
    assert mc.decode(enc, idx) == data


@pytest.mark.parametrize("block_symbols", [256, 100, 1000])
@pytest.mark.parametrize("n", SIZES)
def test_ragged_sizes(tables, n, block_symbols):
    """Shards partly or wholly empty, the last non-empty shard not the last
    shard (n = 1), index blocks that do not divide the encode's tile."""
    ref, t = tables
    data = _data(n)
    mc = tt.MeshCodec(t, cpu_mesh(), block_symbols=block_symbols)
    enc, idx = mc.encode(data)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=block_symbols)
    assert enc == ref_enc == th.encode(data, ref) == oracle.oracle_encode(data, ref)
    assert_same_index(idx, ref_idx)
    assert mc.encode(data, with_index=False) == (enc, None)
    assert mc.decode(enc, idx) == data


def test_empty(tables):
    _ref, t = tables
    mc = tt.MeshCodec(t, cpu_mesh())
    enc, idx = mc.encode(b"")
    assert enc == b"" and idx.total_symbols == 0 and idx.bit_offsets.size == 0
    assert mc.decode(enc, idx) == b""


@pytest.mark.parametrize("pad", [0x00, 0x5A, 0xFF])
def test_eos_padding(tables, pad):
    """The pad lands once, at the global end, whichever shard ends it."""
    ref, t = tables
    for data in (b"a", _data(3001)):
        mc = tt.MeshCodec(t, cpu_mesh(), block_symbols=256, eos_padding=pad)
        enc, _ = mc.encode(data)
        assert enc == th.encode(data, ref, eos_padding=pad) == oracle.oracle_encode(
            data, ref, eos_padding=pad), hex(pad)


def test_unknown_symbol_same_index_and_symbol():
    sparse_ref = th.make_canonical({65: 1, 66: 2}, name="ab")
    sparse = tt.make_canonical({65: 1, 66: 2}, name="ab")
    data = b"AB" * 700 + b"C" + b"AB" * 20  # the offender in the sixth shard
    with pytest.raises(th.UnknownSymbolError) as want:
        th.encode(data, sparse_ref)
    with pytest.raises(tt.UnknownSymbolError) as port:
        tt.encode(data, sparse, device="cpu")
    with pytest.raises(tt.UnknownSymbolError) as got:
        tt.MeshCodec(sparse, cpu_mesh(), block_symbols=256).encode(data)
    assert (got.value.index, got.value.symbol) == (port.value.index, port.value.symbol) == (
        want.value.index, want.value.symbol) == (1400, 67)


def test_hpack_long_codes():
    ref, t = th.load_hpack_table(), tt.load_hpack_table()
    data = _data(6000, seed=5)
    mc = tt.MeshCodec(t, cpu_mesh(), block_symbols=256)
    enc, idx = mc.encode(data)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=256)
    assert enc == ref_enc == oracle.oracle_encode(data, ref)
    assert_same_index(idx, ref_idx)
    assert idx.max_code_len == 30
    assert mc.decode(enc, idx) == data


@pytest.mark.parametrize("block_symbols", [256, 512])
def test_seam_every_shard_ends_on_a_tile(tables, block_symbols):
    """Every shard holds exactly 2 x TILE symbols, so every shard's live
    count is an exact multiple of the encode's tile and of the index block:
    the seam where the JAX TPU path's gather tail double-counts (ROADMAP
    C2a). The bytes equal the oracle's."""
    ref, t = tables
    n = 4 * 2 * pack_encode.TILE
    mesh = cpu_mesh((4,))
    assert _bucket_pow2(-(-n // 4), block_symbols) == 2 * pack_encode.TILE
    data = _data(n, seed=3)
    mc = tt.MeshCodec(t, mesh, block_symbols=block_symbols)
    enc, idx = mc.encode(data)
    ref_enc, ref_idx = th.encode_with_index(data, ref, block_symbols=block_symbols)
    assert enc == oracle.oracle_encode(data, ref) == ref_enc
    assert_same_index(idx, ref_idx)
    assert mc.decode(enc, idx) == data


def test_one_launch_a_nonempty_shard(tables, monkeypatch):
    """Each non-empty shard counts, packs and decodes once; an empty one
    launches nothing (counted here through the plain versions)."""
    _ref, t = tables
    calls = {"count": 0, "pack": 0, "chain": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pack_encode, "count", counting("count", pack_encode.count))
    monkeypatch.setattr(pack_encode, "pack", counting("pack", pack_encode.pack))
    monkeypatch.setattr(chain_decode, "decode_chains",
                        counting("chain", chain_decode.decode_chains))
    mc = tt.MeshCodec(t, cpu_mesh(), block_symbols=256)
    data = _data(3 * 256 + 5)  # per_dev 256: shards 0-3 non-empty
    enc, idx = mc.encode(data)
    assert mc.decode(enc, idx) == data
    assert calls == {"count": 4, "pack": 4, "chain": 4}


def test_corrupt_stream_raises(tables):
    _ref, t = tables
    data = _data(5000, seed=9)
    mc = tt.MeshCodec(t, cpu_mesh(), block_symbols=256)
    enc, idx = mc.encode(data)
    bad = bytearray(enc)
    bad[len(bad) // 2: len(bad) // 2 + 64] = bytes(64)  # zeros match no static code
    with pytest.raises(tt.UnknownSymbolError):
        mc.decode(bytes(bad), idx)


def test_default_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tt.default_mesh()
    mesh = tt.default_mesh(devices=[CPU] * 8)
    assert mesh.shape == (8,) and mesh.axis_names == ("data",)


@pytest.mark.parametrize("limit", [31, 36], ids=["past_2_31", "past_2_36"])
def test_phase_base_past_int32(limit):
    """The twin of tests/test_shard.py's prefix test: mocked shard totals
    whose prefix passes 2^31 (and 2^36) bits, against Python integers."""
    rng = np.random.default_rng(7)
    per = (1 << limit) // 6
    totals = rng.integers(per - (per >> 4), per + (per >> 4), size=8).astype(np.int64) | 1
    phase, word_base = _phase_base(totals)
    offs = [sum(int(x) for x in totals[:i]) for i in range(8)]
    assert offs[-1] > 1 << limit
    assert phase.tolist() == [o & 31 for o in offs]
    assert word_base.tolist() == [o >> 5 for o in offs]

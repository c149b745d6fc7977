"""The port's fixed-size encode step (``best_encode_step``), its device-total
pack, ``encoded_length_bits``, ``block_symbols=None``, the entry twin and
the two example twins, on the CPU.

The JAX package's ``best_encode_step`` runs its Pallas pipeline in
interpret mode here (tens of seconds at 4096 symbols), so the step is held
against the C++ oracle and ``tpu_huffman.encode`` instead. Every comparison
is exact. On the card, ``chip_smoke.py`` holds the kernel form against
these plain versions and checks the step for host syncs and under a CUDA
graph.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
import chip_smoke  # noqa: E402  (bench_suite's helpers without its JAX set-up)
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman_torch import entry  # noqa: E402
from tpu_huffman_torch.ops import pack_encode  # noqa: E402
from tpu_huffman_torch.ops.bitpack import bytes_from_words_np  # noqa: E402
from tpu_huffman_torch.ops.encode import (  # noqa: E402
    DEFAULT_BLOCK_SYMBOLS,
    DeviceTable,
    best_encode_step,
    encoded_length_bits,
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TABLES = ("static", "hpack", "5-30")


def tables(name):
    if name == "static":
        return th.load_static_test_table(), tt.load_static_test_table()
    if name == "hpack":
        return th.load_hpack_table(), tt.load_hpack_table()
    lens = chip_smoke.mixed_lengths_5_30()
    return (th.make_canonical(lens, name="mixed_5_30"),
            tt.make_canonical(lens, name="mixed_5_30"))


def with_pad_len(table, n, pad_len, seed):
    """n random symbols whose codes leave ``pad_len`` bits of EOS padding."""
    data = np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8)
    return chip_smoke.with_pad_len(data, table.lengths, pad_len)


# every pad_len at every n, but where one code cannot leave it: the static
# table's codes are 5-10 bits, so one symbol leaves no 4- or 5-bit pad
STEP_CASES = [(name, n, pad_len) for name in TABLES for n in (1, 31, 4096) for pad_len in range(8)
              if not (name == "static" and n == 1 and pad_len in (4, 5))]


@pytest.mark.parametrize("name,n,pad_len", STEP_CASES)
def test_step_bytes_equal_the_oracle(name, n, pad_len):
    ref_t, port_t = tables(name)
    data = with_pad_len(port_t, n, pad_len, seed=n + pad_len)
    encode_fn, finalize_fn = best_encode_step(port_t, n, device=CPU)
    words, total, padded = encode_fn(torch.from_numpy(data))
    n_words = -(-n * int(port_t.max_len) // 32) + 1
    assert words.dtype == torch.int32 and words.shape == (n_words,)
    for v in (total, padded):
        assert v.dtype == torch.int64 and v.dim() == 0
    got = finalize_fn(torch.from_numpy(data))
    assert all(torch.equal(a, b) for a, b in zip(got, (words, total, padded)))
    total, padded = int(total), int(padded)
    assert padded - total == pad_len and padded % 8 == 0
    want = oracle.oracle_encode(data.tobytes(), ref_t)
    assert bytes_from_words_np(words.numpy(), padded // 8) == want
    assert not words[(padded + 31) // 32:].any()  # zeros past the pad


@pytest.mark.parametrize("n", [31, 4096])
def test_step_bytes_equal_jax_encode(n):
    ref_t, port_t = tables("static")
    data = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8)
    words, _total, padded = best_encode_step(port_t, n, device=CPU)[0](
        torch.from_numpy(data))
    assert bytes_from_words_np(words.numpy(), int(padded) // 8) == th.encode(data.tobytes(), ref_t)


@pytest.mark.parametrize("pad_len", range(8))
@pytest.mark.parametrize("name", ["static", "hpack"])
def test_device_total_pack_equals_pack(name, pad_len):
    """The device-total form (the total as a tensor) gives the by-value
    form's words, and with EOS 0xFF the C++ oracle's bytes; it checks its
    arguments. On the CPU both forms are the plain versions: chip_smoke.py
    holds the kernel against them."""
    ref_t, port_t = tables(name)
    n = 2 * pack_encode.TILE + 77
    data = torch.from_numpy(with_pad_len(port_t, n, pad_len, seed=pad_len))
    dt = DeviceTable.for_table(port_t, CPU)
    tile_bits, _stats = pack_encode.count(data, dt)
    incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
    total = int(incl[-1])
    n_words = -(-n * int(port_t.max_len) // 32) + 1
    for eos in (0xFF, 0x00, 0x5A):
        want, want_offs = pack_encode.pack(data, dt, incl - tile_bits, total, eos, n_words, 100)
        out = torch.full((n_words,), -5, dtype=torch.int32)
        got, offs, padded = pack_encode.pack_device_total(
            data, dt, incl - tile_bits, incl[-1], eos, n_words, 100, out=out)
        assert got is out and torch.equal(got, want) and torch.equal(offs, want_offs)
        assert int(padded) == total + pad_len
        if eos == 0xFF:
            assert bytes_from_words_np(got.numpy(), int(padded) // 8) == oracle.oracle_encode(
                data.numpy().tobytes(), ref_t)
    with pytest.raises(ValueError):
        pack_encode.pack_device_total(data, dt, incl - tile_bits, incl[-1], 0xFF, n_words - 2)
    with pytest.raises(ValueError):
        pack_encode.pack_device_total(data, dt, incl - tile_bits, incl[-1:].int(), 0xFF, n_words)


@pytest.mark.parametrize("at", [0, 4095, 4096, 5000])
def test_finalize_raises_where_encode_does(at):
    ab = tt.make_canonical({65: 1, 66: 2})
    data = bytearray(b"AB" * 3000)
    data[at] = 67
    data[-1] = 68  # a second unknown symbol after the first
    encode_fn, finalize_fn = best_encode_step(ab, len(data), device=CPU)
    with pytest.raises(tt.UnknownSymbolError) as want:
        tt.encode(bytes(data), ab, device=CPU)
    with pytest.raises(tt.UnknownSymbolError) as got:
        finalize_fn(torch.tensor(list(data), dtype=torch.uint8))
    assert (got.value.index, got.value.symbol) == (want.value.index, want.value.symbol) == (at, 67)
    with pytest.raises(th.UnknownSymbolError):  # the JAX package raises too
        th.encode(bytes(data), th.make_canonical({65: 1, 66: 2}))
    # encode_fn never raises: the unknown symbols add no bits
    _w, total, _p = encode_fn(torch.tensor(list(data), dtype=torch.uint8))
    assert int(total) == int(ab.lengths[np.frombuffer(bytes(data), np.uint8)].sum())


@pytest.mark.parametrize("n_valid", [0, 1, 100, 4096, 4097])
@pytest.mark.parametrize("name", TABLES)
def test_encoded_length_bits(name, n_valid):
    ref_t, port_t = tables(name)
    data = np.random.default_rng(n_valid).integers(0, 256, size=4097, dtype=np.uint8)
    for table_or_dt in (port_t, DeviceTable.for_table(port_t, CPU)):
        for nv in (n_valid, torch.tensor(n_valid)):
            bits = encoded_length_bits(torch.from_numpy(data), nv, table_or_dt)
            assert bits.dtype == torch.int64 and bits.dim() == 0
            assert int(bits) == int(port_t.lengths[data[:n_valid]].astype(np.int64).sum())
    head = data[:n_valid].tobytes()
    assert -(-int(bits) // 8) == tt.get_encoded_length(head, port_t) \
        == th.get_encoded_length(head, ref_t)


@pytest.mark.parametrize("call", ["encode_with_index", "best_encode_step"])
def test_block_symbols_none_takes_the_default(call):
    table = tt.load_static_test_table()
    data = np.random.default_rng(3).integers(0, 256, size=3000, dtype=np.uint8).tobytes()
    if call == "encode_with_index":
        enc, idx = tt.encode_with_index(data, table, block_symbols=None, device=CPU)
        assert idx.symbols_per_block == DEFAULT_BLOCK_SYMBOLS == 256
        assert enc == tt.encode(data, table, device=CPU)
        assert tt.decode_indexed(enc, idx, table, device=CPU) == data
    else:
        words, _t, padded = best_encode_step(table, len(data), None, device=CPU)[0](
            torch.frombuffer(bytearray(data), dtype=torch.uint8))
        assert bytes_from_words_np(words.numpy(), int(padded) // 8) == tt.encode(
            data, table, device=CPU)
    with pytest.raises(ValueError):
        tt.encode_with_index(data, table, block_symbols=0, device=CPU)


def test_entry_runs():
    fn, (symbols,) = entry.entry(device="cpu")
    want = np.random.default_rng(0).integers(0, 256, size=65536, dtype=np.uint8)
    assert symbols.device == CPU and np.array_equal(symbols.numpy(), want)
    words, total, padded = fn(symbols)
    assert words.shape == (-(-65536 * int(tt.load_static_test_table().max_len) // 32) + 1,)
    assert bytes_from_words_np(words.numpy(), int(padded) // 8) == oracle.oracle_encode(
        want.tobytes(), th.load_static_test_table())
    # the module's command line runs both entry points
    proc = subprocess.run([sys.executable, "-m", "tpu_huffman_torch.entry", "--device", "cpu"],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    shapes = [tuple(o.shape) for o in (words, total, padded)]
    assert proc.stdout.splitlines()[-2:] == [f"entry ok: {shapes}", "dryrun_multichip(8) ok"]


@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_dryrun_multichip_runs(n_devices):
    entry.dryrun_multichip(n_devices, device="cpu")
    assert entry.mesh_devices(n_devices, "cpu") == [CPU] * n_devices


@pytest.mark.parametrize("name", ["hpack_headers", "mesh_pipeline"])
def test_example_runs(name):
    proc = subprocess.run(
        [sys.executable, "-m", f"tpu_huffman_torch.examples.{name}", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    want = "rejected" if name == "hpack_headers" else "capped streaming decode ok"
    assert want in proc.stdout

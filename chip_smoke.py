"""Smoke test of the PyTorch port on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (name and power limit from nvidia-smi, compute capability
     9.0), torch and CUDA versions; build the kernels and print the build time;
  2. each kernel against its plain PyTorch version on the same CUDA tensors
     at main-path shapes: 8 MiB of random bytes (seed 2024) on the static
     table at block_symbols 256 and 512, and on the HPACK table (codes up to
     30 bits) at 256; every output must be bit-identical;
  3. the golden vectors through the public encode/encode_with_index, and an
     unknown symbol raising with the right index;
  4. the main path at full size through the public API (launch counters
     reset just before, read just after): the static table at 8 and 64 MiB
     of random bytes and the HPACK table at 8 MiB of header text, each
     encode_with_index then decode_indexed; round trips equal, every kernel
     launched, encoded bytes and index equal to the plain version's;
  5. timings with CUDA events at 8 MiB: each kernel's wrapper beside its
     plain version (median of 10 after warm-up), each kernel alone by
     torch.profiler, and encode_with_index + decode_indexed end to end from
     host bytes, in GB/s of input bytes.

The last line is one JSON object {"ok": true, "device": {...}}; the line
before it is the {"kernels": [...]} summary. Without a CUDA device the
script exits non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import ast
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
SEED = 2024  # bench.py's corpus seed
REPS = 10


def hpack_corpus(n: int) -> bytes:
    """``bench_suite.hpack_header_corpus``, taken from its source: importing
    bench_suite would run its JAX compile-cache set-up."""
    path = os.path.join(ROOT, "bench_suite.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(
        node for node in tree.body
        if isinstance(node, ast.FunctionDef) and node.name == "hpack_header_corpus"
    )
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["hpack_header_corpus"](n)


def _golden():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden  # plain data: the reference's known-answer vectors

    return golden


def _median_ms(torch, fn, reps: int = REPS, inner: int = 5) -> float:
    """Median over reps samples of the device time per fn() call, each
    sample timed by CUDA events around inner back-to-back calls, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def _profiled_kernel_ms(torch, calls, reps: int = REPS) -> dict:
    """Device time per launch of each named CUDA kernel, by torch.profiler,
    over reps runs of every call: the kernel alone, without the wrapper's
    allocations and launch gaps. Kernels the profiler did not see are left
    out (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    for call in calls.values():
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls.values():
            for _ in range(reps):
                call()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        for name in calls:
            if f"{name}_kernel" in evt.key and evt.count:
                total_us = getattr(evt, "device_time_total", 0) or evt.cuda_time_total
                out[name] = total_us / evt.count / 1e3
    return out


def _median_wall_ms(torch, fn, reps: int = REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _max_abs_err(torch, a, b) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import tpu_huffman_torch as tt
    from tpu_huffman_torch import _build
    from tpu_huffman_torch.ops import chain_decode, pack_encode
    from tpu_huffman_torch.ops.encode import DeviceTable, _encode_device

    dev = torch.device("cuda")

    # ---- 1. the card, the versions, the build ----------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} capability {cap[0]}.{cap[1]} "
          f"device {torch.cuda.get_device_name(0)}")
    if cap != (9, 0):
        raise AssertionError(f"compute capability {cap}, expected (9, 0)")
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built in {_build.build_seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s): {_build.library_path()}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    static = tt.load_static_test_table()
    hpack = tt.load_hpack_table()
    rng = np.random.default_rng(SEED)
    data8 = rng.integers(0, 256, size=8 * MIB, dtype=np.uint8).tobytes()

    # ---- 2. each kernel against its plain version ------------------------
    errs = {"encode_count": 0, "encode_pack": 0, "chain_decode": 0}
    sym = torch.frombuffer(bytearray(data8), dtype=torch.uint8).to(dev)
    shapes = {}
    # Random bytes on the HPACK table reach its 13-30-bit codes, whose
    # decode goes through the level-1 LUT in global memory.
    for table, K in ((static, 256), (static, 512), (hpack, 256)):
        dt = DeviceTable.for_table(table, dev)
        chunk = pack_encode.chunk_symbols(K)
        cb, st = pack_encode.count(sym, dt, chunk)
        cb_p, st_p = pack_encode.count_plain(sym, dt, chunk)
        torch.cuda.synchronize()
        e = max(_max_abs_err(torch, cb, cb_p), _max_abs_err(torch, st, st_p))
        errs["encode_count"] = max(errs["encode_count"], e)
        incl = torch.cumsum(cb, 0, dtype=torch.int64)
        offs = incl - cb
        total = int(incl[-1])
        n_words = -(-(total + pack_encode.pad_code(total, 0xFF)[1]) // 32)
        words = pack_encode.pack(sym, dt, chunk, offs, total, 0xFF, n_words)
        w_p = pack_encode.pack_plain(sym, dt, chunk, offs, total, 0xFF, n_words)
        torch.cuda.synchronize()
        errs["encode_pack"] = max(errs["encode_pack"], _max_abs_err(torch, words, w_p))

        n = sym.numel()
        block_offs = offs[:: K // chunk].contiguous()
        nb = block_offs.numel()
        nsyms = torch.full((nb,), K, dtype=torch.int32, device=dev)
        nsyms[-1] = n - (nb - 1) * K
        out_start = torch.arange(nb, dtype=torch.int64, device=dev) * K
        out, end, bad = chain_decode.decode_chains(words, block_offs, nsyms, out_start, n, dt)
        out_p, end_p, bad_p = chain_decode.decode_chains_plain(
            words, block_offs, nsyms, out_start, n, dt
        )
        torch.cuda.synchronize()
        e = max(_max_abs_err(torch, out, out_p), _max_abs_err(torch, end, end_p),
                _max_abs_err(torch, bad, bad_p))
        errs["chain_decode"] = max(errs["chain_decode"], e)
        if not torch.equal(out, sym) or int(bad) != 0:
            raise AssertionError(f"kernel decode at K={K} does not return the input")
        if int(end[-1]) != total:
            raise AssertionError(f"last chain ends at {int(end[-1])}, stream at {total}")
        print(f"phase 2 {table.name} K={K}: count, pack, decode bit-identical "
              f"to plain ({total} bits, {nb} blocks, max code {int(st[1])})")
        shapes[table.name, K] = (dt, chunk, offs, total, n_words, words,
                                 block_offs, nsyms, out_start)
    if any(errs.values()):
        raise AssertionError(f"kernels differ from their plain versions: {errs}")

    # ---- 3. golden vectors and the unknown-symbol error ------------------
    golden = _golden()
    cases = [
        (golden.URL, golden.URL_ENCODED),
        (golden.ALL_CODES, golden.ALL_CODES_ENCODED),
        golden.EXACT_FIT_1BYTE,
        golden.EXACT_FIT_2BYTE,
    ]
    for plain_bytes, want in cases:
        if tt.encode(plain_bytes, static) != want:
            raise AssertionError(f"encode({plain_bytes!r}) != golden")
        enc, idx = tt.encode_with_index(plain_bytes, static)
        if enc != want or tt.decode_indexed(enc, idx, static) != plain_bytes:
            raise AssertionError(f"encode_with_index({plain_bytes!r}) != golden")
    even, even_len = golden.EVEN_BYTES
    if len(tt.encode(even, static)) != even_len:
        raise AssertionError("EVEN_BYTES length")
    ab = tt.make_canonical({65: 1, 66: 2})
    bad_input = b"AB" * 5000 + b"C" + b"AB" * 10
    try:
        tt.encode_with_index(bad_input, ab)
    except tt.UnknownSymbolError as exc:
        if (exc.index, exc.symbol) != (10000, 67):
            raise AssertionError(f"unknown symbol at {exc.index}/{exc.symbol}") from exc
    else:
        raise AssertionError("unknown symbol did not raise")
    print("phase 3: golden vectors and unknown-symbol index ok")

    # ---- 4. the main path at full size -----------------------------------
    data64 = np.random.default_rng(SEED + 1).integers(
        0, 256, size=64 * MIB, dtype=np.uint8).tobytes()
    hdrs = hpack_corpus(8 * MIB)
    runs = [("static 8 MiB", static, data8), ("static 64 MiB", static, data64),
            ("hpack 8 MiB", hpack, hdrs)]
    for counter in (pack_encode.launches, chain_decode.launches):
        for k in counter:
            counter[k] = 0
    results = []
    for name, table, data in runs:
        t0 = time.perf_counter()
        enc, idx = tt.encode_with_index(data, table)
        dec = tt.decode_indexed(enc, idx, table)
        secs = time.perf_counter() - t0
        results.append((name, table, data, enc, idx, dec, secs))
    launches = {**pack_encode.launches, **chain_decode.launches}
    print(f"phase 4 launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    for name, table, data, enc, idx, dec, secs in results:
        if dec != data:
            raise AssertionError(f"{name}: round trip differs")
        enc_p, idx_p = tt.encode_with_index(data, table, device="cpu")
        if enc != enc_p:
            raise AssertionError(f"{name}: encoded bytes differ from the plain version's")
        for field in ("symbols_per_block", "total_symbols", "total_bits", "max_code_len"):
            if getattr(idx, field) != getattr(idx_p, field):
                raise AssertionError(f"{name}: index {field} differs")
        if not (np.array_equal(idx.bit_offsets, idx_p.bit_offsets)
                and np.array_equal(idx.n_symbols, idx_p.n_symbols)):
            raise AssertionError(f"{name}: index arrays differ")
        print(f"phase 4 {name}: round trip ok, {len(data)} -> {len(enc)} bytes, "
              f"max code {idx.max_code_len}, {secs * 1e3:.1f} ms first call")

    # ---- 5. timings at 8 MiB ---------------------------------------------
    dt, chunk, offs, total, n_words, words, block_offs, nsyms, out_start = (
        shapes[static.name, 256])
    n = sym.numel()
    gbs = lambda ms: n / (ms * 1e-3) / 1e9  # noqa: E731
    timed = {
        "encode_count": (
            lambda: pack_encode.count(sym, dt, chunk),
            lambda: pack_encode.count_plain(sym, dt, chunk),
        ),
        "encode_pack": (
            lambda: pack_encode.pack(sym, dt, chunk, offs, total, 0xFF, n_words),
            lambda: pack_encode.pack_plain(sym, dt, chunk, offs, total, 0xFF, n_words),
        ),
        "chain_decode": (
            lambda: chain_decode.decode_chains(words, block_offs, nsyms, out_start, n, dt),
            lambda: chain_decode.decode_chains_plain(words, block_offs, nsyms, out_start, n, dt),
        ),
    }
    ms = {}
    for name, (kernel, plain) in timed.items():
        # plain, kernel, kernel, plain: both sides see the same card state
        p1 = _median_ms(torch, plain)
        k1 = _median_ms(torch, kernel)
        k2 = _median_ms(torch, kernel)
        p2 = _median_ms(torch, plain)
        ms[name] = (min(k1, k2), min(p1, p2))
        print(f"phase 5 {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms at 8 MiB, block_symbols 256 "
              f"(kernel {gbs(ms[name][0]):.2f} GB/s, plain {gbs(ms[name][1]):.2f} GB/s)")
    kernel_only = _profiled_kernel_ms(torch, {k: v[0] for k, v in timed.items()})
    for name in timed:
        got = kernel_only.get(name)
        print(f"phase 5 {name}: kernel alone (torch.profiler) "
              + (f"{got:.4f} ms" if got is not None else "not measured"))
    sym_dev_ms = _median_ms(torch, lambda: _encode_device(sym, dt, 0xFF, chunk))
    print(f"phase 5 device-resident encode (count+cumsum+sync+pack): "
          f"{sym_dev_ms:.4f} ms ({gbs(sym_dev_ms):.2f} GB/s)")
    enc8, idx8 = tt.encode_with_index(data8, static)
    enc_ms = _median_wall_ms(torch, lambda: tt.encode_with_index(data8, static))
    dec_ms = _median_wall_ms(torch, lambda: tt.decode_indexed(enc8, idx8, static))
    def round_trip():
        enc, idx = tt.encode_with_index(data8, static)
        return tt.decode_indexed(enc, idx, static)

    e2e_ms = _median_wall_ms(torch, round_trip)
    print(f"phase 5 end to end from host bytes at 8 MiB: encode_with_index "
          f"{enc_ms:.3f} ms ({gbs(enc_ms):.3f} GB/s), decode_indexed {dec_ms:.3f} ms "
          f"({gbs(dec_ms):.3f} GB/s), both {e2e_ms:.3f} ms ({gbs(e2e_ms):.3f} GB/s)")

    kernels = [
        {"name": "encode_count", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/pack_encode.cu",
         "replaces": "tpu_huffman/ops/pallas_encode.py:155"},
        {"name": "encode_pack", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/pack_encode.cu",
         "replaces": "tpu_huffman/ops/pallas_encode.py:155"},
        {"name": "chain_decode", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/chain_decode.cu",
         "replaces": "tpu_huffman/ops/pallas_decode.py:688",
         "also_replaces": "tpu_huffman/ops/pallas_decode.py:481"},
    ]
    for k in kernels:
        k.update(launches=launches[k["name"]], max_abs_err=errs[k["name"]],
                 ms=ms[k["name"]][0], plain_ms=ms[k["name"]][1],
                 kernel_only_ms=kernel_only.get(k["name"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

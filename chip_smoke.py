"""Smoke test of the PyTorch port on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (name and power limit from nvidia-smi, compute capability
     9.0), torch and CUDA versions; build the kernels (one nvcc per source,
     all at once) and print the build time;
  2. each kernel against its plain PyTorch version on the same CUDA tensors
     at main-path shapes, every output bit-identical:
     - count, pack, chain_decode: 8 MiB of random bytes (seed 2024) on the
       static table at block_symbols 256 and 512, and on the HPACK table
       (codes up to 30 bits) at 256;
     - selfsync_decode: the stream of those 8 MiB on the static table, the
       same bytes taken as a stream (a foreign stream full of invalid
       windows), and the HPACK stream of them (30-bit codes, level-1 LUT in
       global memory), each on pass 0 (segment-aligned entries) and on the
       converged pass;
     - stream_decode at 4 KiB: no cap, a cap mid-stream (OUTPUT_FULL), and
       a zero blob (UNKNOWN_SYMBOL);
  3. the golden vectors through the public encode/encode_with_index and
     decode; an unknown symbol raising with the right index on encode and
     zeros raising on decode; max_output giving the first bytes of 1 MiB;
  4. two paths at full size through the public API, each with the launch
     counters reset just before it and read just after, every kernel of the
     path launched: the indexed path (encode_with_index then
     decode_indexed) and the foreign-stream path (decode of the same
     stream with no index), on the static table at 8 and 64 MiB of random
     bytes and the HPACK table at 8 MiB of header text; the decoded bytes
     equal the input, and the encoded bytes and index equal the plain
     version's; the fixpoint passes of each decode are printed;
  5. timings with CUDA events at 8 MiB: each kernel's wrapper beside its
     plain version (median of 10 after warm-up), each kernel alone by
     torch.profiler, the device time of one decode by kernel, and the
     public calls end to end from host bytes, in GB/s of plaintext.

The last line is one JSON object {"ok": true, "device": {...}}; the line
before it is the {"kernels": [...]} summary, with each kernel's bound: the
larger of the bytes it must move (each input read once, each output written
once) over 3.35 TB/s and its integer operations over 67 T/s (the card's
float32 rate outside the tensor cores, the published peak nearest to
32-bit integer work). Without a CUDA device the script exits non-zero and
prints no result. It imports nothing of JAX.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
# The data sheet gives no 32-bit integer rate; its float32 rate outside the
# tensor cores is the nearest published peak.
SCALAR_OPS_PER_S = 67e12
# Integer operations per symbol in each kernel's loop body (a table gather,
# shifts, compares, adds, the store), counted from the sources in csrc/.
OPS_PER_SYMBOL = {"encode_count": 3, "encode_pack": 12, "chain_decode": 10,
                  "selfsync_decode": 10, "stream_decode": 10}


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


def _device_us(evt) -> float:
    """An averaged profiler event's device time in us (the attribute's name
    differs between torch versions)."""
    if hasattr(evt, "device_time_total"):
        return evt.device_time_total
    return evt.cuda_time_total


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
                out[name] = _device_us(evt) / evt.count / 1e3
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


def _device_ms_by_kernel(torch, fn, calls: int = 3) -> dict:
    """Device time per fn() call of each CUDA kernel and copy, by
    torch.profiler over `calls` calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if _device_us(evt):
            out[evt.key] = _device_us(evt) / calls / 1e3
    return out


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take (ms), and what bounds it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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
    from tpu_huffman_torch.ops import chain_decode, pack_encode, selfsync, stream_decode
    from tpu_huffman_torch.ops.bitpack import stage_words
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

    # selfsync_decode on pass 0 (segment-aligned entries, so off the
    # codeword chain) and on the converged pass, for three foreign streams.
    def on_card(b: bytes):
        return stage_words(torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev))

    errs.update(selfsync_decode=0, stream_decode=0)
    enc_static = tt.encode(data8, static)
    foreign = {}
    for name, table, enc in (("static", static, enc_static),
                             ("static random bytes as the stream", static, data8),
                             ("hpack", hpack, tt.encode(data8, hpack))):
        dt = DeviceTable.for_table(table, dev)
        words = on_card(enc)
        n_segs, seg_bits = selfsync._plan_segments(8 * len(enc), selfsync.SEG_WORDS)
        max_syms = selfsync.max_symbols(table, seg_bits)
        entries, passes = selfsync._fixpoint(words, n_segs, seg_bits, 0, max_syms, dt)[4:]
        pass0 = torch.zeros(n_segs, dtype=torch.int32, device=dev)
        for label, ent in (("pass 0", pass0), (f"converged (pass {passes})", entries)):
            got = selfsync.decode_segments(words, ent, seg_bits, max_syms, dt)
            want = selfsync.decode_segments_plain(words, ent, seg_bits, max_syms, dt)
            torch.cuda.synchronize()
            e = max(_max_abs_err(torch, a, b) for a, b in zip(got, want))
            errs["selfsync_decode"] = max(errs["selfsync_decode"], e)
            print(f"phase 2 selfsync_decode {name}, {label}: max_abs_err {e} "
                  f"({n_segs} segments of {seg_bits} bits, {int(got[1].sum())} symbols, "
                  f"{int((got[3] != 0).sum())} segments with an invalid window)")
        foreign[name] = (dt, words, n_segs, seg_bits, max_syms, entries, len(enc))

    # stream_decode at 4 KiB: each stop rule.
    dt = DeviceTable.for_table(static, dev)
    head = on_card(enc_static[:4096])
    for label, words, cap, want_status in (
        ("no cap", head, None, stream_decode.STATUS_OK),
        ("cap 1000", head, 1000, stream_decode.STATUS_OUTPUT_FULL),
        ("zero blob", on_card(bytes(4096)), None, stream_decode.STATUS_UNKNOWN_SYMBOL),
    ):
        got = stream_decode.decode_stream(words, 0, 8 * 4096, cap, dt)
        want = stream_decode.decode_stream_plain(words, 0, 8 * 4096, cap, dt)
        torch.cuda.synchronize()
        e = max(_max_abs_err(torch, a, b) for a, b in zip(got, want))
        errs["stream_decode"] = max(errs["stream_decode"], e)
        n_dec, end_bit, status = got[1].tolist()
        if status != want_status or got[0][:n_dec].cpu().numpy().tobytes() != data8[:n_dec]:
            raise AssertionError(f"stream_decode {label}: status {status}, {n_dec} symbols")
        print(f"phase 2 stream_decode {label}: max_abs_err {e} ({n_dec} symbols, "
              f"end bit {end_bit}, status {status})")
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
        if tt.decode(want, static) != plain_bytes:
            raise AssertionError(f"decode of the golden bytes of {plain_bytes!r}")
    even, even_len = golden.EVEN_BYTES
    enc_even = tt.encode(even, static)
    if len(enc_even) != even_len or tt.decode(enc_even, static) != even:
        raise AssertionError("EVEN_BYTES")
    ab = tt.make_canonical({65: 1, 66: 2})
    bad_input = b"AB" * 5000 + b"C" + b"AB" * 10
    try:
        tt.encode_with_index(bad_input, ab)
    except tt.UnknownSymbolError as exc:
        if (exc.index, exc.symbol) != (10000, 67):
            raise AssertionError(f"unknown symbol at {exc.index}/{exc.symbol}") from exc
    else:
        raise AssertionError("unknown symbol did not raise")
    try:
        tt.decode(bytes(MIB), static)  # zeros match no code of the static table
    except tt.UnknownSymbolError:
        pass
    else:
        raise AssertionError("decode of zeros did not raise")
    data1 = data8[:MIB]
    enc1 = tt.encode(data1, static)
    for k in (0, 1, 4097, 65536):
        if tt.decode(enc1, static, max_output=k) != data1[:k]:
            raise AssertionError(f"decode with max_output={k}")
    print("phase 3: golden vectors, unknown-symbol index, decode of zeros raising, "
          "max_output ok")

    # ---- 4. the two paths at full size ------------------------------------
    data64 = np.random.default_rng(SEED + 1).integers(
        0, 256, size=64 * MIB, dtype=np.uint8).tobytes()
    hdrs = hpack_corpus(8 * MIB)
    runs = [("static 8 MiB", static, data8), ("static 64 MiB", static, data64),
            ("hpack 8 MiB", hpack, hdrs)]

    def reset(*counters):
        for counter in counters:
            for k in counter:
                counter[k] = 0

    # the indexed path: encode_with_index, then decode_indexed
    reset(pack_encode.launches, chain_decode.launches)
    results = []
    for name, table, data in runs:
        t0 = time.perf_counter()
        enc, idx = tt.encode_with_index(data, table)
        dec = tt.decode_indexed(enc, idx, table)
        secs = time.perf_counter() - t0
        results.append((name, table, data, enc, idx, dec, secs))
    launches = {**pack_encode.launches, **chain_decode.launches}
    print(f"phase 4 indexed path launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the indexed path never ran: {launches}")

    # the foreign-stream path: decode of the same streams, with no index
    reset(selfsync.launches, stream_decode.launches)
    foreign_runs = []
    for name, table, data, enc, _idx, _dec, _secs in results:
        before = selfsync.launches["selfsync_decode"]
        t0 = time.perf_counter()
        out = tt.decode(enc, table)
        secs = time.perf_counter() - t0
        foreign_runs.append((name, out, secs, selfsync.launches["selfsync_decode"] - before))
    foreign_launches = {**selfsync.launches, **stream_decode.launches}
    print(f"phase 4 foreign-stream path launches: {foreign_launches}")
    if not all(foreign_launches.values()):
        raise AssertionError(f"a kernel of the foreign-stream path never ran: {foreign_launches}")
    launches.update(foreign_launches)

    for (name, table, data, enc, idx, dec, secs), (_, out, f_secs, passes) in zip(
            results, foreign_runs):
        if dec != data:
            raise AssertionError(f"{name}: round trip differs")
        if out != data:
            raise AssertionError(f"{name}: decode of the stream differs")
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
              f"max code {idx.max_code_len}, {secs * 1e3:.1f} ms first call; "
              f"decode ok, {passes} fixpoint passes, {f_secs * 1e3:.1f} ms first call")

    # ---- 5. timings at 8 MiB ---------------------------------------------
    dt, chunk, offs, total, n_words, words, block_offs, nsyms, out_start = (
        shapes[static.name, 256])
    n = sym.numel()
    gbs = lambda ms: n / (ms * 1e-3) / 1e9  # noqa: E731
    f_dt, f_words, n_segs, seg_bits, max_syms, entries, f_nbytes = foreign["static"]
    _syms, counts, exits, _bad = selfsync.decode_segments(f_words, entries, seg_bits,
                                                          max_syms, f_dt)
    tail_start = n_segs * seg_bits + int(exits[-1]) - seg_bits
    n_tail, tail_end, _status = stream_decode.decode_stream(
        f_words, tail_start, 8 * f_nbytes, None, f_dt)[1].tolist()
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
        "selfsync_decode": (
            lambda: selfsync.decode_segments(f_words, entries, seg_bits, max_syms, f_dt),
            lambda: selfsync.decode_segments_plain(f_words, entries, seg_bits, max_syms, f_dt),
        ),
        "stream_decode": (
            lambda: stream_decode.decode_stream(f_words, tail_start, 8 * f_nbytes, None, f_dt),
            lambda: stream_decode.decode_stream_plain(
                f_words, tail_start, 8 * f_nbytes, None, f_dt),
        ),
    }
    where = {
        "encode_count": "8 MiB, block_symbols 256",
        "encode_pack": "8 MiB, block_symbols 256",
        "chain_decode": "8 MiB, block_symbols 256",
        "selfsync_decode": f"one converged pass over the 8 MiB stream, {n_segs} segments",
        "stream_decode": f"the tail of the 8 MiB stream, {n_tail} symbols",
    }
    n_body = int(counts.sum())
    # (bytes moved, integer operations) of each timed call
    work = {
        "encode_count": (n + 4 * offs.numel() + 16 + 4 * 256, OPS_PER_SYMBOL["encode_count"] * n),
        "encode_pack": (n + 8 * offs.numel() + 8 * 256 + 4 * n_words,
                        OPS_PER_SYMBOL["encode_pack"] * n),
        "chain_decode": (4 * n_words + 20 * block_offs.numel() + n + 8 * block_offs.numel()
                         + 4 + 4 * dt.l0.numel(), OPS_PER_SYMBOL["chain_decode"] * n),
        "selfsync_decode": (4 * min(f_words.numel(), n_segs * selfsync.SEG_WORDS + 1)
                            + 4 * n_segs + n_body + 12 * n_segs + 4 * f_dt.l0.numel(),
                            OPS_PER_SYMBOL["selfsync_decode"] * n_body),
        "stream_decode": (4 * (tail_end // 32 - tail_start // 32 + 2) + n_tail + 24
                          + 4 * f_dt.l0.numel(), OPS_PER_SYMBOL["stream_decode"] * n_tail),
    }
    ms = {}
    for name, (kernel, plain) in timed.items():
        # plain, kernel, kernel, plain: both sides see the same card state
        p1 = _median_ms(torch, plain)
        k1 = _median_ms(torch, kernel)
        k2 = _median_ms(torch, kernel)
        p2 = _median_ms(torch, plain)
        ms[name] = (min(k1, k2), min(p1, p2))
        bound_ms, bound_by = _bound(*work[name])
        print(f"phase 5 {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} ({where[name]})")
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
    before = selfsync.launches["selfsync_decode"]
    foreign_ms = _median_wall_ms(torch, lambda: tt.decode(enc8, static))
    passes = (selfsync.launches["selfsync_decode"] - before) / (REPS + 1)
    print(f"phase 5 end to end from host bytes at 8 MiB: decode {foreign_ms:.3f} ms "
          f"({gbs(foreign_ms):.3f} GB/s of plaintext), beside decode_indexed "
          f"{dec_ms:.3f} ms on the same stream; {passes:g} fixpoint passes per call")
    for label, fn, wall in (("round trip", round_trip, e2e_ms),
                            ("decode", lambda: tt.decode(enc8, static), foreign_ms)):
        by_kernel = _device_ms_by_kernel(torch, fn)
        print(f"phase 5 {label} at 8 MiB, device ms per call by torch.profiler: "
              f"{sum(by_kernel.values()):.4f} busy of {wall:.3f} wall")
        for key, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
            print(f"  {t:.4f} ms  {key[:100]}")

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
        {"name": "selfsync_decode", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/selfsync_decode.cu",
         "replaces": "tpu_huffman/ops/selfsync.py:51"},
        {"name": "stream_decode", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/stream_decode.cu",
         "replaces": "tpu_huffman/ops/decode.py:107"},
    ]
    for k in kernels:
        bound_ms, bound_by = _bound(*work[k["name"]])
        # No single PyTorch call computes any of these functions.
        k.update(launches=launches[k["name"]], max_abs_err=errs[k["name"]],
                 ms=ms[k["name"]][0], plain_ms=ms[k["name"]][1],
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                 kernel_only_ms=kernel_only.get(k["name"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

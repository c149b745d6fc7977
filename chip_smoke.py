"""Smoke test of the PyTorch port on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (name and power limit from nvidia-smi, compute capability
     9.0, SMs and top SM clock), torch and CUDA versions; build the kernels (one nvcc per source,
     all at once) and print the build time;
  2. each kernel against its plain PyTorch version on the same CUDA tensors
     at main-path shapes, every output bit-identical:
     - count, pack (words and block offsets), chain_decode: 8 MiB of random
       bytes (seed 2024) on the static table at block_symbols 256, 512, 100
       and 1000 (the last two give chains whose output spans are not
       16-byte aligned), and on the HPACK table (codes up to 30 bits) at
       256; count and pack also at block_symbols 1; pack into a fresh
       output and into one filled with junk (it writes every word); count
       and pack at the tile's edges (n = TILE - 1, TILE, TILE + 1, a last
       tile of fewer than 32 bits) and on a view off 16-byte alignment,
       at block_symbols 1, 100 and 256 on both tables;
     - selfsync_decode: the stream of those 8 MiB on the static table, the
       same bytes taken as a stream (a foreign stream full of invalid
       windows), and the HPACK stream of them (30-bit codes, level-1 LUT in
       global memory), each on pass 0 (segment-aligned entries) and on the
       fixpoint's converged pass, and in the three forms the stitch launches
       (pass 0 with starts and blast, the patch with its code cap, the
       re-decode of the walked segments with segment ids and dead lanes,
       or a repair of R_MAX segments where the stitch walked none), on
       starts and row buffers filled with junk, every live row 0 /
       NO_START past its count (the kernel writes whole rows; a dead
       lane's syms row is left as it was and zeroed on both sides before
       the comparison); the stitched body and tail start equal the
       fixpoint's (the random-byte stream, whose true chain meets invalid
       windows, stays unresolved);
     - the stitch's walk (phase_walk) on an 8 MiB object of the
       benchmark's canterbury class, whose zero runs keep runs of segments
       out of phase: claims and kept walks against its plain version, the
       walked stitch against the fixpoint, the walk alone beside its bound
       and its plain version, and that object's decode in turns with the
       fixpoint path (wall and device ms, launches, outcomes, host syncs);
     - stream_decode (one block walking the stream in shared-memory
       windows) against both plain versions, the blocked one (symbols, n,
       end bit, status and the windows and sync rounds) and the serial one:
       the 8 MiB stream's 191-symbol tail and 2, 16 and 64 KiB walks on the
       static and HPACK tables; caps at 0, 1, a slice boundary, a window
       boundary, n - 1, n and n + 1; into an output filled with junk; a
       corrupt word in the third window (UNKNOWN_SYMBOL); a zero blob; a
       256 x 8-bit table from bit 3 (no slice ever resynchronises: the
       rounds stay within the slices); phase 8 adds a capped walk started
       past bit 2^31; beside each, the probe's block walk counts the
       re-walks by branch (joined from the old record, the old starts, a
       walk of the suffix), and every branch must have run;
     - stream_decode's device-scalar form (decode_stream_dev: start bit,
       stream length and budget read from device memory, the fused
       streaming drain's tail walk) at the fused drain's output size on
       the 8 MiB stream's tail, uncapped and with budgets 100, 0, n - 1
       and n, and from a negative start, against its plain version and the
       by-value form;
  3. the golden vectors through the public encode/encode_with_index and
     decode; an unknown symbol raising with the right index on encode and
     zeros raising on decode (from the fixpoint fallback); max_output giving
     the first bytes of 1 MiB; the HPACK table built at root_bits 16 through
     decode, decode_indexed and HuffmanDecoder on 1 MiB of random bytes;
  4. two paths at full size through the public API, each with the launch
     counters reset just before it and read just after, every kernel of the
     path launched: the indexed path (encode_with_index then
     decode_indexed) and the foreign-stream path (decode of the same
     stream with no index), on the static table at 8 and 64 MiB of random
     bytes and the HPACK table at 8 MiB of header text; the decoded bytes
     equal the input, the encoded bytes the C++ oracle's, and the encoded
     bytes and index the plain version's; every download of both paths
     lands in a pinned block (copies.d2h_pinned equal to copies.d2h); each
     encode makes exactly one count and one pack launch;
     each decode takes the stitch (2 selfsync_decode launches, 4 with
     a walk and its re-decode, never the fixpoint), its launches and
     unresolved and walked segments printed;
  5. timings with CUDA events at 8 MiB: each kernel's wrapper beside its
     plain version (prof.median_ms: median of 11 samples of 5 calls after
     a warm-up), each kernel alone by torch.profiler (the pack at
     block_symbols 256 and 100, beside its bound), the stitch's three
     forms with their bounds, each redesigned decode form (chain_decode, the
     full pass, the patch) beside the same loop with one store a symbol and
     with none (prof.decode_ablate, prof.kernel_ms), the stitch's torch ops
     by torch.profiler, stream_decode alone at each of decode_ablate's
     walks (7 and 64 bytes, the tail, 2, 16 and 64 KiB, a capped walk of
     2^20 symbols) beside the probe's one-thread `serial` design, an empty
     block and its bound; the device-scalar form alone on the tail beside
     the by-value form in one call; a one-shot decode of 2 KiB to 1 MiB through the
     walk and through the self-sync path (wall and device busy); the
     device time of one decode by kernel, the host syncs of one decode
     (torch.cuda.set_sync_debug_mode), and the public calls end to end from
     host bytes, in GB/s of plaintext;
  6. the streaming path (bench_suite.bench_streaming on the port): 64 MiB of
     random bytes (seed 11) on the static table through a capped
     HuffmanEncoder.encode_chunk loop at 1 MiB (its bytes equal tt.encode's),
     a HuffmanDecoder fed 1 MiB input chunks, and a capped drain of 1 MiB
     symbols a call after one feed (both give the input back), all through
     the fused calls (one sequence of launches and one download a call):
     first call by call against the classic forms (the encoder's two-step
     _encode_chunk_classic; the classic words drains called directly) and
     the C++ oracle (bytes, consumed, done, state(), carries), each fused
     call under set_sync_debug_mode, failing above 1 host sync plus its
     counted second downloads, with the fallbacks to the classic drain
     printed; then, with the launch counters reset before each loop and
     every kernel of the path launched (count, pack, selfsync_decode with
     starts, stream_decode_dev), the
     calls, the selfsync_decode launches per drain and the stitch outcomes
     of each loop, the median ms per call of the first and
     last eight calls of each loop, and 64 MiB / (t_enc + t_dec) in GB/s,
     twice, the classic loops timed in turns with them; the wall and
     device busy (torch.profiler) of one call of each, fused and classic;
     then selfsync_decode with starts against its plain version and timed
     at one drain call's shape; then 4 MiB at 16 KiB chunks (HTTP/2's
     default frame size), every fed call one stream_decode launch: the
     median wall and device busy of a call and 4 MiB / (t_enc + t_dec);
  7. the protocol on the card: a 256 KiB stream at 4 KiB chunks, the
     decoder's threshold lowered so that the fused bulk drains run;
     every call's result, overflow_bits, leftover_bits and state equal
     those on device="cpu"; the stitch outcomes on the card printed; then
     C4: capped encode_chunk calls with an unknown symbol before, at and
     past the capacity cut (after a straddling code, in a run, behind
     carries of 0 and 1 bit, at capacities 0, 1, 3 and 7, and a seeded
     build_table table with holes at capacities 0-7), each call through
     the fused path on the card equal to the C++ oracle's and the CPU's,
     raises included, with encode_count launched on the card;
  8. C2: one uncapped encode_chunk of a stream just past 2^31 bits: no
     segmenting (one pack launch), bytes equal tt.encode's, tt.decode gives
     the input back; capped stream_decode walks from the first code start
     past bit 2^31 and from 4096 codes before it, against both plain
     versions and the input;
  9. HPACK: 1000 header strings, each a fresh stream encoded with
     eos_padding 0xFF and decoded in 7-byte pieces, padding all ones; the
     median us per string;
 10. the profiling probes (tpu_huffman_torch.prof, the counterparts of the
     Pallas probes in scripts/prof/), driven through each module's run()
     with the launch counters reset just before: every form of lut_chain
     (P1, P2, P3; its addr form, the table as next addresses, one
     conflict-free load a round, timed beside smem, the design before it)
     and lut_wide (P6; its word form, one 32-bit marker-bit
     word a lookup, timed beside smem, the design before it), every mode
     of lut_wide_mma (the mma.sync kernel it had, that kernel's split, the
     wgmma and reworked mma.sync kernels, each with its registers and
     blocks an SM) against lut_wide, both forms of lut_chain_mma (P1 and
     P3; its nibble form, the one-hot over the low nibble, two independent
     mma a tile-round and a third that sums the row, timed beside sync,
     the design before it) against lut_chain, every
     kind and form of step_chain (P4; gather's and gather0's lean form,
     the fewest integer instructions a step, timed beside gather smem),
     every pack_ablate mode (P5; the per-thread loop of the design before
     the tile loop at chunks 32 and 4, and the tile loop, both against
     encode_pack's words), and
     every decode_ablate mode and block size (the decode loops' stores
     swapped: the question of scripts/prof/prof_decode_parts.py; its
     stream case: the block walk with the LUT in shared memory or read
     through the cache, without its write pass, at each window shape, and
     the one-thread serial loop, at each walk),
     each bit-identical to its plain version at the script's shape and
     seed and at every shape, round count and block size it is timed at;
     then timed where they fill the card, the dependent-step
     latencies at 1, 8 and 64 warps an SM, and the library yardsticks
     (chained torch.take on P2's and on P3's table; the one-hot
     torch.matmul); the main loop of each chained-lookup kernel in SASS
     (prof.sass: instructions a load, opcodes); the bounds of lut_chain,
     lut_wide and step_chain also
     count their shared-memory lookups (32 lanes x 4 B a cycle an SM at
     the card's top SM clock, from nvidia-smi);
 11. the mesh (tpu_huffman_torch.shard, .distributed): MeshCodec on
     default_mesh() (every card), on 4 shards of the first card and on a
     2 x 2 ("dcn", "ici") mesh of it, 64 MiB of random bytes (seed 2024)
     on the static table at block_symbols 256, with the launch counters
     reset before each mesh and one count, pack and chain_decode per
     non-empty shard asserted; bytes and index equal encode_with_index's,
     decode gives the input; each shard's count, its pack at its own phase
     and at phase 31, and its chain_decode stripe against the plain
     versions; ragged sizes (1, 7, 4095, 4 x 2 tiles so that every shard
     ends on a tile seam, 12345), eos_padding 0x00/0x5A/0xFF, an unknown
     symbol at tt.encode's (index, symbol), a corrupt stream raising;
     canterbury_like(8 MiB, seed 42) with build_table(max_len=14) through
     encode_with_index and the 4-shard mesh against the plain versions;
     two worker processes (this script with --mesh-worker) in a gloo group,
     2 shards each on the first card, through encode_global/decode_global
     on 20,000 and 16 MiB split unevenly: the bytes equal tt.encode of the
     whole, both ranks return the same index and the plaintext, each rank
     launches one count, pack and chain_decode a non-empty shard (NCCL is
     not verified: it runs one rank a card); then wall and device busy of
     MeshCodec.encode/decode at 64 MiB on 1 and 4 shards beside
     encode_with_index/decode_indexed;
 12. the fixed-size step (tpu_huffman_torch.ops.encode.best_encode_step,
     the bench's seam) at 65536 symbols and 8 MiB of random bytes (seed
     2024) on the static, HPACK and 5-30-bit tables (bench_suite's
     make_canonical(mixed_lengths_5_30()), taken from its source), with
     the launch counters reset before each step (one count and one pack
     each): its bytes equal the port's C++ oracle's (tpu_huffman_torch.oracle,
     built by g++ here; a failed build fails the phase), words past the pad
     zero; the pack's device-total form against pack_plain with the total
     as a 0-d tensor at every pad_len 0-7 on each table and size, into
     words filled with junk; encode_fn with no host sync (under
     set_sync_debug_mode "warn", beside the warnings around no call, and
     under "error"), captured in a CUDA graph whose replays equal the eager
     step; finalize_fn raising at tt.encode's (index, symbol); the entry
     twin's entry() and dryrun_multichip(8); both example twins with
     --device cuda in subprocesses; then the step at 8 MiB by events, the
     card alone and a graph replay beside encode_with_index's device
     stages, the device-total pack beside the by-value form, its plain
     version and its bound, and the oracle's encode and decode GB/s on one
     host core, each printed with the card's name and power limit.

The last line is one JSON object {"ok": true, "device": {...}}; the line
before it is the {"kernels": [...]} summary (count, pack and chain_decode
list every path that launched them, with its launches, under "paths"; the
pack's device-total form and the step's timings are under the pack's
"device_total" and "best_encode_step"; stream_decode_dev's launches are
the fused streaming loops' of phase 6),
with each kernel's bound: the
larger of the bytes it must move (each input read once, each output written
once) over 3.35 TB/s and its integer operations over 67 T/s (the card's
float32 rate outside the tensor cores, the published peak nearest to
32-bit integer work); the tensor-core probe's bound counts its bf16 flops
over 989 T/s. Without a CUDA device the script exits non-zero and
prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import ast
import collections
import concurrent.futures
import itertools
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
SEED = 2024  # bench.py's corpus seed
REPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
# The data sheet gives no 32-bit integer rate; its float32 rate outside the
# tensor cores is the nearest published peak.
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense tensor-core bf16 (NVIDIA's data sheet)
# Shared-memory lookups a second: 32 lanes x 4 bytes a cycle an SM, over
# the card's SMs at its top SM clock (main() sets it from the card; this
# is the H100 SXM's 132 SMs at 1980 MHz).
SMEM_LOOKUPS_PER_S = 132 * 32 * 1980e6
SM_HZ = 1980e6  # the top SM clock (main() sets it from the card)
# The stitch's walk is one chain a thread: each step a dependent
# shared-memory lookup and the shift after it, taken as 30 cycles.
WALK_CYCLES_PER_LOOKUP = 30
WALK_SEED = 4190002011  # the benchmark's seeds are this large
# Integer operations per symbol in each kernel's loop body (a table gather,
# shifts, compares, adds, the store), counted from the sources in csrc/.
OPS_PER_SYMBOL = {"encode_count": 5, "encode_pack": 12, "chain_decode": 10,
                  "selfsync_decode": 10, "selfsync_decode_starts": 11, "stream_decode": 10}


def _bench_suite_fn(name: str):
    """A function of ``bench_suite.py``, taken from its source: importing
    bench_suite would run its JAX compile-cache set-up."""
    path = os.path.join(ROOT, "bench_suite.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(
        node for node in tree.body
        if isinstance(node, ast.FunctionDef) and node.name == name
    )
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns[name]


def hpack_corpus(n: int) -> bytes:
    """``bench_suite.hpack_header_corpus``."""
    return _bench_suite_fn("hpack_header_corpus")(n)


def mixed_lengths_5_30() -> dict:
    """``bench_suite.mixed_lengths_5_30``: the code lengths of its 5-30-bit
    table (``make_canonical`` of them is its table_5_30 config)."""
    return _bench_suite_fn("mixed_lengths_5_30")()


def _golden():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden  # plain data: the reference's known-answer vectors

    return golden


def _device_us(evt) -> float:
    """An averaged profiler event's device time in us (the attribute's name
    differs between torch versions)."""
    if hasattr(evt, "device_time_total"):
        return evt.device_time_total
    return evt.cuda_time_total


def _profiled_kernel_ms(torch, calls) -> dict:
    """Device time per launch of each named CUDA kernel, by torch.profiler,
    over REPS runs of every call: the kernel alone, without the wrapper's
    allocations, the fills of its outputs and its launch gaps, which
    prof.kernel_ms's events cannot leave out. Each kernel's mean divides by
    the launches the profiler saw, so a launch it drops does not bias it
    (the probes cannot use it: one kernel name serves many forms there).
    Kernels the profiler did not see are left out (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    for call in calls.values():
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls.values():
            for _ in range(REPS):
                call()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        for name in calls:
            if f"{name}_kernel" in evt.key and evt.count:
                out[name] = _device_us(evt) / evt.count / 1e3
    return out


def _median_wall_ms(torch, fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
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


def _host_ms_by_function(fn, calls: int = 8, top: int = 6) -> list:
    """Host time per fn() call of the functions that spend most of it
    themselves, by cProfile over `calls` calls after one warm-up (cProfile
    adds a little to every Python call)."""
    import cProfile
    import pstats

    fn()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[2], k) for k, v in stats.items()), reverse=True)[:top]
    return [(k[2] if k[0] == "~" else f"{os.path.basename(k[0])}:{k[2]}", t * 1e3 / calls)
            for t, k in rows]


def with_syncs(torch, fn) -> tuple:
    """(fn()'s result, the file:line of each host sync it made): each
    synchronising CUDA call warns under torch.cuda.set_sync_debug_mode("warn")."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return got, ["/".join(w.filename.split("/")[-2:]) + f":{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


def sync_sites(torch, fn) -> list:
    """The file:line of each host sync fn() makes."""
    return with_syncs(torch, fn)[1]


def _bound(nbytes: int, ops: int, lookups: int = 0) -> tuple[float, str]:
    """The least time the card could take (ms), and what bounds it: the
    bytes, the integer operations, or the shared-memory lookups (the
    probes whose work is those lookups)."""
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               (ops / SCALAR_OPS_PER_S * 1e3, "operations"),
               (lookups / SMEM_LOOKUPS_PER_S * 1e3, "shared-memory lookups"))


def _reset(*counters) -> None:
    """Set every launch count to 0."""
    for counter in counters:
        for k in counter:
            counter[k] = 0


def _first_last_ms(times: list) -> tuple[float, float]:
    """Median ms of the first and of the last eight calls of a loop."""
    return (statistics.median(times[:8]) * 1e3, statistics.median(times[-8:]) * 1e3)


def _timed_calls(call, first_arg, next_arg, done):
    """Run call(first_arg), then call(next_arg(result)) until done(result);
    returns the results and each call's seconds (each call ends in a host
    copy, so the host clock covers its device work)."""
    results, times = [], []
    arg = first_arg
    while True:
        t0 = time.perf_counter()
        r = call(arg)
        times.append(time.perf_counter() - t0)
        results.append(r)
        if done(r):
            return results, times
        arg = next_arg(r)


def stitch_calls(torch, selfsync, words, n_segs: int, seg_bits: int, dt, seed: int = SEED):
    """One stitch of a stream's kernel segments from bit 0, with the
    selfsync_decode launches it makes recorded as (args, kwargs): "full"
    (starts and blast), "patch" (the code cap) and "repair" (segment ids).
    When the stitch made no repair launch, the repair form takes R_MAX
    segments picked from `seed` at their true entries, the last quarter of
    its lanes dead. Returns (the calls, the stitch's result)."""
    real = selfsync.decode_segments
    seen = []

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    selfsync.decode_segments = spy
    try:
        stitched = selfsync.stitch(words, 0, (n_segs, seg_bits), dt)
    finally:
        selfsync.decode_segments = real
    calls = {"full": seen[0], "patch": seen[1]}
    if len(seen) > 2:
        calls["repair"] = seen[2]
    else:
        ids = np.random.default_rng(seed).choice(n_segs, size=min(selfsync.R_MAX, n_segs),
                                                 replace=False).astype(np.int32)
        ids[-(len(ids) // 4):] = -1
        seg_ids = torch.from_numpy(ids).to(words.device)
        entries1 = seen[1][0][1]
        ent = torch.where(seg_ids >= 0, entries1[seg_ids.clamp(min=0).long()], 0)
        max_syms = selfsync.max_symbols(dt.table, seg_bits)
        starts = torch.empty((len(ids), max_syms), dtype=torch.int16, device=words.device)
        calls["repair"] = ((words, ent, seg_bits, max_syms, dt),
                           {"starts": starts, "seg_ids": seg_ids})
    return calls, stitched


JUNK = -5  # what a row or lane output holds before a call that must overwrite it


def check_encode(torch, pack_encode, sym, dt, block_symbols: int) -> tuple:
    """count and pack on `sym` against their plain versions, the pack both
    into a fresh output and into one filled with JUNK (it must write every
    word). Returns (count's max_abs_err, pack's over words and block
    offsets, (tile offsets, total bits, n_words, words, block offsets))."""
    from tpu_huffman_torch.prof import max_abs_err

    tile_bits, stats = pack_encode.count(sym, dt)
    want_bits, want_stats = pack_encode.count_plain(sym, dt)
    torch.cuda.synchronize()
    e_count = max(max_abs_err(tile_bits, want_bits), max_abs_err(stats, want_stats))
    incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
    offs = incl - tile_bits
    total = int(incl[-1])
    n_words = -(-(total + pack_encode.pad_code(total, 0xFF)[1]) // 32)
    args = (sym, dt, offs, total, 0xFF, n_words, block_symbols)
    words, block_offs = pack_encode.pack(*args)
    junk = torch.full((n_words,), JUNK, dtype=torch.int32, device=sym.device)
    words_j, block_offs_j = pack_encode.pack(*args, out=junk)
    want_words, want_offs = pack_encode.pack_plain(*args)
    torch.cuda.synchronize()
    e_pack = max(max_abs_err(w, want_words) for w in (words, words_j))
    e_pack = max(e_pack, *(max_abs_err(b, want_offs) for b in (block_offs, block_offs_j)))
    return e_count, e_pack, (offs, total, n_words, words, block_offs)


def stitch_form(selfsync, args, kw, plain: bool = False):
    """A recorded selfsync_decode launch again, on fresh starts and blast
    buffers filled with JUNK (the stitch allocates them uninitialised: the
    kernel writes every slot of a live lane), by the kernel or its plain
    version: its four outputs, then the starts and blast."""
    kw = dict(kw)
    for key in ("starts", "blast", "syms_out"):
        if key in kw:
            kw[key] = kw[key].new_full(kw[key].shape, JUNK & (0xFF if key == "syms_out" else -1))
    fn = selfsync.decode_segments_plain if plain else selfsync.decode_segments
    return (*fn(*args, **kw), *(kw[k] for k in ("starts", "blast") if k in kw))


def defined(torch, selfsync, outs, kw):
    """A stitch form's outputs with each dead repair lane's syms row zeroed:
    a dead lane writes nothing, so the kernel leaves that row as allocated.
    Checks the row contract on the live lanes: 0 in syms and NO_START in
    starts from each count to the end of the row."""
    syms, counts = outs[0], outs[1]
    live = kw["seg_ids"] >= 0 if "seg_ids" in kw else torch.ones_like(counts, dtype=torch.bool)
    past = torch.arange(syms.shape[1], device=syms.device)[None, :] >= counts[:, None].long()
    rows_ok = bool((syms[live] == 0).logical_or(~past[live]).all())
    if "starts" in kw:
        st = outs[4]
        rows_ok &= bool((st[live] == selfsync.NO_START).logical_or(~past[live]).all())
    if not rows_ok:
        raise AssertionError("a live lane left slots past its count unwritten")
    return (torch.where(live[:, None], syms, 0), *outs[1:])


def stitch_form_work(form: str, args, kw, outs, seg_bits: int, seg_words: int) -> tuple:
    """(bytes moved, integer operations) of one launch of a stitch form:
    the stream bits its lanes cover, read once (the full pass: every
    segment's words; the patch: entry to exit; a repair: its live
    segments), the entries and segment ids, each symbol's byte and start,
    the per-lane outputs and the LUT's level 0; and OPS_PER_SYMBOL's count
    for the starts form per symbol."""
    words, entries, dt = args[0], args[1], args[4]
    lanes = entries.numel()
    n_sym = int(outs[1].sum())
    if form == "full":
        covered = 4 * min(words.numel(), lanes * seg_words + 1)
    elif form == "patch":
        covered = int((outs[2].long() - entries.long()).clamp(min=0).sum()) // 8
    else:
        covered = int((kw["seg_ids"] >= 0).sum()) * seg_bits // 8
    per_lane = 4 * (1 + ("seg_ids" in kw) + 3 + ("blast" in kw))
    return (covered + per_lane * lanes + 3 * n_sym + 4 * dt.l0.numel(),
            OPS_PER_SYMBOL["selfsync_decode_starts"] * n_sym)


def classic_decoder(tt, table, dev):
    """A HuffmanDecoder whose bulk drains call the classic words drains
    (selfsync_decode_words, selfsync_decode_capped_words) directly, in
    place of the fused one: the form the fused drain replaced."""
    from tpu_huffman_torch import stream
    from tpu_huffman_torch.ops import selfsync

    dec = tt.HuffmanDecoder(table, device=dev)
    fused = dec._drain

    def drain(capacity):
        rem = dec._rem
        if (8 * rem.nbytes > rem.consumed_bit
                and rem.nbytes - (rem.consumed_bit >> 3) > stream.BULK_DECODE_THRESHOLD):
            args = (rem.buf, rem.nbytes, rem.consumed_bit, table)
            if capacity is None:
                return (*selfsync.selfsync_decode_words(*args), False)
            return selfsync.selfsync_decode_capped_words(*args, capacity)
        return fused(capacity)

    dec._drain = drain
    return dec


def fused_checks(torch, tt, table, dev, data: bytes, encoded: bytes, cap: int) -> dict:
    """The three loops of phase 6 call by call: the fused calls against the
    classic forms (the encoder's _encode_chunk_classic, classic_decoder) and
    the C++ oracle (bytes, consumed, done, state() and carries), each fused
    call under set_sync_debug_mode: at most 1 host sync plus its counted
    second downloads. Returns {loop: {calls, syncs by count, second
    downloads, fallbacks}}."""
    from tpu_huffman_torch import oracle as orc_mod
    from tpu_huffman_torch import stream
    from tpu_huffman_torch.ops import selfsync

    otable = orc_mod.OracleTable(table)
    # what warns with no call between the mode's switches is not the call's
    idle = set(sync_sites(torch, lambda: None))
    report = {}

    def counted(loop, fn):
        """fn() under the sync check; its syncs, second downloads and fallbacks."""
        seconds = stream.encode_outcomes["second_downloads"] + selfsync.outcomes[
            "second_downloads"]
        fell = selfsync.outcomes["fallback"]
        got, sites = with_syncs(torch, fn)
        sites = [site for site in sites if site not in idle]
        second = (stream.encode_outcomes["second_downloads"]
                  + selfsync.outcomes["second_downloads"] - seconds)
        fallback = selfsync.outcomes["fallback"] - fell
        rep = report.setdefault(loop, {"calls": 0, "syncs": collections.Counter(),
                                       "second_downloads": 0, "fallbacks": 0,
                                       "first_call_sites": sites})
        rep["calls"] += 1
        rep["syncs"][len(sites)] += 1
        rep["second_downloads"] += second
        rep["fallbacks"] += fallback
        if len(sites) > 1 + second:
            raise AssertionError(f"phase 6 fused {loop} call {rep['calls']}: "
                                 f"{len(sites)} host syncs ({', '.join(sites)}), "
                                 f"{second} second downloads, {fallback} fallbacks")
        return got

    # the capped encode_chunk loop
    fused, classic = tt.HuffmanEncoder(table, device=dev), tt.HuffmanEncoder(table, device=dev)
    orc = orc_mod.OracleEncoder(otable)
    view = memoryview(data)
    while True:
        r = counted("encode_chunk", lambda: fused.encode_chunk(view, cap))
        c = classic._encode_chunk_classic(view, cap)
        o = orc.encode_chunk(view, cap)
        if not ((r.data, r.consumed, r.done) == (c.data, c.consumed, c.done) == o
                and fused.state() == classic.state()
                and fused.overflow_bits == orc.overflow_bits):
            raise AssertionError("phase 6: a fused encode_chunk differs from the classic "
                                 "form's or the oracle's")
        view = view[r.consumed:]
        if r.done:
            break
    # the decoder fed `cap`-byte input chunks, uncapped
    fused, classic = tt.HuffmanDecoder(table, device=dev), classic_decoder(tt, table, dev)
    orc = orc_mod.OracleDecoder(otable)
    for i in range(0, len(encoded), cap):
        chunk = encoded[i:i + cap]
        r = counted("fed decode_chunk", lambda: fused.decode_chunk(chunk))
        c = classic.decode_chunk(chunk)
        o_out, o_used, _ = orc.decode_chunk(chunk, len(data))
        if not ((r.data, r.done) == (c.data, c.done) and r.data == o_out
                and o_used == len(chunk) and fused.state() == classic.state()):
            raise AssertionError(f"phase 6: fused decode_chunk of input chunk {i // cap} "
                                 f"differs from the classic drain's or the oracle's")
    # one feed, then drains of `cap` symbols a call
    fused, classic = tt.HuffmanDecoder(table, device=dev), classic_decoder(tt, table, dev)
    orc = orc_mod.OracleDecoder(otable)
    pending_o, feed, calls = memoryview(encoded), encoded, 0
    while True:
        r = counted("capped drain", lambda: fused.decode_chunk(feed, capacity=cap))
        c = classic.decode_chunk(feed, capacity=cap)
        feed = b""
        o_out, o_used, o_done = orc.decode_chunk(pending_o, cap)
        pending_o = pending_o[o_used:]
        calls += 1
        same_state = (fused.state() == classic.state()) if r.done or calls % 8 == 0 else True
        if not ((r.data, r.done) == (c.data, c.done) and r.data == o_out
                and r.done == (o_done and not len(pending_o)) and same_state):
            raise AssertionError(f"phase 6: fused capped drain call {calls} differs from the "
                                 f"classic drain's or the oracle's")
        if r.done:
            break
    for loop, rep in report.items():
        rep["syncs"] = dict(sorted(rep["syncs"].items()))
        print(f"phase 6 fused {loop}: {rep['calls']} calls equal to the classic form's and the "
              f"oracle's (bytes, done, state); host syncs per call (calls by count): "
              f"{rep['syncs']}, the first call's at {rep['first_call_sites']} (not counted: "
              f"{sorted(idle)}, which warn with no call between the mode's switches); second "
              f"downloads {rep['second_downloads']}, fallbacks to the classic drain "
              f"{rep['fallbacks']}")
    return report


def phase_streaming(torch, tt, table, counters, dev, stream_mb: int = 64,
                    cap: int = MIB) -> dict:
    """bench_suite.bench_streaming on the port: a capped encode_chunk loop,
    a decoder fed 1 MiB input chunks, and a capped drain of 1 MiB symbols a
    call after one feed, each with the launch counters reset before it;
    the fused calls against the classic forms and the oracle call by call
    (fused_checks), and both forms timed in turns."""
    from tpu_huffman_torch.ops import selfsync

    n = stream_mb * MIB
    data = np.random.default_rng(11).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    want = tt.encode(data, table, device=dev)

    def encode_loop(src, classic=False):
        enc = tt.HuffmanEncoder(table, device=dev)
        step = enc._encode_chunk_classic if classic else enc.encode_chunk
        view = memoryview(src)

        def call(pending):
            return step(pending, cap), pending

        return _timed_calls(call, view, lambda rp: rp[1][rp[0].consumed:], lambda rp: rp[0].done)

    def decoder(classic):
        return classic_decoder(tt, table, dev) if classic else tt.HuffmanDecoder(table,
                                                                                 device=dev)

    def feed_loop(encoded, classic=False):
        dec = decoder(classic)
        offs = list(range(0, len(encoded), cap))
        results, times = [], []
        for i in offs:
            t0 = time.perf_counter()
            results.append(dec.decode_chunk(encoded[i:i + cap]))
            times.append(time.perf_counter() - t0)
        return results, times

    def drain_loop(encoded, classic=False):
        dec = decoder(classic)
        per_call = []

        def call(feed):
            before = selfsync.launches["selfsync_decode"]
            r = dec.decode_chunk(feed, capacity=cap)
            per_call.append(selfsync.launches["selfsync_decode"] - before)
            return r

        results, times = _timed_calls(call, encoded, lambda r: b"", lambda r: r.done)
        return results, times, per_call

    # warm-up: each loop once on a 4-chunk stream (allocator, kernel load)
    warm = data[: 4 * cap]
    warm_enc = b"".join(r.data for r, _ in encode_loop(warm)[0])
    for classic in (False, True):
        encode_loop(warm, classic)
        feed_loop(warm_enc, classic)
        drain_loop(warm_enc, classic)
    checks = fused_checks(torch, tt, table, dev, data, want, cap)

    def classic_loops() -> dict:
        """The three loops through the classic forms, their output checked:
        the median ms of a call."""
        enc_results, enc_times = encode_loop(data, classic=True)
        feed_results, feed_times = feed_loop(want, classic=True)
        drain_results, drain_times, _ = drain_loop(want, classic=True)
        if not (b"".join(r.data for r, _ in enc_results) == want
                and b"".join(r.data for r in feed_results) == data
                == b"".join(r.data for r in drain_results)):
            raise AssertionError("phase 6: a classic loop's output differs")
        return {"encode_chunk": statistics.median(enc_times) * 1e3,
                "fed decode_chunk": statistics.median(feed_times) * 1e3,
                "capped drain": statistics.median(drain_times) * 1e3}

    def launched() -> dict:
        return {k: v for c in counters for k, v in c.items()}

    # the three loops twice, fused and classic in turns (fused first in run
    # 1, classic first in run 2): host-clock times vary from run to run
    classic_ms = {}
    for rep in (1, 2):
        if rep == 2:
            classic_ms[rep] = classic_loops()
        out, ends = {}, {}
        _reset(*counters)
        t0 = time.perf_counter()
        enc_results, enc_times = encode_loop(data)
        t_enc = time.perf_counter() - t0
        out["encode"] = launched()
        encoded = b"".join(r.data for r, _ in enc_results)
        if encoded != want:
            raise AssertionError("streaming encode differs from tt.encode of the same input")

        _reset(*counters, selfsync.outcomes)
        t0 = time.perf_counter()
        feed_results, feed_times = feed_loop(encoded)
        t_dec = time.perf_counter() - t0
        out["feed"], ends["feed"] = launched(), dict(selfsync.outcomes)
        if b"".join(r.data for r in feed_results) != data or not feed_results[-1].done:
            raise AssertionError("streaming decode of input chunks differs from the input")

        _reset(*counters, selfsync.outcomes)
        t0 = time.perf_counter()
        drain_results, drain_times, per_call = drain_loop(encoded)
        t_drain = time.perf_counter() - t0
        out["drain"], ends["drain"] = launched(), dict(selfsync.outcomes)
        if b"".join(r.data for r in drain_results) != data:
            raise AssertionError("capped drain differs from the input")
        if rep == 1:
            classic_ms[rep] = classic_loops()

        for loop, needed in (("encode", ("encode_count", "encode_pack")),
                             ("feed", ("selfsync_decode", "stream_decode_dev")),
                             ("drain", ("selfsync_decode_starts", "stream_decode_dev"))):
            if not all(out[loop][k] for k in needed):
                raise AssertionError(f"streaming {loop} loop did not launch {needed}: {out[loop]}")
        total = {k: sum(out[loop][k] for loop in out) for k in out["encode"]}
        # the by-value walk runs only on remainders of <= 64 KiB, and the
        # fused drains repair in place of the stitch's walk
        if not all(v for k, v in total.items()
                   if k not in ("stream_decode", "selfsync_decode_walk")):
            raise AssertionError(f"a kernel of the streaming path never ran: {total}")
        for loop, times in ((f"encode_chunk, capacity {cap} bytes", enc_times),
                            (f"decode_chunk, {cap}-byte input chunks", feed_times),
                            (f"decode_chunk, capacity {cap} symbols after one feed",
                             drain_times)):
            first, last = _first_last_ms(times)
            groups = [statistics.median(times[i:i + 8]) * 1e3 for i in range(0, len(times), 8)]
            print(f"phase 6 streaming run {rep} {loop}: {len(times)} calls, "
                  f"{sum(times) * 1e3:.1f} ms, median ms per call: first 8 {first:.3f}, last 8 "
                  f"{last:.3f}; by groups of 8: " + " ".join(f"{g:.3f}" for g in groups))
        gbs = n / (t_enc + t_dec) / 1e9
        print(f"phase 6 streaming run {rep}, {stream_mb} MiB at {cap}-byte chunks: encode "
              f"{t_enc * 1e3:.1f} ms ({n / t_enc / 1e9:.3f} GB/s), decode {t_dec * 1e3:.1f} ms "
              f"({n / t_dec / 1e9:.3f} GB/s), capped drain {t_drain * 1e3:.1f} ms "
              f"({n / t_drain / 1e9:.3f} GB/s, {len(drain_times)} calls); "
              f"{stream_mb} MiB / (t_enc + t_dec) = {gbs:.4f} GB/s")
        print(f"phase 6 streaming run {rep} selfsync_decode launches per drain call: "
              f"{dict(sorted(collections.Counter(per_call).items()))}; launches: encode loop "
              f"{out['encode']}, feed loop {out['feed']}, drain loop {out['drain']}; "
              f"stitch outcomes: feed loop {ends['feed']}, drain loop {ends['drain']}")
        medians = {"encode_chunk": statistics.median(enc_times) * 1e3,
                   "fed decode_chunk": statistics.median(feed_times) * 1e3,
                   "capped drain": statistics.median(drain_times) * 1e3}
        print(f"phase 6 streaming run {rep} median ms per call, fused | classic (classic "
              f"{'after' if rep == 1 else 'before'} fused): "
              + ", ".join(f"{k} {v:.3f} | {classic_ms[rep][k]:.3f}" for k, v in medians.items()))
        if rep == 1:
            first_launches = total
    wall = {"fused": medians, "classic": classic_ms[2]}

    # where one call's time goes: device time by kernel and copy (profiler),
    # and host time by function (cProfile), beside the loop's median; the
    # fused call and the classic one in turns
    busy = {}
    drainers = {form: decoder(form == "classic") for form in ("fused", "classic")}
    for dec in drainers.values():
        dec.decode_chunk(encoded, capacity=cap)
    for label in ("encode_chunk", "fed decode_chunk", "capped drain"):
        for form in ("fused", "classic"):
            classic = form == "classic"
            if label == "encode_chunk":
                enc = tt.HuffmanEncoder(table, device=dev)
                step = enc._encode_chunk_classic if classic else enc.encode_chunk
                fn = lambda step=step: step(memoryview(data), cap)  # noqa: E731
            elif label == "fed decode_chunk":
                fn = lambda classic=classic: decoder(classic).decode_chunk(  # noqa: E731
                    encoded[:cap])
            else:
                fn = lambda dec=drainers[form]: dec.decode_chunk(b"", capacity=cap)  # noqa: E731
            by_kernel = _device_ms_by_kernel(torch, fn)
            busy.setdefault(label, {})[form] = sum(by_kernel.values())
            print(f"phase 6 streaming {label} ({form}), device ms per call by torch.profiler: "
                  f"{busy[label][form]:.4f} busy of {wall[form][label]:.3f} wall (run 2 median), "
                  f"{len(by_kernel)} kernels and copies")
            for key, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
                print(f"  {t:.4f} ms  {key[:100]}")
            print(f"phase 6 streaming {label} ({form}), host ms per call by cProfile (own "
                  f"time): " + ", ".join(f"{name} {ms:.3f}"
                                         for name, ms in _host_ms_by_function(fn)))
    return {"launches": first_launches, "encoded": encoded, "data": data, "checks": checks,
            "wall_ms": wall, "busy_ms": busy}


def _protocol(tt, table, data: bytes, device, chunk: int) -> dict:
    """Every result of the three streaming loops at `chunk`, with the
    encoder's carry and the decoder's leftover bits after each call."""
    enc = tt.HuffmanEncoder(table, device=device)
    pending = memoryview(data)
    rec = {"encode": [], "feed": [], "drain": []}
    while True:
        r = enc.encode_chunk(pending, chunk)
        rec["encode"].append((r.data, r.consumed, r.done, enc.overflow_bits))
        pending = pending[r.consumed:]
        if r.done:
            break
    encoded = b"".join(c[0] for c in rec["encode"])
    dec = tt.HuffmanDecoder(table, device=device)
    for i in range(0, len(encoded), chunk):
        r = dec.decode_chunk(encoded[i:i + chunk])
        rec["feed"].append((r.data, r.done, dec.leftover_bits))
    dec = tt.HuffmanDecoder(table, device=device)
    feed = encoded
    while True:
        r = dec.decode_chunk(feed, chunk)
        feed = b""
        rec["drain"].append((r.data, r.done, dec.leftover_bits, dec.state()))
        if r.done:
            return rec


def phase_protocol(torch, tt, table, counters, dev) -> None:
    """The card against the plain versions on the CPU, call by call, on a
    256 KiB stream at 4 KiB chunks with the decoder's threshold lowered so
    that the fused bulk drains run."""
    from tpu_huffman_torch import stream as tstream

    data = np.random.default_rng(12).integers(0, 256, size=256 * 1024, dtype=np.uint8).tobytes()
    saved = tstream.BULK_DECODE_THRESHOLD
    tstream.BULK_DECODE_THRESHOLD = 1024
    from tpu_huffman_torch.ops import selfsync

    try:
        _reset(*counters, selfsync.outcomes)
        card = _protocol(tt, table, data, dev, 4096)
        launched = {k: v for c in counters for k, v in c.items()}
        ends = dict(selfsync.outcomes)
        cpu = _protocol(tt, table, data, "cpu", 4096)
    finally:
        tstream.BULK_DECODE_THRESHOLD = saved
    for loop in ("encode", "feed", "drain"):
        if card[loop] != cpu[loop]:
            bad = next(i for i, (a, b) in enumerate(zip(card[loop], cpu[loop])) if a != b)
            raise AssertionError(f"protocol {loop}: call {bad} differs between card and CPU")
    if b"".join(c[0] for c in card["feed"]) != data or b"".join(
            c[0] for c in card["drain"]) != data:
        raise AssertionError("protocol check: decoded bytes differ from the input")
    # every bulk drain here is fused: the by-value walk takes only remainders
    # of <= 1024 bytes, which these chunks do not leave, and the fused drains
    # repair in place of the stitch's walk
    if not all(v for k, v in launched.items()
               if k not in ("stream_decode", "selfsync_decode_walk")):
        raise AssertionError(f"protocol check: a kernel did not run on the card: {launched}")
    print(f"phase 7 protocol, 256 KiB at 4 KiB chunks, words drains: {len(card['encode'])} "
          f"encode, {len(card['feed'])} feed and {len(card['drain'])} drain calls equal the "
          f"CPU's (bytes, consumed, done, overflow_bits, leftover_bits, state); card "
          f"launches {launched}; stitch outcomes on the card {ends}")
    c4 = phase_c4(tt, dev)
    print(f"phase 7 C4 (capped encode_chunk, unknown symbol at the cut), {c4['cases']} cases "
          f"on two tables with holes: {c4['calls']} calls through the fused path on {dev} "
          f"({c4['raises']} raises) equal the oracle's and the CPU's (bytes, consumed, done, "
          f"overflow_bits, raise index and symbol, state kept on a raise); encode_count "
          f"launched {c4['encode_count']} times on the card")


C4_SPEC = {65: 1, 66: 2, 67: 3, 68: 3}  # A B C D; Z (90) and every other byte have no code


def c4_cases(tt) -> list:
    """(name, table, setup calls, data, capacities): the calls where a
    capped encode_chunk once raised and the oracle did not, the unknown
    symbol at cut - 1, cut and cut + 1, after a code that straddles the cut
    and in a run at the cut, behind carries of 0 and 1 bits at capacities 0,
    1, 3 and 7, and a seeded build_table table with holes at capacities
    drawn from 0-7 over 400 symbols."""
    spec = tt.make_canonical(C4_SPEC)
    dcdc = [(b"DCDC", 1)]  # leaves the carry (1, 1)
    cases = [("AAAAAAAAZ", spec, [], b"AAAAAAAAZ", [1] * 4),
             ("AAAAAAAAAZ", spec, [], b"AAAAAAAAAZ", [1] * 4),
             ("ZA cap 0", spec, [], b"ZA", [0]),
             ("AAAAAAAZ", spec, [], b"AAAAAAAZ", [1] * 4),
             ("carry, cap 3", spec, dcdc, (b"ABCD" * 40 + b"Z" + b"A" * 10)[150:], [3] * 20),
             ("carry, ZA cap 0", spec, dcdc, b"ZA", [0])]
    for cap in (0, 1, 3, 7):
        for carry in (0, 1):
            before = 8 * cap - carry  # A (1 bit) symbols that end at the cut
            for where, head in (("cut-1", b"A" * (before - 1)), ("cut", b"A" * before),
                                ("cut+1", b"A" * (before + 1)),
                                ("straddle", b"A" * (before - 1) + b"D"),
                                ("run", b"A" * before + b"ZZZ")):
                cases.append((f"{where}, carry {carry}, cap {cap}", spec, dcdc if carry else [],
                              head + b"ZA" + b"BCD" * 3, [cap] * (1 if cap == 0 else 60)))
    rng = np.random.default_rng(16)
    corpus = rng.choice(np.arange(40, 104), size=4000).astype(np.uint8)
    built = tt.build_table(corpus.tobytes())
    data = rng.integers(36, 108, size=400, dtype=np.uint8).tobytes()
    cases.append(("build_table, caps 0-7", built, [], data,
                  np.random.default_rng(16).integers(0, 8, size=10_000).tolist()))
    return cases


def c4_stream(tt, enc, table, setup, data: bytes, caps) -> list:
    """Each call's (bytes, consumed, done, overflow_bits) through the
    capacity protocol, None for a raise; after a raise the encoder is reset
    and goes on past the unknown symbol. ``enc`` is the port's
    HuffmanEncoder or the oracle's (whose carry goes out with its error).
    A port's raise must name the first unknown symbol and keep the state."""
    for pending, cap in setup:
        enc.encode_chunk(pending, cap)
    out, pending = [], data
    for cap in caps:
        before = enc.state() if isinstance(enc, tt.HuffmanEncoder) else None
        try:
            r = enc.encode_chunk(pending, cap)
        except tt.UnknownSymbolError as exc:
            bad = int(np.flatnonzero(table.lengths[np.frombuffer(pending, np.uint8)] == 0)[0])
            if before is not None and ((exc.index, exc.symbol) != (bad, pending[bad])
                                       or enc.state() != before):
                raise AssertionError(f"C4: raise at {exc.index} ({exc.symbol}), first unknown "
                                     f"symbol {bad}, state {enc.state()} was {before}")
            out.append(None)
            enc.reset()
            pending = pending[bad + 1:]
            continue
        r = (r.data, r.consumed, r.done) if isinstance(r, tt.EncodeResult) else tuple(r)
        out.append(r + (enc.overflow_bits,))
        pending = pending[r[1]:]
        if r[2]:
            break
    return out


def phase_c4(tt, dev) -> dict:
    """C4 on the card: every case of :func:`c4_cases` through the fused
    encode_chunk on ``dev``, call by call against the oracle binding and
    the CPU's plain run. Fails on a difference, or if encode_count did not
    launch on the card for these calls."""
    from tpu_huffman_torch import oracle
    from tpu_huffman_torch.ops import pack_encode

    stats = {"cases": 0, "calls": 0, "raises": 0}
    runs = []
    for name, table, setup, data, caps in c4_cases(tt):
        otable = oracle.OracleTable(table)
        want = c4_stream(tt, oracle.OracleEncoder(otable), table, setup, data, caps)
        cpu = c4_stream(tt, tt.HuffmanEncoder(table, device="cpu"), table, setup, data, caps)
        runs.append((name, table, setup, data, caps, want, cpu))
    pack_encode.launches["encode_count"] = 0
    for name, table, setup, data, caps, want, cpu in runs:
        card = c4_stream(tt, tt.HuffmanEncoder(table, device=dev), table, setup, data, caps)
        if not card == cpu == want:
            bad = next(i for i, calls in enumerate(itertools.zip_longest(card, cpu, want))
                       if not calls[0] == calls[1] == calls[2])
            raise AssertionError(f"C4 case {name}: call {bad} differs: card {card[bad:][:1]}, "
                                 f"CPU {cpu[bad:][:1]}, oracle {want[bad:][:1]}")
        stats["cases"] += 1
        stats["calls"] += len(card)
        stats["raises"] += card.count(None)
    stats["encode_count"] = pack_encode.launches["encode_count"]
    if not stats["encode_count"]:
        raise AssertionError("C4: encode_count did not launch on the card")
    return stats


def phase_c2(torch, tt, table, counters, dev, limit_bits: int = 1 << 31) -> None:
    """One uncapped encode_chunk whose stream is just past 2^31 bits (the
    JAX package's fault C2 range, for limit_bits 2^31): no segmenting, one
    pack launch, bytes equal tt.encode's, and tt.decode gives the input
    back; then capped stream_decode walks from the first code start at or
    past limit_bits and from 4096 codes before it (across it, to the end),
    against both plain versions and the input."""
    from tpu_huffman_torch.ops import pack_encode
    from tpu_huffman_torch.ops.encode import DeviceTable

    # at least 5 bits a symbol, 9.48 on average: limit_bits / 8 symbols is enough
    data = np.random.default_rng(SEED + 2).integers(0, 256, size=limit_bits // 8,
                                                    dtype=np.uint8)
    dt = DeviceTable.for_table(table, dev)
    cum = torch.cumsum(dt.lengths[torch.from_numpy(data).to(dev).long()], 0, dtype=torch.int64)
    hi = limit_bits + 30
    k = int(torch.searchsorted(cum, torch.tensor([hi], device=dev), right=True))
    total = int(cum[k - 1])
    # stream_decode walks from the first code start at or past limit_bits
    # (symbol j + 1 starts where symbol j ends) and from 4096 codes before it
    j = int(torch.searchsorted(cum, torch.tensor([limit_bits], device=dev)))
    walks = [(int(cum[j]), j + 1, 1), (int(cum[j - 4097]), j - 4096, 8192)]
    del cum
    if not limit_bits - 1 < total <= hi:
        raise AssertionError(f"C2 input: {total} bits outside ({limit_bits} - 1, {hi}]")
    src = data[:k]
    _reset(*counters)
    t0 = time.perf_counter()
    r = tt.HuffmanEncoder(table, device=dev).encode_chunk(src)
    secs = time.perf_counter() - t0
    packs = pack_encode.launches["encode_pack"]
    if not r.done or r.consumed != k or packs != 1 or len(r.data) != -(-total // 8):
        raise AssertionError(f"C2 encode: done {r.done}, consumed {r.consumed} of {k}, "
                             f"{packs} pack launches, {len(r.data)} bytes")
    if r.data != tt.encode(src, table, device=dev):
        raise AssertionError("C2 encode differs from tt.encode")
    if tt.decode(r.data, table, device=dev) != src.tobytes():
        raise AssertionError("C2 stream does not decode to the input")
    from tpu_huffman_torch.ops import stream_decode
    from tpu_huffman_torch.ops.bitpack import stage_words

    words = stage_words(torch.frombuffer(bytearray(r.data), dtype=torch.uint8).to(dev))
    for walk_start, first, cap in walks:
        _e, info, _st, _t = stream_case(torch, stream_decode,
                                        f"phase 8's stream from bit {walk_start}, cap {cap}",
                                        words, walk_start, total, cap, dt, phase=8)
        n = info[0]
        syms = stream_decode.decode_stream(words, walk_start, total, cap, dt)[0][:n]
        if n != min(cap, k - first) or (
                syms.cpu().numpy().tobytes() != src[first:first + n].tobytes()):
            raise AssertionError(f"C2: the walk from bit {walk_start} differs from the input")
    del words
    print(f"phase 8 C2: encode_chunk of {k} symbols, {total} bits ({limit_bits} + "
          f"{total - limit_bits}), "
          f"one pack launch, {secs * 1e3:.1f} ms; equals tt.encode and decodes to the input")


def phase_hpack(torch, tt, table, counters, dev, n_strings: int = 1000) -> None:
    """The reference consumer's call pattern: each header string a fresh
    stream on the HPACK table, encoded with eos_padding 0xFF, decoded
    through decode_chunk in 7-byte pieces, its padding checked."""
    corpus = hpack_corpus(64 * n_strings)
    lens = np.random.default_rng(5).integers(4, 64, size=n_strings)
    offs = np.concatenate([[0], np.cumsum(lens)])
    strings = [corpus[a:b] for a, b in zip(offs[:-1], offs[1:])]
    _reset(*counters)
    times = []
    for s in strings:
        t0 = time.perf_counter()
        enc = tt.HuffmanEncoder(table, eos_padding=0xFF, device=dev).encode(s)
        dec = tt.HuffmanDecoder(table, device=dev)
        out = b"".join(dec.decode_chunk(enc[i:i + 7]).data for i in range(0, len(enc), 7))
        padded = dec.padding_is_all_ones()
        times.append(time.perf_counter() - t0)
        if out != s or not padded:
            raise AssertionError(f"HPACK string {s!r}: decoded {out!r}, padding ok {padded}")
        if enc != tt.encode(s, table, device="cpu"):
            raise AssertionError(f"HPACK string {s!r}: encoded bytes differ from the plain ones")
    launched = {k: v for c in counters for k, v in c.items() if v}
    print(f"phase 9 HPACK: {n_strings} header strings ({int(lens.sum())} bytes), each a fresh "
          f"stream, 7-byte decode pieces, padding all ones: median "
          f"{statistics.median(times) * 1e6:.1f} us per string (first 8 "
          f"{statistics.median(times[:8]) * 1e6:.1f}, last 8 {statistics.median(times[-8:]) * 1e6:.1f}); "
          f"launches {launched}")


def phase_store_design(torch, selfsync, chain_decode, chain_args, stitch_forms,
                       alone: dict) -> dict:
    """Each redesigned form (chain_decode; the stitch's full pass with starts
    and blast, and its patch, at the launches the stitch made) beside the
    same loop with one store a symbol (`byte`, the design it replaced) and
    with no row stores (`none`), through prof.decode_ablate, all timed by
    prof.kernel_ms in this run; the byte mode's row fills timed alone, and
    the full pass without starts. Returns {label: ms}."""
    import functools

    from tpu_huffman_torch.prof import decode_ablate, kernel_ms

    calls = {"chain_decode": functools.partial(chain_decode.decode_chains, *chain_args)}
    for m in ("byte", "none"):
        calls[f"chain_decode {m}"] = functools.partial(decode_ablate.chain_ablate, *chain_args, m)
    for form in ("full", "patch"):
        args, kw = stitch_forms[form]
        calls[form] = functools.partial(selfsync.decode_segments, *args, **kw)
        a_kw = {"starts": "starts" in kw, "blast": "blast" in kw,
                "max_codes": kw.get("max_codes", 0)}
        for m in ("byte", "none"):
            calls[f"{form} {m}"] = functools.partial(decode_ablate.segments_ablate, *args, m,
                                                     **a_kw)
        rows = kw["starts"].shape
        calls[f"{form} byte fill"] = functools.partial(
            lambda rows, dev: (torch.zeros(rows, dtype=torch.uint8, device=dev),
                               torch.full(rows, selfsync.NO_START, dtype=torch.int16,
                                          device=dev)), rows, args[0].device)
    args, kw = stitch_forms["full"]
    calls["full without starts"] = functools.partial(selfsync.decode_segments, *args,
                                                     blast=kw["blast"])
    t = kernel_ms(calls)
    for form in ("chain_decode", "full", "patch"):
        fill = t.get(f"{form} byte fill", 0.0)
        got = alone.get(form)
        print(f"phase 5 store design, {form}: sector (the kernel) {t[form]:.4f} ms (alone by "
              f"torch.profiler " + (f"{got:.4f}" if got is not None else "not measured")
              + f"), byte {t[f'{form} byte']:.4f} ms"
              + (f" ({t[f'{form} byte'] - fill:.4f} without its {fill:.4f} ms row fill)"
                 if fill else "")
              + f", none {t[f'{form} none']:.4f} ms (prof.kernel_ms, same run)")
    bare = t["full without starts"]
    print(f"phase 5 full pass with starts {t['full']:.4f} ms, without {bare:.4f} ms: "
          f"{t['full'] / bare:.3f}x")
    return t


def stream_case(torch, stream_decode, label, words, start_bit, total_bits, cap, dt,
                serial: bool = True, out=None, want_status=None, phase: int = 2,
                shape=None, branches=None) -> tuple:
    """stream_decode (the kernel, at `shape` = (window_words, sub_bits) or
    the wrapper's for this walk, with stats) against the blocked plain
    version at the same shape (symbols[:n], n, end_bit, status and stats)
    and, with `serial`, against decode_stream_plain (symbols[:n], n,
    end_bit, status), run on copies on the CPU, where its one small op a
    step is quicker. With `branches` ({overlap: int64[4]}), the probe's
    block walk at the same shape and each overlap, equal to the blocked
    plain version at that overlap, adds its re-walks by branch to the
    overlap's counters. Returns (the max abs err, (n, end_bit, status),
    stats, threads)."""
    from tpu_huffman_torch.ops.encode import DeviceTable
    from tpu_huffman_torch.prof import decode_ablate, max_abs_err

    walk = stream_decode.walk_bits(start_bit, total_bits, cap, dt)
    ww, sub = shape or stream_decode.card_shape(walk, dt)
    threads = stream_decode.geometry(ww, sub)
    st_k = torch.full((2,), JUNK, dtype=torch.int64, device=words.device)
    st_p = torch.zeros_like(st_k)
    if shape is None:
        got = stream_decode.decode_stream(words, start_bit, total_bits, cap, dt, out=out,
                                          stats=st_k)
    else:
        got = stream_decode._launch(words, start_bit, total_bits, cap, dt, ww, sub, out=out,
                                    stats=st_k)
    wants = [stream_decode.decode_stream_blocked_plain(
        words, start_bit, total_bits, cap, dt, window_words=ww, sub_bits=sub, stats=st_p)]
    if serial:
        cpu = torch.device("cpu")
        wants.append([x.to(words.device) for x in stream_decode.decode_stream_plain(
            words.cpu(), start_bit, total_bits, cap, DeviceTable.for_table(dt.table, cpu))])
    probes = []
    for overlap, counts in (branches or {}).items():
        args = (words, start_bit, total_bits, cap, dt)
        probes.append((decode_ablate.stream_ablate(*args, "block", threads, sub,
                                                   overlap=overlap, branches=counts),
                       decode_ablate.stream_ablate_plain(*args, "block", threads, sub,
                                                         overlap=overlap)))
    torch.cuda.synchronize()
    n = int(got[1][0])
    e = max_abs_err(st_k, st_p)
    for want in wants:
        e = max(e, max_abs_err(got[1], want[1]), max_abs_err(got[0][:n], want[0][:n]))
    for probe, want in probes:
        n_p = int(want[1][0])
        e = max(e, max_abs_err(probe[1], want[1]), max_abs_err(probe[0][:n_p], want[0][:n_p]))
    info = tuple(got[1].tolist())
    if e or (want_status is not None and info[2] != want_status):
        raise AssertionError(f"stream_decode {label}: max_abs_err {e}, info {info}, "
                             f"want status {want_status}")
    print(f"phase {phase} stream_decode {label}: max_abs_err {e} against the blocked plain version"
          + (" and the serial one" if serial else "") + f" ({info[0]} symbols, end bit "
          f"{info[1]}, status {info[2]}; {threads} threads x {sub} bits, windows and most "
          f"sync rounds "
          f"{tuple(st_k.tolist())})")
    return e, info, tuple(st_k.tolist()), threads


def walk_lookups(selfsync, words, steps, table, first: int, entry: int, last: int,
                 seg_bits: int) -> int:
    """The lookups of the walk kernel's loop (walk_segment) from segment
    ``first`` at ``entry`` to the end of segment ``last``, replayed on the
    host: a step table lookup each step, and a code table lookup too where
    the step is 0 or crosses the segment's end. ``words`` are the stream's
    uint32 words, ``steps`` the walk table (a list)."""
    k = selfsync.WALK_STEP_BITS
    pos, lookups = first * seg_bits + entry, 0
    for s in range(first, last + 1):
        end = (s + 1) * seg_bits
        while pos < end:
            w = pos >> 5
            pair = int(words[w]) << 32 | int(words[w + 1])
            win = (pair << (pos & 31) >> 32) & 0xFFFFFFFF
            step = steps[win >> (32 - k)]
            lookups += 1
            if step == 0 or pos + step > end:
                step = table.decode_window(win)[1]
                lookups += 1
                if step == 0:  # an invalid window: the walk stops there
                    return lookups
            pos += step
    return lookups


def phase_walk(torch, tt, dev, mb: int = 8, seed: int = WALK_SEED) -> dict:
    """The stitch's walk on the stream it is for: an mb MiB object of the
    benchmark's canterbury class (portbench.gen.canterbury_like and its
    fitted table, 0x00 the 2-bit code 00), encoded on the card, whose zero
    runs keep runs of segments out of phase. The walk kernel against its
    plain version on the same tensors (claims and kept walks equal); the
    stitch's body and tail start against the fixpoint's; the walk alone
    (torch.profiler) beside its bound, the lookups of the kept walk with
    the most (walk_lookups) at WALK_CYCLES_PER_LOOKUP cycles each, and its
    plain version; then tt.decode of the object in
    turns with the fixpoint path (the stitch left out): wall ms, device ms,
    launches, outcomes and host syncs a call."""
    from portbench import gen
    from tpu_huffman_torch.ops import selfsync
    from tpu_huffman_torch.ops.bitpack import stage_words
    from tpu_huffman_torch.ops.encode import DeviceTable
    from tpu_huffman_torch.prof import max_abs_err, median_ms

    table = tt.HuffmanTable.from_tsv_file(
        os.path.join(ROOT, "portbench", "configs", "canterbury.tsv"))
    data = gen.canterbury_like(mb * MIB, seed, 0).tobytes()
    enc = tt.encode(data, table, device=dev)
    words = stage_words(torch.frombuffer(bytearray(enc), dtype=torch.uint8).to(dev))
    dt = DeviceTable.for_table(table, dev)
    plan = selfsync._plan_segments(8 * len(enc), selfsync.SEG_WORDS)
    n_segs, seg_bits = plan
    max_syms = selfsync.max_symbols(table, seg_bits)
    m = selfsync._merge(words, 0, plan, dt)
    n_fail = int(m.fail.sum())
    seg_ids = torch.nonzero(m.fail)[:, 0].to(torch.int32)
    args = (words, seg_ids, m.entries1, m.exits0, seg_bits, dt)
    claim, ends = selfsync.walk_segments(*args)
    plain = selfsync.walk_segments_plain(*args)
    torch.cuda.synchronize()
    err = max(max_abs_err(claim, plain[0]), max_abs_err(ends, plain[1]))
    kept = [(s, e) for s, e in zip(seg_ids.tolist(), ends.tolist()) if e >= 0]
    walked = claim >= 0
    counts = selfsync.decode_segments(
        words, claim, seg_bits, max_syms, dt,
        seg_ids=torch.where(walked, torch.arange(n_segs, device=dev), -1).to(torch.int32))[1]
    per_seg = counts.tolist()
    symbols = max(sum(per_seg[s:e + 1]) for s, e in kept)
    host_words = np.frombuffer(enc + bytes(8 - len(enc) % 4), dtype=">u4")
    step_table = selfsync.walk_steps(dt).tolist()
    entry_of = claim.tolist()
    lookups = max(walk_lookups(selfsync, host_words, step_table, table, s, entry_of[s], e,
                               seg_bits) for s, e in kept)
    print(f"phase 2 selfsync walk, canterbury {mb} MiB (seed {seed}): max_abs_err {err} "
          f"(claims and kept walks; {n_segs} segments, {n_fail} unresolved, {len(kept)} runs "
          f"kept, {int(walked.sum())} segments walked, longest run "
          f"{max(e - s + 1 for s, e in kept)} segments, longest walk {symbols} symbols in "
          f"{lookups} lookups at most)")
    if err:
        raise AssertionError(f"the walk kernel differs from its plain version: {err}")
    stitched = selfsync.stitch(words, 0, plan, dt)
    syms_f, counts_f, exits_f, _bad, _entries, passes = selfsync._fixpoint(
        words, n_segs, seg_bits, 0, max_syms, dt)
    if stitched is None or not (
            torch.equal(stitched[0], selfsync._body(syms_f, counts_f))
            and stitched[1] == n_segs * seg_bits + int(exits_f[-1]) - seg_bits):
        raise AssertionError("the walked stitch differs from the fixpoint's chain")
    print(f"phase 2 stitch canterbury {mb} MiB: walked; body ({stitched[0].numel()} symbols) "
          f"and tail start equal the fixpoint's ({passes} passes)")

    # the walk alone, its bound, the plain version's time
    walk_fn = lambda: selfsync.walk_segments(*args)  # noqa: E731
    k1, k2 = median_ms(walk_fn), median_ms(walk_fn)
    alone = _profiled_kernel_ms(torch, {"selfsync_walk": walk_fn}).get("selfsync_walk")
    plain_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        selfsync.walk_segments_plain(*args)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
    bound_ms = lookups * WALK_CYCLES_PER_LOOKUP / SM_HZ * 1e3
    res = {"ms": min(k1, k2), "alone_ms": alone, "plain_ms": statistics.median(plain_s) * 1e3,
           "bound_ms": bound_ms, "bound_by": f"{lookups} dependent lookups", "lanes": n_fail,
           "runs": len(kept), "segments_walked": int(walked.sum()), "max_abs_err": err}
    print(f"phase 2 selfsync walk alone: kernel {k1:.4f} / {k2:.4f} ms (alone "
          + (f"{alone:.4f}" if alone is not None else "not measured")
          + f"), plain {res['plain_ms']:.1f} ms, bound {bound_ms:.4f} ms ({lookups} lookups x "
          f"{WALK_CYCLES_PER_LOOKUP} cycles at {SM_HZ / 1e6:.0f} MHz)")

    # tt.decode end to end, in turns with the fixpoint path
    def decode():
        return tt.decode(enc, table, device=dev)

    if decode() != data:
        raise AssertionError("decode of the canterbury stream differs")
    launches0, outcomes0 = dict(selfsync.launches), dict(selfsync.outcomes)
    walk_ms = _median_wall_ms(torch, decode)
    calls = REPS + 1
    res["per_call"] = {
        **{k: (v - launches0[k]) / calls for k, v in selfsync.launches.items()},
        **{k: (v - outcomes0[k]) / calls for k, v in selfsync.outcomes.items()}}
    res["host_syncs_per_decode"] = (len(sync_sites(torch, decode))
                                    - len(sync_sites(torch, lambda: None)))
    res["decode_device_ms"] = sum(_device_ms_by_kernel(torch, decode).values())
    real_stitch = selfsync.stitch
    selfsync.stitch = lambda *a, **kw: None
    try:
        fix_ms = _median_wall_ms(torch, decode)
        fix_busy = sum(_device_ms_by_kernel(torch, decode).values())
    finally:
        selfsync.stitch = real_stitch
    walk_ms2 = _median_wall_ms(torch, decode)
    res.update(decode_ms=min(walk_ms, walk_ms2), fixpoint_decode_ms=fix_ms,
               fixpoint_device_ms=fix_busy)
    print(f"phase 2 decode of the canterbury {mb} MiB stream, in turns: walk {walk_ms:.3f}, "
          f"fixpoint {fix_ms:.3f}, walk {walk_ms2:.3f} ms wall; device "
          f"{res['decode_device_ms']:.4f} / {fix_busy:.4f} ms; {res['host_syncs_per_decode']} "
          f"host syncs; a call: {res['per_call']}")
    if res["per_call"]["fixpoint"]:
        raise AssertionError("decode of the canterbury stream fell back to the fixpoint")
    return res


def phase_stream_checks(torch, tt, dev, data8: bytes, enc_static: bytes) -> int:
    """stream_decode against both plain versions on the walks of the main
    paths and on each stop rule: the 8 MiB stream's tail, 2, 16 and 64 KiB
    walks on the static and HPACK tables; caps at 0, 1, a slice boundary, a
    window boundary, n - 1, n and n + 1; a zero blob; a corrupt word in the
    third window; a 256 x 8-bit table (codes that never resynchronise) from
    a misaligned start; into an output filled with junk. Beside every case
    the probe's block walk, at the kernel's overlap and at 0, counts the
    re-walks by branch; each branch must run. Returns the max abs err (0)."""
    import functools

    from tpu_huffman_torch.ops import stream_decode
    from tpu_huffman_torch.ops.bitpack import stage_words
    from tpu_huffman_torch.ops.encode import DeviceTable
    from tpu_huffman_torch.prof import decode_ablate

    def on_card(b: bytes):
        return stage_words(torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev))

    # re-walks by branch from the probe's block walk beside every case, at the
    # kernel's overlap and at 0 (every slice enters at its first bit)
    branches = {ov: torch.zeros(len(decode_ablate.BRANCHES), dtype=torch.int64, device=dev)
                for ov in (stream_decode.OVERLAP_BITS, 0)}
    case = functools.partial(stream_case, branches=branches)
    err = 0
    shape = (2048, 128)  # for the caps and the corrupt word: 512 slices a window
    sub = shape[1]
    data_np = np.frombuffer(data8, np.uint8)
    for name, table, enc in (("static", tt.load_static_test_table(), enc_static),
                             ("hpack", tt.load_hpack_table(),
                              tt.encode(data8[:MIB], tt.load_hpack_table(), device=dev))):
        dt = DeviceTable.for_table(table, dev)
        words = on_card(enc)
        bits = 8 * len(enc)
        lens = table.lengths[data_np[: 1 << 20]].astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(lens)])  # code starts, from bit 0
        n_all = len(data8) if name == "static" else MIB
        tail = n_all - 191
        tail_bit = int(table.lengths[data_np[:tail]].astype(np.int64).sum())
        walks = {"tail": (tail_bit, bits, None)}
        for kib in (2, 16, 64):
            walks[f"{kib} KiB"] = (0, 8 * 1024 * kib, None)
        for label, (a, b, cap) in walks.items():
            err = max(err, case(torch, stream_decode, f"{name} {label}", words, a, b, cap,
                                       dt)[0])
        # caps on the 16 KiB walk at `shape`: the first symbol of slice 5 and
        # of window 1 are the counts of code starts before 5 * sub and W * 32
        total = 8 * 16 * 1024
        n16 = int(np.searchsorted(starts, total, side="right")) - 1  # codes ending by `total`
        caps = {"0": 0, "1": 1, "slice boundary": int(np.searchsorted(starts, 5 * sub)),
                "window boundary": int(np.searchsorted(starts, 32 * shape[0]))}
        _e, info, _st, _t = case(torch, stream_decode, f"{name} 16 KiB uncapped", words,
                                        0, total, None, dt, serial=False, shape=shape)
        n = info[0]
        caps.update({"n - 1": n - 1, "n": n, "n + 1": n + 1})
        for label, cap in caps.items():
            full = cap < n
            err = max(err, stream_case(
                torch, stream_decode, f"{name} 16 KiB cap {label} ({cap}), 512 x 128", words, 0,
                total, cap, dt, want_status=stream_decode.STATUS_OUTPUT_FULL if full else None,
                shape=shape)[0])
        if n != n16:
            raise AssertionError(f"{name} 16 KiB walk: {n} symbols, the plaintext has {n16}")
        # into an output filled with junk: [:n] is all written
        m = stream_decode.out_size(dt, 0, total, None)
        junk = torch.full((m + 16,), 0xAB, dtype=torch.uint8, device=dev)
        err = max(err, case(torch, stream_decode, f"{name} 16 KiB into junk", words, 0,
                                   total, None, dt, out=junk[3:])[0])
        if name == "static":
            # a corrupt word in the third window of a 64 KiB walk at `shape`
            bad = words.clone()
            bad[2 * shape[0] + 100] = 0
            err = max(err, stream_case(
                torch, stream_decode, f"{name} 64 KiB, word {2 * shape[0] + 100} zeroed (window "
                f"3 of 512 x 128)", bad, 0, 8 * 65536, None, dt,
                want_status=stream_decode.STATUS_UNKNOWN_SYMBOL, shape=shape)[0])
            err = max(err, case(torch, stream_decode, "static zero blob, 4 KiB",
                                       on_card(bytes(4096)), 0, 8 * 4096, None, dt,
                                       want_status=stream_decode.STATUS_UNKNOWN_SYMBOL)[0])
    flat = tt.make_canonical({i: 8 for i in range(256)}, name="flat8")
    fdt = DeviceTable.for_table(flat, dev)
    fwords = on_card(tt.encode(data8[:16384], flat, device=dev))
    e, _info, st, threads = case(torch, stream_decode, "256 x 8-bit table from bit 3",
                                        fwords, 3, 8 * 16384, None, fdt)
    if st[1] > threads:
        raise AssertionError(f"flat8: {st[1]} sync rounds, more than the {threads} slices")
    counts = {ov: dict(zip(decode_ablate.BRANCHES, c.tolist())) for ov, c in branches.items()}
    print(f"phase 2 stream_decode re-walks by branch over these cases (the probe's block walk, "
          f"each launch equal to the blocked plain version), by overlap: {counts}")
    for name in decode_ablate.BRANCHES:
        if not any(c[name] for c in counts.values()):
            raise AssertionError(f"stream_decode re-walk branch {name!r} never ran in phase 2")
    return max(err, e)


def phase_stream_dev(torch, tt, dev, data8: bytes, enc_static: bytes) -> dict:
    """The device-scalar stream_decode (decode_stream_dev, the fused
    drain's tail walk) at the fused drain's output size on the 8 MiB
    stream's 191-symbol tail: uncapped, with budgets 100 (a capped tail),
    0, n - 1 and n, and from a negative start (read as 0, over 4 KiB);
    each against its plain version (decode_stream_dev_plain) and the
    by-value form on the same scalars. Then the tail timed alone beside the
    by-value form in one call (prof.kernel_ms), the wrapper and the plain
    version by events. Returns the kernels line's row."""
    import functools

    from tpu_huffman_torch.ops import selfsync, stream_decode
    from tpu_huffman_torch.ops.bitpack import stage_words
    from tpu_huffman_torch.ops.encode import DeviceTable
    from tpu_huffman_torch.prof import kernel_ms, max_abs_err, median_ms

    table = tt.load_static_test_table()
    dt = DeviceTable.for_table(table, dev)
    words = stage_words(torch.frombuffer(bytearray(enc_static), dtype=torch.uint8).to(dev))
    bits = 8 * len(enc_static)
    data_np = np.frombuffer(data8, np.uint8)
    tail_bit = int(table.lengths[data_np[:-191]].astype(np.int64).sum())
    slots = 2 * selfsync.SEG_BITS // int(table.min_len) + 1  # the fused drain's
    cases = {"tail uncapped": (tail_bit, bits, slots), "tail budget 100": (tail_bit, bits, 100),
             "tail budget 0": (tail_bit, bits, 0), "tail budget 190": (tail_bit, bits, 190),
             "tail budget 191": (tail_bit, bits, 191),
             "start -7 (read as 0), 4 KiB": (-7, 8 * 4096, slots)}
    err = 0
    for label, (start, limit, budget) in cases.items():
        args = torch.tensor([start, limit, budget], dtype=torch.int64, device=dev)
        got = stream_decode.decode_stream_dev(words, args, slots, dt)
        plain = stream_decode.decode_stream_dev_plain(words, args, slots, dt)
        by_value = stream_decode.decode_stream(words, max(start, 0), limit,
                                               min(max(budget, 0), slots), dt)
        torch.cuda.synchronize()
        n = int(got[1][0])
        e = max(max_abs_err(got[1], want[1]) for want in (plain, by_value))
        e = max(e, *(max_abs_err(got[0][:n], want[0][:n]) for want in (plain, by_value)))
        err = max(err, e)
        print(f"phase 2 stream_decode_dev {label} ({slots} slots): max_abs_err {e} against its "
              f"plain version and the by-value form; (n, end bit, status) "
              f"{tuple(got[1].tolist())}")
    if err:
        raise AssertionError(f"stream_decode_dev differs: max_abs_err {err}")
    tail_args = torch.tensor([tail_bit, bits, slots], dtype=torch.int64, device=dev)
    dev_fn = functools.partial(stream_decode.decode_stream_dev, words, tail_args, slots, dt)
    value_fn = functools.partial(stream_decode.decode_stream, words, tail_bit, bits, None, dt)
    plain_fn = functools.partial(stream_decode.decode_stream_dev_plain, words, tail_args,
                                 slots, dt)
    alone = kernel_ms({"device scalars": dev_fn, "by value": value_fn,
                       "device scalars again": dev_fn})
    ms = median_ms(dev_fn)
    plain_ms = _once_ms(torch, plain_fn)[0]
    n, end, _status = dev_fn()[1].tolist()
    bound_ms, bound_by = _bound(4 * (end // 32 - tail_bit // 32 + 2) + n + 48
                                + 4 * dt.l0.numel(), OPS_PER_SYMBOL["stream_decode"] * n)
    threads = stream_decode.geometry(*stream_decode.card_shape(slots * int(table.max_len), dt))
    print(f"phase 5 stream_decode_dev, the 191-symbol tail ({threads} threads): alone "
          f"{alone['device scalars']:.4f} / {alone['device scalars again']:.4f} ms beside the "
          f"by-value form's {alone['by value']:.4f} ms (prof.kernel_ms, one call); wrapper "
          f"{ms:.4f} ms by events, plain {plain_ms:.2f} ms (one call), bound {bound_ms:.7f} ms "
          f"by {bound_by}")
    return {"name": "stream_decode_dev", "route": "cuda",
            "source": "tpu_huffman_torch/csrc/stream_decode.cu",
            "replaces": "tpu_huffman/ops/decode.py:107",
            "replaces_note": "decode_stream_kernel with its scalars traced; the JAX fused "
                             "drain walks this tail on the host (ops/selfsync.py:1610)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "kernel_only_ms": min(alone["device scalars"], alone["device scalars again"]),
            "by_value_kernel_only_ms": alone["by value"],
            "timed": f"the 8 MiB stream's 191-symbol tail, {slots} slots"}


def _once_ms(torch, fn) -> tuple:
    """(ms, result) of one fn() call timed by CUDA events: for plain
    versions too slow for median_ms's 56 calls."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    got = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), got


def phase_stream_timing(torch, dev) -> dict:
    """stream_decode alone (prof.kernel_ms) at each walk of
    decode_ablate.STREAM_WALKS on the 8 MiB static stream (7 and 64 bytes,
    the 191-symbol tail, 2, 16 and 64 KiB, a capped walk of 2^20 symbols),
    beside the probe's `serial` mode (the one-thread design it replaced),
    the blocked plain version (one call), its bound, and an empty block of
    the same threads (the floor of one launch). Returns {walk: row}."""
    import functools

    from tpu_huffman_torch.ops import stream_decode
    from tpu_huffman_torch.prof import decode_ablate, kernel_ms, max_abs_err

    rows = {}
    for walk, args in decode_ablate.stream_walks(dev).items():
        words, start, total, cap, dt = args
        ww, sub = stream_decode.card_shape(stream_decode.walk_bits(start, total, cap, dt), dt)
        threads = stream_decode.geometry(ww, sub)
        got = stream_decode.decode_stream(*args)
        n, end, status = got[1].tolist()
        plain = functools.partial(stream_decode.decode_stream_blocked_plain, *args,
                                  window_words=ww, sub_bits=sub)
        plain_ms, want = _once_ms(torch, plain)
        e = max(max_abs_err(got[1], want[1]), max_abs_err(got[0][:n], want[0][:n]))
        if e:
            raise AssertionError(f"stream_decode {walk}: differs from the blocked plain version")
        t = kernel_ms({"kernel": functools.partial(stream_decode.decode_stream, *args),
                       "serial": functools.partial(decode_ablate.stream_ablate, *args, "serial"),
                       "empty": functools.partial(decode_ablate.empty_block, dev, threads)})
        nbytes = 4 * (end // 32 - start // 32 + 2) + n + 24 + 4 * dt.l0.numel()
        bound_ms, bound_by = _bound(nbytes, OPS_PER_SYMBOL["stream_decode"] * n)
        rows[walk] = {"symbols": n, "bits": end - start, "status": status, "threads": threads,
                      "sub_bits": sub, "ms": t["kernel"],
                      "serial_ms": t["serial"], "empty_ms": t["empty"], "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": e}
        r = rows[walk]
        print(f"phase 5 stream_decode {walk} ({n} symbols, {end - start} bits, {threads} "
              f"threads x {sub} bits): kernel alone {r['ms']:.4f} ms, serial (the "
              f"one-thread design) {r['serial_ms']:.4f} ms ({r['serial_ms'] / r['ms']:.1f}x), "
              f"empty block "
              f"{r['empty_ms']:.4f} ms (prof.kernel_ms), bound {bound_ms:.7f} ms by {bound_by}, "
              f"blocked plain {r['plain_ms']:.2f} ms (one call)")
    return rows


def phase_stream_crossover(torch, tt, table, dev, sizes=(2, 16, 64, 256, 1024)) -> dict:
    """Where stream_decode's walk and the self-sync path cross: a one-shot
    decode of the same stream (KiB of plaintext from default_rng(SEED) on
    the static table) through decode(max_output) (the walk, any size) and
    through selfsync.selfsync_decode (the stitch plus the walk of the
    tail), each the median host wall of REPS calls and its device busy by
    torch.profiler. Returns {KiB: {path: (wall ms, busy ms)}}."""
    from tpu_huffman_torch.ops import selfsync

    data = np.random.default_rng(SEED).integers(0, 256, size=max(sizes) * 1024,
                                                dtype=np.uint8).tobytes()
    res = {}
    for kib in sizes:
        plain_bytes = data[:kib * 1024]
        enc = tt.encode(plain_bytes, table, device=dev)
        paths = {"walk": lambda: tt.decode(enc, table, max_output=len(plain_bytes), device=dev),
                 "self-sync": lambda: selfsync.selfsync_decode(enc, table, device=dev)}
        res[kib] = {}
        for name, fn in paths.items():
            if fn() != plain_bytes:
                raise AssertionError(f"crossover {kib} KiB: the {name} path differs from the input")
            res[kib][name] = (_median_wall_ms(torch, fn),
                              sum(_device_ms_by_kernel(torch, fn).values()))
        print(f"phase 5 one-shot decode of {kib} KiB ({len(enc)} stream bytes): "
              + ", ".join(f"{k} {w:.3f} ms wall, {b:.4f} ms device busy"
                          for k, (w, b) in res[kib].items()))
    return res


def phase_streaming_small(torch, tt, table, counters, dev, n: int = 4 * MIB,
                          chunk: int = 16 * 1024) -> dict:
    """An HTTP/2-sized streaming run: n bytes (seed 13) through a capped
    HuffmanEncoder loop at `chunk` bytes, then a HuffmanDecoder fed the
    stream in `chunk`-byte pieces, every drain through stream_decode
    (retained bytes stay under stream.BULK_DECODE_THRESHOLD); the median
    wall and device busy of a fed call, and n / (t_enc + t_dec)."""
    from tpu_huffman_torch.ops import selfsync, stream_decode

    data = np.random.default_rng(13).integers(0, 256, size=n, dtype=np.uint8).tobytes()

    def encode_loop():
        enc = tt.HuffmanEncoder(table, device=dev)
        view, parts = memoryview(data), []
        while True:
            r = enc.encode_chunk(view, chunk)
            parts.append(r.data)
            view = view[r.consumed:]
            if r.done:
                return b"".join(parts)

    def feed_loop(encoded):
        dec = tt.HuffmanDecoder(table, device=dev)
        out, times = [], []
        for i in range(0, len(encoded), chunk):
            t0 = time.perf_counter()
            out.append(dec.decode_chunk(encoded[i:i + chunk]).data)
            times.append(time.perf_counter() - t0)
        return b"".join(out), times

    feed_loop(encode_loop()[: 8 * chunk])  # warm-up
    _reset(*counters)
    t0 = time.perf_counter()
    encoded = encode_loop()
    t_enc = time.perf_counter() - t0
    _reset(*counters, selfsync.outcomes)
    t0 = time.perf_counter()
    out, times = feed_loop(encoded)
    t_dec = time.perf_counter() - t0
    launched = {k: v for c in counters for k, v in c.items() if v}
    if out != data:
        raise AssertionError("16 KiB streaming decode differs from the input")
    calls = len(times)
    if stream_decode.launches["stream_decode"] != calls or selfsync.launches["selfsync_decode"]:
        raise AssertionError(f"16 KiB streaming: {calls} fed calls, launches {launched}")
    piece = encoded[:chunk]
    busy = sum(_device_ms_by_kernel(torch, lambda: tt.HuffmanDecoder(
        table, device=dev).decode_chunk(piece)).values())
    res = {"calls": calls, "median_ms": statistics.median(times) * 1e3, "busy_ms": busy,
           "gbs": n / (t_enc + t_dec) / 1e9, "t_enc_ms": t_enc * 1e3, "t_dec_ms": t_dec * 1e3}
    print(f"phase 6 streaming at {chunk}-byte chunks, {n} bytes: {calls} fed decode_chunk calls, "
          f"each one stream_decode launch ({launched}); median {res['median_ms']:.3f} ms wall a "
          f"call, device busy {busy:.4f} ms a call (torch.profiler, one fresh decoder fed one "
          f"piece); encode {res['t_enc_ms']:.1f} ms, decode {res['t_dec_ms']:.1f} ms, "
          f"{n} / (t_enc + t_dec) = {res['gbs']:.4f} GB/s")
    return res


def phase_probes(torch, dev) -> list:
    """The probes' entry points (each module's run()) with the launch
    counters reset just before and read just after; the library
    yardsticks; a {"kernels": [...]} row per probe kernel."""
    import torch.nn.functional as F

    from tpu_huffman_torch import prof
    from tpu_huffman_torch.ops.bitpack import u32
    from tpu_huffman_torch.prof import decode_ablate, latency, lut, mma_lut, pack_ablate, sass

    counters = (lut.launches, mma_lut.launches, latency.launches, pack_ablate.launches,
                decode_ablate.launches)
    _reset(*counters)
    t0 = time.perf_counter()
    res = {"lut": lut.run(dev), "mma": mma_lut.run(dev), "latency": latency.run(dev),
           "pack": pack_ablate.run(dev), "decode": decode_ablate.run(dev)}
    secs = time.perf_counter() - t0
    launched = {k: v for c in counters for k, v in c.items()}
    print(f"phase 10 probes: every form bit-identical to its plain version at the scripts' "
          f"shapes and seeds, {secs:.1f} s; launches {launched}")
    if not all(launched.values()):
        raise AssertionError(f"a probe kernel never ran: {launched}")

    for case, forms in res["lut"]["chain"].items():
        print(f"phase 10 lut_chain {case}, {prof.FILL_ELEMENTS} elements x {lut.R_CHAIN} rounds: "
              + ", ".join(f"{f} {r['ms']:.4f} ms ({r['ns_per_lookup']:.5f} ns/lookup)"
                          for f, r in forms.items())
              + f"; smem again after the others {forms['smem']['again_ms']:.4f} ms; plain "
              f"{forms['smem']['plain_ms']:.4f} ms")
    stream = res["lut"]["stream"]
    print(f"phase 10 lut_chain P2 addr at 0 rounds {stream['addr_0_rounds_ms']:.4f} ms, a copy of "
          f"the same bytes (clone) {stream['copy_ms']:.4f} ms")
    wide = res["lut"]["wide"]
    print(f"phase 10 lut_wide P6, {prof.FILL_ELEMENTS} elements x {lut.R_WIDE} rounds: "
          + ", ".join(f"{f} {r['ms']:.4f} ms ({r['ns_per_lookup']:.5f} ns/lookup)"
                      for f, r in wide.items())
          + f"; smem again after the others {wide['smem']['again_ms']:.4f} ms; plain "
          f"{wide['smem']['plain_ms']:.4f} ms, word's plain {wide['word']['plain_ms']:.4f} ms")
    for form, by_w in res["lut"]["sweep"].items():
        print(f"phase 10 lut_chain P3 {form} ns per dependent lookup: "
              + ", ".join(f"{w} warps/SM {ns:.3f}" for w, ns in by_w.items()))
    for name, r in sass.loops().items():
        print(f"phase 10 sass {name}: {sass.text(r)}")
    for (kind, form), r in res["latency"]["configs"].items():
        print(f"phase 10 step_chain {kind} {form} ns per dependent step: "
              + ", ".join(f"{w} warps/SM {ns:.3f}" for w, ns in r["sweep"].items())
              + f"; {r['ms']:.4f} ms for {latency.INNER} steps on {res['latency']['n']} "
              f"elements, plain {r['plain_ms']:.3f} ms"
              + (f"; again after the others {r['again_ms']:.4f} ms" if "again_ms" in r else ""))
    mma = res["mma"]
    for mode, r in mma["wide"]["modes"].items():
        print(f"phase 10 lut_wide_mma {mode}, {mma['n']} elements x {lut.R_WIDE} rounds: "
              f"{r['ms']:.4f} ms ({r['ns_per_lookup']:.5f} ns/lookup); {r['registers']} "
              f"registers, {r['blocks_per_sm']} blocks of {r['block']} an SM "
              f"({r['threads_per_sm']} threads)"
              + (f"; again after the others {r['again_ms']:.4f} ms" if "again_ms" in r else ""))
    print(f"phase 10 lut_wide_mma: {mma_lut.NEW_MODE} {mma['wide']['ms']:.4f} ms, was "
          f"({mma_lut.OLD_MODE}) {mma['wide']['was_ms']:.4f} ms; plain "
          f"{mma['wide']['plain_ms']:.3f} ms ({mma_lut.OLD_MODE}'s "
          f"{mma['wide']['was_plain_ms']:.3f})")
    chain_mma = mma["chain"]
    for case, kinds in chain_mma["cases"].items():
        print(f"phase 10 lut_chain_mma {case}, {mma['n']} elements x {lut.R_CHAIN} rounds: "
              + ", ".join(f"{k} {r['ms']:.4f} ms ({r['ns_per_lookup']:.5f} ns/lookup; "
                          f"{r['registers']} registers, {r['threads_per_sm']} threads an SM)"
                          for k, r in kinds.items() if k != "sync again")
              + f"; sync again after the others {kinds['sync again']:.4f} ms")
    print(f"phase 10 lut_chain_mma: {mma_lut.NEW_FORM} {chain_mma['ms']:.4f} ms, was "
          f"({mma_lut.OLD_FORM}) {chain_mma['was_ms']:.4f} ms, again "
          f"{chain_mma['was_again_ms']:.4f}; plain {chain_mma['plain_ms']:.3f} ms "
          f"({mma_lut.OLD_FORM}'s {chain_mma['was_plain_ms']:.3f})")
    pk = res["pack"]
    print(f"phase 10 pack_ablate, {pk['n']} symbols, one thread a chunk (32 symbols but "
          f"'thread 4'), full one block a tile ({pk['n_tiles']} tiles): "
          + ", ".join(f"{m} {r['ms']:.4f} ms" for m, r in pk["modes"].items())
          + f"; encode_pack {pk['pack_ms']:.4f} ms (thread includes the "
          f"{pk['fill_ms']:.4f} ms fill of its output words; full and encode_pack fill "
          f"nothing); plain full {pk['modes']['full']['plain_ms']:.3f} ms")

    dec = res["decode"]
    for case, t in dec["cases"].items():
        print(f"phase 10 decode_ablate {case} ({dec['lanes'][case]} lanes, "
              f"{dec['symbols'][case]} symbols): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
              + (f"; byte includes the {dec['fill_ms'][case]:.4f} ms fill of its rows"
                 if case != "chain" else ""))
    st = dec["stream"]
    for walk, t in st["ms"].items():
        print(f"phase 10 decode_ablate stream {walk} ({st['symbols'][walk]} symbols, "
              f"shape {st['shape'][walk]} (threads x bits a slice), windows and most sync rounds "
              f"{st['stats'][walk]}, clock cycles in staging, speculation, sync rounds, scan + "
              f"write + copy {st['cycles'][walk]}, re-walks {st['branches'][walk]}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()))
    print("phase 10 decode_ablate empty block: " + ", ".join(
        f"{t} threads {ms:.4f} ms" for t, ms in st["empty_ms"].items()))

    # library yardsticks, timed here only: chained torch.take (P2's chain
    # at the fill shape), R torch.take of the packed wide entry, and the
    # one-hot torch.matmul (the counterpart of prof_mxu_lut.py's xla_onehot)
    xf, t2, _acc = res["lut"]["fill"]["P2"]
    x64, t64 = xf.to(torch.int64), t2.to(torch.int64)

    def take_chain():
        y = x64
        for _ in range(lut.R_CHAIN):
            y = torch.take(t64, y)
        return y

    if not torch.equal(take_chain().to(torch.int32), lut.lut_chain(xf, t2, lut.R_CHAIN)):
        raise AssertionError("chained torch.take differs from lut_chain")
    take_ms = prof.median_ms(take_chain)
    # P3's 32-bit table: the chain masks each value to 8 bits, so its
    # chained torch.take reads a masked copy of the 256 entries
    x3, t3, _acc3 = res["lut"]["fill"]["P3"]
    x3_64, t3_masked = x3.to(torch.int64), t3.to(torch.int64) & 255

    def take_chain3():
        y = x3_64
        for _ in range(lut.R_CHAIN):
            y = torch.take(t3_masked, y)
        return y

    if not torch.equal(take_chain3().to(torch.int32), lut.lut_chain(x3, t3, lut.R_CHAIN)):
        raise AssertionError("chained torch.take differs from lut_chain on P3's table")
    take3_ms = prof.median_ms(take_chain3)
    xw, p32, lens = res["lut"]["fill"]["P6"]
    xw64 = xw.to(torch.int64)
    packed = (u32(p32) << 8) | (lens.to(torch.int64) & 255)

    def take_wide():
        acc = torch.zeros_like(xw64)
        for r in range(lut.R_WIDE):
            acc ^= torch.take(packed, (xw64 + r) & 255)
        return acc

    take_wide_ms = prof.median_ms(take_wide)
    xm, p32m, lensm = mma["fill"]["P6"]
    tab = mma_lut.wide_table(p32m, lensm).to(torch.bfloat16)
    xm64 = xm.to(torch.int64)

    def onehot_matmul():
        for r in range(lut.R_WIDE):
            y = torch.matmul(F.one_hot((xm64 + r) & 255, 256).to(torch.bfloat16), tab)
        return y

    onehot_ms = prof.median_ms(onehot_matmul)
    # P1's k_onehot as the TPU script writes it: the 256-wide one-hot times
    # the (256, 1) table, + r, & 255, chained
    xc, tc, acc_c = mma["fill"]["P1"]
    xc64, tab_c = xc.to(torch.int64), tc.to(torch.bfloat16).reshape(256, 1)

    def onehot_chain():
        y = xc64
        for r in range(lut.R_CHAIN):
            y = (torch.matmul(F.one_hot(y, 256).to(torch.bfloat16), tab_c)[:, 0].to(torch.int64)
                 + r) & 255
        return y

    if not acc_c or not torch.equal(onehot_chain().to(torch.int32),
                                    lut.lut_chain(xc, tc, lut.R_CHAIN, True)):
        raise AssertionError("the chained one-hot torch.matmul differs from lut_chain")
    onehot_chain_ms = prof.median_ms(onehot_chain)
    print(f"phase 10 library: {lut.R_CHAIN} chained torch.take {take_ms:.4f} ms "
          f"({prof.FILL_ELEMENTS} elements; P2's table), {take3_ms:.4f} ms (P3's 32-bit "
          f"table, masked); {lut.R_WIDE} torch.take of the packed wide entry "
          f"{take_wide_ms:.4f} ms; {lut.R_WIDE} one-hot torch.matmul (bf16) {onehot_ms:.4f} ms "
          f"({mma['n']} elements); {lut.R_CHAIN} chained one-hot torch.matmul (bf16, P1) "
          f"{onehot_chain_ms:.4f} ms ({mma['n']} elements)")

    n = prof.FILL_ELEMENTS
    chain_row = res["lut"]["chain"]["P2"]["addr"]
    chain_was = res["lut"]["chain"]["P2"]["smem"]
    lat = res["latency"]["configs"]["gather", "lean"]
    lat_was = res["latency"]["configs"][latency.OLD]
    n_lat = res["latency"]["n"]
    n_sym = pk["n"]
    rows = [
        {"name": "lut_chain", "route": "cuda", "source": "tpu_huffman_torch/csrc/probe_lut.cu",
         "replaces": "scripts/prof/prof_kernel_lut.py:37",
         "also_replaces": "scripts/prof/prof_kernel_gather2d.py:24, "
                          "scripts/prof/prof_dynamic_gather.py:34, :92",
         "launches": launched["lut_chain"], "ms": chain_row["ms"],
         "was_ms": chain_was["ms"], "was": "smem form", "was_again_ms": chain_was["again_ms"],
         "plain_ms": chain_row["plain_ms"], "library_ms": take_ms,
         "library": f"{lut.R_CHAIN} chained torch.take",
         "p3_library_ms": take3_ms, "stream_ms": res["lut"]["stream"],
         "timed": f"P2's chain (byte table, addr form, blocks of {lut.ADDR_THREADS}) at {n} "
                  f"elements x {lut.R_CHAIN} rounds",
         "work": (8 * n + 256, n * lut.R_CHAIN, n * lut.R_CHAIN),
         "forms_ms": {c: {f: r["ms"] for f, r in fm.items()}
                      for c, fm in res["lut"]["chain"].items()},
         "ns_per_dependent_lookup": res["lut"]["sweep"]},
        {"name": "lut_wide", "route": "cuda", "source": "tpu_huffman_torch/csrc/probe_lut.cu",
         "replaces": "scripts/prof/prof_mxu_lut.py:101",
         "launches": launched["lut_wide"] + launched["lut_wide_word"],
         "word_launches": launched["lut_wide_word"], "ms": wide["word"]["ms"],
         "was_ms": wide["smem"]["ms"], "was": "smem form",
         "plain_ms": wide["word"]["plain_ms"], "library_ms": take_wide_ms,
         "library": f"{lut.R_WIDE} torch.take of the packed (pattern, length) entry",
         "timed": f"P6 (word form, one 32-bit marker-bit word a lookup) at {n} elements x "
                  f"{lut.R_WIDE} rounds",
         "work": (8 * n + 2048, n * lut.R_WIDE, n * lut.R_WIDE),
         "forms_ms": {f: r["ms"] for f, r in wide.items()}},
        {"name": "lut_wide_mma", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/probe_mma_lut.cu",
         "replaces": "scripts/prof/prof_mxu_lut.py:152",
         "launches": launched["lut_wide_mma"],
         "ms": mma["wide"]["ms"], "was_ms": mma["wide"]["was_ms"],
         "was": f"{mma_lut.OLD_MODE} mode", "plain_ms": mma["wide"]["plain_ms"],
         "library_ms": onehot_ms,
         "library": f"{lut.R_WIDE} x torch.matmul(F.one_hot(idx, 256).bfloat16(), table)",
         "timed": f"P6, mode {mma_lut.NEW_MODE}, at {mma['n']} elements x {lut.R_WIDE} rounds",
         "modes_ms": {m: r["ms"] for m, r in mma["wide"]["modes"].items()},
         "modes_shape": {m: {k: r[k] for k in ("registers", "block", "blocks_per_sm",
                                               "threads_per_sm")}
                         for m, r in mma["wide"]["modes"].items()}},
        {"name": "lut_chain_mma", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/probe_mma_lut.cu",
         "replaces": "scripts/prof/prof_kernel_lut.py:37 (k_onehot, :93)",
         "launches": launched["lut_chain_mma"] + launched["lut_chain_mma_nibble"],
         "nibble_launches": launched["lut_chain_mma_nibble"],
         "ms": chain_mma["ms"], "was_ms": chain_mma["was_ms"],
         "was_again_ms": chain_mma["was_again_ms"], "was": f"{mma_lut.OLD_FORM} form",
         "plain_ms": chain_mma["plain_ms"], "was_plain_ms": chain_mma["was_plain_ms"],
         "library_ms": onehot_chain_ms,
         "library": f"{lut.R_CHAIN} chained torch.matmul(F.one_hot(x, 256).bfloat16(), "
                    f"T as (256, 1) bf16) + r, & 255",
         "timed": f"P1 (accumulate), form {mma_lut.NEW_FORM}, at {mma['n']} elements x "
                  f"{lut.R_CHAIN} rounds",
         "forms_ms": {c: {k: (r if k == "sync again" else r["ms"]) for k, r in kinds.items()}
                      for c, kinds in chain_mma["cases"].items()},
         "forms_shape": {c: {k: {f: r[f] for f in ("registers", "block", "blocks_per_sm",
                                                   "threads_per_sm")}
                             for k, r in kinds.items() if k != "sync again"}
                         for c, kinds in chain_mma["cases"].items()}},
        {"name": "step_chain", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/probe_latency.cu",
         "replaces": "scripts/prof/prof_r3_gather_latency.py:31",
         "launches": launched["step_chain"], "ms": lat["ms"], "was_ms": lat_was["ms"],
         "was": "gather, smem form", "was_again_ms": lat_was["again_ms"],
         "plain_ms": lat["plain_ms"], "library_ms": None,
         "library": "none: no PyTorch call runs a chain of dependent steps",
         "timed": f"gather, lean, {latency.INNER} steps on {n_lat} elements (64 warps/SM)",
         "work": (8 * n_lat + 4096, n_lat * latency.INNER, n_lat * latency.INNER),
         "forms_ms": {f"{k} {f}": r["ms"] for (k, f), r in res["latency"]["configs"].items()},
         "ns_per_dependent_step": {f"{k} {f}": r["sweep"]
                                   for (k, f), r in res["latency"]["configs"].items()}},
        {"name": "pack_ablate", "route": "cuda", "source": "tpu_huffman_torch/csrc/probe_pack.cu",
         "replaces": "scripts/prof/prof_pack_ablate.py:187",
         "launches": launched["pack_ablate"], "ms": pk["modes"]["full"]["ms"],
         "plain_ms": pk["modes"]["full"]["plain_ms"], "library_ms": None,
         "library": "none: no PyTorch call packs variable-length codes",
         "timed": f"full mode, {n_sym} symbols",
         "work": (n_sym + 4 * pk["n_words"], OPS_PER_SYMBOL["encode_pack"] * n_sym),
         "modes_ms": {m: r["ms"] for m, r in pk["modes"].items()},
         "encode_pack_ms": pk["pack_ms"], "thread_output_fill_ms": pk["fill_ms"]},
        {"name": "decode_ablate", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/probe_decode.cu",
         "replaces": "scripts/prof/prof_decode_parts.py:48",
         "launches": launched["decode_ablate"],
         "ms": dec["cases"]["chain"][f"sector {decode_ablate.BLOCK}"],
         "plain_ms": dec["chain_plain_ms"], "library_ms": None,
         "library": "none: no PyTorch call decodes variable-length codes",
         "timed": f"chain case, sector mode (chain_decode's loop), {dec['symbols']['chain']} "
                  f"symbols at block {decode_ablate.BLOCK}",
         "work": (dec["chain_bytes"], OPS_PER_SYMBOL["chain_decode"] * dec["symbols"]["chain"]),
         "cases_ms": dec["cases"], "byte_fill_ms": dec["fill_ms"],
         "stream_ms": dec["stream"]["ms"], "stream_stats": dec["stream"]["stats"],
         "stream_cycles": dec["stream"]["cycles"],
         "empty_block_ms": dec["stream"]["empty_ms"]},
    ]
    # each run() held every launch it timed against its plain version
    errs = {k: v for r in res.values() for k, v in r["max_abs_err"].items()}
    for row in rows:
        row["max_abs_err"] = errs[row["name"]]
        if row["name"] == "lut_wide_mma":
            # tensor-core flops as executed: a one-hot row of 256 times 8 columns
            n_m = mma["n"]
            by_bytes = (8 * n_m + 4096) / HBM_BYTES_PER_S * 1e3
            by_ops = n_m * lut.R_WIDE * 2 * 256 * 8 / BF16_FLOPS_PER_S * 1e3
            row["bound_ms"], row["bound_by"] = (
                (by_bytes, "bytes") if by_bytes >= by_ops
                else (by_ops, "operations (tensor-core bf16 flops over 989e12)"))
        elif row["name"] == "lut_chain_mma":
            # the TPU product's work: a one-hot row of 256 times a (256, 1)
            # table, 512 flops a lookup; the sync form pads it to 8
            # columns, 4096 flops (padded_bound_ms); bytes: x and out once,
            # the nibble form's (16, 16) bf16 table
            n_m = mma["n"]
            by_bytes = (8 * n_m + 16 * 16 * 2) / HBM_BYTES_PER_S * 1e3
            by_ops = n_m * lut.R_CHAIN * 2 * 256 / BF16_FLOPS_PER_S * 1e3
            row["bound_ms"], row["bound_by"] = (
                (by_bytes, "bytes") if by_bytes >= by_ops
                else (by_ops, "operations (the TPU product's 512 bf16 flops a lookup over "
                              "989e12)"))
            row["padded_bound_ms"] = max(
                by_bytes, n_m * lut.R_CHAIN * 2 * 256 * 8 / BF16_FLOPS_PER_S * 1e3)
        else:
            row["bound_ms"], row["bound_by"] = _bound(*row.pop("work"))
        print(f"phase 10 {row['name']}: {row['ms']:.4f} ms"
              + (f" (was {row['was_ms']:.4f}, {row['was']})" if "was_ms" in row else "")
              + f", bound {row['bound_ms']:.6f} ms by {row['bound_by']}, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ({row['timed']})")
    return rows


# The mesh phase's two-process case: rank 0's share of each input.
MESH_PROC_SPLITS = ((20_000, 12_032), (16 * MIB, 10 * MIB + 12_345))
MESH_PROC_SHARDS = 2  # shards a process, all on the first card
MESH_PROC_TIMEOUT = 300  # seconds a worker may take


def _mesh_proc_inputs(n: int) -> bytes:
    return np.random.default_rng(SEED + 3 + n).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def mesh_worker(rank: str, store: str, out_path: str, device: str) -> int:
    """One process of the mesh phase's gloo group of two, which meets
    through the file ``store`` (run as ``chip_smoke.py --mesh-worker RANK
    STORE OUT DEVICE``): MESH_PROC_SHARDS
    shards on ``device``, encode_global and decode_global of its share of
    each MESH_PROC_SPLITS input, with the launch counters read around each
    call; every result goes to the .npz ``out_path`` for the parent."""
    import torch

    sys.path.insert(0, ROOT)
    import tpu_huffman_torch as tt
    from tpu_huffman_torch import distributed as dist
    from tpu_huffman_torch.ops import chain_decode, pack_encode

    rank = int(rank)
    dist.initialize(f"file://{store}", world_size=2, rank=rank, backend="gloo")
    dev = torch.device(device)
    mesh = dist.global_data_mesh(local_devices=[dev] * MESH_PROC_SHARDS)
    codec = tt.MeshCodec(tt.load_static_test_table(), mesh, block_symbols=256)
    out = {}
    for case, (n, split) in enumerate(MESH_PROC_SPLITS):
        full = _mesh_proc_inputs(n)
        mine = full[:split] if rank == 0 else full[split:]
        _reset(pack_encode.launches, chain_decode.launches)
        t0 = time.perf_counter()
        enc, idx = dist.encode_global(codec, mine)
        t1 = time.perf_counter()
        enc_launches = dict(pack_encode.launches)
        _reset(chain_decode.launches)
        dec = dist.decode_global(codec, enc, idx)
        t2 = time.perf_counter()
        out.update({
            f"{case}_encoded": np.frombuffer(enc, dtype=np.uint8),
            f"{case}_bit_offsets": idx.bit_offsets, f"{case}_n_symbols": idx.n_symbols,
            f"{case}_fields": np.array([idx.symbols_per_block, idx.total_symbols,
                                        idx.total_bits, idx.max_code_len]),
            f"{case}_decoded_ok": np.array(dec == full),
            f"{case}_launches": np.array([enc_launches["encode_count"],
                                          enc_launches["encode_pack"],
                                          chain_decode.launches["chain_decode"]]),
            f"{case}_seconds": np.array([t1 - t0, t2 - t1]),
        })
    np.savez(out_path, **out)
    # leave the group together: a gloo group torn down at exit after its
    # peer has gone aborts the process
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _mesh_processes(tt, table, dev) -> dict:
    """Two worker processes in a gloo group, MESH_PROC_SHARDS shards each on
    ``dev``: the bytes of encode_global equal tt.encode of the whole, both
    ranks return the same index and the plaintext, and each rank launches
    one count, pack and chain_decode a non-empty local shard."""
    import tempfile

    from tpu_huffman_torch.shard import _bucket_pow2

    with tempfile.TemporaryDirectory(prefix="mesh_proc_") as tmp:
        paths = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-worker", str(r),
                 os.path.join(tmp, "store"), paths[r], str(dev)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)
        ]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MESH_PROC_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"mesh worker {r} failed ({p.returncode}):\n{log}")
        res = []
        for path in paths:
            with np.load(path) as z:
                res.append(dict(z))
    report = {}
    for case, (n, split) in enumerate(MESH_PROC_SPLITS):
        full = _mesh_proc_inputs(n)
        want = tt.encode(full, table, device=dev)
        r0, r1 = res
        for key in ("encoded", "bit_offsets", "n_symbols", "fields"):
            if not np.array_equal(r0[f"{case}_{key}"], r1[f"{case}_{key}"]):
                raise AssertionError(f"two processes, {n} bytes: the ranks' {key} differ")
        if r0[f"{case}_encoded"].tobytes() != want:
            raise AssertionError(f"two processes, {n} bytes: encode_global != tt.encode of the whole")
        if not (r0[f"{case}_decoded_ok"] and r1[f"{case}_decoded_ok"]):
            raise AssertionError(f"two processes, {n} bytes: decode_global != the input")
        bs, total, bits, _max = (int(x) for x in r0[f"{case}_fields"])
        idx = tt.BlockIndex(bs, r0[f"{case}_bit_offsets"], r0[f"{case}_n_symbols"], total, bits)
        if tt.decode_indexed(want, idx, table, device=dev) != full:
            raise AssertionError(f"two processes, {n} bytes: the index does not decode the stream")
        per_dev = _bucket_pow2(max(256, -(-split // MESH_PROC_SHARDS),
                                   -(-(n - split) // MESH_PROC_SHARDS)), 256)
        launches = []
        for r, share in enumerate((split, n - split)):
            live = sum(1 for j in range(MESH_PROC_SHARDS) if j * per_dev < share)
            got = res[r][f"{case}_launches"].tolist()
            if got != [live] * 3:
                raise AssertionError(f"two processes, {n} bytes, rank {r}: launches "
                                     f"(count, pack, chain_decode) {got}, expected {live} each")
            launches.append(got)
        report[n] = {"split": [split, n - split], "launches_by_rank": launches,
                     "seconds_by_rank": [res[r][f"{case}_seconds"].tolist() for r in range(2)]}
    return report


def _mesh_kernel_checks(mc, data: bytes, encoded: bytes, index) -> dict:
    """Each kernel of the mesh path against its plain version at the
    shapes the 4-shard mesh gives it: every shard's count, its pack at its
    own phase (and at phase 31, the widest shift), its chain_decode stripe
    with relative offsets."""
    from tpu_huffman_torch.ops import chain_decode, pack_encode
    from tpu_huffman_torch.prof import max_abs_err
    from tpu_huffman_torch.shard import _bucket_pow2, _phase_base

    symbols = np.frombuffer(data, dtype=np.uint8)
    per_dev = _bucket_pow2(-(-symbols.size // mc.mesh.size), mc.block_symbols)
    shards = mc._count(symbols, per_dev)
    totals = mc._read_counts(shards)[:, 2]
    phases, _bases = _phase_base(totals)
    errs = {"encode_count": 0, "encode_pack": 0, "chain_decode": 0}
    last = max(j for j, s in enumerate(shards) if s is not None)
    for j, s in enumerate(shards):
        if s is None:
            continue
        dt = mc._dt(s.symbols.device)
        tb_p, st_p = pack_encode.count_plain(s.symbols, dt)
        errs["encode_count"] = max(errs["encode_count"], max_abs_err(s.tile_bits, tb_p),
                                   max_abs_err(s.stats, st_p))
        eos = mc.eos_padding if j == last else 0
        for phase in sorted({int(phases[j]), 31}):
            got = mc._pack(s, phase, int(totals[j]), eos, True)
            n_words = got[0].numel()
            want = pack_encode.pack_plain(s.symbols, dt, s.incl - s.tile_bits + phase,
                                          phase + int(totals[j]), eos, n_words,
                                          mc.block_symbols)
            errs["encode_pack"] = max(errs["encode_pack"], max_abs_err(got[0], want[0]),
                                      max_abs_err(got[1], want[1]))
    offs = np.asarray(index.bit_offsets, dtype=np.int64)
    counts = np.asarray(index.n_symbols, dtype=np.int64)
    raw = np.frombuffer(encoded, dtype=np.uint8)
    for g, dev in enumerate(mc._local):
        args = mc._decode_args(raw, offs, counts, g, dev)
        if args is None:
            continue
        got = chain_decode.decode_chains(*args)
        want = chain_decode.decode_chains_plain(*args)
        errs["chain_decode"] = max(errs["chain_decode"],
                                   *(max_abs_err(a, b) for a, b in zip(got, want)))
    if any(errs.values()):
        raise AssertionError(f"a mesh kernel differs from its plain version: {errs}")
    return errs


def _same_index(a, b) -> bool:
    return (a.symbols_per_block, a.total_symbols, a.total_bits, a.max_code_len) == (
        b.symbols_per_block, b.total_symbols, b.total_bits, b.max_code_len
    ) and np.array_equal(a.bit_offsets, b.bit_offsets) and np.array_equal(
        a.n_symbols, b.n_symbols)


CANTERBURY_MB = 8


def canterbury(n: int) -> bytes:
    """bench_suite.py's canterbury corpus: ``canterbury_like(n, seed=42)``
    (~25 s of Python at 8 MiB, so main() makes it in a process of its own
    while the earlier phases run)."""
    sys.path.insert(0, ROOT)
    from tpu_huffman_torch import corpora

    return corpora.canterbury_like(n, seed=42)


def phase_mesh(torch, tt, table, dev, smi: str, corpus: bytes, mb: int = 64) -> dict:
    """Phase 11: MeshCodec and the multi-process layer (see the module
    docstring), ``corpus`` the canterbury corpus. Returns the launches of
    each path and the timings."""
    from tpu_huffman_torch.ops import chain_decode, pack_encode
    from tpu_huffman_torch.shard import Mesh, _bucket_pow2

    t0 = time.perf_counter()
    counters = (pack_encode.launches, chain_decode.launches)
    card = dev.type == "cuda"
    meshes = {
        "default_mesh()": tt.default_mesh() if card else tt.default_mesh(devices=[dev]),
        "4 shards": Mesh([dev] * 4, ("data",)),
        "2 x 2 (dcn, ici)": Mesh(np.full((2, 2), dev, dtype=object), ("dcn", "ici")),
    }
    codecs = {name: tt.MeshCodec(table, mesh, block_symbols=256) for name, mesh in meshes.items()}

    def launched() -> list:
        return [pack_encode.launches["encode_count"], pack_encode.launches["encode_pack"],
                chain_decode.launches["chain_decode"]]

    def live_shards(mc, n: int) -> int:
        per_dev = _bucket_pow2(-(-n // mc.mesh.size), mc.block_symbols)
        return sum(1 for s in range(mc.mesh.size) if s * per_dev < n)

    # ---- the main path at full size: each mesh, counters reset around it
    data = np.random.default_rng(SEED).integers(0, 256, size=mb * MIB, dtype=np.uint8).tobytes()
    want, want_idx = tt.encode_with_index(data, table, device=dev)
    paths = {}
    for name, mc in codecs.items():
        _reset(*counters)
        enc, idx = mc.encode(data)
        dec = mc.decode(enc, idx)
        got = launched()
        live = live_shards(mc, len(data))
        if enc != want or not _same_index(idx, want_idx) or dec != data:
            raise AssertionError(f"mesh {name}, {mb} MiB: bytes, index or round trip differ "
                                 "from encode_with_index / decode_indexed")
        if got != [live] * 3:
            raise AssertionError(f"mesh {name}, {mb} MiB: launches (count, pack, chain_decode) "
                                 f"{got}, expected {live} each (one a non-empty shard)")
        paths[name] = dict(zip(("encode_count", "encode_pack", "chain_decode"), got))
        print(f"phase 11 mesh {name} (shards: {meshes[name].size} on {dev}), {mb} MiB: bytes and "
              f"index equal encode_with_index's, decode gives the input; launches (count, "
              f"pack, chain_decode) {got}")
    errs = _mesh_kernel_checks(codecs["4 shards"], data, want, want_idx)
    print(f"phase 11 mesh kernels at the 4-shard mesh's shapes ({mb / 4:g} MiB a shard, each "
          f"shard's phase and phase 31) against their plain versions: max_abs_err {errs} "
          f"({time.perf_counter() - t0:.1f} s into the phase)")

    # ---- ragged sizes, EOS padding, an unknown symbol, a corrupt stream
    seam = 4 * pack_encode.TILE * 2  # each of 4 shards exactly 2 tiles
    assert _bucket_pow2(seam // 4, 256) == 2 * pack_encode.TILE
    for n in (1, 7, 4095, seam, 12_345):
        small = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
        ref, ref_idx = tt.encode_with_index(small, table, device=dev)
        if ref != tt.encode(small, table, device="cpu"):
            raise AssertionError(f"{n} bytes: the card's encode differs from the plain version's")
        for name, mc in codecs.items():
            _reset(*counters)
            enc, idx = mc.encode(small)
            if enc != ref or not _same_index(idx, ref_idx) or mc.decode(enc, idx) != small:
                raise AssertionError(f"mesh {name}, {n} bytes: differs from encode_with_index")
            if launched() != [live_shards(mc, n)] * 3:
                raise AssertionError(f"mesh {name}, {n} bytes: launches {launched()}")
    four = codecs["4 shards"]
    for pad in (0x00, 0x5A, 0xFF):
        padded = tt.MeshCodec(table, meshes["4 shards"], block_symbols=256, eos_padding=pad)
        for small in (b"a", data[:3001]):
            if padded.encode(small)[0] != tt.encode(small, table, eos_padding=pad, device=dev):
                raise AssertionError(f"mesh eos_padding {pad:#x}: differs from tt.encode")
    ab = tt.make_canonical({65: 1, 66: 2})
    bad_input = b"AB" * 5000 + b"C" + b"AB" * 10
    caught = []
    for encode in (lambda: tt.encode(bad_input, ab, device=dev),
                   lambda: tt.MeshCodec(ab, meshes["4 shards"]).encode(bad_input)):
        try:
            encode()
        except tt.UnknownSymbolError as exc:
            caught.append((exc.index, exc.symbol))
    if caught != [(10000, 67)] * 2:
        raise AssertionError(f"unknown symbol: tt.encode and the mesh raised {caught}")
    small = data[:12_345]
    enc, idx = four.encode(small)
    corrupt = bytearray(enc)
    corrupt[len(enc) // 2: len(enc) // 2 + 64] = bytes(64)  # zeros match no static code
    for name, decode in (("mesh", lambda: four.decode(bytes(corrupt), idx)),
                         ("decode_indexed", lambda: tt.decode_indexed(bytes(corrupt), idx, table,
                                                                      device=dev))):
        try:
            decode()
        except tt.UnknownSymbolError:
            continue
        raise AssertionError(f"{name}: a corrupt stream did not raise")
    print("phase 11 mesh ragged sizes 1, 7, 4095, 4 x 2 tiles (every shard ends on a tile "
          "seam), 12345 on every mesh; eos_padding 0x00/0x5A/0xFF; unknown symbol at "
          "(10000, 67) as tt.encode; a corrupt stream raising: ok "
          f"({time.perf_counter() - t0:.1f} s into the phase)")

    # ---- canterbury with build_table (bench_suite.py's corpus and table)
    ctable = tt.build_table(corpus, max_len=14)
    enc_c, idx_c = tt.encode_with_index(corpus, ctable, device=dev)
    plain_c = tt.encode(corpus, ctable, device="cpu")
    mesh_c, mesh_idx = tt.MeshCodec(ctable, meshes["4 shards"]).encode(corpus)
    if not (enc_c == plain_c == mesh_c and _same_index(mesh_idx, idx_c)):
        raise AssertionError("canterbury: the card's bytes or index differ from the plain "
                             "version's or encode_with_index's")
    if tt.decode_indexed(enc_c, idx_c, ctable, device=dev) != corpus or tt.MeshCodec(
            ctable, meshes["4 shards"]).decode(mesh_c, mesh_idx) != corpus:
        raise AssertionError("canterbury: a decode differs from the corpus")
    print(f"phase 11 canterbury_like({len(corpus) / MIB:g} MiB, seed=42), build_table(max_len=14) "
          f"({ctable.min_len}..{ctable.max_len}-bit codes): {len(corpus)} -> {len(enc_c)} bytes; "
          "encode_with_index and the 4-shard mesh equal the plain version's bytes, the mesh's "
          "index encode_with_index's; both decodes give the corpus "
          f"({time.perf_counter() - t0:.1f} s into the phase)")

    # ---- two processes, gloo
    procs = _mesh_processes(tt, table, dev)
    for n, rep in procs.items():
        print(f"phase 11 two processes (gloo, {MESH_PROC_SHARDS} shards each on {dev}), {n} "
              f"bytes split {rep['split']}: encode_global equals tt.encode of the whole, both "
              f"ranks return the same index and the plaintext; launches (count, pack, "
              f"chain_decode) by rank {rep['launches_by_rank']}; seconds (encode, decode) by "
              f"rank {rep['seconds_by_rank']}")
    print("phase 11 NCCL is not verified: NCCL runs one rank a card and this run has one card "
          f"({time.perf_counter() - t0:.1f} s into the phase)")

    # ---- timings at full size: 1 and 4 shards beside the one-device calls
    timed = {
        "encode_with_index": lambda: tt.encode_with_index(data, table, device=dev),
        "decode_indexed": lambda: tt.decode_indexed(want, want_idx, table, device=dev),
        "MeshCodec.encode, 1 shard": lambda: codecs["default_mesh()"].encode(data),
        "MeshCodec.decode, 1 shard": lambda: codecs["default_mesh()"].decode(want, want_idx),
        "MeshCodec.encode, 4 shards": lambda: four.encode(data),
        "MeshCodec.decode, 4 shards": lambda: four.decode(want, want_idx),
    }
    timings = {}
    for name, fn in timed.items():
        wall = _median_wall_ms(torch, fn)
        by_kernel = _device_ms_by_kernel(torch, fn)
        busy = sum(by_kernel.values())
        timings[name] = {"wall_ms": wall, "device_busy_ms": busy}
        print(f"phase 11 {name} at {mb} MiB: {wall:.3f} ms wall (median of {REPS}), "
              f"{busy:.4f} ms device busy (torch.profiler), {mb * MIB / wall / 1e6:.3f} GB/s of "
              f"plaintext; {smi}")
        for key, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]:
            print(f"  {t:.4f} ms  {key[:100]}")
    print(f"phase 11 done in {time.perf_counter() - t0:.1f} s")
    return {"paths": paths, "processes": {str(n): r for n, r in procs.items()},
            "timings": timings, "max_abs_err": errs}


STEP_SIZES = (65536, 8 * MIB)  # the entry's step, and bench.py's 8 MiB
EXAMPLES = {"hpack_headers": "rejected", "mesh_pipeline": "capped streaming decode ok"}
EXAMPLE_TIMEOUT = 300  # seconds an example may take


def with_pad_len(data: np.ndarray, lengths: np.ndarray, pad_len: int) -> np.ndarray:
    """``data`` (uint8) with its last two symbols (its one symbol) picked so
    that the codes leave ``pad_len`` bits of EOS padding."""
    out = data.copy()
    tail = min(out.size, 2)
    head = int(lengths[out[:-tail]].astype(np.int64).sum())
    coded = [int(c) for c in np.flatnonzero(lengths)]
    picks = itertools.product(coded, repeat=tail)
    for pick in picks:
        if (head + sum(int(lengths[c]) for c in pick) + pad_len) % 8 == 0:
            out[-tail:] = pick
            return out
    raise AssertionError(f"no {tail} codes leave a pad of {pad_len} bits")


def phase_step(torch, tt, static, hpack, dev, smi: str, data8: bytes) -> dict:
    """Phase 12: best_encode_step, its device-total pack, the oracle, the
    entry twin and the examples (see the module docstring). Returns the
    step path's launches and the numbers for the kernels line."""
    from tpu_huffman_torch import oracle

    t0 = time.perf_counter()
    # the oracle is built here and must load: a failed g++ raises
    oracle._load()
    print(f"phase 12 oracle library {oracle._LIB_PATH} ready in "
          f"{time.perf_counter() - t0:.2f} s")
    tables = (static, hpack, tt.make_canonical(mixed_lengths_5_30(), name="mixed_5_30"))
    full = np.frombuffer(data8, dtype=np.uint8)
    launches, per_step, steps = step_paths(torch, tt, oracle, tables, dev, full)
    err = device_total_checks(torch, tables, dev, full)
    encode_fn, sym = steps[static.name, STEP_SIZES[-1]]
    other = torch.from_numpy(with_pad_len(full[::-1].copy(), static.lengths, 3)).to(dev)
    graph = sync_free_and_graph(torch, encode_fn, sym, other)
    finalize_checks(torch, tt, dev)
    entry_checks(oracle, static, dev)
    run_examples()
    timed = step_timings(torch, static, dev, smi, steps, graph)
    o_enc, o_dec = oracle_gbs(oracle, static, data8)
    print(f"phase 12 [{smi}] oracle on one host core at 8 MiB (static): encode "
          f"{o_enc:.4f} GB/s, decode {o_dec:.4f} GB/s (median of 5, host clock)")
    timed["device_total"].update(launches_per_step=max(per_step),
                                 launches=launches["encode_pack"], max_abs_err=err)
    timed["best_encode_step"].update(oracle_encode_gbs=o_enc, oracle_decode_gbs=o_dec)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, **timed}


def run_examples() -> None:
    """The two example twins on the card, one after the other: each must
    exit 0 and print its line."""
    for name, line in EXAMPLES.items():
        proc = subprocess.run(
            [sys.executable, "-m", f"tpu_huffman_torch.examples.{name}", "--device", "cuda"],
            cwd=ROOT, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=EXAMPLE_TIMEOUT)
        if proc.returncode != 0 or line not in proc.stdout:
            raise AssertionError(f"example {name} failed ({proc.returncode}):\n{proc.stdout}")
        print(f"phase 12 example {name} --device cuda ok: "
              + " | ".join(ln for ln in proc.stdout.splitlines() if ln.strip()))


def step_paths(torch, tt, oracle, tables, dev, full: np.ndarray) -> tuple:
    """best_encode_step on each table at each of STEP_SIZES, with the launch
    counters reset just before each step and read just after: bytes equal
    the oracle's, zeros past the pad, finalize_fn the same. Returns (the
    launches summed, each step's pack launches, {(table name, n):
    (encode_fn, symbols)})."""
    from tpu_huffman_torch.ops import pack_encode
    from tpu_huffman_torch.ops.bitpack import bytes_from_words_np
    from tpu_huffman_torch.ops.encode import best_encode_step

    launches, per_step, steps = {}, [], {}
    for table in tables:
        otable = oracle.OracleTable(table)
        for n in STEP_SIZES:
            data = full[:n]
            sym = torch.from_numpy(data.copy()).to(dev)
            encode_fn, finalize_fn = best_encode_step(table, n, device=dev)
            _reset(pack_encode.launches)
            words, total, padded = encode_fn(sym)
            _sync(torch, dev)
            ran = dict(pack_encode.launches)
            if ran != {"encode_count": 1, "encode_pack": 1}:
                raise AssertionError(f"step {table.name} n={n}: launches {ran}, not one "
                                     f"count and one pack")
            for k, v in ran.items():
                launches[k] = launches.get(k, 0) + v
            per_step.append(ran["encode_pack"])
            n_words = -(-n * int(table.max_len) // 32) + 1
            padded_bits = int(padded)
            want = oracle.OracleEncoder(otable).encode(data.tobytes())
            got = bytes_from_words_np(words.cpu().numpy(), padded_bits // 8)
            tail_zero = not bool(words[(padded_bits + 31) // 32:].any())
            if (words.shape != (n_words,) or got != want or not tail_zero
                    or int(total) != int(table.lengths[data].astype(np.int64).sum())):
                raise AssertionError(f"step {table.name} n={n}: bytes equal the oracle's "
                                     f"{got == want}, zeros past the pad {tail_zero}")
            fin = finalize_fn(sym)
            if not all(torch.equal(a, b) for a, b in zip(fin, (words, total, padded))):
                raise AssertionError(f"step {table.name} n={n}: finalize_fn differs")
            steps[table.name, n] = (encode_fn, sym)
            print(f"phase 12 best_encode_step {table.name} n={n}: bytes equal the port "
                  f"oracle's ({padded_bits // 8} bytes, {int(total)} bits, W={n_words}), "
                  f"zeros past the pad; launches {ran}")
    return launches, per_step, steps


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_total_checks(torch, tables, dev, full: np.ndarray) -> int:
    """The device-total pack against pack_plain (the total as a 0-d tensor)
    at every pad_len 0-7, each table and each of STEP_SIZES, into words
    filled with junk. Returns the max_abs_err (raises unless 0)."""
    from tpu_huffman_torch.ops import pack_encode
    from tpu_huffman_torch.ops.encode import DeviceTable
    from tpu_huffman_torch.prof import max_abs_err

    err, checks = 0, 0
    for table in tables:
        dt = DeviceTable.for_table(table, dev)
        for n in STEP_SIZES:
            n_words = -(-n * int(table.max_len) // 32) + 1
            for pad_len in range(8):
                sym = torch.from_numpy(with_pad_len(full[:n], table.lengths, pad_len)).to(dev)
                tile_bits, _stats = pack_encode.count(sym, dt)
                incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
                offs = incl - tile_bits
                junk = torch.full((n_words,), JUNK, dtype=torch.int32, device=dev)
                got = pack_encode.pack_device_total(sym, dt, offs, incl[-1], 0xFF, n_words,
                                                    256, out=junk)
                want_w, want_o = pack_encode.pack_plain(sym, dt, offs, incl[-1], 0xFF,
                                                        n_words, 256)
                want_p = incl[-1] + pack_encode.pad_code(incl[-1], 0xFF)[1]
                _sync(torch, dev)
                e = max(max_abs_err(got[0], want_w), max_abs_err(got[1], want_o),
                        max_abs_err(got[2], want_p))
                if int(got[2]) - int(incl[-1]) != pad_len:
                    raise AssertionError(f"pad_len {pad_len}: padded - total = "
                                         f"{int(got[2]) - int(incl[-1])}")
                err, checks = max(err, e), checks + 1
    if err:
        raise AssertionError(f"device-total pack differs from pack_plain: {err}")
    print(f"phase 12 device-total pack against pack_plain (total as a 0-d tensor): "
          f"max_abs_err {err} over {checks} launches ({len(tables)} tables x n {STEP_SIZES} x "
          f"pad_len 0-7, into junk-filled words)")
    return err


def capture(torch, fn, x) -> tuple:
    """fn(x) captured in a CUDA graph after two warm-up calls on a side
    stream. Returns (graph, the captured outputs); replays rewrite them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x)
    return graph, out


def sync_free_and_graph(torch, encode_fn, sym, other):
    """encode_fn makes no host sync and runs under set_sync_debug_mode
    ("error"); captured in a CUDA graph, its replays equal the eager step
    on the captured input and on ``other`` copied into it. Returns the
    graph."""
    eager = encode_fn(sym)
    torch.cuda.synchronize()
    # the sites that warn with nothing between the mode's switches are the
    # switches' own
    idle = sync_sites(torch, lambda: None)
    syncs = sync_sites(torch, lambda: encode_fn(sym))
    extra = list((collections.Counter(syncs) - collections.Counter(idle)).elements())
    if extra:
        raise AssertionError(f"encode_fn synchronised at {extra} (with nothing between the "
                             f"mode's switches: {idle})")
    torch.cuda.set_sync_debug_mode("error")
    try:
        encode_fn(sym)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"phase 12 encode_fn: 0 host syncs (set_sync_debug_mode 'warn': {len(syncs)} "
          f"warnings around the call, {len(idle)} around no call: {', '.join(idle)}), and it "
          f"runs under set_sync_debug_mode('error')")
    g_in = sym.clone()
    graph, g_out = capture(torch, encode_fn, g_in)
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(g_out, eager))
    g_in.copy_(other)
    graph.replay()
    want_other = encode_fn(other)
    torch.cuda.synchronize()
    same_other = all(torch.equal(a, b) for a, b in zip(g_out, want_other))
    if not (same and same_other):
        raise AssertionError(f"CUDA graph replay differs from the eager step: {same}, "
                             f"{same_other}")
    print("phase 12 encode_fn captured in a CUDA graph: replays equal the eager step on the "
          "captured input and on new bytes copied into it")
    return graph


def finalize_checks(torch, tt, dev) -> None:
    """finalize_fn raises UnknownSymbolError at the first unknown symbol of
    a partial table, at tt.encode's (index, symbol)."""
    from tpu_huffman_torch.ops.encode import best_encode_step

    ab = tt.make_canonical({65: 1, 66: 2})
    for n, at in ((STEP_SIZES[0], 40000), (STEP_SIZES[-1], 5 * STEP_SIZES[-1] // 8 + 3)):
        bad = bytearray(b"AB" * (n // 2))
        bad[at], bad[-1] = 67, 68
        _fn, finalize_fn = best_encode_step(ab, n, device=dev)
        got = want = None
        try:
            finalize_fn(torch.frombuffer(bad, dtype=torch.uint8).to(dev))
        except tt.UnknownSymbolError as exc:
            got = (exc.index, exc.symbol)
        try:
            tt.encode(bytes(bad), ab, device=dev)
        except tt.UnknownSymbolError as exc:
            want = (exc.index, exc.symbol)
        if not got == want == (at, 67):
            raise AssertionError(f"finalize_fn raised at {got}, encode at {want}")
        print(f"phase 12 finalize_fn n={n}: UnknownSymbolError{got}, as tt.encode")


def entry_checks(oracle, static, dev) -> None:
    """entry() once, its bytes against the oracle's; dryrun_multichip(8)."""
    from tpu_huffman_torch import entry
    from tpu_huffman_torch.ops.bitpack import bytes_from_words_np

    fn, (e_sym,) = entry.entry(dev)
    words, _total, padded = fn(e_sym)
    if bytes_from_words_np(words.cpu().numpy(), int(padded) // 8) != oracle.oracle_encode(
            e_sym.cpu().numpy().tobytes(), static):
        raise AssertionError("entry(): bytes differ from the oracle's")
    entry.dryrun_multichip(8, dev)
    print(f"phase 12 entry() ok ({e_sym.numel()} symbols on {e_sym.device}, "
          f"{int(padded) // 8} bytes equal the oracle's); dryrun_multichip(8) ok on "
          f"{sorted(set(map(str, entry.mesh_devices(8, dev))))}")


def oracle_gbs(oracle, table, data: bytes, reps: int = 5) -> tuple:
    """The oracle's encode and decode of ``data`` on one host core, GB/s of
    plaintext (median of ``reps``, host clock): the bench's baseline."""
    otable = oracle.OracleTable(table)
    o_enc, o_dec = oracle.OracleEncoder(otable), oracle.OracleDecoder(otable)
    stream = o_enc.encode(data)
    enc_s, dec_s = [], []
    for _ in range(reps):
        o_enc.reset()
        t1 = time.perf_counter()
        o_enc.encode(data)
        enc_s.append(time.perf_counter() - t1)
        o_dec.reset()
        t1 = time.perf_counter()
        back = o_dec.decode(stream)
        dec_s.append(time.perf_counter() - t1)
    if back != data:
        raise AssertionError("oracle decode differs from the input")
    return (len(data) / statistics.median(enc_s) / 1e9,
            len(data) / statistics.median(dec_s) / 1e9)


def step_timings(torch, static, dev, smi: str, steps: dict, graph) -> dict:
    """The step alone at 8 MiB (events; the card alone behind a sleep
    kernel; a graph replay) beside encode_with_index's device stages, and
    the device-total pack beside the by-value form, its plain version and
    its bound."""
    from tpu_huffman_torch.ops import pack_encode
    from tpu_huffman_torch.ops.encode import DeviceTable, _encode_device
    from tpu_huffman_torch.prof import kernel_ms, median_ms

    n = STEP_SIZES[-1]
    encode_fn, sym = steps[static.name, n]
    dt = DeviceTable.for_table(static, dev)
    n_words = -(-n * int(static.max_len) // 32) + 1
    tile_bits, _stats = pack_encode.count(sym, dt)
    incl = torch.cumsum(tile_bits, 0, dtype=torch.int64)
    offs = incl - tile_bits
    total = int(incl[-1])
    step_fn = lambda: encode_fn(sym)  # noqa: E731
    pack_fn = lambda: pack_encode.pack_device_total(  # noqa: E731
        sym, dt, offs, incl[-1], 0xFF, n_words, 256)
    by_value_fn = lambda: pack_encode.pack(  # noqa: E731
        sym, dt, offs, total, 0xFF, n_words, 256)
    plain_fn = lambda: pack_encode.pack_plain(  # noqa: E731
        sym, dt, offs, incl[-1], 0xFF, n_words, 256)
    stages_fn = lambda: _encode_device(sym, dt, 0xFF, 256)  # noqa: E731
    s1, d1, d2, s2 = (median_ms(f) for f in (step_fn, stages_fn, stages_fn, step_fn))
    card_ms = kernel_ms({"step": step_fn, "device-total pack": pack_fn,
                         "by-value pack": by_value_fn})
    p1, k1, k2, p2 = (median_ms(f) for f in (plain_fn, pack_fn, pack_fn, plain_fn))
    alone = _profiled_kernel_ms(torch, {"encode_pack": pack_fn}).get("encode_pack")
    # the symbols read once; the words, block offsets and padded length
    # written once; the total read once
    bound = _bound(n + 4 * n_words + 8 * -(-n // 256) + 16, OPS_PER_SYMBOL["encode_pack"] * n)
    graph_ms = median_ms(graph.replay)
    small_fn, small_sym = steps[static.name, STEP_SIZES[0]]
    small_ms = median_ms(lambda: small_fn(small_sym))
    small_graph_ms = median_ms(capture(torch, small_fn, small_sym)[0].replay)
    by_table = kernel_ms({name: (lambda fn=fn, x=x: fn(x))
                          for (name, size), (fn, x) in steps.items() if size == n})
    gbs = lambda ms: n / (ms * 1e-3) / 1e9  # noqa: E731
    print(f"phase 12 [{smi}] best_encode_step at 8 MiB (static): {s1:.4f} / {s2:.4f} ms by "
          f"events ({gbs(min(s1, s2)):.2f} GB/s), the card alone {card_ms['step']:.4f} ms; "
          f"a CUDA graph replay {graph_ms:.4f} ms; encode_with_index's device stages (count, "
          f"cumsum, host read, pack) {d1:.4f} / {d2:.4f} ms ({gbs(min(d1, d2)):.2f} GB/s); "
          f"at {STEP_SIZES[0]} symbols the step {small_ms:.4f} ms, a graph replay "
          f"{small_graph_ms:.4f} ms; the card alone at 8 MiB by table: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in by_table.items()))
    print(f"phase 12 [{smi}] device-total pack at 8 MiB: {k1:.4f} / {k2:.4f} ms by events, "
          "alone " + (f"{alone:.4f}" if alone is not None else "not measured")
          + f" ms (torch.profiler), the card alone {card_ms['device-total pack']:.4f} ms "
          f"beside the by-value pack's {card_ms['by-value pack']:.4f}; plain {p1:.4f} / "
          f"{p2:.4f} ms; bound {bound[0]:.6f} ms by {bound[1]}")
    return {
        "device_total": {
            "ms": min(k1, k2), "alone_ms": alone, "card_ms": card_ms["device-total pack"],
            "by_value_card_ms": card_ms["by-value pack"], "plain_ms": min(p1, p2),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None},
        "best_encode_step": {
            "ms": min(s1, s2), "card_ms": card_ms["step"], "graph_replay_ms": graph_ms,
            "device_stages_ms": min(d1, d2), f"ms_at_{STEP_SIZES[0]}": small_ms,
            f"graph_replay_ms_at_{STEP_SIZES[0]}": small_graph_ms,
            "card_ms_by_table": by_table},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import tpu_huffman_torch as tt
    from tpu_huffman_torch import _build, metrics, oracle
    from tpu_huffman_torch.ops import chain_decode, pack_encode, selfsync, stream_decode
    from tpu_huffman_torch.ops.bitpack import stage_words
    from tpu_huffman_torch.ops.encode import DeviceTable, _encode_device
    from tpu_huffman_torch.prof import max_abs_err, median_ms

    dev = torch.device("cuda")
    # phase 11's corpus, made meanwhile in a process of its own
    corpus_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    corpus_job = corpus_pool.submit(canterbury, CANTERBURY_MB * MIB)

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
    global SMEM_LOOKUPS_PER_S
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SMEM_LOOKUPS_PER_S = sms * 32 * sm_mhz * 1e6
    global SM_HZ
    SM_HZ = sm_mhz * 1e6
    print(f"{sms} SMs, top SM clock {sm_mhz:.0f} MHz: shared-memory lookups bound at "
          f"{SMEM_LOOKUPS_PER_S:.4g} a second (32 lanes x 4 B a cycle an SM)")
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
    # decode goes through the level-1 LUT in global memory; block_symbols
    # 100 and 1000 give lane spans that are not 16-byte aligned; count and
    # pack also run at block_symbols 1 (a block offset every symbol).
    for table, K in ((static, 256), (static, 512), (static, 100), (static, 1000),
                     (static, 1), (hpack, 256)):
        dt = DeviceTable.for_table(table, dev)
        e_count, e_pack, (offs, total, n_words, words, block_offs) = check_encode(
            torch, pack_encode, sym, dt, K)
        errs["encode_count"] = max(errs["encode_count"], e_count)
        errs["encode_pack"] = max(errs["encode_pack"], e_pack)
        if K == 1:
            print(f"phase 2 {table.name} K=1: count, pack (fresh and junk-filled output) "
                  f"bit-identical to plain ({total} bits, {block_offs.numel()} block offsets)")
            continue

        n = sym.numel()
        nb = block_offs.numel()
        nsyms = torch.full((nb,), K, dtype=torch.int32, device=dev)
        nsyms[-1] = n - (nb - 1) * K
        out_start = torch.arange(nb, dtype=torch.int64, device=dev) * K
        out, end, bad = chain_decode.decode_chains(words, block_offs, nsyms, out_start, n, dt)
        out_p, end_p, bad_p = chain_decode.decode_chains_plain(
            words, block_offs, nsyms, out_start, n, dt
        )
        torch.cuda.synchronize()
        e = max(max_abs_err(out, out_p), max_abs_err(end, end_p),
                max_abs_err(bad, bad_p))
        errs["chain_decode"] = max(errs["chain_decode"], e)
        if not torch.equal(out, sym) or int(bad) != 0:
            raise AssertionError(f"kernel decode at K={K} does not return the input")
        if int(end[-1]) != total:
            raise AssertionError(f"last chain ends at {int(end[-1])}, stream at {total}")
        print(f"phase 2 {table.name} K={K}: count, pack (fresh and junk-filled output), "
              f"decode bit-identical to plain ({total} bits, {nb} blocks, "
              f"{offs.numel()} tiles)")
        shapes[table.name, K] = (dt, offs, total, n_words, words,
                                 block_offs, nsyms, out_start)
    # the tile's edges, and a view off 16-byte alignment (the byte loads)
    tile = pack_encode.TILE
    for table in (static, hpack):
        dt = DeviceTable.for_table(table, dev)
        # as many symbols after two whole tiles as take fewer than 32 bits
        head = torch.cumsum(dt.lengths[sym[2 * tile:2 * tile + 31].long()], 0)
        edges = {"TILE - 1": sym[:tile - 1], "TILE": sym[:tile], "TILE + 1": sym[:tile + 1],
                 "a last tile of < 32 bits": sym[:2 * tile + int((head < 32).sum())],
                 "a view off 16-byte alignment": sym[3:3 * tile + 20]}
        for label, part in edges.items():
            e_count = e_pack = 0
            for K in (1, 100, 256):
                ec, ep, (_offs, total, *_rest) = check_encode(torch, pack_encode, part, dt, K)
                e_count, e_pack = max(e_count, ec), max(e_pack, ep)
            errs["encode_count"] = max(errs["encode_count"], e_count)
            errs["encode_pack"] = max(errs["encode_pack"], e_pack)
            print(f"phase 2 count, pack at {label} ({part.numel()} symbols, {table.name}, "
                  f"{total} bits): max_abs_err {e_count}, {e_pack} at block_symbols 1, 100, 256")

    # selfsync_decode on pass 0 (segment-aligned entries, so off the
    # codeword chain) and on the converged pass, for three foreign streams.
    def on_card(b: bytes):
        return stage_words(torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev))

    errs.update(selfsync_decode=0, stream_decode=0)
    enc_static = tt.encode(data8, static)
    foreign = {}
    stitch_errs, stitch_shapes = {}, {}
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
            # the plain form, and the form that also writes each symbol's
            # start bit (the TPU kernel's emit_offs form)
            got = selfsync.decode_segments(words, ent, seg_bits, max_syms, dt)
            starts_k = torch.full((n_segs, max_syms), JUNK, dtype=torch.int16, device=dev)
            got_s = selfsync.decode_segments(words, ent, seg_bits, max_syms, dt, starts=starts_k)
            starts_p = torch.full_like(starts_k, JUNK)
            want = selfsync.decode_segments_plain(words, ent, seg_bits, max_syms, dt, starts_p)
            torch.cuda.synchronize()
            defined(torch, selfsync, got, {})
            defined(torch, selfsync, (*got_s, starts_k), {"starts": starts_k})
            e = max(max_abs_err(a, b) for a, b in zip(got, want))
            e_s = max([max_abs_err(a, b) for a, b in zip(got_s, want)]
                      + [max_abs_err(starts_k, starts_p)])
            errs["selfsync_decode"] = max(errs["selfsync_decode"], e, e_s)
            print(f"phase 2 selfsync_decode {name}, {label}: max_abs_err {e}, with starts "
                  f"(rows whole: 0 / NO_START past each count) "
                  f"{e_s} ({n_segs} segments of {seg_bits} bits, {int(got[1].sum())} symbols, "
                  f"{int((got[3] != 0).sum())} segments with an invalid window)")
        # the stitch's three launch forms at the launches it makes here, and
        # its body and tail start against the fixpoint's
        calls, stitched = stitch_calls(torch, selfsync, words, n_segs, seg_bits, dt)
        for form, (args, kw) in calls.items():
            got = defined(torch, selfsync, stitch_form(selfsync, args, kw), kw)
            want = defined(torch, selfsync, stitch_form(selfsync, args, kw, plain=True), kw)
            torch.cuda.synchronize()
            e = max(max_abs_err(a, b) for a, b in zip(got, want))
            stitch_errs[form] = max(stitch_errs.get(form, 0), e)
            print(f"phase 2 selfsync_decode {name}, stitch {form}: max_abs_err {e} "
                  f"({args[1].numel()} lanes, {int(got[1].sum())} symbols"
                  + (f", {int((kw['seg_ids'] >= 0).sum())} live" if form == "repair" else "")
                  + ")")
        syms_f, counts_f, exits_f, bad_f = selfsync._fixpoint(words, n_segs, seg_bits, 0,
                                                               max_syms, dt)[:4]
        if stitched is None:
            if not bool((bad_f != 0).any()):
                raise AssertionError(f"{name}: the stitch left a clean stream unresolved")
            print(f"phase 2 stitch {name}: unresolved, as it must be: the fixpoint's chain "
                  f"meets invalid windows in {int((bad_f != 0).sum())} segments")
        else:
            body, tail_start, _total, _cut = stitched
            if not (torch.equal(body, selfsync._body(syms_f, counts_f)) and tail_start
                    == n_segs * seg_bits + int(exits_f[-1]) - seg_bits):
                raise AssertionError(f"{name}: the stitched body or tail start differs from "
                                     f"the fixpoint's")
            print(f"phase 2 stitch {name}: body ({body.numel()} symbols) and tail start "
                  f"{tail_start} equal the fixpoint's")
        stitch_shapes[name] = calls
        foreign[name] = (dt, words, n_segs, seg_bits, max_syms, entries, len(enc))

    walk_row = phase_walk(torch, tt, dev)
    errs["stream_decode"] = phase_stream_checks(torch, tt, dev, data8, enc_static)
    dev_row = phase_stream_dev(torch, tt, dev, data8, enc_static)
    errs["selfsync_decode"] = max(errs["selfsync_decode"], *stitch_errs.values(),
                                  walk_row["max_abs_err"])
    if any(errs.values()):
        raise AssertionError(f"kernels differ from their plain versions: {errs}, stitch forms "
                             f"{stitch_errs}")

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
    fell_back = selfsync.outcomes["fixpoint"]
    try:
        tt.decode(bytes(MIB), static)  # zeros match no code of the static table
    except tt.UnknownSymbolError:
        pass
    else:
        raise AssertionError("decode of zeros did not raise")
    if selfsync.outcomes["fixpoint"] != fell_back + 1:
        raise AssertionError("decode of zeros did not raise from the fixpoint fallback")
    data1 = data8[:MIB]
    enc1 = tt.encode(data1, static)
    for k in (0, 1, 4097, 65536):
        if tt.decode(enc1, static, max_output=k) != data1[:k]:
            raise AssertionError(f"decode with max_output={k}")
    # a table built at root_bits 16 (the device LUT is built at 12): random
    # bytes reach HPACK's 30-bit codes on every decode path
    hpack16 = tt.HuffmanTable.from_specs(hpack.specs(), name="hpack16", root_bits=16)
    enc16, idx16 = tt.encode_with_index(data1, hpack16)
    dec16 = tt.HuffmanDecoder(hpack16)
    fed16 = b"".join(dec16.decode_chunk(enc16[i:i + 256 * 1024]).data
                     for i in range(0, len(enc16), 256 * 1024))
    if enc16 != tt.encode(data1, hpack):
        raise AssertionError("root_bits 16: encoded bytes differ from the root_bits 12 table's")
    if not (tt.decode(enc16, hpack16) == tt.decode_indexed(enc16, idx16, hpack16) == fed16
            == data1):
        raise AssertionError("root_bits 16: a decode path differs from the input")
    print("phase 3: golden vectors, unknown-symbol index, decode of zeros raising through "
          "the fixpoint, max_output ok; HPACK at root_bits 16 (LUT built at "
          f"{DeviceTable.for_table(hpack16, dev).root_bits}), 1 MiB random bytes, max code "
          f"{idx16.max_code_len}: decode, decode_indexed and HuffmanDecoder give the input")

    # ---- 4. the two paths at full size ------------------------------------
    data64 = np.random.default_rng(SEED + 1).integers(
        0, 256, size=64 * MIB, dtype=np.uint8).tobytes()
    hdrs = hpack_corpus(8 * MIB)
    runs = [("static 8 MiB", static, data8), ("static 64 MiB", static, data64),
            ("hpack 8 MiB", hpack, hdrs)]

    # the indexed path: encode_with_index, then decode_indexed; every
    # download of both paths lands in a pinned block (ops.encode.to_host)
    copies0 = dict(metrics.copies)
    _reset(pack_encode.launches, chain_decode.launches)
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
    if set(pack_encode.launches.values()) != {len(runs)}:
        raise AssertionError(f"{len(runs)} encodes made {pack_encode.launches} launches, "
                             f"not one count and one pack each")

    # the foreign-stream path: decode of the same streams, with no index;
    # each must take the stitch (2 launches, 3 with a repair)
    _reset(selfsync.launches, stream_decode.launches, selfsync.outcomes)
    foreign_runs = []
    for name, table, data, enc, _idx, _dec, _secs in results:
        before, ends = dict(selfsync.launches), dict(selfsync.outcomes)
        t0 = time.perf_counter()
        out = tt.decode(enc, table)
        secs = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in selfsync.launches.items()}
        ends = {k: v - ends[k] for k, v in selfsync.outcomes.items()}
        walks = ends["repaired"] + ends["walked"]  # a walk and a re-decode each
        if (ends["fixpoint"] or ran["selfsync_decode"] != 2 + 2 * walks
                or ran["selfsync_decode_repair"] != walks or ran["selfsync_decode_walk"] != walks):
            raise AssertionError(f"{name}: decode did not take the stitch: launches {ran}, "
                                 f"outcomes {ends}")
        foreign_runs.append((name, out, secs, ran, ends))
    foreign_launches = {"selfsync_decode": selfsync.launches["selfsync_decode"],
                        "stream_decode": stream_decode.launches["stream_decode"]}
    print(f"phase 4 foreign-stream path launches: {dict(selfsync.launches)}, "
          f"{dict(stream_decode.launches)}; stitch outcomes {dict(selfsync.outcomes)}")
    if not all(foreign_launches.values()):
        raise AssertionError(f"a kernel of the foreign-stream path never ran: {foreign_launches}")
    launches.update(foreign_launches)
    d2h, pinned = (metrics.copies[k] - copies0[k] for k in ("d2h", "d2h_pinned"))
    print(f"phase 4 staging: {pinned} of {d2h} downloads of both paths into pinned blocks "
          f"(d2h_pinned / d2h {pinned / max(d2h, 1):.4f})")
    if not d2h or pinned != d2h:
        raise AssertionError(f"phase 4: {d2h - pinned} of {d2h} downloads not pinned")

    for (name, table, data, enc, idx, dec, secs), (_, out, f_secs, ran, ends) in zip(
            results, foreign_runs):
        if dec != data:
            raise AssertionError(f"{name}: round trip differs")
        if out != data:
            raise AssertionError(f"{name}: decode of the stream differs")
        if enc != oracle.oracle_encode(data, table):
            raise AssertionError(f"{name}: encoded bytes differ from the oracle's")
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
              f"decode ok through the stitch, selfsync_decode launches {ran}, "
              f"{ends['segments_repaired']} segments unresolved, {ends['segments_walked']} "
              f"walked, {f_secs * 1e3:.1f} ms first call")

    # ---- 5. timings at 8 MiB ---------------------------------------------
    dt, offs, total, n_words, words, block_offs, nsyms, out_start = shapes[static.name, 256]
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
            lambda: pack_encode.count(sym, dt),
            lambda: pack_encode.count_plain(sym, dt),
        ),
        "encode_pack": (
            lambda: pack_encode.pack(sym, dt, offs, total, 0xFF, n_words, 256),
            lambda: pack_encode.pack_plain(sym, dt, offs, total, 0xFF, n_words, 256),
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
    # (bytes moved, integer operations) of each timed call. The encode's
    # bytes are the design's floor: the symbols read once, the words and
    # the block offsets written once.
    work = {
        "encode_count": (n, OPS_PER_SYMBOL["encode_count"] * n),
        "encode_pack": (n + 4 * n_words + 8 * block_offs.numel(),
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
        p1 = median_ms(plain)
        k1 = median_ms(kernel)
        k2 = median_ms(kernel)
        p2 = median_ms(plain)
        ms[name] = (min(k1, k2), min(p1, p2))
        bound_ms, bound_by = _bound(*work[name])
        print(f"phase 5 {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} ({where[name]})")
    kernel_only = _profiled_kernel_ms(torch, {k: v[0] for k, v in timed.items()})
    for name in timed:
        got = kernel_only.get(name)
        print(f"phase 5 {name}: kernel alone (torch.profiler) "
              + (f"{got:.4f} ms" if got is not None else "not measured"))
    # the pack at block_symbols 100 (the same tiles: only the block offsets
    # differ), beside the pack at 256
    pack100 = (lambda: pack_encode.pack(sym, dt, offs, total, 0xFF, n_words, 100),
               lambda: pack_encode.pack_plain(sym, dt, offs, total, 0xFF, n_words, 100))
    p1, k1, k2, p2 = (median_ms(f) for f in (pack100[1], pack100[0], pack100[0], pack100[1]))
    alone100 = _profiled_kernel_ms(torch, {"encode_pack": pack100[0]}).get("encode_pack")
    alone256 = kernel_only.get("encode_pack")
    bound100 = _bound(n + 4 * n_words + 8 * -(-n // 100), OPS_PER_SYMBOL["encode_pack"] * n)
    pack_100 = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "alone_ms": alone100,
                "bound_ms": bound100[0], "bound_by": bound100[1],
                "alone_ratio_100_to_256": (alone100 / alone256 if alone100 and alone256
                                           else None)}
    print(f"phase 5 encode_pack at block_symbols 100: kernel {k1:.4f} / {k2:.4f} ms (alone "
          + (f"{alone100:.4f}" if alone100 is not None else "not measured")
          + f"; {pack_100['alone_ratio_100_to_256']} of the pack alone at 256), plain "
          f"{p1:.4f} / {p2:.4f} ms, bound {bound100[0]:.6f} ms by {bound100[1]}")
    # the stitch's forms at the launches it made on the static 8 MiB stream:
    # events (wrapper, fresh output buffers) beside the plain version,
    # profiler (kernel alone), bound from this run's lanes and symbols
    forms = {}
    for form, (args, kw) in stitch_shapes["static"].items():
        k_fn = lambda args=args, kw=kw: stitch_form(selfsync, args, kw)  # noqa: E731
        p_fn = lambda args=args, kw=kw: stitch_form(selfsync, args, kw, plain=True)  # noqa: E731
        p1, k1, k2, p2 = median_ms(p_fn), median_ms(k_fn), median_ms(k_fn), median_ms(p_fn)
        alone = _profiled_kernel_ms(torch, {"selfsync_decode": k_fn}).get("selfsync_decode")
        outs = k_fn()
        bound_ms, bound_by = _bound(*stitch_form_work(form, args, kw, outs, seg_bits,
                                                      selfsync.SEG_WORDS))
        forms[form] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "alone_ms": alone,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": stitch_errs[form], "lanes": args[1].numel(),
                       "symbols": int(outs[1].sum())}
        print(f"phase 5 selfsync_decode stitch {form}: kernel {k1:.4f} / {k2:.4f} ms (alone "
              + (f"{alone:.4f}" if alone is not None else "not measured")
              + f"), plain {p1:.4f} / {p2:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} "
              f"({forms[form]['lanes']} lanes, {forms[form]['symbols']} symbols)")
    forms["walk"] = walk_row
    stream_walks = phase_stream_timing(torch, dev)
    crossover = phase_stream_crossover(torch, tt, static, dev)
    forms["store_design_ms"] = phase_store_design(
        torch, selfsync, chain_decode, (words, block_offs, nsyms, out_start, n, dt),
        stitch_shapes["static"], {"chain_decode": kernel_only.get("chain_decode"),
                                  **{f: forms[f]["alone_ms"] for f in ("full", "patch")}})
    plan8 = (n_segs, seg_bits)
    by_kernel = _device_ms_by_kernel(torch, lambda: selfsync.stitch(f_words, 0, plan8, f_dt))
    in_kernel = sum(t for k, t in by_kernel.items() if "selfsync_decode_kernel" in k)
    stitch_ms = median_ms(lambda: selfsync.stitch(f_words, 0, plan8, f_dt))
    forms["stitch_torch_ops_device_ms"] = sum(by_kernel.values()) - in_kernel
    print(f"phase 5 stitch of the static 8 MiB stream: {stitch_ms:.4f} ms by events; device "
          f"{forms['stitch_torch_ops_device_ms']:.4f} ms in its torch ops and copies, "
          f"{in_kernel:.4f} ms in selfsync_decode (torch.profiler)")
    for key, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:16]:
        print(f"  {t:.4f} ms  {key[:100]}")
    sym_dev_ms = median_ms(lambda: _encode_device(sym, dt, 0xFF, 256))
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
    per_call = (selfsync.launches["selfsync_decode"] - before) / (REPS + 1)
    print(f"phase 5 end to end from host bytes at 8 MiB: decode {foreign_ms:.3f} ms "
          f"({gbs(foreign_ms):.3f} GB/s of plaintext), beside decode_indexed "
          f"{dec_ms:.3f} ms on the same stream; {per_call:g} selfsync_decode launches per call")
    # host syncs of one decode: each synchronizing CUDA call warns in this
    # mode; beside it, the same with nothing between the mode's switches,
    # and the decode with the stitch left out (the fixpoint path)
    real_stitch = selfsync.stitch
    selfsync.stitch = lambda *args, **kw: None
    try:
        fixpoint_syncs = sync_sites(torch, lambda: tt.decode(enc8, static))
        fixpoint_ms = _median_wall_ms(torch, lambda: tt.decode(enc8, static))
        fixpoint_busy = sum(_device_ms_by_kernel(torch, lambda: tt.decode(enc8, static)).values())
    finally:
        selfsync.stitch = real_stitch
    stitch_ms2 = _median_wall_ms(torch, lambda: tt.decode(enc8, static))
    print(f"phase 5 decode at 8 MiB with the stitch left out (the fixpoint path), in turns: "
          f"stitch {foreign_ms:.3f}, fixpoint {fixpoint_ms:.3f} ms (device busy "
          f"{fixpoint_busy:.4f}), stitch {stitch_ms2:.3f} ms wall")
    idle_syncs = sync_sites(torch, lambda: None)
    syncs = sync_sites(torch, lambda: tt.decode(enc8, static))
    forms["host_syncs_per_decode"] = len(syncs) - len(idle_syncs)
    print(f"phase 5 host syncs of one 8 MiB decode (torch.cuda.set_sync_debug_mode): "
          f"{len(syncs)} ({', '.join(syncs)}), of which {len(idle_syncs)} with no call between "
          f"the mode's switches ({', '.join(idle_syncs)}); with the stitch left out (the "
          f"fixpoint): {len(fixpoint_syncs)} ({', '.join(fixpoint_syncs)})")
    for label, fn, wall in (("round trip", round_trip, e2e_ms),
                            ("decode", lambda: tt.decode(enc8, static), foreign_ms)):
        by_kernel = _device_ms_by_kernel(torch, fn)
        print(f"phase 5 {label} at 8 MiB, device ms per call by torch.profiler: "
              f"{sum(by_kernel.values()):.4f} busy of {wall:.3f} wall")
        for key, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
            print(f"  {t:.4f} ms  {key[:100]}")

    # ---- 6-9. streaming, the protocol on the card, C2, HPACK ---------------
    counters = (pack_encode.launches, selfsync.launches, stream_decode.launches)
    streaming = phase_streaming(torch, tt, static, counters, dev)
    streaming_small = phase_streaming_small(torch, tt, static, counters, dev)

    # selfsync_decode with starts at the capped drain's shape: the prefix of
    # (capacity + 1) * max_len + 64 bits that one 1 MiB drain call decodes
    cap = MIB
    prefix_words = -(-((cap + 1) * static.max_len + 64) // 32)
    d_words = on_card(streaming["encoded"][: 4 * prefix_words])
    d_segs, d_seg_bits = selfsync._plan_segments(32 * prefix_words, selfsync.SEG_WORDS)
    d_max = selfsync.max_symbols(static, d_seg_bits)
    d_entries = selfsync._fixpoint(d_words, d_segs, d_seg_bits, 0, d_max, f_dt)[4]
    st_k = torch.zeros((d_segs, d_max), dtype=torch.int16, device=dev)
    st_p = torch.zeros_like(st_k)
    got = selfsync.decode_segments(d_words, d_entries, d_seg_bits, d_max, f_dt, starts=st_k)
    want = selfsync.decode_segments_plain(d_words, d_entries, d_seg_bits, d_max, f_dt, st_p)
    torch.cuda.synchronize()
    e = max([max_abs_err(a, b) for a, b in zip(got, want)]
            + [max_abs_err(st_k, st_p)])
    if e:
        raise AssertionError(f"selfsync_decode with starts differs from plain: {e}")
    d_body = int(got[1].sum())
    starts_timed = {
        "kernel": lambda: selfsync.decode_segments(d_words, d_entries, d_seg_bits, d_max, f_dt,
                                                   starts=st_k),
        "plain": lambda: selfsync.decode_segments_plain(d_words, d_entries, d_seg_bits, d_max,
                                                        f_dt, st_p),
        "without starts": lambda: selfsync.decode_segments(d_words, d_entries, d_seg_bits,
                                                           d_max, f_dt),
    }
    p1 = median_ms(starts_timed["plain"])
    k1 = median_ms(starts_timed["kernel"])
    n1 = median_ms(starts_timed["without starts"])
    k2 = median_ms(starts_timed["kernel"])
    p2 = median_ms(starts_timed["plain"])
    starts_alone = _profiled_kernel_ms(torch, {"selfsync_decode": starts_timed["kernel"]})
    starts_bound = _bound(4 * prefix_words + 4 * d_segs + 3 * d_body + 12 * d_segs
                          + 4 * f_dt.l0.numel(), OPS_PER_SYMBOL["selfsync_decode_starts"] * d_body)
    starts_ms = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                 "alone_ms": starts_alone.get("selfsync_decode"), "bound_ms": starts_bound[0],
                 "bound_by": starts_bound[1], "without_starts_ms": n1}
    print(f"phase 6 selfsync_decode with starts, one converged pass over one 1 MiB drain's "
          f"prefix ({d_segs} segments, {d_body} symbols): max_abs_err 0; kernel {k1:.4f} / "
          f"{k2:.4f} ms (alone {starts_ms['alone_ms']}), without starts {n1:.4f} ms, plain "
          f"{p1:.4f} / {p2:.4f} ms, bound {starts_bound[0]:.6f} ms by {starts_bound[1]}")

    phase_protocol(torch, tt, static, counters, dev)
    phase_c2(torch, tt, static, counters, dev)
    phase_hpack(torch, tt, hpack, counters, dev)
    probe_rows = phase_probes(torch, dev)
    corpus = corpus_job.result()
    corpus_pool.shutdown()
    mesh = phase_mesh(torch, tt, static, dev, smi, corpus)
    step = phase_step(torch, tt, static, hpack, dev, smi, data8)

    kernels = [
        {"name": "encode_count", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/pack_encode.cu",
         "replaces": "tpu_huffman/ops/pallas_encode.py:155"},
        {"name": "encode_pack", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/pack_encode.cu",
         "replaces": "tpu_huffman/ops/pallas_encode.py:155",
         "block_symbols_100": pack_100, "device_total": step["device_total"],
         "best_encode_step": step["best_encode_step"]},
        {"name": "chain_decode", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/chain_decode.cu",
         "replaces": "tpu_huffman/ops/pallas_decode.py:688",
         "also_replaces": "tpu_huffman/ops/pallas_decode.py:481"},
        {"name": "selfsync_decode", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/selfsync_decode.cu",
         "replaces": "tpu_huffman/ops/selfsync.py:51",
         "also_replaces": "tpu_huffman/ops/selfsync.py:51 (emit_offs=True: starts and "
                          "blast, the full pass at :900-906; the patch at :902; the repair "
                          "at :1060)",
         "starts": starts_ms, "stitch_forms": forms},
        {"name": "stream_decode", "route": "cuda",
         "source": "tpu_huffman_torch/csrc/stream_decode.cu",
         "replaces": "tpu_huffman/ops/decode.py:107", "walks": stream_walks,
         "walk_vs_selfsync_ms": crossover,
         "streaming_16k": streaming_small},
    ]
    errs["encode_pack"] = max(errs["encode_pack"], step["device_total"]["max_abs_err"])
    for k in kernels:
        if k["name"] in mesh["max_abs_err"]:
            errs[k["name"]] = max(errs[k["name"]], mesh["max_abs_err"][k["name"]])
            # every path that launches it, with that path's launches
            k["paths"] = {"encode_with_index / decode_indexed (phase 4)": launches[k["name"]],
                          **{f"MeshCodec, {name} (phase 11)": got[k["name"]]
                             for name, got in mesh["paths"].items()},
                          "encode_global / decode_global, 2 processes (phase 11)": {
                              n: rep["launches_by_rank"] for n, rep in mesh["processes"].items()}}
            if k["name"] in step["launches"]:
                k["paths"]["best_encode_step, 3 tables x 2 sizes (phase 12)"] = (
                    step["launches"][k["name"]])
            if streaming["launches"].get(k["name"]):
                k["paths"]["fused streaming calls, 64 MiB (phase 6)"] = (
                    streaming["launches"][k["name"]])
        bound_ms, bound_by = _bound(*work[k["name"]])
        # No single PyTorch call computes any of these functions.
        k.update(launches=launches[k["name"]], max_abs_err=errs[k["name"]],
                 ms=ms[k["name"]][0], plain_ms=ms[k["name"]][1],
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                 kernel_only_ms=kernel_only.get(k["name"]),
                 stream_launches=streaming["launches"].get(k["name"], 0))
    # the device-scalar walk runs on the fused streaming drains only (phase 6)
    dev_row.update(launches=streaming["launches"]["stream_decode_dev"],
                   stream_launches=streaming["launches"]["stream_decode_dev"])
    kernels.append(dev_row)
    kernels += probe_rows
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(*sys.argv[2:]))
    sys.exit(main())

"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` file for ``sm_90a`` (one process per
file, all at once) and links them into one shared library with a plain C
interface, in ``tpu_huffman_torch/_build/`` (listed in ``.gitignore``).
The library's name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a built one is reused. It is loaded with
``ctypes``; pointers and the stream go over as ``c_void_p`` and 64-bit
values as ``c_longlong``. Every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises when that
is not 0. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from . import metrics

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, into build_log
)
NVCC_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C entry point -> argument types (csrc/*.cu, extern "C"). Each takes the
# CUDA device index first and the stream last.
SIGNATURES = {
    # device, syms, n, lengths, tile_bits, stats, stream
    "thc_encode_count": (_I32, _P, _I64, _P, _P, _P, _P),
    # device, syms, n, patterns, lengths, tile_offs, total_bits,
    # eos_padding, words, n_words, block_symbols, block_offs (or null),
    # total_dev (or null), padded_out (or null), stream
    "thc_encode_pack": (
        _I32, _P, _I64, _P, _P, _P, _I64, _I32, _P, _I64, _I64, _P, _P, _P, _P,
    ),
    # device, words, n_words, bit_offs, n_syms, out_start, n_blocks, l0,
    # root_bits, l1, l1_size, max_len, out, end_bits, bad, stream
    "thc_chain_decode": (
        _I32, _P, _I64, _P, _P, _P, _I64, _P, _I32, _P, _I64, _I32, _P, _P, _P, _P,
    ),
    # device, words, n_words, entries, seg_ids (or null), n_lanes, seg_bits,
    # pitch, max_codes, l0, root_bits, l1, l1_size, max_len, syms, starts (or
    # null), counts, exits, bad, blast (or null), stream
    "thc_selfsync_decode": (
        _I32, _P, _I64, _P, _P, _I64, _I32, _I32, _I32, _P, _I32, _P, _I64, _I32, _P,
        _P, _P, _P, _P, _P, _P,
    ),
    # device, words, n_words, seg_ids, entries, n_lanes, exits0, n_segs,
    # seg_bits, l0, root_bits, l1, l1_size, max_len, steps, ends, pairs, cap,
    # counters, claim, stream
    "thc_selfsync_walk": (
        _I32, _P, _I64, _P, _P, _I32, _P, _I32, _I32, _P, _I32, _P, _I64, _I32, _P, _P, _P,
        _I64, _P, _P, _P,
    ),
    # device, words, n_words, start_bit, total_bits, out_capacity, l0,
    # root_bits, l1, l1_size, max_len, min_len, threads, sub_bits, overlap,
    # out, info, stats (or null), stream
    "thc_stream_decode": (
        _I32, _P, _I64, _I64, _I64, _I64, _P, _I32, _P, _I64, _I32, _I32, _I32, _I32, _I32,
        _P, _P, _P, _P,
    ),
    # device, words, n_words, args (int64 start_bit, total_bits, budget on
    # the device), out_slots, l0, root_bits, l1, l1_size, max_len, min_len,
    # threads, sub_bits, overlap, out, info, stream
    "thc_stream_decode_dev": (
        _I32, _P, _I64, _P, _I64, _P, _I32, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P, _P, _P,
    ),
    # The profiling probes (prof/), csrc/probe_*.cu.
    # device, x, n, table, table_bytes, rounds, accumulate, form, block,
    # grid, out, stream
    "thc_probe_lut_chain": (
        _I32, _P, _I64, _P, _I32, _I32, _I32, _I32, _I32, _I32, _P, _P,
    ),
    # device, x0, n, p32, lens, rounds, form, block, grid, out, stream
    "thc_probe_lut_wide": (_I32, _P, _I64, _P, _P, _I32, _I32, _I32, _I32, _P, _P),
    # device, x0, n, words, rounds, block, grid, out, stream
    "thc_probe_lut_word": (_I32, _P, _I64, _P, _I32, _I32, _I32, _P, _P),
    # device, x, n, tab, rounds, mode, block, grid (<= 0: fill the card
    # once), out, stream
    "thc_probe_mma_lut": (_I32, _P, _I64, _P, _I32, _I32, _I32, _I32, _P, _P),
    # device, mode, block -> blocks an SM holds
    "thc_probe_mma_occupancy": (_I32, _I32, _I32),
    # device, mode -> registers a thread
    "thc_probe_mma_registers": (_I32, _I32),
    # device, x, n, lut, steps, kind, form, block, grid, out, stream
    "thc_probe_step_chain": (_I32, _P, _I64, _P, _I32, _I32, _I32, _I32, _I32, _P, _P),
    # device, syms, n, chunk, patterns, lengths, chunk_offs (tile offsets
    # for mode full), total_bits, eos_padding, words, n_words, sums, mode,
    # stream
    "thc_probe_pack": (
        _I32, _P, _I64, _I32, _P, _P, _P, _I64, _I32, _P, _I64, _P, _I32, _P,
    ),
    # thc_chain_decode's arguments before the stream, then mode, block
    "thc_probe_chain_decode": (
        _I32, _P, _I64, _P, _P, _P, _I64, _P, _I32, _P, _I64, _I32, _P, _P, _P, _I32, _I32, _P,
    ),
    # thc_stream_decode's arguments before the stream, then cycles and
    # branches (each or null), mode
    "thc_probe_stream_decode": (
        _I32, _P, _I64, _I64, _I64, _I64, _P, _I32, _P, _I64, _I32, _I32, _I32, _I32, _I32,
        _P, _P, _P, _P, _P, _I32, _P,
    ),
    # thc_selfsync_decode's arguments before the stream, then mode, block
    "thc_probe_selfsync_decode": (
        _I32, _P, _I64, _P, _P, _I64, _I32, _I32, _I32, _P, _I32, _P, _I64, _I32, _P,
        _P, _P, _P, _P, _P, _I32, _I32, _P,
    ),
}

_lock = threading.Lock()
_lib = None
build_seconds = 0.0  # wall time of the build this process made (0 = reused)
build_log = ""  # nvcc's output for that build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    return found or "/usr/local/cuda/bin/nvcc"


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))) + sorted(
        glob.glob(os.path.join(_CSRC, "*.cuh"))
    )


def library_path() -> str:
    """Path of the shared library for the sources as they stand."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libthc_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise if any fails. Returns their output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    return "".join(outs)


def _build(out: str) -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cu]
    t0 = time.perf_counter()
    try:
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, p] for p, o in zip(cu, objs)])
        log += _run_all([[_nvcc(), *NVCC_LINK_FLAGS, "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, out)  # atomic: a process building at once sees all or nothing
    build_seconds = time.perf_counter() - t0
    build_log = log


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            with metrics.span("tt.setup.kernels"):
                path = library_path()
                if not os.path.exists(path):
                    metrics.setup["kernel_builds"] += 1
                    _build(path)
                metrics.setup["kernel_loads"] += 1
                lib = ctypes.CDLL(path)
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                lib.thc_error_string.argtypes = [ctypes.c_int]
                lib.thc_error_string.restype = ctypes.c_char_p
                _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = load().thc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")

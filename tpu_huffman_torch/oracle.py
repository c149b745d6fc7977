"""ctypes bindings to the C++ host codec (``cpp/``), the bit-exact oracle
(ports ``tpu_huffman/oracle.py`` without JAX).

The C++ library follows the reference's semantics exactly
(cpp/include/tpuhuff/tpuhuff.hpp). The port's tests and ``chip_smoke.py``
hold the kernels' bytes against it, and the bench times it on one CPU core
as the baseline.

The shared library is built on first use by ``g++`` from
``cpp/src/tpuhuff.cpp`` and ``cpp/src/capi.cpp``, read by path, into the
port's git-ignored ``tpu_huffman_torch/_build/`` (not ``cpp/build/``, so
that nothing under ``cpp/`` changes). It is rebuilt when a source is newer
than it. A failed build raises; :func:`oracle_available` is the only call
that turns that into False.

The classes take the port's :class:`HuffmanTable` and raise the port's
:class:`UnknownSymbolError`. A SHORT_BUFFER status comes back as
``done=False``, as in the JAX module.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from .errors import UnknownSymbolError
from .tables import HuffmanTable

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CPP_DIR = os.path.join(os.path.dirname(_PKG_DIR), "cpp")
_LIB_PATH = os.path.join(_PKG_DIR, "_build", "libtpuhuff.so")
_SOURCES = (
    os.path.join(_CPP_DIR, "src", "tpuhuff.cpp"),
    os.path.join(_CPP_DIR, "src", "capi.cpp"),
)
_HEADERS = (
    os.path.join(_CPP_DIR, "include", "tpuhuff", "tpuhuff.hpp"),
    os.path.join(_CPP_DIR, "include", "tpuhuff", "exports.hpp"),
)

_OK, _SHORT_BUFFER, _UNKNOWN_SYMBOL = 0, 1, 2

_build_lock = threading.Lock()
_lib = None


def _build_lib() -> str:
    """g++ into a file of this process's own, then an atomic rename: other
    processes that build at once see all of a library or none."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-std=c++17", "-O2", "-fPIC", "-shared",
        "-I", os.path.join(_CPP_DIR, "include"), *_SOURCES, "-o", tmp,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) or any(
            os.path.getmtime(s) > os.path.getmtime(_LIB_PATH) for s in _SOURCES + _HEADERS
        ):
            _build_lib()
        lib = ctypes.CDLL(_LIB_PATH)

        lib.th_table_create.restype = ctypes.c_void_p
        lib.th_table_create.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ]
        lib.th_table_destroy.restype = None
        lib.th_table_destroy.argtypes = [ctypes.c_void_p]
        lib.th_encoder_create.restype = ctypes.c_void_p
        lib.th_encoder_create.argtypes = [ctypes.c_void_p, ctypes.c_uint8]
        lib.th_encoder_destroy.restype = None
        lib.th_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib.th_encoder_reset.restype = None
        lib.th_encoder_reset.argtypes = [ctypes.c_void_p]
        lib.th_encoder_carry_pattern.restype = ctypes.c_uint32
        lib.th_encoder_carry_pattern.argtypes = [ctypes.c_void_p]
        lib.th_encoder_carry_len.restype = ctypes.c_uint8
        lib.th_encoder_carry_len.argtypes = [ctypes.c_void_p]
        lib.th_encoded_length.restype = ctypes.c_uint64
        lib.th_encoded_length.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.th_encode.restype = ctypes.c_int
        lib.th_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, u64p,
            ctypes.c_char_p, ctypes.c_uint64, u64p,
        ]
        lib.th_decoder_create.restype = ctypes.c_void_p
        lib.th_decoder_create.argtypes = [ctypes.c_void_p]
        lib.th_decoder_destroy.restype = None
        lib.th_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.th_decoder_reset.restype = None
        lib.th_decoder_reset.argtypes = [ctypes.c_void_p]
        lib.th_decoder_working_bits.restype = ctypes.c_uint64
        lib.th_decoder_working_bits.argtypes = [ctypes.c_void_p]
        lib.th_decoder_num_bits.restype = ctypes.c_uint8
        lib.th_decoder_num_bits.argtypes = [ctypes.c_void_p]
        lib.th_decode.restype = ctypes.c_int
        lib.th_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, u64p,
            ctypes.c_char_p, ctypes.c_uint64, u64p,
        ]
        _lib = lib
        return lib


class OracleTable:
    """C++-side compiled table built from a HuffmanTable's specs."""

    def __init__(self, table: HuffmanTable, root_bits: int | None = None):
        lib = _load()
        specs = table.specs()
        n = len(specs)
        syms = (ctypes.c_uint16 * n)(*[s.symbol for s in specs])
        lens = (ctypes.c_uint8 * n)(*[s.num_bits for s in specs])
        pats = (ctypes.c_uint32 * n)(*[s.pattern for s in specs])
        self._lib = lib
        self._ptr = lib.th_table_create(
            syms, lens, pats, n, root_bits if root_bits is not None else table.root_bits
        )
        if not self._ptr:
            raise ValueError("C++ table rejected the specs")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.th_table_destroy(self._ptr)
            self._ptr = None


class OracleEncoder:
    """Streaming encoder over the C++ oracle (the reference's API)."""

    def __init__(self, otable: OracleTable, eos_padding: int = 0xFF):
        self._lib = _load()
        self._table = otable  # keeps the C++ table alive
        self._ptr = self._lib.th_encoder_create(otable._ptr, eos_padding)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.th_encoder_destroy(self._ptr)
            self._ptr = None

    def reset(self) -> None:
        self._lib.th_encoder_reset(self._ptr)

    @property
    def overflow_bits(self) -> tuple[int, int]:
        return (
            int(self._lib.th_encoder_carry_pattern(self._ptr)),
            int(self._lib.th_encoder_carry_len(self._ptr)),
        )

    def encoded_length(self, data: bytes) -> int:
        return int(self._lib.th_encoded_length(self._ptr, bytes(data), len(data)))

    def encode_chunk(self, data: bytes, capacity: int) -> tuple[bytes, int, bool]:
        """Returns (out_bytes, consumed, done)."""
        out = ctypes.create_string_buffer(capacity)
        consumed = ctypes.c_uint64()
        written = ctypes.c_uint64()
        st = self._lib.th_encode(
            self._ptr, bytes(data), len(data), ctypes.byref(consumed),
            out, capacity, ctypes.byref(written),
        )
        if st == _UNKNOWN_SYMBOL:
            raise UnknownSymbolError()
        return out.raw[: written.value], int(consumed.value), st == _OK

    def encode(self, data: bytes) -> bytes:
        out, _, done = self.encode_chunk(data, self.encoded_length(data) + 8)
        if not done:
            raise RuntimeError("C++ encoder ran out of room sized by encoded_length")
        return out


class OracleDecoder:
    """Streaming decoder over the C++ oracle."""

    def __init__(self, otable: OracleTable):
        self._lib = _load()
        self._table = otable
        self._ptr = self._lib.th_decoder_create(otable._ptr)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.th_decoder_destroy(self._ptr)
            self._ptr = None

    def reset(self) -> None:
        self._lib.th_decoder_reset(self._ptr)

    @property
    def leftover_bits(self) -> tuple[int, int]:
        """(working_bits MSB-aligned value, num_bits)."""
        return (
            int(self._lib.th_decoder_working_bits(self._ptr)),
            int(self._lib.th_decoder_num_bits(self._ptr)),
        )

    def decode_chunk(self, data: bytes, capacity: int) -> tuple[bytes, int, bool]:
        """Returns (out_bytes, in_consumed, done)."""
        out = ctypes.create_string_buffer(max(capacity, 1))
        consumed = ctypes.c_uint64()
        written = ctypes.c_uint64()
        st = self._lib.th_decode(
            self._ptr, bytes(data), len(data), ctypes.byref(consumed),
            out, capacity, ctypes.byref(written),
        )
        if st == _UNKNOWN_SYMBOL:
            raise UnknownSymbolError()
        return out.raw[: written.value], int(consumed.value), st == _OK

    def decode(self, data: bytes) -> bytes:
        """One-shot decode with internal growth (allow_growth semantics)."""
        chunks = []
        pending = bytes(data)
        cap = max(len(data) * 2, 64)
        while True:
            out, consumed, done = self.decode_chunk(pending, cap)
            chunks.append(out)
            pending = pending[consumed:]
            if done and not pending:
                return b"".join(chunks)
            if done and consumed == 0 and not out:
                # An Ok status with input left and no progress would spin
                # forever (a decoder that keeps the spec never returns it).
                raise RuntimeError("C++ decoder returned Ok without consuming input")


def oracle_encode(data: bytes, table: HuffmanTable, eos_padding: int = 0xFF) -> bytes:
    """One-shot encode through the C++ oracle."""
    return OracleEncoder(OracleTable(table), eos_padding).encode(data)


def oracle_decode(data: bytes, table: HuffmanTable) -> bytes:
    """One-shot decode through the C++ oracle."""
    return OracleDecoder(OracleTable(table)).decode(data)


def oracle_available() -> bool:
    """Whether the library builds and loads. Any failure is False: callers
    that must not skip quietly (``chip_smoke.py``) call the classes, which
    raise."""
    try:
        _load()
        return True
    except Exception:
        return False

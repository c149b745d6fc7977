"""tpu_huffman_torch: the static-Huffman codec in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``tpu_huffman``, which stays the reference: the
same bytes, block index and errors for the same inputs. It carries the main
path (one-shot ``encode``/``encode_with_index`` and the block-parallel
``decode_indexed``), the one-shot ``decode`` of foreign streams, which
carry no index, the streaming ``HuffmanEncoder``/``HuffmanDecoder``
with the reference's SHORT_BUFFER resume protocol, the data-parallel
``MeshCodec`` over a mesh of devices and processes, and the table tools.
Public functions and constructors take ``device`` (default ``"cuda"``;
a mesh names its devices); on ``"cpu"`` they run the kernels' plain
PyTorch versions. The kernels (``csrc/*.cu``) are built with ``nvcc`` at first use
(``_build.py``). Nothing here imports JAX or the JAX package.

Layer map (SURVEY.md §1):
  1. library runtime  -> library_init/clean_up + errors (errors.py)
  2. codec core       -> ops/encode.py, ops/decode.py and their kernels
                         (ops/pack_encode.py, ops/chain_decode.py,
                         ops/selfsync.py, ops/stream_decode.py, csrc/)
  3. symbol coder     -> tables.HuffmanTable
  4. streaming        -> stream.HuffmanEncoder/HuffmanDecoder (testing.py:
                         the transitive round-trip oracles)
  5. mesh             -> shard.MeshCodec/default_mesh (each shard's count,
                         pack and chain_decode on its own device, an int64
                         prefix of the shards' bit totals, a word OR);
                         distributed.py: the process group, global meshes,
                         encode_global/decode_global on torch.distributed
  (tools)             -> tables.build_table/optimal_code_lengths/
                         safe_eos_padding and the .def/.tsv/.npz artifacts;
                         huffgen.py: the table-compiler CLI; corpora.py:
                         the benchmark corpora; metrics.py: call counters
                         and a torch.profiler trace; prof/: the profiling
                         probes on the card (not imported here)
"""

from __future__ import annotations

from .errors import (
    CompressionError,
    ShortBufferError,
    TableError,
    UnknownSymbolError,
)
from .ops import (
    BlockIndex,
    decode,
    decode_indexed,
    encode,
    encode_with_index,
    get_encoded_length,
)
from .shard import MeshCodec, default_mesh
from .stream import DecodeResult, EncodeResult, HuffmanDecoder, HuffmanEncoder
from .tables import (
    CodeSpec,
    HuffmanTable,
    build_table,
    from_reference,
    load_hpack_table,
    load_static_test_table,
    make_canonical,
    optimal_code_lengths,
    safe_eos_padding,
)

__version__ = "0.1.0"

_library_initialized = False


def library_init() -> None:
    """Parity with aws_compression_library_init. Idempotent; only flips the
    guard."""
    global _library_initialized
    _library_initialized = True


def library_clean_up() -> None:
    """Parity with aws_compression_library_clean_up."""
    global _library_initialized
    _library_initialized = False


def library_is_initialized() -> bool:
    return _library_initialized


__all__ = [
    "BlockIndex",
    "CodeSpec",
    "CompressionError",
    "DecodeResult",
    "EncodeResult",
    "HuffmanDecoder",
    "HuffmanEncoder",
    "HuffmanTable",
    "MeshCodec",
    "ShortBufferError",
    "TableError",
    "UnknownSymbolError",
    "build_table",
    "decode",
    "decode_indexed",
    "default_mesh",
    "encode",
    "encode_with_index",
    "from_reference",
    "get_encoded_length",
    "library_clean_up",
    "library_init",
    "library_is_initialized",
    "load_hpack_table",
    "load_static_test_table",
    "make_canonical",
    "optimal_code_lengths",
    "safe_eos_padding",
]

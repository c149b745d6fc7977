"""Encode, indexed decode and foreign-stream decode on torch tensors, with
their CUDA kernels (ports ``tpu_huffman/ops/``)."""

from .bitpack import (
    bytes_from_words_np,
    bytes_to_words,
    extract_windows,
    words_from_bytes_np,
    words_to_bytes,
)
from .decode import (
    STATUS_OK,
    STATUS_OUTPUT_FULL,
    STATUS_UNKNOWN_SYMBOL,
    BlockIndex,
    decode,
    decode_indexed,
    lut_lookup,
)
from .encode import (
    DEFAULT_BLOCK_SYMBOLS,
    DEFAULT_EOS_PADDING,
    DeviceTable,
    encode,
    encode_with_index,
    get_encoded_length,
)

__all__ = [
    "BlockIndex",
    "DEFAULT_BLOCK_SYMBOLS",
    "DEFAULT_EOS_PADDING",
    "DeviceTable",
    "STATUS_OK",
    "STATUS_OUTPUT_FULL",
    "STATUS_UNKNOWN_SYMBOL",
    "bytes_from_words_np",
    "bytes_to_words",
    "decode",
    "decode_indexed",
    "encode",
    "encode_with_index",
    "extract_windows",
    "get_encoded_length",
    "lut_lookup",
    "words_from_bytes_np",
    "words_to_bytes",
]

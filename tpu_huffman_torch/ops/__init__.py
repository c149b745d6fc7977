"""Encode and indexed decode on torch tensors, with their CUDA kernels
(ports ``tpu_huffman/ops/``)."""

from .bitpack import bytes_to_words, extract_windows, words_to_bytes
from .decode import BlockIndex, decode_indexed, lut_lookup
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
    "bytes_to_words",
    "decode_indexed",
    "encode",
    "encode_with_index",
    "extract_windows",
    "get_encoded_length",
    "lut_lookup",
    "words_to_bytes",
]

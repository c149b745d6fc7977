"""Round-trip test oracles (ports ``tpu_huffman/testing.py``, with a
``device`` argument: ``"cuda"`` by default, ``"cpu"`` for the plain
versions).

Framework equivalents of the reference's shipped test helpers
(reference: source/huffman_testing.c:15-73 ``huffman_test_transitive`` and
source/huffman_testing.c:75-173 ``huffman_test_transitive_chunked``). They
raise AssertionError with the same failure vocabulary so property/fuzz
tests read like the reference's.
"""

from __future__ import annotations

from .stream import HuffmanDecoder, HuffmanEncoder
from .tables import HuffmanTable


def transitive(
    table: HuffmanTable, data: bytes, encoded_size: int | None = None,
    device="cuda",
) -> None:
    """One-shot encode -> decode -> compare (reference huffman_testing.c:15-73).

    ``encoded_size`` of None skips the exact-size check (reference passes 0).
    """
    enc = HuffmanEncoder(table, device=device)
    dec = HuffmanDecoder(table, device=device)
    encoded = enc.encode(data)
    if encoded_size is not None and len(encoded) != encoded_size:
        raise AssertionError(
            f"encoded length is incorrect: {len(encoded)} != {encoded_size}"
        )
    expected = enc.encoded_length(data)
    if len(encoded) != expected:
        raise AssertionError(
            f"encoded length disagrees with get_encoded_length: "
            f"{len(encoded)} != {expected}"
        )
    out = dec.decode(encoded)
    if len(out) != len(data):
        raise AssertionError(f"decode output size incorrect: {len(out)} != {len(data)}")
    if out != bytes(data):
        raise AssertionError("decoded data does not match input data")


def transitive_chunked(
    table: HuffmanTable,
    data: bytes,
    encoded_size: int | None,
    output_chunk_size: int,
    device="cuda",
) -> None:
    """Chunked-output round trip (reference huffman_testing.c:75-173).

    Grows the output budget by ``output_chunk_size`` per call and loops on
    the SHORT_BUFFER-equivalent ``done=False`` until the stream completes,
    for both encode and decode.
    """
    enc = HuffmanEncoder(table, device=device)
    dec = HuffmanDecoder(table, device=device)

    encoded = bytearray()
    remaining = bytes(data)
    while True:
        res = enc.encode_chunk(remaining, output_chunk_size)
        if remaining and not res.data:
            raise AssertionError("encode didn't write any data")
        encoded.extend(res.data)
        remaining = remaining[res.consumed :]
        if res.done:
            if remaining:
                raise AssertionError("encode done with input left over")
            break
    if encoded_size is not None and len(encoded) != encoded_size:
        raise AssertionError(
            f"encoded length is incorrect: {len(encoded)} != {encoded_size}"
        )

    output = bytearray()
    to_decode: bytes | bytearray = bytes(encoded)
    while True:
        budget = output_chunk_size
        if len(output) + budget > len(data):
            budget = len(data) - len(output)
        res = dec.decode_chunk(to_decode, budget)
        to_decode = b""  # decoder retains unread input internally
        if not res.done and not res.data and budget:
            raise AssertionError("decode didn't write any data")
        output.extend(res.data)
        if res.done:
            break
    if len(output) != len(data):
        raise AssertionError(
            f"decode output size incorrect: {len(output)} != {len(data)}"
        )
    if bytes(output) != bytes(data):
        raise AssertionError("decoded data does not match input data")


def transitive_chunked_input(
    table: HuffmanTable, data: bytes, input_chunk_size: int, device="cuda"
) -> None:
    """Partial-*input* decode sweep (reference tests/huffman_test.c:275-314):
    encode whole, then feed the encoded bytes to the decoder in chunks."""
    enc = HuffmanEncoder(table, device=device)
    dec = HuffmanDecoder(table, device=device)
    encoded = enc.encode(data)
    output = bytearray()
    for i in range(0, len(encoded), input_chunk_size):
        res = dec.decode_chunk(encoded[i : i + input_chunk_size], None)
        output.extend(res.data)
    if bytes(output) != bytes(data):
        raise AssertionError("decoded data does not match input data")

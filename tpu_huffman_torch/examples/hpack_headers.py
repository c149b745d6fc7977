"""Downstream-consumer example on the port: HPACK-style header compression
(the twin of the repository's ``examples/hpack_headers.py``).

The reference's downstream consumer is aws-c-http's HPACK implementation.
This example runs the same usage pattern on the port: per-header-field
Huffman coding with the RFC 7541 table, EOS padding of 0xFF (all ones,
RFC 7541 §5.2), and the decoder-side padding check.

Run: python -m tpu_huffman_torch.examples.hpack_headers [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import tpu_huffman_torch as tt


def hpack_encode_field(value: bytes, table: tt.HuffmanTable, device="cuda") -> bytes:
    """Huffman-encode one header field value (EOS padding 0xFF)."""
    return tt.encode(value, table, eos_padding=0xFF, device=device)


def hpack_decode_field(blob: bytes, table: tt.HuffmanTable, device="cuda") -> bytes:
    """Decode one field, enforcing RFC 7541 §5.2 padding validity."""
    dec = tt.HuffmanDecoder(table, device=device)
    out = dec.decode_chunk(blob).data
    if not dec.padding_is_all_ones():
        raise ValueError("HPACK: padding is not EOS-prefix (all ones)")
    return out


def main(device="cuda") -> None:
    # The real RFC 7541 Appendix B code (what aws-c-http ships); swap in
    # tt.load_static_test_table() for the reference repo's test table.
    table = tt.load_hpack_table()
    headers = {
        b":method": b"GET",
        b":path": b"/index.html?q=tpu+huffman",
        b"host": b"www.example.com",
        b"user-agent": b"tpu-huffman/0.1 (jax; pallas)",
        b"accept-encoding": b"gzip, deflate, br",
    }
    total_raw = total_enc = 0
    for name, value in headers.items():
        for field in (name, value):
            blob = hpack_encode_field(field, table, device)
            back = hpack_decode_field(blob, table, device)
            if back != field:
                raise AssertionError(f"round trip of {field!r} gave {back!r}")
            total_raw += len(field)
            total_enc += len(blob)
    print(f"headers: {total_raw} B raw -> {total_enc} B encoded "
          f"({100 * total_enc / total_raw:.1f}%)  round-trip + padding checks OK")

    # A zero-padded (invalid per HPACK) stream must be rejected. Use a
    # payload whose bit length isn't byte-aligned so padding exists.
    payload = next(
        p for p in (b"a", b"x", b"ab", b"abc", b"abcd")
        if int(table.lengths[list(p)].sum()) % 8
    )
    bad = tt.encode(payload, table, eos_padding=0x00, device=device)
    try:
        hpack_decode_field(bad, table, device)
    except ValueError:
        print("zero-padded stream correctly rejected")
    else:
        raise AssertionError("invalid padding not detected")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(parser.parse_args().device)

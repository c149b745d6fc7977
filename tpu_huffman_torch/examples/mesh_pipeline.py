"""Scale-out example on the port: data-parallel mesh codec and capped
streaming decode (the twin of the repository's ``examples/mesh_pipeline.py``).

Shows what the C reference, a single-threaded state machine, has no
counterpart for:

  1. MeshCodec: block-data-parallel encode/decode over a mesh of devices
     (every visible card on --device cuda; eight CPU entries on --device
     cpu, the JAX example's virtual 8-device CPU mesh).
  2. Capacity-bounded streaming decode (the reference's SHORT_BUFFER
     resume protocol) on the bulk self-sync path instead of a
     symbol-at-a-time loop.

Run: python -m tpu_huffman_torch.examples.mesh_pipeline [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import tpu_huffman_torch as tt
from tpu_huffman_torch.shard import MeshCodec, default_mesh

CPU_MESH_ENTRIES = 8


def main(device="cuda") -> None:
    table = tt.load_static_test_table()
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=200_000, dtype=np.uint8).tobytes()

    # --- 1. mesh-parallel encode/decode ---------------------------------
    if torch.device(device).type == "cpu":
        mesh = default_mesh([torch.device("cpu")] * CPU_MESH_ENTRIES)
    else:
        mesh = default_mesh()  # 1-D mesh, every visible card
    codec = MeshCodec(table, mesh)
    encoded, index = codec.encode(data)
    if encoded != tt.encode(data, table, device=device):  # bit-identical to one device
        raise AssertionError("mesh encode differs from encode")
    if codec.decode(encoded, index) != data:
        raise AssertionError("mesh decode differs from the input")
    print(f"mesh encode/decode ok: {len(data)} -> {len(encoded)} bytes "
          f"on {codec.mesh.devices.size} devices")

    # --- 2. capacity-bounded streaming decode ----------------------------
    dec = tt.HuffmanDecoder(table, device=device)
    out, rounds = [], 0
    res = dec.decode_chunk(encoded, capacity=32_768)
    out.append(res.data)
    while not res.done:
        res = dec.decode_chunk(b"", capacity=32_768)
        out.append(res.data)
        rounds += 1
    if b"".join(out) != data:
        raise AssertionError("capped streaming decode differs from the input")
    print(f"capped streaming decode ok: {rounds + 1} SHORT_BUFFER rounds "
          f"of 32 KiB each")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(parser.parse_args().device)

"""Entry points of the port (the twin of the repository's ``__graft_entry__.py``).

entry()             -> (fn, (symbols,)): the one-card step, best_encode_step's
                       encode_fn on the static table at 65536 symbols.
dryrun_multichip(n) -> one data-parallel round trip through MeshCodec on an
                       n-entry mesh, at tiny shapes.

Both run on the card by default; ``device="cpu"`` runs the kernels' plain
versions, only when asked.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.encode import best_encode_step, resolve_device
from .shard import Mesh, MeshCodec
from .tables import load_static_test_table

ENTRY_SYMBOLS = 65536


def entry(device="cuda"):
    """The flagship step on one device: count, int64 prefix and pack of
    65536 symbols, with no host synchronisation. Returns (fn, (symbols,)),
    ``symbols`` 65536 bytes of ``default_rng(0)`` on the device and
    ``fn(symbols)`` -> (words, total_bits, padded_bits)."""
    dev = resolve_device(device)
    encode_fn, _finalize = best_encode_step(load_static_test_table(), ENTRY_SYMBOLS,
                                            device=dev)
    rng = np.random.default_rng(0)
    symbols = torch.from_numpy(rng.integers(0, 256, size=ENTRY_SYMBOLS, dtype=np.uint8))
    return encode_fn, (symbols.to(dev),)


def mesh_devices(n_devices: int, device="cuda") -> list[torch.device]:
    """``n_devices`` mesh entries: the visible cards in order, repeated when
    there are fewer than n (the port's mesh takes repeated devices), or n
    CPU entries for ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_devices
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One data-parallel round trip over an ``n_devices`` mesh: a 2 x n/2
    ("dcn", "ici") mesh when n is even and > 2, else a 1-D ("data",) one;
    MeshCodec at block_symbols 64 on the static table, 8 x 64 x 4 bytes of
    ``default_rng(1)``. Raises if the round trip differs."""
    devices = np.empty(n_devices, dtype=object)
    devices[:] = mesh_devices(n_devices, device)
    if n_devices % 2 == 0 and n_devices > 2:
        mesh = Mesh(devices.reshape(2, n_devices // 2), ("dcn", "ici"))
    else:
        mesh = Mesh(devices, ("data",))
    codec = MeshCodec(load_static_test_table(), mesh, block_symbols=64)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=8 * 64 * 4, dtype=np.uint8).tobytes()
    encoded, index = codec.encode(data)
    if codec.decode(encoded, index) != data:
        raise AssertionError("multichip round-trip mismatch")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(8, args.device)
    print("dryrun_multichip(8) ok")

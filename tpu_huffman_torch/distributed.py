"""Multi-process bring-up and meshes for MeshCodec on ``torch.distributed``
(ports ``tpu_huffman/distributed.py``).

Usage, the same program in every process:

    import tpu_huffman_torch as tt
    from tpu_huffman_torch import distributed as dist

    dist.initialize()                      # env:// (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)
    mesh = dist.global_data_mesh()         # every process's CUDA devices, in process order
    codec = tt.MeshCodec(table, mesh)

    encoded, index = dist.encode_global(codec, my_bytes)
    assert dist.decode_global(codec, encoded, index) == all_bytes

Every process of the group calls each function here together. The
collectives are ``all_gather`` of small tensors (see ``shard.py``): on
CUDA tensors under NCCL, through the CPU under gloo.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist

from .shard import Mesh, _all_gather


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Join the process group (idempotent).

    With no ``init_method`` it reads ``MASTER_ADDR``/``MASTER_PORT`` and,
    where ``world_size``/``rank`` are not given, ``WORLD_SIZE``/``RANK``
    (``env://``). With no ``backend`` it takes "nccl" when a CUDA device is
    visible (the default meshes then run on CUDA devices) and "gloo"
    otherwise; a given backend is used as it is.
    """
    if tdist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend, "init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    tdist.init_process_group(**kwargs)


def _default_devices() -> list[torch.device]:
    """This process's CUDA devices: its own card under a process-per-card
    launch (``torchrun``'s ``LOCAL_WORLD_SIZE`` > 1: ``cuda:LOCAL_RANK``),
    else every visible card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is False); "
            "pass local_devices=[...] for CPU shards"
        )
    if int(os.environ.get("LOCAL_WORLD_SIZE") or 1) > 1:
        return [torch.device("cuda", int(os.environ.get("LOCAL_RANK") or 0))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _local_and_world(local_devices) -> tuple[list[torch.device], int]:
    if local_devices is None:
        local_devices = _default_devices()
    local = [torch.device(d) for d in local_devices]
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    if tdist.is_initialized() and tdist.get_backend() == "nccl" and local[0].type == "cuda":
        # NCCL's collectives run on the current device: this process's first
        torch.cuda.set_device(local[0])
    if world > 1:
        counts = _all_gather(torch.tensor([len(local)]), local[0]).reshape(-1)
        if (counts != len(local)).any():
            raise ValueError(f"processes own different numbers of devices: {counts.tolist()}")
    return local, world


def global_data_mesh(axis: str = "data", local_devices=None) -> Mesh:
    """1-D mesh over every process's local devices, in process order.
    ``local_devices`` defaults to the process's own card under a
    process-per-card launch (``LOCAL_WORLD_SIZE`` > 1), else to every
    visible CUDA device."""
    local, world = _local_and_world(local_devices)
    return Mesh(np.asarray(local * world, dtype=object), (axis,), n_processes=world)


def dcn_ici_mesh(local_devices=None) -> Mesh:
    """2-D (processes x local devices) mesh with axes ("dcn", "ici"): the
    first axis crosses processes, the second stays within one."""
    local, world = _local_and_world(local_devices)
    devs = np.asarray(local * world, dtype=object).reshape(world, len(local))
    return Mesh(devs, ("dcn", "ici"), n_processes=world)


def encode_global(codec, local_data):
    """Data-parallel encode where each process contributes its own bytes
    (``MeshCodec.encode_sharded``). Returns (encoded_bytes, BlockIndex),
    the same on every process: the encoding of the processes' bytes
    concatenated in process order."""
    return codec.encode_sharded(local_data)


def decode_global(codec, encoded: bytes, index):
    """Collective decode; every process returns the full plaintext."""
    return codec.decode(encoded, index)

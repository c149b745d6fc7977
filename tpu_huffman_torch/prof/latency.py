"""Dependent-step latency (``csrc/probe_latency.cu``), the counterpart of P4
``scripts/prof/prof_r3_gather_latency.py:make`` (:11, pallas_call :31).

:func:`step_chain` runs ``steps`` dependent steps on every uint32 element
(int32 bits), with (s, l) = ((i // 128) % 8, i % 128) for flat index i and
``lut`` a (8, 128) uint32 table:

* ``chain``:   ``x = (x >= 2^31 ? x + 13 : x) ^ (x >> 1)``;
* ``gather``:  ``x = lut[s, x & 127] + x``;
* ``gather0``: ``x = lut[x & 7, l] + x``;

with the table in shared memory (``smem``), global memory through L1
(``ldg``) or L2 only (``l2``), or in shared memory with the fewest integer
instructions a step (``lean``: the chain's fixed part of the index hoisted,
one LOP3 for gather's index, steps unrolled in groups of 32). One thread
runs one chain, so the kernel's time per step at one warp an SM is the
latency of a dependent step, and at 64 warps an SM the SM's throughput
for it.

P4's LUT row is ``arange(128) * 2654435761`` (mod 2^32), whose low 7 bits
are 49 j: gather maps j = v & 127 to 50 j mod 128, and after 7 steps every
element's index is 0 (:func:`p4_inputs`). From there on each gather step is
a broadcast load: the script's property, which the kernels do not use.

``python -m tpu_huffman_torch.prof.latency`` checks every kind and form on
the card against the plain version at P4's shape and prints ns per step
at 1, 8 and 64 warps an SM (the slope between two step counts), with
``gather smem`` (the design before ``lean``) timed first and again last.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..ops.bitpack import MASK32, i32, u32
from . import (
    WARPS_PER_SM,
    card,
    check_calls,
    check_equal,
    grid,
    is_cuda,
    kernel_ms,
    median_ms,
    on_card,
    require_cuda,
    slope_ns,
    sweep_shape,
    tile,
)

KINDS = ("chain", "gather", "gather0")
FORMS = ("smem", "ldg", "l2", "lean")
_KIND_ID = {"chain": 0, "gather": 1, "gather0": 2}
_FORM_ID = {"smem": 0, "ldg": 2, "l2": 3, "lean": 7}  # probe_lut.cu's numbers; lean its own
OLD = ("gather", "smem")  # the design before lean, timed first and last
INNER = 512  # P4's steps
SWEEP_STEPS = (1024, 8192)
THREADS = 256
launches = {"step_chain": 0}


def p4_inputs():
    """prof_r3_gather_latency.py: X from default_rng(0), then the LUT rows
    of arange(128) * 2654435761 (mod 2^32). Both uint32."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 31, size=(64, 8, 128), dtype=np.uint32)
    lut = np.tile((np.arange(128, dtype=np.uint32) * np.uint32(2654435761))[None, :], (8, 1))
    return x, lut


def configs():
    """(kind, form) pairs: the chain once, each gather in every form."""
    return [("chain", "smem")] + [(k, f) for k in KINDS[1:] for f in FORMS]


def step_chain(x: torch.Tensor, lut: torch.Tensor, steps: int, kind: str,
               form: str = "smem", block: int = THREADS) -> torch.Tensor:
    """``steps`` dependent steps of ``kind`` on every element of ``x``
    (int32 holding uint32 bits, any shape); ``lut``: int32 (8, 128). The
    form is ignored for ``chain``; every form computes the same function.
    ``block`` sets the kernel's block size."""
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int32 tensor")
    if lut.dtype != torch.int32 or lut.shape != (8, 128) or lut.device != x.device:
        raise ValueError("lut must be int32 (8, 128) on x's device")
    if kind not in KINDS or form not in FORMS:
        raise ValueError(f"kind must be one of {KINDS}, form one of {FORMS}")
    if not is_cuda(x):
        return step_chain_plain(x, lut, steps, kind)
    lut = lut.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    err = _build.load().thc_probe_step_chain(
        x.device.index, x.data_ptr(), n, lut.data_ptr(), steps, _KIND_ID[kind], _FORM_ID[form],
        block, grid(n, block, x.device), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("thc_probe_step_chain", err)
    launches["step_chain"] += 1
    return out


def step_chain_plain(x: torch.Tensor, lut: torch.Tensor, steps: int, kind: str) -> torch.Tensor:
    """Plain version of :func:`step_chain`, in int64 masked to 32 bits."""
    v = u32(x).reshape(-1)
    i = torch.arange(v.numel(), device=x.device)
    row = ((i // 128) % 8) * 128
    lane = i % 128
    t = u32(lut).reshape(-1)
    for _ in range(steps):
        if kind == "chain":
            v = torch.where(v >= 1 << 31, (v + 13) & MASK32, v) ^ (v >> 1)
        elif kind == "gather":
            v = (t[row + (v & 127)] + v) & MASK32
        else:
            v = (t[(v & 7) * 128 + lane] + v) & MASK32
    return i32(v).reshape(x.shape)


def run(dev: torch.device | None = None) -> dict:
    """Check every kind and form against the plain version at P4's shape,
    time each at P4's steps on 64 warps an SM, and sweep the occupancy;
    every timed launch (each block size of the sweep at both step counts)
    is also held against the plain version at its own shape. Every launch
    is timed in one kernel_ms call, OLD first and again last (its
    ``again_ms``). Returns {"configs": {(kind, form): {"ms", "plain_ms",
    "sweep": {warps: ns per step}}}, "n": elements timed, "max_abs_err":
    {"step_chain": over every comparison}}. Kernel times are the kernel
    alone."""
    dev = on_card(dev)
    x_np, lut_np = p4_inputs()
    x = torch.from_numpy(x_np.view(np.int32)).to(dev)
    lut = torch.from_numpy(lut_np.view(np.int32)).to(dev)
    # P4's X tiled to one wave at 64 warps an SM; each sweep shape takes a
    # prefix of it, so the plain version at the largest shape holds them all
    n_max, block_max = sweep_shape(max(WARPS_PER_SM), dev)
    xs_all = tile(x, n_max)
    res = {"configs": {}, "n": n_max}
    err = 0
    plain_ms, want = {}, {}
    for kind in KINDS:
        plain_ms[kind] = median_ms(functools.partial(step_chain_plain, xs_all, lut, INNER, kind))
        for k in (INNER,) + SWEEP_STEPS:
            want[kind, k] = step_chain_plain(xs_all, lut, k, kind)
    calls = {}
    for kind, form in configs():
        err = max(err, check_equal(f"step_chain {kind} {form}",
                                   step_chain(x, lut, INNER, kind, form),
                                   step_chain_plain(x, lut, INNER, kind)))
        res["configs"][kind, form] = {"plain_ms": plain_ms[kind]}
        calls[kind, form, 64, INNER] = functools.partial(step_chain, xs_all, lut, INNER, kind,
                                                         form, block_max)
        for w in WARPS_PER_SM:
            n, block = sweep_shape(w, dev)
            for k in SWEEP_STEPS:
                calls[kind, form, w, k] = functools.partial(step_chain, xs_all[:n], lut, k, kind,
                                                            form, block)
    first = OLD + (64, INNER)
    old = calls.pop(first)
    calls = {first: old, **calls, first + ("again",): old}
    err = max(err, check_calls(
        "step_chain", calls, lambda label: want[label[0], label[3]][:sweep_shape(label[2], dev)[0]]))
    t = kernel_ms(calls)
    res["configs"][OLD]["again_ms"] = t[first + ("again",)]
    lo, hi = SWEEP_STEPS
    for (kind, form), r in res["configs"].items():
        r["ms"] = t[kind, form, 64, INNER]
        r["sweep"] = {w: slope_ns(t[kind, form, w, lo], t[kind, form, w, hi], hi - lo)
                      for w in WARPS_PER_SM}
    res["max_abs_err"] = {"step_chain": err}
    return res


def main() -> None:
    dev = require_cuda()
    print(card())
    res = run(dev)
    for (kind, form), r in res["configs"].items():
        label = kind if kind == "chain" else f"{kind} {form}"
        print(f"step_chain {label:12s}: ns per dependent step "
              + ", ".join(f"{w} warps/SM {ns:.2f}" for w, ns in r["sweep"].items())
              + f"; {r['ms']:.4f} ms for {INNER} steps on {res['n']} elements (plain "
              f"{r['plain_ms']:.2f} ms); equal to plain at P4's shape"
              + (f"; again after the others {r['again_ms']:.4f} ms" if "again_ms" in r else ""))


if __name__ == "__main__":
    main()

"""The one-hot table lookup on the tensor cores (``csrc/probe_mma_lut.cu``),
the counterpart of the MXU probes: P6 ``scripts/prof/prof_mxu_lut.py``'s
``f_onehot`` (:152, body ``k_onehot`` :127) and the one-column case of P1
``scripts/prof/prof_kernel_lut.py``'s ``k_onehot`` (:93, run :37).

* :func:`lut_wide_mma` computes :func:`.lut.lut_wide` (a (256, 8) bf16
  table of the pattern's four bytes, the length and three zero columns);
* :func:`lut_chain_mma` computes :func:`.lut.lut_chain` (every column the
  table's low byte).

The kernel multiplies a bf16 one-hot of 16 indexes by the table with
``mma.sync.m16n8k16`` and f32 accumulation; integers <= 255 are exact, so
the output equals the lookup kernels' bit for bit. The plain versions are
the same product in float32 on whatever device the tensors are on.

``python -m tpu_huffman_torch.prof.mma_lut`` checks both on the card
against the plain versions and ``lut_wide``/``lut_chain`` at the scripts'
shapes and prints ns per lookup at one wave of the card (2048 threads on
every SM).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..ops.bitpack import MASK32, i32, u32
from . import (
    card,
    check_calls,
    check_equal,
    grid,
    is_cuda,
    kernel_ms,
    median_ms,
    one_wave,
    on_card,
    require_cuda,
    slope_ns,
    tile,
)
from . import lut as _lut

THREADS = 256
PLAIN_ROWS = 1 << 19  # one-hot rows the plain version builds at a time
launches = {"lut_wide_mma": 0, "lut_chain_mma": 0}


def wide_table(p32: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(256, 8) float32: the pattern's bytes high to low, the length (& 255),
    three zero columns."""
    p = u32(p32)
    cols = [(p >> s) & 255 for s in (24, 16, 8, 0)] + [lens.to(torch.int64) & 255]
    t = torch.stack(cols, 1).to(torch.float32)
    return torch.cat([t, t.new_zeros(256, 3)], 1)


def chain_table(table: torch.Tensor) -> torch.Tensor:
    """(256, 8) float32: every column the table's low byte."""
    return (table.to(torch.int64) & 255).to(torch.float32)[:, None].expand(256, 8).contiguous()


def _launch(x: torch.Tensor, tab: torch.Tensor, rounds: int, mode: int, name: str):
    """The kernel alone, on a (256, 8) bf16 table already on the card."""
    out = torch.empty_like(x)
    n = x.numel()
    err = _build.load().thc_probe_mma_lut(
        x.device.index, x.data_ptr(), n, tab.data_ptr(), rounds, mode, THREADS,
        grid(n, THREADS, x.device), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("thc_probe_mma_lut", err)
    launches[name] += 1
    return out


def _onehot_rows(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """onehot(idx) @ tab in float32, PLAIN_ROWS rows at a time: (n, 8)
    exact integers."""
    flat = idx.reshape(-1)
    parts = [F.one_hot(flat[i:i + PLAIN_ROWS], 256).to(torch.float32) @ tab
             for i in range(0, flat.numel(), PLAIN_ROWS)]
    return torch.cat(parts).to(torch.int64)


def _check(x: torch.Tensor, *tables: torch.Tensor) -> None:
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int32 tensor")
    if any(t.device != x.device or t.shape != (256,) for t in tables):
        raise ValueError("tables must be 256 entries on x's device")


def lut_wide_mma(x0: torch.Tensor, p32: torch.Tensor, lens: torch.Tensor,
                 rounds: int) -> torch.Tensor:
    """:func:`.lut.lut_wide` by one-hot products on the tensor cores."""
    _check(x0, p32, lens)
    if not is_cuda(x0):
        return lut_wide_mma_plain(x0, p32, lens, rounds)
    return _launch(x0, wide_table(p32, lens).to(torch.bfloat16), rounds, 0, "lut_wide_mma")


def lut_wide_mma_plain(x0: torch.Tensor, p32: torch.Tensor, lens: torch.Tensor,
                       rounds: int) -> torch.Tensor:
    """Plain version of :func:`lut_wide_mma`: the float32 one-hot product,
    the bytes reassembled into the pattern."""
    tab = wide_table(p32, lens)
    base = x0.to(torch.int64).reshape(-1)
    accp = torch.zeros_like(base)
    accl = torch.zeros_like(base)
    for r in range(rounds):
        c = _onehot_rows((base + r) & 255, tab)
        accp ^= (c[:, 0] << 24) | (c[:, 1] << 16) | (c[:, 2] << 8) | c[:, 3]
        accl += c[:, 4]
    return i32((accp ^ accl) & MASK32).reshape(x0.shape)


def lut_chain_mma(x: torch.Tensor, table: torch.Tensor, rounds: int,
                  accumulate: bool = False) -> torch.Tensor:
    """:func:`.lut.lut_chain` by one-hot products on the tensor cores."""
    _check(x, table)
    if not is_cuda(x):
        return lut_chain_mma_plain(x, table, rounds, accumulate)
    return _launch(x, chain_table(table).to(torch.bfloat16), rounds, 2 if accumulate else 1,
                   "lut_chain_mma")


def lut_chain_mma_plain(x: torch.Tensor, table: torch.Tensor, rounds: int,
                        accumulate: bool = False) -> torch.Tensor:
    """Plain version of :func:`lut_chain_mma`."""
    tab = chain_table(table)
    y = x.to(torch.int64).reshape(-1) & 255
    for r in range(rounds):
        y = (_onehot_rows(y, tab)[:, 0] + (r if accumulate else 0)) & 255
    return y.to(torch.int32).reshape(x.shape)


def run(dev: torch.device | None = None) -> dict:
    """Check both kernels against their plain versions and against
    lut_wide / lut_chain at P6's and P1's shapes, then time them at one
    wave of 270,336 elements, each launch timed also held against the
    plain version there. The timed launches take their bf16 tables built
    once, so the times are the mma kernel alone. Returns {"wide": {...},
    "chain": {...}, "n": elements timed, "fill": the timed tensors,
    "max_abs_err": {kernel: over every comparison}}."""
    dev = on_card(dev)
    p32_np, len_np, x_np = _lut.p6_inputs()
    p32 = torch.from_numpy(p32_np.view(np.int32)).to(dev)
    lens = torch.from_numpy(len_np).to(dev)
    x0 = torch.from_numpy(x_np).to(dev)
    got = lut_wide_mma(x0, p32, lens, _lut.R_WIDE)
    err = {"lut_wide_mma": max(
        check_equal("lut_wide_mma vs plain", got, lut_wide_mma_plain(x0, p32, lens, _lut.R_WIDE)),
        check_equal("lut_wide_mma vs lut_wide", got, _lut.lut_wide(x0, p32, lens, _lut.R_WIDE)))}
    table_np, x1_np = _lut.p1_inputs()
    table = torch.from_numpy(table_np).to(dev)
    x1 = torch.from_numpy(x1_np).to(dev)
    got = lut_chain_mma(x1, table, _lut.R_CHAIN, True)
    err["lut_chain_mma"] = max(
        check_equal("lut_chain_mma vs plain", got,
                    lut_chain_mma_plain(x1, table, _lut.R_CHAIN, True)),
        check_equal("lut_chain_mma vs lut_chain", got,
                    _lut.lut_chain(x1, table, _lut.R_CHAIN, True)))

    # one wave: the plain version and the library product build the
    # one-hot in device memory, 2 KB a lookup
    n = one_wave(dev)
    xw, xc = tile(x0, n), tile(x1, n)
    res = {"n": n, "fill": {"P6": (xw, p32, lens), "P1": (xc, table)}}
    tab_w = wide_table(p32, lens).to(torch.bfloat16)
    tab_c = chain_table(table).to(torch.bfloat16)
    kernels = {"wide": lambda k: _launch(xw, tab_w, k, 0, "lut_wide_mma"),
               "chain": lambda k: _launch(xc, tab_c, k, 2, "lut_chain_mma")}
    plains = {"wide": lambda k: lut_wide_mma_plain(xw, p32, lens, k),
              "chain": lambda k: lut_chain_mma_plain(xc, table, k, True)}
    # (the script's rounds, another round count for the slope)
    rounds = {"wide": (_lut.R_WIDE, _lut.R_WIDE // 4), "chain": (_lut.R_CHAIN, 4 * _lut.R_CHAIN)}
    calls = {(name, k): functools.partial(kernels[name], k)
             for name in kernels for k in rounds[name]}
    for name in kernels:
        err[f"lut_{name}_mma"] = max(err[f"lut_{name}_mma"], check_calls(
            f"lut_{name}_mma", {label: fn for label, fn in calls.items() if label[0] == name},
            lambda label: plains[name](label[1])))
    t = kernel_ms(calls)
    for name, (r, other) in rounds.items():
        res[name] = {"ms": t[name, r], "plain_ms": median_ms(functools.partial(plains[name], r)),
                     "ns_per_lookup": slope_ns(t[name, other], t[name, r], r - other) / n}
    res["max_abs_err"] = err
    return res


def main() -> None:
    dev = require_cuda()
    print(card())
    res = run(dev)
    for name, rounds in (("wide", _lut.R_WIDE), ("chain", _lut.R_CHAIN)):
        r = res[name]
        print(f"lut_{name}_mma: {r['ms']:.4f} ms at {res['n']} elements x {rounds} rounds, "
              f"{r['ns_per_lookup']:.5f} ns/lookup (plain {r['plain_ms']:.3f} ms); equal to "
              f"lut_{name} and to plain at the script's shape")


if __name__ == "__main__":
    main()

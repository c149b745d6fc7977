"""The one-hot table lookup on the tensor cores (``csrc/probe_mma_lut.cu``),
the counterpart of the MXU probes: P6 ``scripts/prof/prof_mxu_lut.py``'s
``f_onehot`` (:152, body ``k_onehot`` :127) and the one-column case of P1
``scripts/prof/prof_kernel_lut.py``'s ``k_onehot`` (:93, run :37).

* :func:`lut_wide_mma` computes :func:`.lut.lut_wide` (a (256, 8) bf16
  table of the pattern's four bytes, the length and three zero columns);
* :func:`lut_chain_mma` computes :func:`.lut.lut_chain`, by the kernel
  ``form`` (``CHAIN_FORMS``): ``sync`` the first design (a (256, 8) table,
  every column the table's low byte, 16 dependent k-steps a round), and
  ``nibble`` (the default) the one-hot factored over the low nibble: the
  table as a 16 x 16 B (:func:`nibble_table`), two independent
  ``mma.sync`` a tile-round, then the row's column picked by the high
  nibble: a third product, in fp16, of the columns masked by the high
  nibble's one-hot with a B of ones, which leaves the entry in every
  thread of the row's group, four tiles a warp.
  :func:`lut_chain_mma_nibble_plain` repeats its arithmetic.

The kernels multiply a bf16 one-hot by the table with f32 accumulation;
integers <= 255 are exact, so the output equals the lookup kernels' bit
for bit. The plain versions are the same product in float32 on whatever
device the tensors are on. :func:`lut_wide_mma`'s ``mode`` picks the
kernel (``WIDE_MODES``):

* ``sync`` — ``mma.sync.m16n8k16``, two tiles a warp, the table's
  fragments in registers, the one-hot rebuilt a k-step with two predicates
  and four selects (the yardstick of the new modes; :func:`lut_chain_mma`
  runs it too);
* ``mma_only`` and ``build_only`` — ``sync`` split: the mma and the
  epilogue with no one-hot built a k-step (the round's column hot in every
  k-step), and the build and the epilogue with no mma (out is 0); each has
  its own plain version (:func:`split_plain`);
* ``wgmma`` — ``wgmma.mma_async.m64n8k16`` (sm_90a), 64 lookups a
  warpgroup a round, the one-hot as A from registers, the table as B in
  shared memory, a round's 16 k-steps one group while the next round's
  fragments are built; ``wgmma8`` the same with two groups of 8 a round;
* ``sync4`` — ``mma.sync`` reworked: four tiles a warp interleaved by
  k-step, the table's fragments in shared memory.

``wgmma``, ``wgmma8`` and ``sync4`` build the one-hot with one fp16x2
compare an A register, whose 1.0 (0x3C00) reads as 2^-7 in bf16, and
share a branch-free epilogue; :func:`lut_wide_mma_bytes_plain` repeats
their arithmetic. ``NEW_MODE`` is the fastest of the three on the card,
``sync4`` (PERF.md section 6).

``python -m tpu_huffman_torch.prof.mma_lut`` checks every mode and form on
the card against its plain version and ``lut_wide``/``lut_chain`` at the
scripts' shapes and prints ns per lookup at one wave of the card (2048
threads on every SM), with each kernel's registers and blocks an SM.
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
# lut_wide_mma's kernels: mode -> (C mode id, block; grid 0 fills the card
# once, at the blocks an SM holds)
WIDE_MODES = {"sync": (0, THREADS), "mma_only": (3, THREADS), "build_only": (4, THREADS),
              "wgmma": (5, 128), "wgmma8": (6, 128), "sync4": (7, THREADS)}
OLD_MODE = "sync"
NEW_MODE = "sync4"
SPLIT_MODES = ("mma_only", "build_only")
MAGIC_BITS = 0x4B400000  # float bits of 1.5 * 2^23, the new modes' accumulator start
CHAIN_FORMS = ("sync", "nibble")
OLD_FORM = "sync"
NEW_FORM = "nibble"
# "lut_chain_mma" counts the sync form's launches, "lut_chain_mma_nibble"
# the nibble form's
launches = {"lut_wide_mma": 0, "lut_chain_mma": 0, "lut_chain_mma_nibble": 0}


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


def nibble_table(table: torch.Tensor) -> torch.Tensor:
    """The nibble form's B, (16, 16) bfloat16: ``B[lo][hi] = T[16 hi + lo]
    & 255`` (exact in bf16)."""
    return (table.to(torch.int64) & 255).reshape(16, 16).t().contiguous().to(torch.bfloat16)


def chain_mode(form: str, accumulate: bool) -> int:
    """The C mode id of a chain form: ``sync`` 1 or 2, ``nibble`` 8 or 9
    (the second with accumulate)."""
    if form not in CHAIN_FORMS:
        raise ValueError(f"form must be one of {CHAIN_FORMS}")
    return (1 if form == OLD_FORM else 8) + int(accumulate)


def _launch(x: torch.Tensor, tab: torch.Tensor, rounds: int, mode: int, name: str,
            block: int = THREADS):
    """The kernel alone, on its mode's bf16 table already on the card
    ((256, 8), or (16, 16) for the nibble form). Modes 0-4 get one thread
    an element, capped at a wave; the others fill
    the card once (grid 0)."""
    out = torch.empty_like(x)
    n = x.numel()
    err = _build.load().thc_probe_mma_lut(
        x.device.index, x.data_ptr(), n, tab.data_ptr(), rounds, mode, block,
        grid(n, block, x.device) if mode <= 4 else 0, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("thc_probe_mma_lut", err)
    launches[name] += 1
    return out


def kernel_shape(mode: str | int, dev: torch.device) -> dict:
    """A kernel's registers a thread and blocks an SM (the CUDA occupancy
    calculator on ptxas's allocation), for a wide mode by name or a C mode
    id (:func:`chain_mode`), at blocks of THREADS for the latter:
    {"registers", "block", "blocks_per_sm", "threads_per_sm"}."""
    mid, block = WIDE_MODES[mode] if isinstance(mode, str) else (mode, THREADS)
    lib = _build.load()
    regs = lib.thc_probe_mma_registers(dev.index or 0, mid)
    per_sm = lib.thc_probe_mma_occupancy(dev.index or 0, mid, block)
    if regs < 0 or per_sm < 0:
        raise RuntimeError(f"{mode}: CUDA error {-min(regs, per_sm)} reading the kernel's shape")
    return {"registers": regs, "block": block, "blocks_per_sm": per_sm,
            "threads_per_sm": per_sm * block}


def _onehot_product(idx: torch.Tensor, tab: torch.Tensor, hot: float = 1.0) -> torch.Tensor:
    """(hot * onehot(idx)) @ tab in float32, PLAIN_ROWS rows at a time:
    (n, 8), exact for a power-of-two hot."""
    flat = idx.reshape(-1)
    return torch.cat([(F.one_hot(flat[i:i + PLAIN_ROWS], 256).to(torch.float32) * hot) @ tab
                      for i in range(0, flat.numel(), PLAIN_ROWS)])


def _onehot_rows(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """onehot(idx) @ tab in float32: (n, 8) exact integers."""
    return _onehot_product(idx, tab).to(torch.int64)


def _check(x: torch.Tensor, *tables: torch.Tensor) -> None:
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int32 tensor")
    if any(t.device != x.device or t.shape != (256,) for t in tables):
        raise ValueError("tables must be 256 entries on x's device")


def lut_wide_mma(x0: torch.Tensor, p32: torch.Tensor, lens: torch.Tensor, rounds: int,
                 mode: str = NEW_MODE) -> torch.Tensor:
    """:func:`.lut.lut_wide` by one-hot products on the tensor cores, by
    the kernel ``mode`` (``WIDE_MODES``; the split modes compute
    :func:`split_plain`)."""
    _check(x0, p32, lens)
    if mode not in WIDE_MODES:
        raise ValueError(f"mode must be one of {tuple(WIDE_MODES)}")
    if not is_cuda(x0):
        if mode in SPLIT_MODES:
            return split_plain(x0, p32, lens, rounds, mode)
        if mode == OLD_MODE:
            return lut_wide_mma_plain(x0, p32, lens, rounds)
        return lut_wide_mma_bytes_plain(x0, p32, lens, rounds)
    return _launch_wide(x0, wide_table(p32, lens).to(torch.bfloat16), rounds, mode)


def _launch_wide(x0: torch.Tensor, tab: torch.Tensor, rounds: int, mode: str) -> torch.Tensor:
    mid, block = WIDE_MODES[mode]
    return _launch(x0, tab, rounds, mid, "lut_wide_mma", block)


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


def _byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's __byte_perm on int64 values < 2^32: byte i of the result is
    byte (sel >> 4i) & 7 of y:x."""
    both = x | (y << 32)
    out = torch.zeros_like(x)
    for i in range(4):
        out |= ((both >> (8 * ((sel >> (4 * i)) & 7))) & 255) << (8 * i)
    return out


SELECTORS = (0x0411, 0x1104, 0x1111, 0x1111)  # the epilogue's byte_perm of thread t
HOT = 2.0 ** -7  # the new modes' one-hot entry: set.eq.f16x2's fp16 1.0 (0x3C00) read as bf16


def lut_wide_mma_bytes_plain(x0: torch.Tensor, p32: torch.Tensor, lens: torch.Tensor,
                             rounds: int) -> torch.Tensor:
    """Plain version of the modes ``wgmma``, ``wgmma8`` and ``sync4``: the
    float32 product of a one-hot whose hot entry is HOT (fp16 1.0's bits
    read as bf16), then their branch-free epilogue. Each column c becomes
    128 c + 1.5 * 2^23, whose float bits are MAGIC_BITS + the entry;
    thread t of a row's four XORs byte_perm(C[2t], C[2t + 1],
    SELECTORS[t]) into its pattern and adds C[2t]'s bits; at the end t = 2
    keeps its sum less rounds * MAGIC_BITS, the others their pattern, and
    the four are XORed."""
    tab = wide_table(p32, lens)
    base = x0.to(torch.int64).reshape(-1)
    accp = [torch.zeros_like(base) for _ in range(4)]
    accl = [torch.zeros_like(base) for _ in range(4)]
    for r in range(rounds):
        c = _onehot_product((base + r) & 255, tab, HOT)
        bits = (c * 128 + 12582912).view(torch.int32).to(torch.int64) & MASK32
        for t in range(4):
            accp[t] ^= _byte_perm(bits[:, 2 * t], bits[:, 2 * t + 1], SELECTORS[t])
            accl[t] = (accl[t] + bits[:, 2 * t]) & MASK32
    out = (accl[2] - rounds * MAGIC_BITS) & MASK32
    for t in (0, 1, 3):
        out ^= accp[t]
    return i32(out).reshape(x0.shape)


def split_plain(x0: torch.Tensor, p32: torch.Tensor, lens: torch.Tensor, rounds: int,
                mode: str) -> torch.Tensor:
    """Plain versions of the split modes. ``build_only``: zeros.
    ``mma_only``: the round's column c = (x0 + r) & 15 is hot in all 16
    k-steps, so C = SUM_j T[16j + c] (integers up to 16 * 255), through
    ``sync``'s epilogue in 32 bits: (C0 << 24 | C1 << 16) ^ (C2 << 8 | C3)
    XORed, C4 summed."""
    if mode == "build_only":
        return torch.zeros_like(x0)
    sums = wide_table(p32, lens).to(torch.int64).reshape(16, 16, 8).sum(0)  # [c, column]
    base = x0.to(torch.int64).reshape(-1)
    accp = torch.zeros_like(base)
    accl = torch.zeros_like(base)
    for r in range(rounds):
        s = sums[(base + r) & 15]
        accp ^= (((s[:, 0] << 24) | (s[:, 1] << 16)) ^ ((s[:, 2] << 8) | s[:, 3])) & MASK32
        accl += s[:, 4]
    return i32((accp ^ accl) & MASK32).reshape(x0.shape)


def lut_chain_mma(x: torch.Tensor, table: torch.Tensor, rounds: int,
                  accumulate: bool = False, form: str = NEW_FORM) -> torch.Tensor:
    """:func:`.lut.lut_chain` by one-hot products on the tensor cores, by
    the kernel ``form`` (``CHAIN_FORMS``)."""
    _check(x, table)
    mode = chain_mode(form, accumulate)
    if not is_cuda(x):
        return _chain_plain(form)(x, table, rounds, accumulate)
    return _launch_chain(x, _chain_tab(table, form), rounds, mode)


def _chain_tab(table: torch.Tensor, form: str) -> torch.Tensor:
    """A chain form's bf16 table as its kernel reads it."""
    return (chain_table(table) if form == OLD_FORM else nibble_table(table)).to(torch.bfloat16)


def _launch_chain(x: torch.Tensor, tab: torch.Tensor, rounds: int, mode: int) -> torch.Tensor:
    return _launch(x, tab, rounds, mode,
                   "lut_chain_mma" if mode <= 2 else "lut_chain_mma_nibble")


def lut_chain_mma_plain(x: torch.Tensor, table: torch.Tensor, rounds: int,
                        accumulate: bool = False) -> torch.Tensor:
    """Plain version of :func:`lut_chain_mma`'s ``sync`` form."""
    tab = chain_table(table)
    y = x.to(torch.int64).reshape(-1) & 255
    for r in range(rounds):
        y = (_onehot_rows(y, tab)[:, 0] + (r if accumulate else 0)) & 255
    return y.to(torch.int32).reshape(x.shape)


def _nibble_lookup(y: torch.Tensor, b: torch.Tensor, add: int) -> torch.Tensor:
    """One round of the nibble form on int64 indexes < 256, ``add`` the
    round's r & 255 (0 without accumulate), in float32, which holds every
    step exactly: the one-hot of lo = y & 15 (1.0) times B, times the
    one-hot of hi = y >> 4, summed over the row with 1024 + add, whose fp16
    bits' low byte is the entry + add."""
    out = []
    for i in range(0, y.numel(), PLAIN_ROWS):
        yi = y[i:i + PLAIN_ROWS]
        lo = F.one_hot(yi & 15, 16).to(torch.float32)
        c = ((lo @ b) * F.one_hot(yi >> 4, 16)).sum(1) + (1024 + add)
        out.append(c.to(torch.float16).view(torch.int16).to(torch.int64))
    return (torch.cat(out) if out else y) & 255


def lut_chain_mma_nibble_plain(x: torch.Tensor, table: torch.Tensor, rounds: int,
                               accumulate: bool = False) -> torch.Tensor:
    """Plain version of :func:`lut_chain_mma`'s ``nibble`` form, its
    arithmetic round by round (:func:`_nibble_lookup`), r & 255 added with
    ``accumulate``."""
    b = nibble_table(table).to(torch.float32)
    y = x.to(torch.int64).reshape(-1) & 255
    for r in range(rounds):
        y = _nibble_lookup(y, b, (r & 255) if accumulate else 0)
    return y.to(torch.int32).reshape(x.shape)


def _chain_plain(form: str):
    """The plain version of a chain form, as f(x, table, rounds,
    accumulate)."""
    return lut_chain_mma_plain if form == OLD_FORM else lut_chain_mma_nibble_plain


def _wide_plain(mode: str):
    """The plain version of a wide mode, as f(x0, p32, lens, rounds)."""
    if mode in SPLIT_MODES:
        return functools.partial(_split, mode)
    return lut_wide_mma_plain if mode == OLD_MODE else lut_wide_mma_bytes_plain


def _split(mode, x0, p32, lens, rounds):
    return split_plain(x0, p32, lens, rounds, mode)


CHAIN_CASES = ("P1", "P3")  # P1 accumulates on a byte table, P3 masks a 32-bit one


def run(dev: torch.device | None = None) -> dict:
    """Check every kernel against its plain version, and the lookups
    against lut_wide / lut_chain, at P6's, P1's and P3's shapes; then time
    them at one wave of 270,336 elements, each launch timed also held
    against its plain version there. The timed launches take their bf16
    tables built once, so the times are the mma kernel alone. The wide
    modes are timed in one kernel_ms call, ``sync`` (the design before)
    first and again last, and so are the chain forms of each case.
    Returns {"wide": the NEW_MODE's {"ms", "was_ms", "plain_ms",
    "ns_per_lookup"} and "modes": {mode: {"ms", "ns_per_lookup",
    "registers", "block", "blocks_per_sm", "threads_per_sm"}}, "chain":
    P1's NEW_FORM {"ms", "was_ms", "was_again_ms", "ns_per_lookup",
    "plain_ms", "was_plain_ms"} and "cases": {case: {form: {"ms",
    "ns_per_lookup", registers...}, "sync again": ms}},
    "n": elements timed, "fill": the timed tensors, "max_abs_err":
    {kernel: over every comparison}}."""
    dev = on_card(dev)
    p32_np, len_np, x_np = _lut.p6_inputs()
    p32 = torch.from_numpy(p32_np.view(np.int32)).to(dev)
    lens = torch.from_numpy(len_np).to(dev)
    x0 = torch.from_numpy(x_np).to(dev)
    want = _lut.lut_wide(x0, p32, lens, _lut.R_WIDE)
    check_equal("lut_wide_mma plain vs lut_wide", lut_wide_mma_plain(x0, p32, lens, _lut.R_WIDE),
                want)
    check_equal("the new modes' plain vs lut_wide",
                lut_wide_mma_bytes_plain(x0, p32, lens, _lut.R_WIDE), want)
    err = {"lut_wide_mma": 0, "lut_chain_mma": 0}
    for mode in WIDE_MODES:
        got = lut_wide_mma(x0, p32, lens, _lut.R_WIDE, mode)
        err["lut_wide_mma"] = max(err["lut_wide_mma"], check_equal(
            f"lut_wide_mma {mode} vs plain", got,
            _wide_plain(mode)(x0, p32, lens, _lut.R_WIDE)))
        if mode not in SPLIT_MODES:
            check_equal(f"lut_wide_mma {mode} vs lut_wide", got, want)
    cases = {name: c for name, c in _lut.chain_cases(dev).items() if name in CHAIN_CASES}
    for name, (x, table, acc) in cases.items():
        want = _lut.lut_chain(x, table, _lut.R_CHAIN, acc)
        for form in CHAIN_FORMS:
            got = lut_chain_mma(x, table, _lut.R_CHAIN, acc, form)
            err["lut_chain_mma"] = max(
                err["lut_chain_mma"],
                check_equal(f"lut_chain_mma {name} {form} vs plain", got,
                            _chain_plain(form)(x, table, _lut.R_CHAIN, acc)),
                check_equal(f"lut_chain_mma {name} {form} vs lut_chain", got, want))

    # one wave: the plain versions and the library product build the
    # one-hot in device memory, 2 KB a lookup (128 B for nibble)
    n = one_wave(dev)
    xw = tile(x0, n)
    res = {"n": n, "fill": {"P6": (xw, p32, lens)}}
    tab_w = wide_table(p32, lens).to(torch.bfloat16)
    # (the script's rounds, another round count for the slope)
    rw = (_lut.R_WIDE, _lut.R_WIDE // 4)
    rc = (_lut.R_CHAIN, 4 * _lut.R_CHAIN)
    order = (OLD_MODE,) + tuple(m for m in WIDE_MODES if m != OLD_MODE) + (OLD_MODE,)
    calls = {}
    for mode in order:
        for k in rw:
            label = ("wide", mode, k) if ("wide", mode, k) not in calls else ("wide", mode, k, 2)
            calls[label] = functools.partial(_launch_wide, xw, tab_w, k, mode)
    plains = {}

    def want_of(label):
        kind = _wide_plain(label[1])
        if (kind, label[2]) not in plains:
            plains[kind, label[2]] = kind(xw, p32, lens, label[2])
        return plains[kind, label[2]]

    err["lut_wide_mma"] = max(err["lut_wide_mma"], check_calls("lut_wide_mma", calls, want_of))
    del plains
    t = kernel_ms(calls)
    modes = {}
    for mode in WIDE_MODES:
        hi, lo = t["wide", mode, rw[0]], t["wide", mode, rw[1]]
        modes[mode] = {"ms": hi, "ns_per_lookup": slope_ns(lo, hi, rw[0] - rw[1]) / n,
                       **kernel_shape(mode, dev)}
    modes[OLD_MODE]["again_ms"] = t["wide", OLD_MODE, rw[0], 2]
    res["wide"] = {"ms": modes[NEW_MODE]["ms"], "was_ms": modes[OLD_MODE]["ms"],
                   "ns_per_lookup": modes[NEW_MODE]["ns_per_lookup"], "modes": modes,
                   "plain_ms": median_ms(functools.partial(
                       lut_wide_mma_bytes_plain, xw, p32, lens, rw[0])),
                   "was_plain_ms": median_ms(functools.partial(
                       lut_wide_mma_plain, xw, p32, lens, rw[0]))}

    # the chain forms of each case in one kernel_ms call, sync first and
    # again last
    res["chain"] = {"cases": {}}
    for name, (x, table, acc) in cases.items():
        xc = tile(x, n)
        res["fill"][name] = (xc, table, acc)
        kinds = (OLD_FORM, NEW_FORM, "sync again")
        calls = {}
        for label in kinds:
            form = OLD_FORM if label == "sync again" else label
            tab = _chain_tab(table, form)
            for k in rc:
                calls[label, k] = functools.partial(
                    _launch_chain, xc, tab, k, chain_mode(form, acc))
        # each plain version once a round count, held against lut_chain
        plains = {}
        for k in rc:
            want = _lut.lut_chain(xc, table, k, acc)
            for form in CHAIN_FORMS:
                plains[form, k] = _chain_plain(form)(xc, table, k, acc)
                check_equal(f"lut_chain_mma {name} {form} plain vs lut_chain at {k} rounds",
                            plains[form, k], want)
        err["lut_chain_mma"] = max(err["lut_chain_mma"], check_calls(
            f"lut_chain_mma {name}", calls,
            lambda lb: plains[OLD_FORM if lb[0] == "sync again" else lb[0], lb[1]]))
        del plains
        t = kernel_ms(calls)
        out = {}
        for form in CHAIN_FORMS:
            lo, hi = t[form, rc[0]], t[form, rc[1]]
            out[form] = {"ms": lo, "ns_per_lookup": slope_ns(lo, hi, rc[1] - rc[0]) / n,
                         **kernel_shape(chain_mode(form, acc), dev)}
        out["sync again"] = t["sync again", rc[0]]
        res["chain"]["cases"][name] = out
    p1 = res["chain"]["cases"]["P1"]
    xc, table, acc = res["fill"]["P1"]
    res["chain"].update({
        "ms": p1[NEW_FORM]["ms"], "ns_per_lookup": p1[NEW_FORM]["ns_per_lookup"],
        "was_ms": p1["sync"]["ms"], "was_again_ms": p1["sync again"],
        "plain_ms": median_ms(functools.partial(
            lut_chain_mma_nibble_plain, xc, table, rc[0], acc)),
        "was_plain_ms": median_ms(functools.partial(
            lut_chain_mma_plain, xc, table, rc[0], acc))})
    res["max_abs_err"] = err
    return res


def _shape_text(r: dict) -> str:
    return (f"{r['registers']} registers, {r['blocks_per_sm']} blocks of {r['block']} an SM "
            f"({r['threads_per_sm']} threads)")


def main() -> None:
    dev = require_cuda()
    print(card())
    res = run(dev)
    w = res["wide"]
    for mode, r in w["modes"].items():
        print(f"lut_wide_mma {mode:10s}: {r['ms']:.4f} ms at {res['n']} elements x "
              f"{_lut.R_WIDE} rounds, {r['ns_per_lookup']:.5f} ns/lookup; {_shape_text(r)}"
              + (f"; again after the others {r['again_ms']:.4f} ms" if "again_ms" in r else ""))
    print(f"lut_wide_mma: {NEW_MODE} {w['ms']:.4f} ms, was ({OLD_MODE}) {w['was_ms']:.4f} ms; "
          f"plain {w['plain_ms']:.3f} ms ({OLD_MODE}'s {w['was_plain_ms']:.3f}); every mode equal "
          f"to its plain version, and the lookups to lut_wide, at the script's shape")
    c = res["chain"]
    for name, kinds in c["cases"].items():
        for label, r in kinds.items():
            if label != "sync again":
                print(f"lut_chain_mma {name} {label:6s}: {r['ms']:.4f} ms at {res['n']} "
                      f"elements x {_lut.R_CHAIN} rounds, {r['ns_per_lookup']:.5f} ns/lookup; "
                      f"{_shape_text(r)}")
        print(f"lut_chain_mma {name} sync again after the others: {kinds['sync again']:.4f} ms")
    print(f"lut_chain_mma: {NEW_FORM} {c['ms']:.4f} ms, was ({OLD_FORM}) {c['was_ms']:.4f} ms, "
          f"again {c['was_again_ms']:.4f}; plain {c['plain_ms']:.3f} ms ({OLD_FORM}'s "
          f"{c['was_plain_ms']:.3f}); every form equal to its plain version and to lut_chain "
          f"at the scripts' shapes and at one wave")


if __name__ == "__main__":
    main()

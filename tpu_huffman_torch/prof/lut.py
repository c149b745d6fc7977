"""Chained and wide table lookups (``csrc/probe_lut.cu``), the counterparts
of the Pallas lookup probes:

* P1 ``scripts/prof/prof_kernel_lut.py:run`` (:37): a 256-byte table, 16
  rounds of ``x = (T[x] + r) & 255`` — :func:`lut_chain` with
  ``accumulate``;
* P2 ``scripts/prof/prof_kernel_gather2d.py:run`` (:24) and P3
  ``scripts/prof/prof_dynamic_gather.py``'s ``f`` and ``ft`` (:34, :92): 16
  rounds of ``x = T[x] & 255`` on a byte table (P2, laid along lanes or
  sublanes: the same function) and on a 32-bit one (P3) — :func:`lut_chain`;
* P6 ``scripts/prof/prof_mxu_lut.py``'s ``f_gather3`` (:101): 64 rounds of
  ``idx = (x0 + r) & 255``, ``out = XOR p32[idx] ^ SUM len[idx]`` —
  :func:`lut_wide`.

``form`` places the table: ``smem``, ``smem_rep`` (a copy per bank
column), ``ldg`` (global, through L1), ``l2`` (global, L2 only), ``shfl``
(the warp's registers, read with ``__shfl_sync``), for :func:`lut_chain`
``addr`` (the table as next addresses, :func:`addr_table`, a copy per bank
column: one conflict-free load a round; its own kernel, whose plain
version :func:`lut_chain_addr_plain` walks the same entries), and for
:func:`lut_wide` ``packed`` (pattern and length as one 64-bit shared
memory entry) and ``word`` (pattern and length as one 32-bit marker-bit
word, :func:`word_table`, a copy per bank column: one conflict-free load a
lookup; its own kernel, :func:`lut_wide_word`). Every form computes the
same function; the plain version is one function whatever the form.

``python -m tpu_huffman_torch.prof.lut`` checks every form on the card
against the plain version at the scripts' shapes, prints ns per lookup at
a shape that fills the card (the old ``smem`` form timed first and again
last), and the ns per dependent lookup of every ``lut_chain`` form at 1,
8 and 64 warps an SM.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..ops.bitpack import MASK32, i32, u32
from . import (
    FILL_ELEMENTS,
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

_PLACEMENTS = ("smem", "smem_rep", "ldg", "l2", "shfl")
FORMS = _PLACEMENTS + ("addr",)
WIDE_FORMS = _PLACEMENTS + ("packed", "word")
_FORM_ID = {"smem": 0, "smem_rep": 1, "ldg": 2, "l2": 3, "shfl": 4, "packed": 5, "addr": 6}
THREADS = 256
# the addr form's blocks: a block takes 33 KB of shared memory (65 KB with
# accumulate: its copies hold the table twice), so two of 1024 threads fill
# an SM
ADDR_THREADS = 1024
# the word form's blocks: a block takes 64 KB of shared memory (its 32 KB
# of copies start at a 32 KB boundary), so two of 1024 threads fill an SM
WORD_THREADS = 1024
R_CHAIN = 16  # P1, P2, P3's rounds
R_WIDE = 64  # P6's rounds
SWEEP_ROUNDS = (256, 2048)  # the two chain lengths of the occupancy sweep
launches = {"lut_chain": 0, "lut_wide": 0, "lut_wide_word": 0}


# ---- the scripts' inputs, from their seeds in their draw order -----------

def p1_inputs():
    """prof_kernel_lut.py: default_rng(3), the uint8 table, then X."""
    rng = np.random.default_rng(3)
    table = rng.integers(0, 256, size=256, dtype=np.uint8)
    x = rng.integers(0, 256, size=(64, 8, 128), dtype=np.int32)
    return table, x


def p2_inputs():
    """prof_kernel_gather2d.py: default_rng(3), the int32 table, then X."""
    rng = np.random.default_rng(3)
    table = rng.integers(0, 256, size=256, dtype=np.int32)
    x = rng.integers(0, 256, size=(64, 8, 128), dtype=np.int32)
    return table, x


def p3_inputs(g: int = 16):
    """prof_dynamic_gather.py: default_rng(3), a table of values < 2^31,
    then X of shape (G, 256, 128); a smaller g takes X's first rows."""
    rng = np.random.default_rng(3)
    table = rng.integers(0, 2**31, size=256, dtype=np.int64).astype(np.int32)
    x = rng.integers(0, 256, size=(16, 256, 128), dtype=np.int32)
    return table, x[:g]


def p6_inputs(g: int = 128):
    """prof_mxu_lut.py: default_rng(7), the lengths, the patterns, then X
    of shape (G, 8, 128). Returns (p32 uint32, lengths int32, X)."""
    rng = np.random.default_rng(7)
    len_np = rng.integers(5, 31, size=256).astype(np.int32)
    pat_np = rng.integers(0, 1 << 32, size=256, dtype=np.uint64).astype(np.uint32)
    mask = (np.uint64(0xFFFFFFFF) << (32 - len_np).astype(np.uint64)).astype(np.uint32)
    p32 = np.where(len_np > 0, pat_np & mask, np.uint32(0)).astype(np.uint32)
    x = rng.integers(0, 256, size=(128, 8, 128), dtype=np.int32)
    return p32, len_np, x[:g]


# ---- lut_chain --------------------------------------------------------------

def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor")


def lut_chain(x: torch.Tensor, table: torch.Tensor, rounds: int, accumulate: bool = False,
              form: str = "smem", block: int | None = None) -> torch.Tensor:
    """``rounds`` dependent lookups of every element: ``x = (T[x] + r) &
    255`` with ``accumulate``, else ``x = T[x] & 255``, r = 0, 1, ...

    ``x``: int32, any shape (values taken & 255); ``table``: 256 entries,
    uint8 (a byte table) or int32 (a 32-bit one). ``block`` (a multiple of
    32) sets the kernel's block size, with which the caller sets the
    occupancy; None takes ADDR_THREADS for ``addr``, else THREADS.
    """
    _check_x(x, "x")
    if table.dtype not in (torch.uint8, torch.int32) or table.shape != (256,):
        raise ValueError("table must be uint8[256] or int32[256]")
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}")
    if table.device != x.device:
        raise ValueError("x and table are on different devices")
    if not is_cuda(x):
        if form == "addr":
            return lut_chain_addr_plain(x, table, rounds, accumulate)
        return lut_chain_plain(x, table, rounds, accumulate)
    if block is None:
        block = ADDR_THREADS if form == "addr" else THREADS
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError("block must be a multiple of 32 in [32, 1024]")
    table = table.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    err = _build.load().thc_probe_lut_chain(
        x.device.index, x.data_ptr(), n, table.data_ptr(), table.element_size(), rounds,
        int(accumulate), _FORM_ID[form], block, grid(n, block, x.device), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("thc_probe_lut_chain", err)
    launches["lut_chain"] += 1
    return out


def lut_chain_plain(x: torch.Tensor, table: torch.Tensor, rounds: int,
                    accumulate: bool = False) -> torch.Tensor:
    """Plain version of :func:`lut_chain`."""
    t = table.to(torch.int64)
    y = x.to(torch.int64) & 255
    for r in range(rounds):
        y = (t[y] + (r if accumulate else 0)) & 255
    return y.to(torch.int32)


def addr_table(table: torch.Tensor) -> torch.Tensor:
    """The addr form's entries as its kernel stages them: int32[256 * 32],
    entry idx of copy c at word ``idx * 32 + c``, holding the byte offset of
    the next lookup in copy c, ``((T[idx] & 255) << 7) | (c << 2)``, from a
    byte or a 32-bit table alike. The kernel adds the copies' shared address,
    so that an entry is the next load's address, and for ``accumulate``
    stages the 256 rows twice (row idx + 256 = row idx)."""
    t = table.to(torch.int64) & 255
    c = torch.arange(32, device=table.device)
    return ((t[:, None] << 7) | (c[None, :] << 2)).reshape(-1).to(torch.int32)


def lut_chain_addr_plain(x: torch.Tensor, table: torch.Tensor, rounds: int,
                         accumulate: bool = False) -> torch.Tensor:
    """Plain version of the addr form: the walk of its kernel over
    :func:`addr_table`, element i in lane i % 32 (its lane in a warp of
    the grid-stride loop), ``e = A[e >> 2]`` on row e >> 7 taken & 255 (the
    kernel's second copy of the rows), with ``accumulate`` then ``e += (r &
    255) << 7`` unmasked; the value is ``(e >> 7) & 255``."""
    a = addr_table(table).to(torch.int64)
    lane = torch.arange(x.numel(), device=x.device).reshape(x.shape) % 32
    e = ((x.to(torch.int64) & 255) << 7) | (lane << 2)
    for r in range(rounds):
        e = a[(e >> 2) & (a.numel() - 1)]
        if accumulate:
            e = e + ((r & 255) << 7)
    return ((e >> 7) & 255).to(torch.int32)


# ---- lut_wide ---------------------------------------------------------------

def lut_wide(x0: torch.Tensor, p32: torch.Tensor, lens: torch.Tensor, rounds: int,
             form: str = "smem") -> torch.Tensor:
    """For every element, ``rounds`` lookups at ``idx = (x0 + r) & 255``:
    ``out = XOR_r p32[idx] ^ SUM_r lens[idx]`` (int32 bits).

    ``p32``: int32[256] (uint32 patterns' bits); ``lens``: int32[256], taken
    & 255 (code lengths).
    """
    _check_x(x0, "x0")
    if p32.dtype != torch.int32 or lens.dtype != torch.int32 or p32.shape != (256,) \
            or lens.shape != (256,):
        raise ValueError("p32 and lens must be int32[256]")
    if form not in WIDE_FORMS:
        raise ValueError(f"form must be one of {WIDE_FORMS}")
    if p32.device != x0.device or lens.device != x0.device:
        raise ValueError("x0, p32 and lens are on different devices")
    if form == "word":
        return lut_wide_word(x0, word_table(p32, lens), rounds)
    if not is_cuda(x0):
        return lut_wide_plain(x0, p32, lens, rounds)
    p32, lens = p32.contiguous(), lens.contiguous()
    out = torch.empty_like(x0)
    n = x0.numel()
    err = _build.load().thc_probe_lut_wide(
        x0.device.index, x0.data_ptr(), n, p32.data_ptr(), lens.data_ptr(), rounds,
        _FORM_ID[form], THREADS, grid(n, THREADS, x0.device), out.data_ptr(),
        torch.cuda.current_stream(x0.device).cuda_stream,
    )
    _build.check("thc_probe_lut_wide", err)
    launches["lut_wide"] += 1
    return out


def lut_wide_plain(x0: torch.Tensor, p32: torch.Tensor, lens: torch.Tensor,
                   rounds: int) -> torch.Tensor:
    """Plain version of :func:`lut_wide`."""
    p = u32(p32)
    ln = lens.to(torch.int64) & 255
    base = x0.to(torch.int64)
    accp = torch.zeros_like(base)
    accl = torch.zeros_like(base)
    for r in range(rounds):
        idx = (base + r) & 255
        accp ^= p[idx]
        accl += ln[idx]
    return i32((accp ^ accl) & MASK32)


# ---- lut_wide's word form --------------------------------------------------

def word_table(p32: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The 256 (pattern, length) entries as int32 marker-bit words, ``w =
    p | 1 << (31 - l)`` with l = lens & 255: a left-aligned pattern of l <=
    31 bits has its low 32 - l bits zero, so the lowest set bit marks the
    length and the bits above it are the pattern (l = 0, p = 0 is 1 << 31).
    Raises ValueError naming the first entry with l > 31 or a pattern bit
    below its length."""
    if p32.dtype != torch.int32 or lens.dtype != torch.int32 or p32.shape != (256,) \
            or lens.shape != (256,):
        raise ValueError("p32 and lens must be int32[256]")
    p = u32(p32).cpu()
    ln = lens.to(torch.int64).cpu() & 255
    long_ = torch.nonzero(ln > 31)
    if long_.numel():
        i = int(long_[0])
        raise ValueError(f"entry {i}: length {int(ln[i])} > 31 has no marker-bit word")
    stray = torch.nonzero(p & ((1 << (32 - ln)) - 1))
    if stray.numel():
        i = int(stray[0])
        raise ValueError(f"entry {i}: pattern {int(p[i]):#010x} has a bit below its length "
                         f"{int(ln[i])}")
    return i32(p | (1 << (31 - ln))).to(p32.device)


def word_decode(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(p32, lens) of a :func:`word_table`, by torch ops: the marker is
    ``w & -w``, the pattern ``w ^ marker``, the length 31 - log2(marker)."""
    w = u32(words)
    lsb = w & -w
    pos = torch.frexp(lsb.to(torch.float64))[1].to(torch.int64) - 1
    return i32(w ^ lsb), (31 - pos).to(torch.int32)


def lut_wide_word(x0: torch.Tensor, words: torch.Tensor, rounds: int) -> torch.Tensor:
    """:func:`lut_wide` on a :func:`word_table` (int32[256]), one 32-bit
    load a lookup; the kernel of ``form="word"``, on a table built once."""
    _check_x(x0, "x0")
    if words.dtype != torch.int32 or words.shape != (256,):
        raise ValueError("words must be int32[256]")
    if words.device != x0.device:
        raise ValueError("x0 and words are on different devices")
    if not is_cuda(x0):
        return lut_wide_word_plain(x0, words, rounds)
    words = words.contiguous()
    out = torch.empty_like(x0)
    n = x0.numel()
    err = _build.load().thc_probe_lut_word(
        x0.device.index, x0.data_ptr(), n, words.data_ptr(), rounds, WORD_THREADS,
        grid(n, WORD_THREADS, x0.device), out.data_ptr(),
        torch.cuda.current_stream(x0.device).cuda_stream,
    )
    _build.check("thc_probe_lut_word", err)
    launches["lut_wide_word"] += 1
    return out


def lut_wide_word_plain(x0: torch.Tensor, words: torch.Tensor, rounds: int) -> torch.Tensor:
    """Plain version of :func:`lut_wide_word`: the words decoded by
    :func:`word_decode`, then :func:`lut_wide_plain`."""
    p32, lens = word_decode(words)
    return lut_wide_plain(x0, p32, lens, rounds)


# ---- the probe ----------------------------------------------------------------

def chain_cases(dev: torch.device) -> dict:
    """P1, P2 and P3 as (x, table, accumulate) on dev, at the scripts'
    shapes."""
    out = {}
    for name, (table, x), acc in (("P1", p1_inputs(), True), ("P2", p2_inputs(), False),
                                  ("P3", p3_inputs(), False)):
        dtype = torch.uint8 if name != "P3" else torch.int32
        out[name] = (torch.from_numpy(x).to(dev), torch.from_numpy(table).to(dtype).to(dev), acc)
    return out


def run(dev: torch.device | None = None) -> dict:
    """Check every form against the plain version at the scripts' shapes,
    then time it at FILL_ELEMENTS elements and sweep lut_chain's occupancy.
    Every timed launch (each form at both round counts, each block size of
    the sweep) is also held against the plain version at its own shape.

    The chain forms are timed in one kernel_ms call, and so are the wide
    ones, ``smem`` (the design before ``addr`` and ``word``) first and
    again last (``again_ms``).

    Returns {"chain": {case: {form: {...}}}, "wide": {form: {...}},
    "sweep": {form: {warps: ns per dependent lookup}}, "stream": P2's
    addr at 0 rounds and a copy of its bytes (ms), "fill": the timed
    tensors, "max_abs_err": {kernel: over every comparison}}. Kernel times
    are the kernel alone; ns per lookup is the slope between two round
    counts over the elements.
    """
    dev = on_card(dev)
    res = {"chain": {}, "wide": {}, "sweep": {}, "fill": {}}
    err = {"lut_chain": 0, "lut_wide": 0}
    cases = chain_cases(dev)
    calls, want = {}, {}
    chain_rounds = (R_CHAIN, 4 * R_CHAIN)
    for name, (x, table, acc) in cases.items():
        plain = lut_chain_plain(x, table, R_CHAIN, acc)
        check_equal(f"lut_chain {name} addr's plain walk", lut_chain_addr_plain(
            x, table, R_CHAIN, acc), plain)
        for form in FORMS:
            err["lut_chain"] = max(err["lut_chain"], check_equal(
                f"lut_chain {name} {form}", lut_chain(x, table, R_CHAIN, acc, form), plain))
        xf = tile(x, FILL_ELEMENTS)
        res["fill"][name] = (xf, table, acc)
        res["chain"][name] = {"plain_ms": median_ms(
            functools.partial(lut_chain_plain, xf, table, R_CHAIN, acc))}
        for k in chain_rounds:
            want[name, k] = lut_chain_plain(xf, table, k, acc)
    # every case and form in one kernel_ms call, the old design (smem)
    # first and last
    for form in ("smem",) + tuple(f for f in FORMS if f != "smem") + ("smem",):
        for name, (xf, table, acc) in res["fill"].items():
            for k in chain_rounds:
                label = (name, form, k) if (name, form, k) not in calls else (name, form, k,
                                                                                "again")
                calls[label] = functools.partial(lut_chain, xf, table, k, acc, form)
    err["lut_chain"] = max(err["lut_chain"], check_calls(
        "lut_chain", calls, lambda label: want[label[0], label[2]]))
    t = kernel_ms(calls)
    for name in cases:
        plain_ms = res["chain"][name].pop("plain_ms")
        n = res["fill"][name][0].numel()
        for form in FORMS:
            lo, hi = t[name, form, R_CHAIN], t[name, form, 4 * R_CHAIN]
            res["chain"][name][form] = {
                "ms": lo, "ns_per_lookup": slope_ns(lo, hi, 3 * R_CHAIN) / n,
                "plain_ms": plain_ms}
        res["chain"][name]["smem"]["again_ms"] = t[name, "smem", R_CHAIN, "again"]
    # what the stream alone costs: addr at 0 rounds (its loads, staging and
    # stores) beside a device copy of the same bytes
    xf, table, _ = res["fill"]["P2"]
    zero = functools.partial(lut_chain, xf, table, 0, False, "addr")
    err["lut_chain"] = max(err["lut_chain"], check_equal(
        "lut_chain P2 addr 0 rounds", zero(), lut_chain_plain(xf, table, 0)))
    t = kernel_ms({"zero": zero, "copy": xf.clone})
    res["stream"] = {"addr_0_rounds_ms": t["zero"], "copy_ms": t["copy"]}

    p32_np, len_np, x_np = p6_inputs()
    p32 = torch.from_numpy(p32_np.view(np.int32)).to(dev)
    lens = torch.from_numpy(len_np).to(dev)
    x0 = torch.from_numpy(x_np).to(dev)
    plain = lut_wide_plain(x0, p32, lens, R_WIDE)
    # the script's own truth, on the host
    idx = (x_np[None] + np.arange(R_WIDE).reshape(-1, 1, 1, 1)) & 255
    truth = np.bitwise_xor.reduce(p32_np[idx], axis=0).view(np.int32) ^ len_np[idx].sum(
        axis=0, dtype=np.int32)
    check_equal("lut_wide plain vs prof_mxu_lut.py's truth", plain.cpu(), torch.from_numpy(truth))
    words = word_table(p32, lens)
    for got, want_t, what in zip(word_decode(words), (p32, lens), ("patterns", "lengths")):
        check_equal(f"word_table's {what} decoded", got, want_t)
    check_equal("lut_wide_word plain", lut_wide_word_plain(x0, words, R_WIDE), plain)
    for form in WIDE_FORMS:
        err["lut_wide"] = max(err["lut_wide"], check_equal(
            f"lut_wide {form}", lut_wide(x0, p32, lens, R_WIDE, form), plain))
    xf = tile(x0, FILL_ELEMENTS)
    res["fill"]["P6"] = (xf, p32, lens)
    plain_ms = {"word": median_ms(functools.partial(lut_wide_word_plain, xf, words, R_WIDE))}
    plain_ms.update(dict.fromkeys(
        WIDE_FORMS[:-1], median_ms(functools.partial(lut_wide_plain, xf, p32, lens, R_WIDE))))
    rounds = (R_WIDE // 4, R_WIDE)
    want = {k: lut_wide_plain(xf, p32, lens, k) for k in rounds}
    want_word = {k: lut_wide_word_plain(xf, words, k) for k in rounds}
    # the forms in one kernel_ms call, the old design (smem) first and
    # last: the word form on its table built once, the kernel alone
    order = ("smem",) + tuple(f for f in WIDE_FORMS if f != "smem")
    calls = {}
    for form in order + ("smem",):
        for k in rounds:
            label = (form, k) if (form, k) not in calls else (form, k, "again")
            calls[label] = (functools.partial(lut_wide_word, xf, words, k) if form == "word"
                            else functools.partial(lut_wide, xf, p32, lens, k, form))
    err["lut_wide"] = max(err["lut_wide"], check_calls(
        "lut_wide", calls, lambda label: (want_word if label[0] == "word" else want)[label[1]]))
    t = kernel_ms(calls)
    for form in WIDE_FORMS:
        lo, hi = t[form, R_WIDE // 4], t[form, R_WIDE]
        res["wide"][form] = {"ms": hi, "plain_ms": plain_ms[form],
                             "ns_per_lookup": slope_ns(lo, hi, R_WIDE - R_WIDE // 4) / xf.numel()}
    res["wide"]["smem"]["again_ms"] = t["smem", R_WIDE, "again"]

    # ns per dependent lookup: P3's 32-bit table (the decode LUT's entry
    # width), one chain a thread, at 1, 8 and 64 warps an SM; each sweep
    # shape takes a prefix of the largest one's elements
    x3, t3, _ = cases["P3"]
    xs_all = x3.reshape(-1)[:sweep_shape(max(WARPS_PER_SM), dev)[0]].contiguous()
    want = {k: lut_chain_plain(xs_all, t3, k) for k in SWEEP_ROUNDS}
    calls = {}
    for form in FORMS:
        for w in WARPS_PER_SM:
            n, block = sweep_shape(w, dev)
            for k in SWEEP_ROUNDS:
                calls[form, w, k] = functools.partial(lut_chain, xs_all[:n], t3, k, False, form,
                                                      block)
    err["lut_chain"] = max(err["lut_chain"], check_calls(
        "lut_chain sweep", calls,
        lambda label: want[label[2]][:sweep_shape(label[1], dev)[0]]))
    t = kernel_ms(calls)
    lo, hi = SWEEP_ROUNDS
    for form in FORMS:
        res["sweep"][form] = {w: slope_ns(t[form, w, lo], t[form, w, hi], hi - lo)
                              for w in WARPS_PER_SM}
    res["max_abs_err"] = err
    return res


def main() -> None:
    dev = require_cuda()
    print(card())
    res = run(dev)
    for name, forms in res["chain"].items():
        for form, r in forms.items():
            print(f"lut_chain {name} {form:8s}: {r['ms']:.4f} ms at {FILL_ELEMENTS} elements x "
                  f"{R_CHAIN} rounds, {r['ns_per_lookup']:.5f} ns/lookup (plain "
                  f"{r['plain_ms']:.3f} ms); equal to plain at the script's shape"
                  + (f"; again after the others {r['again_ms']:.4f} ms" if "again_ms" in r
                     else ""))
    print(f"lut_chain P2 addr at 0 rounds {res['stream']['addr_0_rounds_ms']:.4f} ms, a copy of "
          f"the same bytes (clone) {res['stream']['copy_ms']:.4f} ms")
    for form, r in res["wide"].items():
        print(f"lut_wide P6 {form:8s}: {r['ms']:.4f} ms at {FILL_ELEMENTS} elements x {R_WIDE} "
              f"rounds, {r['ns_per_lookup']:.5f} ns/lookup (plain {r['plain_ms']:.3f} ms)"
              + (f"; again after the others {r['again_ms']:.4f} ms" if "again_ms" in r else ""))
    for form, by_w in res["sweep"].items():
        print(f"lut_chain P3 {form:8s} ns per dependent lookup: "
              + ", ".join(f"{w} warps/SM {ns:.2f}" for w, ns in by_w.items()))


if __name__ == "__main__":
    main()

"""The profiling probes' plain versions (tpu_huffman_torch.prof) against
the truths of the Pallas probes they port (scripts/prof/), on the CPU.

The inputs are the scripts' own, regenerated from their seeds; the truths
are the JAX package's select tree and ``jnp.take_along_axis`` in plain jnp
(no ``pallas_call``), and the scripts' numpy checks. Every comparison is
exact: the probes compute integer functions. The kernels themselves run
only on a CUDA card (chip_smoke.py phase 10).
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_huffman as th  # noqa: E402
import tpu_huffman_torch as tt  # noqa: E402
from tpu_huffman import oracle  # noqa: E402
from tpu_huffman.ops.pallas_encode import _make_byte_lut  # noqa: E402
from tpu_huffman_torch.ops.bitpack import words_to_bytes  # noqa: E402
from tpu_huffman_torch.ops.encode import DeviceTable  # noqa: E402
from tpu_huffman_torch.prof import latency, lut, mma_lut, pack_ablate  # noqa: E402

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=1)
def _select_tree_chain():
    """P1's truth: 16 rounds of x = (T[x] + r) & 255 through the JAX
    package's select tree over the table packed as prof_kernel_lut.py packs
    it."""
    table, x = lut.p1_inputs()
    p32 = tuple(int(table[4 * i]) | (int(table[4 * i + 1]) << 8) | (int(table[4 * i + 2]) << 16)
                | (int(table[4 * i + 3]) << 24) for i in range(64))
    tree = _make_byte_lut(p32)

    @jax.jit
    def chain(v):
        acc = jnp.zeros(v.shape, jnp.uint32)
        for _ in range(lut.R_CHAIN):
            v = (tree(v) + acc) & 255
            acc = acc + 1
        return v.astype(jnp.int32)

    return np.asarray(chain(jnp.asarray(x).astype(jnp.uint32)))


@pytest.mark.parametrize("form", lut.FORMS)
def test_lut_chain_accumulate_equals_select_tree(form):
    table, x = lut.p1_inputs()
    got = lut.lut_chain(_t(x), _t(table), lut.R_CHAIN, accumulate=True, form=form)
    assert np.array_equal(got.numpy(), _select_tree_chain())


@pytest.mark.parametrize("layout", ["lanes", "sublane"])
def test_lut_chain_equals_take_along_axis(layout):
    """P2: 16 rounds of x = T[x] & 255 against take_along_axis with the
    table laid along lanes (8, 256) or sublanes (256, 128), tile by tile."""
    table, x = lut.p2_inputs()
    g = x.shape[0]
    if layout == "lanes":
        tab = jnp.broadcast_to(jnp.asarray(table), (g, 8, 256))
        axis = 2
    else:
        tab = jnp.broadcast_to(jnp.asarray(table)[:, None], (g, 256, 128))
        axis = 1

    @jax.jit
    def chain(v):
        for _ in range(lut.R_CHAIN):
            v = jnp.take_along_axis(tab, v, axis=axis) & 255
        return v

    want = np.asarray(chain(jnp.asarray(x)))
    got = lut.lut_chain(_t(x), _t(table).to(torch.uint8), lut.R_CHAIN)
    assert np.array_equal(got.numpy(), want)
    # the int32 form of the same byte table gives the same chain
    assert torch.equal(lut.lut_chain(_t(x), _t(table), lut.R_CHAIN), got)


@pytest.mark.parametrize("form", lut.FORMS)
def test_lut_chain_32bit_table_equals_numpy_truth(form):
    """P3: prof_dynamic_gather.py's own check (:49-52), a table of values up
    to 2^31, at a reduced G."""
    table, x = lut.p3_inputs(g=4)
    want = x
    for _ in range(lut.R_CHAIN):
        want = table[want] & 255
    got = lut.lut_chain(_t(x), _t(table), lut.R_CHAIN, form=form)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["P1", "P2", "P3"])
def test_addr_table_holds_next_offsets(case):
    """The addr form's entries as its kernel stages them: entry idx of copy
    c at word idx * 32 + c holds (T[idx] & 255) << 7 | c << 2, for the byte
    tables (P1, P2) and the 32-bit one (P3) alike."""
    table, _ = {"P1": lut.p1_inputs, "P2": lut.p2_inputs, "P3": lut.p3_inputs}[case]()
    dtype = torch.int32 if case == "P3" else torch.uint8
    a = lut.addr_table(_t(table).to(dtype)).numpy().reshape(256, 32)
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 256 * 32 * 4
    assert np.array_equal(a >> 7, np.broadcast_to((table.astype(np.int64) & 255)[:, None],
                                                  (256, 32)))
    assert np.array_equal(a & 127, np.broadcast_to(np.arange(32) << 2, (256, 32)))


@pytest.mark.parametrize("rounds", [0, 5, 17, 64, 300])
@pytest.mark.parametrize("acc", [False, True])
def test_lut_chain_addr_walk_equals_plain(rounds, acc):
    """The addr form's plain walk over its entries, at round counts off its
    unrolled group of 16 and past 256 added to the index bits."""
    table, x = lut.p1_inputs()
    x = _t(x[:3])
    assert torch.equal(lut.lut_chain_addr_plain(x, _t(table), rounds, acc),
                       lut.lut_chain_plain(x, _t(table), rounds, acc))


def _p6_truth(p32_np, len_np, x):
    """prof_mxu_lut.py's host truth (:184-193)."""
    accp = np.zeros(x.shape, np.uint32)
    accl = np.zeros(x.shape, np.int32)
    for r in range(lut.R_WIDE):
        idx = (x + r) & 255
        accp ^= p32_np[idx]
        accl += len_np[idx]
    return accp.view(np.int32) ^ accl


@pytest.mark.parametrize("form", lut.WIDE_FORMS)
def test_lut_wide_equals_p6_truth(form):
    p32_np, len_np, x = lut.p6_inputs(g=32)
    got = lut.lut_wide(_t(x), _t(p32_np.view(np.int32)), _t(len_np), lut.R_WIDE, form=form)
    assert np.array_equal(got.numpy(), _p6_truth(p32_np, len_np, x))


def test_lut_wide_mma_plain_equals_lut_wide():
    """The tensor-core lookup's plain version (a float32 one-hot product)
    against lut_wide: the bytes and lengths are exact."""
    p32_np, len_np, x = lut.p6_inputs(g=8)
    args = (_t(x), _t(p32_np.view(np.int32)), _t(len_np), lut.R_WIDE)
    got = mma_lut.lut_wide_mma(*args)
    assert torch.equal(got, mma_lut.lut_wide_mma_plain(*args))
    assert torch.equal(got, lut.lut_wide(*args))


def _canonical_table(rng):
    """A random canonical code over 256 symbols with lengths 0-31 (one
    symbol at 31, one absent at 0, Kraft sum <= 1), patterns left-aligned in
    32 bits; some lengths carry bits above their low byte (taken & 255)."""
    lens = np.zeros(256, np.int64)
    order = rng.permutation(256)
    budget = 1 << 31  # Kraft sum left, in units of 2^-31
    for i, sym in enumerate(order[:255]):
        want = 31 if i == 0 else int(rng.integers(1, 32))
        if budget == 0:
            break
        lens[sym] = max(want, 31 - (int(budget).bit_length() - 1))
        budget -= 1 << (31 - int(lens[sym]))
    p32 = np.zeros(256, np.uint32)
    code, prev = 0, 0
    for sym in sorted(np.nonzero(lens)[0], key=lambda s: (lens[s], s)):
        code <<= int(lens[sym]) - prev
        prev = int(lens[sym])
        p32[sym] = code << (32 - prev)
        code += 1
    high = rng.integers(0, 4, size=256) * 256 * (rng.random(256) < 0.1)
    return p32, lens, (lens + high).astype(np.int32)


def test_word_table_round_trips():
    """P6's table and 200 seeded random canonical tables: word_table, then
    its plain decode, gives back (p32, lens & 255)."""
    p32_np, len_np, _ = lut.p6_inputs(g=1)
    cases = [(p32_np, len_np.astype(np.int64), len_np)]
    rng = np.random.default_rng(13)
    cases += [_canonical_table(rng) for _ in range(200)]
    assert any(0 in c[1] for c in cases[1:]) and all(31 in c[1] for c in cases[1:])
    for p32, lens, lens_arg in cases:
        words = lut.word_table(_t(p32.view(np.int32)), _t(lens_arg))
        got_p, got_l = lut.word_decode(words)
        assert np.array_equal(got_p.numpy().view(np.uint32), p32)
        assert np.array_equal(got_l.numpy(), lens)


@pytest.mark.parametrize("entry,p,length,what", [
    (5, 0, 32, "length 32 > 31"),
    (9, 0x80000001, 12, "bit below its length"),
    (0, 1, 0, "bit below its length"),
])
def test_word_table_raises_on_what_it_cannot_encode(entry, p, length, what):
    p32_np, len_np, _ = lut.p6_inputs(g=1)
    p32, lens = p32_np.copy(), len_np.copy()
    p32[entry], lens[entry] = p, length
    with pytest.raises(ValueError, match=f"entry {entry}: .*{what}"):
        lut.word_table(_t(p32.view(np.int32)), _t(lens))


def test_lut_wide_word_plain_equals_p6_truth():
    """The word form's plain version decodes the word table with torch ops:
    at the script's seed it gives prof_mxu_lut.py's host truth."""
    p32_np, len_np, x = lut.p6_inputs(g=32)
    words = lut.word_table(_t(p32_np.view(np.int32)), _t(len_np))
    got = lut.lut_wide_word(_t(x), words, lut.R_WIDE)
    assert np.array_equal(got.numpy(), _p6_truth(p32_np, len_np, x))
    assert torch.equal(got, lut.lut_wide_word_plain(_t(x), words, lut.R_WIDE))


@pytest.mark.parametrize("mode", [m for m in mma_lut.WIDE_MODES if m not in mma_lut.SPLIT_MODES])
@pytest.mark.parametrize("rounds", [lut.R_WIDE, 5])
def test_lut_wide_mma_modes_equal_lut_wide(mode, rounds):
    """Every lookup mode's plain version (for the new modes, their
    branch-free byte_perm epilogue) against lut_wide and the float32
    one-hot product."""
    p32_np, len_np, x = lut.p6_inputs(g=4)
    args = (_t(x), _t(p32_np.view(np.int32)), _t(len_np), rounds)
    got = mma_lut.lut_wide_mma(*args, mode=mode)
    assert torch.equal(got, lut.lut_wide(*args))
    assert torch.equal(got, mma_lut.lut_wide_mma_plain(*args))
    assert torch.equal(mma_lut.lut_wide_mma_bytes_plain(*args), got)


def _sync_epilogue_emulated(x, p32, lens, rounds):
    """The split mode mma_only, thread by thread as mma_lut_kernel runs it:
    a one-hot row with column (x0 + r) & 15 hot in all 16 k-steps, times the
    table in float32; threads t = 0, 1 OR their shifted columns into a
    32-bit pattern, t = 2 sums column 4; the four combine at the end."""
    tab = mma_lut.wide_table(_t(p32.view(np.int32)), _t(len_np_of(lens))).numpy()
    flat = x.reshape(-1).astype(np.int64)
    accp = np.zeros((2, flat.size), np.uint64)
    accl = np.zeros(flat.size, np.uint64)
    for r in range(rounds):
        a = np.zeros((flat.size, 256), np.float32)
        c = (flat + r) & 15
        for j in range(16):
            a[np.arange(flat.size), 16 * j + c] = 1.0
        cols = (a @ tab).astype(np.uint64)
        accp[0] ^= ((cols[:, 0] << 24) | (cols[:, 1] << 16)) & 0xFFFFFFFF
        accp[1] ^= ((cols[:, 2] << 8) | cols[:, 3]) & 0xFFFFFFFF
        accl = (accl + cols[:, 4]) & 0xFFFFFFFF
    out = (accp[0] ^ accp[1] ^ accl).astype(np.uint32)
    return out.view(np.int32).reshape(x.shape)


def len_np_of(lens):
    return np.ascontiguousarray(lens, dtype=np.int32)


@pytest.mark.parametrize("rounds", [lut.R_WIDE // 4, 7])
def test_split_plain_versions(rounds):
    """The split modes' plain versions: mma_only against the old kernel's
    epilogue emulated thread by thread, build_only zeros."""
    p32_np, len_np, x = lut.p6_inputs(g=1)
    x = x[:, :2]
    args = (_t(x), _t(p32_np.view(np.int32)), _t(len_np), rounds)
    got = mma_lut.lut_wide_mma(*args, mode="mma_only")
    assert np.array_equal(got.numpy(), _sync_epilogue_emulated(x, p32_np, len_np, rounds))
    assert torch.equal(mma_lut.lut_wide_mma(*args, mode="build_only"), torch.zeros_like(got))


def test_new_wrappers_reject_bad_arguments():
    x = torch.zeros(8, dtype=torch.int32)
    table = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError):
        mma_lut.lut_wide_mma(x, table, table, 1, mode="hmma")
    with pytest.raises(ValueError):
        lut.lut_wide_word(x, torch.zeros(128, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        lut.lut_wide_word(x, torch.zeros(256, dtype=torch.int64), 1)


@pytest.mark.parametrize("table_kind", ["P1", "P3"])
def test_lut_chain_mma_plain_equals_lut_chain(table_kind):
    if table_kind == "P1":
        table, x = lut.p1_inputs()
        acc = True
    else:
        table, x = lut.p3_inputs(g=1)
        acc = False
    x = x[:16]
    got = mma_lut.lut_chain_mma(_t(x), _t(table), lut.R_CHAIN, acc)
    assert torch.equal(got, lut.lut_chain(_t(x), _t(table), lut.R_CHAIN, acc))


def _jnp_onehot_chain(table, x, rounds, accumulate):
    """prof_kernel_lut.py's k_onehot (:93-106) in jnp on the CPU: each
    round a float32 dot_general of the 256-wide one-hot with the (256, 1)
    table, then + acc and & 255; acc counts the rounds with accumulate (the
    script's P1), else stays 0 (P3's masked chain, its table taken &
    255)."""
    tf = jnp.asarray((table.astype(np.int64) & 255).astype(np.float32)).reshape(256, 1)

    @jax.jit
    def chain(v):
        acc = jnp.zeros(v.shape, jnp.int32)
        for _ in range(rounds):
            oh = (v[..., None] == jax.lax.broadcasted_iota(jnp.int32, (1, 1, 256), 2)).astype(
                jnp.float32)
            y = jax.lax.dot_general(oh.reshape(-1, 256), tf, (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.float32)
            v = (y.reshape(v.shape).astype(jnp.int32) + acc) & 255
            if accumulate:
                acc = acc + 1
        return v

    return np.asarray(chain(jnp.asarray(x)))


def _chain_case(case):
    """(table, x, accumulate) of P1 (a byte table, accumulate) or P3 (a
    32-bit table, masked), 2048 elements of the script's X."""
    if case == "P1":
        table, x = lut.p1_inputs()
        return table, x[:2], True
    table, x = lut.p3_inputs(g=1)
    return table, x[:, :16], False


@functools.lru_cache(maxsize=None)
def _k_onehot_truth(case, rounds):
    table, x, acc = _chain_case(case)
    return _jnp_onehot_chain(table, x, rounds, acc)


@pytest.mark.parametrize("rounds", [0, 1, 5, lut.R_CHAIN, 17])
@pytest.mark.parametrize("case", ["P1", "P3"])
def test_lut_chain_mma_nibble_equals_k_onehot(case, rounds):
    """The nibble form's plain version (the fp16 products, the high
    nibble's mask and the row sum with 1024 + r) against lut_chain, the
    sync form's plain version and the JAX body of k_onehot, at the
    script's rounds and off them."""
    table, x, acc = _chain_case(case)
    args = (_t(x), _t(table), rounds, acc)
    got = mma_lut.lut_chain_mma(*args)
    assert torch.equal(got, mma_lut.lut_chain_mma_nibble_plain(*args))
    assert torch.equal(got, lut.lut_chain(*args))
    assert torch.equal(got, mma_lut.lut_chain_mma_plain(*args))
    assert torch.equal(mma_lut.lut_chain_mma(*args, form="sync"), got)
    assert np.array_equal(got.numpy(), _k_onehot_truth(case, rounds))


def _bf16(bits):
    """16-bit patterns read as bf16, in float32."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _f16(bits):
    """16-bit patterns read as fp16, in float32."""
    return np.asarray(bits, np.uint16).view(np.float16).astype(np.float32)


def _f16_bits(values):
    """float values as fp16 bit patterns, uint32."""
    return np.asarray(values, np.float32).astype(np.float16).view(np.uint16).astype(np.uint32)


def _f16x2_eq(a, b):
    """set.eq.f16x2 on uint32 arrays of fp16 pairs that hold exact
    integers: 0x3C00 (fp16 1.0) in each half where the halves are equal."""
    out = np.zeros(np.broadcast(a, b).shape, np.uint32)
    for shift in (0, 16):
        eq = ((a >> shift) & 0xFFFF) == ((b >> shift) & 0xFFFF)
        out |= np.where(eq, np.uint32(0x3C00 << shift), np.uint32(0))
    return out


def _halves(w, h):
    """Half h of each word in both halves (set_eq_half's broadcast)."""
    return ((w >> (16 * h)) & 0xFFFF) * np.uint32(0x10001)


def _byte_perm(x, y, sel):
    both = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(255)) << np.uint64(8 * i)
    return out.astype(np.uint32)


_LANE = np.arange(32, dtype=np.uint32)
_G, _T = _LANE >> 2, _LANE & 3


def _mma_model(a, b, read, c_rows=None):
    """mma.sync m16n8k16 over a warp's registers (uint32[32] each, 16-bit
    halves read by ``read``): A (16 x 16) from a[0..3] as rows g, g + 8 x
    columns 2t..2t+1, 2t+8..2t+9; B (16 x 8) from b[0..1] as rows 2t..2t+1,
    2t+8..2t+9 of column g; C (16 x 8) from c_rows (float, or 0). Returns
    D (16 x 8) in float64 and each lane's f32 fragment d[0..3] = D[g][2t],
    D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]."""
    amat = np.zeros((16, 16))
    for i, (row_off, col_off) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for half in range(2):
            amat[_G + row_off, 2 * _T + col_off + half] = read((a[i] >> (16 * half)) & 0xFFFF)
    bmat = np.zeros((16, 8))
    for i, k_off in enumerate((0, 8)):
        for half in range(2):
            bmat[2 * _T + k_off + half, _G] = read((b[i] >> (16 * half)) & 0xFFFF)
    d = amat @ bmat + (0 if c_rows is None else c_rows)
    frag = np.stack([d[_G, 2 * _T], d[_G, 2 * _T + 1], d[_G + 8, 2 * _T], d[_G + 8, 2 * _T + 1]])
    return d, frag


def _b_fragments(bits):
    """B's registers as the kernel loads them from a (16, 16) table of
    16-bit patterns: n-tile h, rows 2t, 2t + 1 and 2t + 8, 2t + 9 of
    column 8h + g."""
    breg = np.zeros((2, 2, 32), np.uint32)
    for h in range(2):
        col = 8 * h + _G
        breg[h, 0] = bits[2 * _T, col] | (bits[2 * _T + 1, col] << 16)
        breg[h, 1] = bits[2 * _T + 8, col] | (bits[2 * _T + 9, col] << 16)
    return breg


def _lo_fragment(v):
    """The one-hot of lo = v & 15 for rows g (low half) and g + 8 (high
    half), A registers by set.eq of the keys 1024 + column."""
    key_lo = (0x6400 + 2 * _T) | ((0x6400 + 2 * _T + 1) << 16)
    key_hi = key_lo + 8 * 0x10001
    klo = (v & 0x000F000F) | 0x64006400
    return [_f16x2_eq(key_lo, _halves(klo, 0)), _f16x2_eq(key_lo, _halves(klo, 1)),
            _f16x2_eq(key_hi, _halves(klo, 0)), _f16x2_eq(key_hi, _halves(klo, 1))]


def _mma_round_model(b_tab, v, bias):
    """One tile-round of chain_nibble_kernel, thread by thread: the two products in fp16 (B the table's entries as fp16), their
    fragments (rows g, g + 8 x columns 2t, 2t + 1 of each n-tile) masked by
    set.eq of the high nibble's keys 1024 + 16 column and mul.f16x2, then
    the masked fragments as A times a B of ones with C = bias (fp16 pair).
    Returns (the lanes' words, owners[row, t]: whether thread t's mask kept
    a column of the row)."""
    breg = _b_fragments(_f16_bits(_bf16(b_tab.view(np.uint16))))
    a = _lo_fragment(v)

    def f16_regs(frag):  # f32 fragment -> two fp16x2 registers (rows g, g + 8)
        bits = _f16_bits(frag)
        return [bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16)]

    c = [f16_regs(_mma_model(a, breg[h], _f16)[1]) for h in range(2)]
    hkey_lo = (0x6400 + 32 * _T) | ((0x6400 + 32 * _T + 16) << 16)
    hkey_hi = hkey_lo + 128 * 0x10001
    khi = (v & 0x00F000F0) | 0x64006400
    masks = [_f16x2_eq(hkey_lo, _halves(khi, 0)), _f16x2_eq(hkey_lo, _halves(khi, 1)),
             _f16x2_eq(hkey_hi, _halves(khi, 0)), _f16x2_eq(hkey_hi, _halves(khi, 1))]
    regs = [c[0][0], c[0][1], c[1][0], c[1][1]]
    sel = []
    for r, m in zip(regs, masks):
        lo = _f16(r & 0xFFFF) * _f16(m & 0xFFFF)
        hi = _f16(r >> 16) * _f16(m >> 16)
        sel.append(_f16_bits(lo) | (_f16_bits(hi) << 16))
    owners = np.zeros((16, 4), bool)
    for i, row_off in enumerate((0, 8, 0, 8)):
        owners[_G + row_off, _T] |= masks[i] != 0
    crows = np.zeros((16, 8))
    crows[_G, 2 * _T] = crows[_G, 2 * _T + 1] = _f16(bias & 0xFFFF)
    crows[_G + 8, 2 * _T] = crows[_G + 8, 2 * _T + 1] = _f16(bias >> 16)
    ones = np.full(32, 0x3C003C00, np.uint32)
    d = f16_regs(_mma_model(sel, [ones, ones], _f16, crows)[1])
    return _byte_perm(d[0], d[1], 0x5410), owners


@pytest.mark.parametrize("case", ["P1", "P3"])
def test_nibble_fragments_thread_by_thread(case):
    """A numpy model of chain_nibble_kernel's warp, by the m16n8k16
    fragment layout: nibble_table holds T[16 hi + lo], each row's column
    is kept by exactly one of its group's four threads, and after a round
    every thread of the group holds both rows' T[x] & 255; over the
    script's rounds the packed chain (with accumulate, r & 255 added to
    both halves) gives lut_chain."""
    table, x, acc = _chain_case(case)
    b_tab = mma_lut.nibble_table(_t(table)).view(torch.int16).numpy()
    tb = table.astype(np.int64) & 255
    b_int = _bf16(b_tab.view(np.uint16)).astype(np.int64)
    assert all(b_int[lo, hi] == tb[16 * hi + lo] for lo in range(16) for hi in range(16))
    # C's columns thread t holds (2t, 2t + 1 of each n-tile): each hi in
    # exactly one thread's, the owner's, (hi >> 1) & 3
    held = [{2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t} for t in range(4)]
    assert all([hi in cols for cols in held] == [(hi >> 1) & 3 == t for t in range(4)]
               for hi in range(16))
    no_add = np.uint32(0x64006400)
    # every index in both halves: 16 tiles of 16 rows
    idx = np.random.default_rng(5).permutation(256).reshape(16, 16)
    for rows in idx:
        v = (rows[_G] | (rows[_G + 8] << 16)).astype(np.uint32)
        w, owners = _mma_round_model(b_tab, v, no_add)
        assert (owners.sum(1) == 1).all()
        assert np.array_equal(w & 0x00FF00FF,
                              (tb[rows[_G]] | (tb[rows[_G + 8]] << 16)).astype(np.uint32))
    flat = x.reshape(-1)[:32]
    v = ((flat[_G] & 255) | ((flat[8 + _G] & 255) << 16)).astype(np.uint32)
    for r in range(lut.R_CHAIN):
        add = np.uint32(r & 255) * np.uint32(0x10001) if acc else np.uint32(0)
        v, _ = _mma_round_model(b_tab, v, no_add + add)
    want = lut.lut_chain(_t(flat[:16].copy()), _t(table), lut.R_CHAIN, acc).numpy()
    assert np.array_equal(v & 0xFF, want[_G]) and np.array_equal((v >> 16) & 0xFF, want[8 + _G])


def test_lut_chain_mma_rejects_unknown_form():
    table, x = lut.p1_inputs()
    with pytest.raises(ValueError, match="form"):
        mma_lut.lut_chain_mma(_t(x[:1]), _t(table), 1, form="wgmma")


@pytest.mark.parametrize("form,accumulate,mode", [
    ("sync", False, 1), ("sync", True, 2), ("nibble", False, 8), ("nibble", True, 9)])
def test_chain_mode_ids(form, accumulate, mode):
    """The C mode ids of the chain forms: thc_probe_mma_lut's 1 and 2
    (mma_lut_kernel's chain) and 8 and 9 (chain_nibble_kernel<Acc>)."""
    assert mma_lut.chain_mode(form, accumulate) == mode


@pytest.mark.parametrize("rounds", [255, 256, 257, 520])
def test_lut_chain_mma_nibble_wraps_the_round_add(rounds):
    """Past 256 rounds the accumulated add is r & 255 (the kernel keeps it
    packed as (rr + 0x10001) & 0x00FF00FF): the nibble plain version still
    equals lut_chain and the sync form's plain version on P1's inputs."""
    table, x, _ = _chain_case("P1")
    args = (_t(x[:1, :64]), _t(table), rounds, True)
    got = mma_lut.lut_chain_mma_nibble_plain(*args)
    assert torch.equal(got, lut.lut_chain(*args))
    assert torch.equal(got, mma_lut.lut_chain_mma_plain(*args))


def test_p4_gather_indexes_collapse_to_zero_after_seven_steps():
    """P4's LUT row (arange(128) * 2654435761) maps gather's index j to 50 j
    mod 128: 128, 64, ... 2 distinct indexes over steps 0-6, and from step 7
    on every element reads entry 0 of its row (a broadcast load)."""
    x, lut_np = latency.p4_inputs()
    args = (_t(x.view(np.int32)), _t(lut_np.view(np.int32)))
    for steps in range(8):
        v = latency.step_chain_plain(*args, steps, "gather").numpy().view(np.uint32)
        assert len(np.unique(v & 127)) == 128 >> steps
    assert not (v & 127).any()


_SASS = """
        Function : _Z6kernelPj
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   SHF.L.U32 R3, R2, 0x2, RZ ;
        /*0030*/                   LOP3.LUT R3, R5, 0x1fc, R3, 0xf8, !PT ;
        /*0040*/                   LDS R3, [R3] ;
        /*0050*/                   IMAD.IADD R2, R2, 0x1, R3 ;
        /*0060*/                   LDS R6, [R3+0x80] ;
        /*0070*/                   VIADD R7, R7, 0xfffffffe ;
        /*0080*/               @P0 BRA 0x20 ;
        /*0090*/                   STG.E desc[UR4][R4.64], R2 ;
        /*00a0*/               @P1 BRA 0x10 ;
        /*00b0*/                   EXIT ;
"""


def test_sass_main_loop_is_the_innermost_loop_with_loads():
    """prof.sass on a cuobjdump listing: the inner loop (0x20-0x80, two LDS)
    and not the outer one (0x10-0xa0) is the main loop, and its other
    instructions a load count the counter and the branch."""
    from tpu_huffman_torch.prof import sass

    functions = sass.parse(_SASS)
    assert list(functions) == ["_Z6kernelPj"]
    assert len(functions["_Z6kernelPj"]) == 12
    body = sass.main_loop(functions["_Z6kernelPj"])
    assert body[0].startswith("SHF.L.U32") and body[-1] == "@P0 BRA 0x20"
    r = sass.summary(body)
    assert (r["instructions"], r["loads"], r["per_load"]) == (7, 2, 2.5)
    assert r["opcodes"] == {"LDS": 2, "SHF.L.U32": 1, "LOP3.LUT": 1, "IMAD.IADD": 1,
                            "VIADD": 1, "BRA": 1}
    assert sass.main_loop([(0, "EXIT")]) == []


_SASS_MMA = """
        Function : _Z4mmakPj
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   LOP3.LUT R3, R2, 0xf000f, RZ, 0xc0, !PT ;
        /*0030*/                   HSET2.BF.EQ.AND R8, R6, R3, PT ;
        /*0040*/                   HMMA.16816.F16 R12, R8, R10, RZ ;
        /*0050*/                   HMMA.16816.F16 R16, R8, R14, RZ ;
        /*0060*/                   SHFL.BFLY PT, R5, R4, 0x1, 0x1f ;
        /*0070*/                   HMMA.16816.F16 R18, R12, R20, R22 ;
        /*0080*/                   VIADD R9, R9, 0x1 ;
        /*0090*/               @P0 BRA 0x20 ;
        /*00a0*/                   HMMA.16816.F32.BF16 R12, R8, R10, RZ ;
        /*00b0*/               @P1 BRA 0xa0 ;
        /*00c0*/                   STG.E desc[UR4][R4.64], R2 ;
        /*00d0*/               @P2 BRA 0x10 ;
        /*00e0*/                   EXIT ;
"""


def test_sass_main_loop_without_loads_is_the_one_with_most_hmma():
    """prof.sass on a listing with no LDS: of the two inner loops the one
    with three HMMA (0x20-0x90), not the one-HMMA remainder loop or the
    outer element loop, is the main loop; counted at the nibble kernel's
    3 HMMA a tile-round it is one tile-round of 3 HMMA, 1 SHFL and 4 other
    instructions."""
    from tpu_huffman_torch.prof import sass

    body = sass.main_loop(sass.parse(_SASS_MMA)["_Z4mmakPj"])
    assert body[0].startswith("LOP3.LUT") and body[-1] == "@P0 BRA 0x20"
    r = sass.summary(body, sass.MMA_NAMES["chain_nibble_kernel<true>"])
    assert (r["instructions"], r["loads"], r["per_load"], r["hmma"], r["shfl"]) == (
        8, 0, None, 3, 1)
    assert r["tile_rounds"] == 1 and r["per_tile_round"] == {"HMMA": 3, "SHFL": 1, "other": 4}
    assert r["opcodes"]["HSET2.BF.EQ.AND"] == 1 and r["opcodes"]["HMMA.16816.F16"] == 3
    assert "per_tile_round" not in sass.summary(body)
    assert "tile-round 3 HMMA, 1 SHFL, 4.000 other" in sass.text(r)


def _jnp_steps(kind, x, lut_np):
    """prof_r3_gather_latency.py's step (:15-23), tile by tile over (G, 8,
    128), INNER times, in jnp on the CPU."""
    g = x.shape[0]
    tab = jnp.broadcast_to(jnp.asarray(lut_np), (g, 8, 128))

    def body(_, v):
        if kind == "gather":
            return jnp.take_along_axis(tab, (v & 127).astype(jnp.int32), axis=2) + v
        if kind == "chain":
            return jnp.where(v >= jnp.uint32(0x80000000), v + jnp.uint32(13), v) ^ (
                v >> jnp.uint32(1))
        return jnp.take_along_axis(tab, (v & 7).astype(jnp.int32), axis=1) + v

    return np.asarray(jax.jit(lambda v: jax.lax.fori_loop(0, latency.INNER, body, v))(
        jnp.asarray(x)))


@pytest.mark.parametrize("kind,form", latency.configs())
def test_step_chain_equals_jnp(kind, form):
    x, lut_np = latency.p4_inputs()
    x = x[:8]
    got = latency.step_chain(_t(x.view(np.int32)), _t(lut_np.view(np.int32)), latency.INNER,
                             kind, form)
    assert np.array_equal(got.numpy().view(np.uint32), _jnp_steps(kind, x, lut_np))


def test_pack_ablate_full_equals_reference_and_oracle():
    ref, t = th.load_static_test_table(), tt.load_static_test_table()
    data = pack_ablate.p5_inputs(5000)
    dt = DeviceTable.for_table(t, CPU)
    sym = _t(data)
    lay = pack_ablate.layout(sym, dt)
    words = pack_ablate.pack_ablate(sym, dt, "full", lay)
    got = words_to_bytes(words)[: (lay[1] + 7) // 8].numpy().tobytes()
    assert got == th.encode(data.tobytes(), ref) == oracle.oracle_encode(data.tobytes(), ref)
    assert torch.equal(pack_ablate.pack_ablate(sym, dt, "full"), words)


@pytest.mark.parametrize("mode", ["nop", "extract", "lut", "lut4"])
def test_pack_ablate_modes_equal_numpy_sums(mode):
    t = tt.load_static_test_table()
    data = pack_ablate.p5_inputs(4099)  # a ragged last chunk
    got = pack_ablate.pack_ablate(_t(data), DeviceTable.for_table(t, CPU), mode).numpy()
    n_chunks = -(-data.size // pack_ablate.CHUNK)
    want = np.zeros((n_chunks, 2), np.int64)
    for c in range(n_chunks):
        s = data[c * pack_ablate.CHUNK:(c + 1) * pack_ablate.CHUNK].astype(np.int64)
        if mode == "extract":
            want[c, 0] = s.sum()
        elif mode != "nop":
            want[c, 0] = t.lengths[s].astype(np.int64).sum()
            want[c, 1] = np.bitwise_xor.reduce(t.patterns[s].astype(np.uint32))
    assert got.shape == (n_chunks, 2)
    assert np.array_equal(got.view(np.uint32), want.astype(np.uint32))


@pytest.mark.parametrize("module", ["lut", "mma_lut", "latency", "pack_ablate"])
def test_main_raises_without_a_card(monkeypatch, module):
    mod = importlib.import_module(f"tpu_huffman_torch.prof.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run()


def test_wrappers_reject_bad_arguments():
    x = torch.zeros(8, dtype=torch.int32)
    table = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError):
        lut.lut_chain(x, table, 1, form="tree")
    with pytest.raises(ValueError):
        lut.lut_chain(x, torch.zeros(128, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        lut.lut_wide(x, table, table, 1, form="onehot")
    with pytest.raises(ValueError):
        latency.step_chain(x, torch.zeros((8, 128), dtype=torch.int32), 1, "scatter")
    with pytest.raises(ValueError):
        latency.step_chain(x, torch.zeros((8, 128), dtype=torch.int32), 1, "gather", "leaner")
    with pytest.raises(ValueError):
        pack_ablate.pack_ablate(torch.zeros(4, dtype=torch.uint8),
                                DeviceTable.for_table(tt.load_static_test_table(), CPU), "win")

"""The exact digit product's (B10) arithmetic and layouts, on the CPU.

``csrc/matmul_int8.cu`` cannot run here, so these tests replay in numpy what
it does: the launcher's digit quads (``_kernels.digit_quads``), the stage
loader's cp.async copies with their zero-fill and swizzles, each lane's
128-bit shared-memory loads, its A registers (one shift and one mask of a
raw word) and B registers (four digit bytes), the mma.m16n8k32 sums over
the PTX ISA's fragment ownership, the cp.async ring, the contraction splits
with their atomic adds and the epilogue, for both instances at ragged
shapes.  Each replay is held bit-equal to ``packed_matmul_int8_plain`` and,
on a packed panel, to the reference's ``packed_matmul_int8`` in Pallas
interpret mode.  The instances' constants are read from the kernel's
source.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from miraculix_tpu.io import codec  # noqa: E402
from miraculix_tpu.ops import dgemm as ref_dgemm  # noqa: E402

from miraculix_tpu_torch import _kernels  # noqa: E402
from miraculix_tpu_torch.ops.dgemm import (  # noqa: E402
    packed_matmul_int8, packed_matmul_int8_plain)

SRC = (Path(_kernels.__file__).parent / "csrc" / "matmul_int8.cu").read_text()
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3     # a lane's group and its thread in the group
MASK = np.uint32(0x03030303)


class Cfg:
    """One instance, from its ``using NAME = Cfg<NT, WN, WM, MI, DW,
    STAGES>;`` line, with the template's derived constants."""

    def __init__(self, name):
        m = re.search(rf"using {name} = Cfg<(\d+), (\d+), (\d+), (\d+), "
                      rf"(\d+), (\d+)>;", SRC)
        (self.NT, self.WN, self.WM, self.MI, self.DW,
         self.STAGES) = map(int, m.groups())
        self.name = name.lower()
        self.NI = self.NT // self.WN
        self.WARPS = self.WN * self.WM
        self.THREADS = 32 * self.WARPS
        self.BM, self.BN = 16 * self.MI * self.WM, 8 * self.NT
        self.CA = self.DW // 4
        self.A_WORDS, self.B_WORDS = self.BM * self.DW, self.BN * self.DW * 4


NARROW, WIDE = Cfg("Narrow"), Cfg("Wide")
CFGS = {"narrow": NARROW, "wide": WIDE}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(rng, rows, kw):
    """Random planar16 words whose 2-bit fields are 0, 1 or 2."""
    w = rng.integers(0, 2 ** 32, size=(rows, kw), dtype=np.uint64)
    w = w.astype(np.uint32)
    both = (w & (w >> np.uint32(1))) & np.uint32(0x55555555)
    return w & ~(both << np.uint32(1))


def _digits(rng, cols, n):
    """Digits over the int8 range with -64, 64 and both int8 ends in every
    byte lane."""
    d = rng.choice(np.array([-128, -64, -1, 0, 1, 64, 127]), size=(cols, n))
    d[::3] = np.where(d[::3] > 0, 64, -64)
    return d.astype(np.int8)


def _plain(z, d):
    return packed_matmul_int8_plain(torch.from_numpy(z.view(np.int32)),
                                    torch.from_numpy(d)).numpy()


# -- the replay ---------------------------------------------------------------

def digit_quads(d, kw):
    """The digit quads by their definition: byte b of [j, P, q, u] is
    D[(4b + q) kw + 4P + u, j], zero past the digits' rows and past kw."""
    cols, n = d.shape
    kwq = -(-kw // 4)
    out = np.zeros((n, kwq, 4, 4), np.int64)
    j, P, q, u = np.meshgrid(np.arange(n), np.arange(kwq), np.arange(4),
                             np.arange(4), indexing="ij")
    for b in range(4):
        row = (4 * b + q) * kw + 4 * P + u
        ok = (row < cols) & (4 * P + u < kw)
        byte = np.where(ok, d[np.minimum(row, cols - 1), j], 0)
        out |= (byte.astype(np.int64) & 0xFF) << (8 * b)
    return out.astype(np.uint32).view(np.int32)


def a_chunk(c, r, p):
    """Chunk index of words 4p..4p+3 of row r in an A stage."""
    return r * c.CA + (p ^ ((r // (8 // c.CA)) & (c.CA - 1)))


def b_chunk(c, col, j):
    """Chunk index of chunk j = 4P + q of column col in a B stage."""
    return col * c.DW + (j ^ ((col & 1) << 2))


def load_stage(c, z, dq, w_end, row0, col0, k0, vec):
    """One stage as the kernel's threads copy it -> (A stage uint32
    [A_WORDS], B stage int32 [B_WORDS], each copy's shared byte address
    by thread: A [copies, THREADS], B [copies, THREADS])."""
    rows, kw = z.shape
    n, kwq = dq.shape[:2]
    a = np.full(c.A_WORDS, 0xDEADBEEF, np.uint32)   # every word is written
    b = np.full(c.B_WORDS, -7, np.int32)
    tid = np.arange(c.THREADS)
    a_addr, b_addr = [], []
    if vec:
        for i in range(c.BM * c.CA // c.THREADS):
            idx = tid + i * c.THREADS
            r, p = idx // c.CA, idx % c.CA
            ok = (row0 + r < rows) & (k0 + 4 * p < w_end)
            dst = 4 * a_chunk(c, r, p)
            for u in range(4):
                src = z[np.minimum(row0 + r, rows - 1),
                        np.minimum(k0 + 4 * p + u, kw - 1)]
                a[dst + u] = np.where(ok, src, 0)
            a_addr.append(4 * dst)
    else:
        for i in range(c.A_WORDS // c.THREADS):
            idx = tid + i * c.THREADS
            r, w = idx // c.DW, idx % c.DW
            ok = (row0 + r < rows) & (k0 + w < w_end)
            dst = 4 * a_chunk(c, r, w >> 2) + (w & 3)
            a[dst] = np.where(ok, z[np.minimum(row0 + r, rows - 1),
                                    np.minimum(k0 + w, kw - 1)], 0)
            a_addr.append(4 * dst)
    for i in range(c.BN * c.DW // c.THREADS):
        idx = tid + i * c.THREADS
        col, j = idx // c.DW, idx % c.DW
        P = k0 // 4 + (j >> 2)
        ok = (col0 + col < n) & (P < kwq)
        dst = 4 * b_chunk(c, col, j)
        src = dq[np.minimum(col0 + col, n - 1), np.minimum(P, kwq - 1),
                 j & 3]                                    # [THREADS, 4]
        for u in range(4):
            b[dst + u] = np.where(ok, src[:, u], 0)
        b_addr.append(4 * dst)
    return a, b, np.array(a_addr), np.array(b_addr)


# m16n8k32 .s8 fragment ownership (PTX ISA): element e of lane (g, t) is
# byte e % 4 of register e // 4
E16, E8 = np.arange(16), np.arange(8)
A_ROW = G[:, None] + 8 * ((E16[None] & 4) >> 2)       # g for e in 0-3, 8-11
A_COL = 4 * T[:, None] + (E16[None] & 3) + 16 * (E16[None] >= 8)
B_K = 4 * T[:, None] + (E8[None] & 3) + 16 * (E8[None] >= 4)
B_N = np.broadcast_to(G[:, None], (32, 8))
C_ROW = G[:, None] + 8 * (np.arange(4)[None] >= 2)
C_COL = 2 * T[:, None] + (np.arange(4)[None] & 1)


def _signed_bytes(regs):
    regs = np.ascontiguousarray(regs, dtype="<u4")
    return regs.view(np.int8).reshape(*regs.shape[:-1], -1)


def a_matrix(regs):
    """A fragments [..., 32, 4] -> the 16 x 32 int8 matrices they hold."""
    a = np.zeros(regs.shape[:-2] + (16, 32), np.float64)
    a[..., A_ROW, A_COL] = _signed_bytes(regs)
    return a


def b_matrix(regs):
    """B fragments [..., 32, 2] -> the 32 x 8 (k x n) matrices they hold."""
    b = np.zeros(regs.shape[:-2] + (32, 8), np.float64)
    b[..., B_K, B_N] = _signed_bytes(regs)
    return b


def warp_origins(c):
    """Each warp's first row and first column in the block: [WARPS, 1, 1]."""
    warp = np.arange(c.WARPS)[:, None, None]
    return (warp // c.WN) * 16 * c.MI, (warp % c.WN) * 8 * c.NI


def lane_loads(c, p):
    """The shared byte addresses each lane's 128-bit loads read at 4-word
    step p: A rows g / g + 8 [WARPS, MI, 32] each, B [WARPS, NI, 32]."""
    arow, bcol = warp_origins(c)
    r = arow + 16 * np.arange(c.MI)[None, :, None] + G
    col = bcol + 8 * np.arange(c.NI)[None, :, None] + G
    return (16 * a_chunk(c, r, p), 16 * a_chunk(c, r + 8, p),
            16 * b_chunk(c, col, 4 * p + T))


def fragments(c, a, b, p, h):
    """Every warp's A fragments [WARPS, MI, 32, 4] and B fragments
    [WARPS, NI, 32, 2] of mma step h of 4-word step p, made as the kernel
    makes them: A one shift and one mask of the loaded words, B two of the
    loaded digit words."""
    lo_addr, hi_addr, b_addr = lane_loads(c, p)
    lo = a.reshape(-1, 4)[lo_addr // 16]          # [W, MI, 32, 4] words
    hi = a.reshape(-1, 4)[hi_addr // 16]
    bq = b.view(np.uint32).reshape(-1, 4)[b_addr // 16]
    sh = (2 * T).astype(np.uint32)
    w0, w1 = 2 * h, 2 * h + 1
    af = np.stack([(lo[..., w0] >> sh) & MASK, (hi[..., w0] >> sh) & MASK,
                   (lo[..., w1] >> sh) & MASK, (hi[..., w1] >> sh) & MASK],
                  axis=-1)
    bf = bq[..., [w0, w1]]
    return af, bf


def block(c, z, dq, row0, col0, w_begin, w_end, vec):
    """One block's accumulators [WARPS, MI, NI, 32, 4] through the kernel's
    ring: stage s in slot s % STAGES, the slot of stage s - 1 refilled with
    stage s + STAGES - 1 after the barrier of stage s."""
    nst = -(-(w_end - w_begin) // c.DW)
    ring = [None] * c.STAGES
    acc = np.zeros((c.WARPS, c.MI, c.NI, 32, 4), np.int64)

    def load(s):
        held = ring[s % c.STAGES]
        assert held is None or held[0] == s - c.STAGES   # consumed
        ring[s % c.STAGES] = (s, *load_stage(c, z, dq, w_end, row0, col0,
                                             w_begin + s * c.DW, vec)[:2])

    for s in range(min(c.STAGES - 1, nst)):
        load(s)
    for s in range(nst):
        held, a, b = ring[s % c.STAGES]
        assert held == s
        if s + c.STAGES - 1 < nst:
            load(s + c.STAGES - 1)
        for p in range(c.CA):
            for h in (0, 1):
                af, bf = fragments(c, a, b, p, h)
                d = a_matrix(af)[:, :, None] @ b_matrix(bf)[:, None]
                acc += d[..., C_ROW, C_COL].astype(np.int64)
    return acc


def replay(c, z, d, split_words=None):
    """decode(z) @ D as the launch of instance ``c`` computes it: row tiles
    x column groups x contraction splits, each split's partials added into
    the zeroed output (or stored where there is one split)."""
    rows, kw = z.shape
    n = d.shape[1]
    dq = _kernels.digit_quads(torch.from_numpy(d), kw).numpy()
    per = split_words or -(-kw // c.DW) * c.DW
    assert per % c.DW == 0
    splits = -(-kw // per)
    vec = kw % 4 == 0
    out = np.zeros((rows, n), np.int64)
    written = np.zeros((rows, n), np.int64)
    arow, bcol = warp_origins(c)
    mi = np.arange(c.MI)[None, :, None, None, None]
    ni = np.arange(c.NI)[None, None, :, None, None]
    r_of = arow[..., None, None] + 16 * mi + C_ROW
    c_of = bcol[..., None, None] + 8 * ni + C_COL
    for x in range(-(-rows // c.BM)):
        for y in range(-(-n // c.BN)):
            for s in range(splits):
                acc = block(c, z, dq, x * c.BM, y * c.BN, s * per,
                            min(kw, (s + 1) * per), vec)
                r = np.broadcast_to(x * c.BM + r_of, acc.shape)
                col = np.broadcast_to(y * c.BN + c_of, acc.shape)
                keep = (r < rows) & (col < n)
                np.add.at(out, (r[keep], col[keep]), acc[keep])
                np.add.at(written, (r[keep], col[keep]), 1)
    assert (written == splits).all()        # each output once a split
    assert np.abs(out).max(initial=0) < 2 ** 31
    return out


# -- the digit layout ---------------------------------------------------------

def test_replay_follows_the_source():
    """The expressions this replay copies stand in the kernel's source: the
    two swizzles, the lanes' load addresses and the fragment registers."""
    flat = " ".join(SRC.split())
    for expr in (
            "r * C::CA + (p ^ ((r / (8 / C::CA)) & (C::CA - 1)))",
            "c * C::DW + (j ^ ((c & 1) << 2))",
            "a + 4 * a_chunk<C>(r, p)", "a + 4 * a_chunk<C>(r + 8, p)",
            "b + 4 * b_chunk<C>(bcol + 8 * ni + g, 4 * p + t)",
            "(el(lo[mi], 2 * h) >> sh) & 0x03030303u, "
            "(el(hi[mi], 2 * h) >> sh) & 0x03030303u, "
            "(el(lo[mi], 2 * h + 1) >> sh) & 0x03030303u, "
            "(el(hi[mi], 2 * h + 1) >> sh) & 0x03030303u",
            "{el(bq[ni], 2 * h), el(bq[ni], 2 * h + 1)}",
            "const int arow = (warp / C::WN) * 16 * C::MI",
            "const int bcol = (warp % C::WN) * 8 * C::NI",
            "const int r = row0 + arow + 16 * mi + g + 8 * (e >> 1)",
            "const int c = col0 + bcol + 8 * ni + 2 * t + (e & 1)",
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32"):
        assert expr in flat or expr in " ".join(
            (Path(_kernels.__file__).parent / "csrc" / "mma.cuh")
            .read_text().split()), expr


@pytest.mark.parametrize("cols,kw,n", [(80, 5, 1), (590, 37, 7), (2048, 128, 9),
                                       (16 * 37, 37, 3), (37, 37, 2)])
def test_digit_quads_layout(cols, kw, n):
    """The launcher's pre-pass equals the definition byte for byte: partial
    planes (cols < 16 kw), kw off the 4-word chunk, one column."""
    d = _digits(np.random.default_rng(cols + n), cols, n)
    got = _kernels.digit_quads(torch.from_numpy(d), kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, -(-kw // 4),
                                                             4, 4)
    np.testing.assert_array_equal(got.numpy(), digit_quads(d, kw))


@pytest.mark.parametrize("n", [3, 24])
def test_digit_quads_carry_the_kernel_arithmetic(n):
    """The launcher's digit quads, multiplied as the kernel does (register
    q = (w >> 2q) & 0x03030303 against byte b = plane 4b + q of the same
    word, signed), give the plain product."""
    g = np.random.default_rng(7).integers(0, 3, size=(64, 1500)).astype(
        np.uint8)
    zq = codec.pack_planar16(g)
    kw = zq.shape[1]
    d = np.random.default_rng(n).choice(np.array([-128, -64, -1, 1, 64, 127]),
                                        size=(1500, n)).astype(np.int8)
    dq = _kernels.digit_quads(torch.from_numpy(d), kw).numpy()
    dbytes = dq.view(np.int8).reshape(n, -1, 4, 4, 4)   # [j, P, q, u, b]
    acc = np.zeros((zq.shape[0], n), np.int64)
    for q in range(4):
        r = (zq.astype(np.int64) >> (2 * q)) & 0x03030303
        for b in range(4):
            y = dbytes[:, :, q, :, b].reshape(n, -1)[:, :kw]   # [n, kw]
            acc += ((r >> (8 * b)) & 0xFF) @ y.T.astype(np.int64)
    np.testing.assert_array_equal(acc, _plain(zq, d))


# -- the fragments and shared memory ------------------------------------------

def test_fragment_ownership_is_one_to_one():
    for row, col, shape in ((A_ROW, A_COL, (16, 32)), (B_K, B_N, (32, 8)),
                            (C_ROW, C_COL, (16, 8))):
        flat = np.ravel_multi_index((row.ravel(), col.ravel()), shape)
        assert np.array_equal(np.sort(flat), np.arange(np.prod(shape)))


@pytest.mark.parametrize("cfg", ["narrow", "wide"])
def test_fragments_hold_the_stage(cfg):
    """Through the swizzled stages and the lanes' loads, each warp's A
    fragments of mma step (p, h) are its rows' int8 quads of words 4p + 2h
    and 4p + 2h + 1 (decode.cuh int8_quads order) and its B fragments the
    matching 32 digits of its columns, planes in the same order."""
    c = CFGS[cfg]
    rng = np.random.default_rng(3)
    z = _words(rng, c.BM, c.DW)
    d = _digits(rng, 16 * c.DW, c.BN)
    dq = _kernels.digit_quads(torch.from_numpy(d), c.DW).numpy()
    a, b, _, _ = load_stage(c, z, dq, c.DW, 0, 0, 0, True)
    quads = np.stack([(z >> np.uint32(2 * q)) & MASK for q in range(4)],
                     axis=-1).astype("<u4").view(np.uint8)
    quads = quads.reshape(c.BM, 16 * c.DW)       # k = 16 w + 4 q + b
    plane = (np.arange(16) % 4) * 4 + np.arange(16) // 4   # k -> plane
    arow, bcol = warp_origins(c)
    for p in range(c.CA):
        for h in (0, 1):
            w0 = 4 * p + 2 * h
            af, bf = fragments(c, a, b, p, h)
            ks = slice(16 * w0, 16 * w0 + 32)
            rows_d = np.concatenate([plane * c.DW + w0,
                                     plane * c.DW + w0 + 1])
            for w in range(c.WARPS):
                for mi in range(c.MI):
                    r0 = int(arow[w, 0, 0]) + 16 * mi
                    np.testing.assert_array_equal(
                        a_matrix(af[w, mi]), quads[r0:r0 + 16, ks])
                for ni in range(c.NI):
                    c0 = int(bcol[w, 0, 0]) + 8 * ni
                    np.testing.assert_array_equal(
                        b_matrix(bf[w, ni]), d[rows_d, c0:c0 + 8])


def _groups(addr):
    """16-byte bank groups (of 8) of byte addresses."""
    return (np.asarray(addr) // 16) % 8


@pytest.mark.parametrize("cfg", ["narrow", "wide"])
def test_shared_memory_is_free_of_bank_conflicts(cfg):
    """Every quarter warp of the lanes' 128-bit loads touches its distinct
    16-byte chunks in distinct bank groups (an A load's 8 rows are 8
    distinct chunks in 8 groups over the whole warp), and so does every
    quarter warp of the 16-byte cp.async stores; the 4-byte copies of a
    warp hit 32 distinct banks.  Stage bases are 128-byte aligned."""
    c = CFGS[cfg]
    assert (4 * c.A_WORDS) % 128 == 0 and (4 * c.B_WORDS) % 128 == 0
    for p in range(c.CA):
        lo, hi, b = lane_loads(c, p)
        for addr in (lo, hi, b):
            for quarter in addr.reshape(-1, 8):
                uniq = np.unique(quarter)
                assert len(set(_groups(uniq))) == len(uniq)
        for addr in (lo, hi):
            for warp in addr.reshape(-1, 32):
                assert len(np.unique(warp)) == 8
                assert len(set(_groups(np.unique(warp)))) == 8
    z = _words(np.random.default_rng(4), c.BM, c.DW)
    dq = np.zeros((c.BN, c.DW // 4, 4, 4), np.int32)
    for vec in (True, False):
        _, _, a_addr, b_addr = load_stage(c, z, dq, c.DW, 0, 0, 0, vec)
        for addr in ([a_addr] if vec else []) + [b_addr]:
            for quarter in addr.reshape(-1, 8):
                assert len(set(_groups(quarter))) == 8
        if not vec:
            for warp in a_addr.reshape(-1, 32):
                assert len(set((warp // 4) % 32)) == 32


@pytest.mark.parametrize("cfg", ["narrow", "wide"])
def test_stage_copies_cover_the_stage_once(cfg):
    """Each thread's copies of one stage write every word of both stages
    exactly once (the vec and the 4-byte paths alike)."""
    c = CFGS[cfg]
    z = _words(np.random.default_rng(5), c.BM, c.DW)
    dq = np.zeros((c.BN, c.DW // 4, 4, 4), np.int32)
    for vec in (True, False):
        _, _, a_addr, b_addr = load_stage(c, z, dq, c.DW, 0, 0, 0, vec)
        span = 16 if vec else 4
        a_bytes = (a_addr.ravel()[:, None] + np.arange(span)).ravel()
        assert np.array_equal(np.sort(a_bytes), np.arange(4 * c.A_WORDS))
        b_bytes = (b_addr.ravel()[:, None] + np.arange(16)).ravel()
        assert np.array_equal(np.sort(b_bytes), np.arange(4 * c.B_WORDS))


# -- whole launches -----------------------------------------------------------

@pytest.mark.parametrize("rows,kw,cols,n,cfg,split_words", [
    (1, 5, 80, 1, "narrow", None),        # one row, kw off the chunk
    (129, 37, 590, 7, "narrow", 32),      # rows off 128, two splits
    (131, 64, 1000, 8, "narrow", None),   # 16-byte copies, cols < 16 kw
    (40, 70, 1120, 9, "wide", 32),        # the wide tile's edge, 3 splits
    (257, 13, 208, 96, "wide", None),     # rows off 256, one full group
    (17, 70, 1000, 97, "wide", 32),       # a ragged second group, 3 splits
    (70, 36, 500, 9, "narrow", 64),       # 2 column groups of 8
    (33, 80, 1200, 3, "wide", 64),        # a narrow width on the wide tile
    (48, 100, 1600, 33, "wide", None),    # 4 stages: the ring wraps
    (20, 160, 2500, 5, "narrow", None),   # 5 stages: the ring wraps
])
def test_replay_equals_plain(rows, kw, cols, n, cfg, split_words):
    """Ragged rows (off 16, 128 and 256), kw off the stage and the chunk,
    digit rows short of 16 kw, widths around both tiles' column groups and
    contraction splits of whole stages: bit-equal to plain."""
    rng = np.random.default_rng(rows * kw + n)
    z = _words(rng, rows, kw)
    z[: rows // 2 + 1, : kw // 2 + 1] = 0xAAAAAAAA        # all 2s
    d = _digits(rng, cols, n)
    np.testing.assert_array_equal(replay(CFGS[cfg], z, d, split_words),
                                  _plain(z, d))


def test_split_rule_takes_whole_stages_and_fills_the_card():
    """The launcher's split rule at the smoke's four shapes ('n' 16,384 x
    4,096 words, 't' 65,536 x 1,024; 8 and 96 digit columns, with one wide
    and two narrow blocks an SM on 132 SMs): whole stages a split, every
    word in one split, at least the waves asked for (one by default, two
    as a timing tool asks), the last wave >= 90% full; short contractions
    do not split."""
    resident = {"narrow": 2, "wide": 1}
    for rows, kw in ((16384, 4096), (65536, 1024)):
        for n, cfg in ((8, "narrow"), (96, "wide")):
            c = CFGS[cfg]
            info = {"rows": c.BM, "cols": c.BN, "words": c.DW,
                    "blocks_per_sm": resident[cfg]}
            for want, how in ((1, {}), (2, {"waves": 2})):
                per = _kernels.int8_split_words(rows, kw, n, info, 132, **how)
                splits = -(-kw // per)
                assert per % c.DW == 0
                assert (splits - 1) * per < kw <= splits * per
                blocks = -(-rows // c.BM) * -(-n // c.BN) * splits
                waves = blocks / (resident[cfg] * 132)
                assert waves >= want
                assert waves / np.ceil(waves) >= 0.9
    info = {"rows": 256, "cols": 96, "words": 16, "blocks_per_sm": 1}
    assert _kernels.int8_split_words(40, 100, 96, info, 132) == 112


def test_replay_equals_plain_and_reference():
    """A packed panel (64 x 1,500 SNPs, 128 words) through both instances,
    with a split each, equals the reference's digit product in interpret
    mode and plain."""
    g = np.random.default_rng(9).integers(0, 3, size=(64, 1500)).astype(
        np.uint8)
    z = codec.pack_planar16(g)
    d = np.random.default_rng(10).integers(-64, 65, size=(1500, 12)).astype(
        np.int8)
    want = np.asarray(ref_dgemm.packed_matmul_int8(
        jnp.asarray(z), jnp.asarray(d, jnp.int32), interpret=True))
    np.testing.assert_array_equal(want, _plain(z, d))
    np.testing.assert_array_equal(replay(WIDE, z, d, 64), want)
    np.testing.assert_array_equal(replay(NARROW, z, d[:, :8], 64),
                                  want[:, :8])


@pytest.mark.parametrize("dtype,low,high,ok", [
    (torch.int8, -128, 127, True),
    (torch.int16, -128, 127, True),
    (torch.int16, -129, 0, False),
    (torch.int32, 0, 128, False),
    (torch.int64, -200, 5, False),
    (torch.uint8, 0, 200, False)])
def test_public_product_checks_the_digit_range(dtype, low, high, ok):
    """``packed_matmul_int8`` takes int8 digits as they are (in range by
    type, so nothing is read back) and reads the range of wider integers:
    both ends of [-128, 127] pass, one past either end raises."""
    rng = np.random.default_rng(int(high - low))
    z = torch.from_numpy(_words(rng, 20, 6).view(np.int32))
    d = torch.zeros((90, 3), dtype=dtype)
    d[0, 0], d[89, 2] = low, high
    if ok:
        got = packed_matmul_int8(z, d)
        assert torch.equal(got, packed_matmul_int8_plain(z, d.to(torch.int8)))
    else:
        with pytest.raises(ValueError, match=r"\[-128, 127\]"):
            packed_matmul_int8(z, d)

"""The integer crossproduct kernel's arithmetic and layouts, on the CPU.

``csrc/crossprod.cu`` cannot run here, so these tests replay in numpy what it
does: the decode of a packed word into 16 int8 contraction values
(``decode.cuh`` ``int8_quads``), the stage loader's zero-fill, the swizzled
int8 tile in shared memory with its 16-byte stores and ``ldmatrix`` phases,
the lane ownership of the mma.m16n8k32 A, B and C fragments, the cp.async
ring and the two decode buffers, the epilogue, and the walks of the three
launches: K3's banded upper tile pairs with their mirror, B8's grouped grid,
and B12's masked grid through ``_mirror_merge`` at the library's tile edge.
Each replay is held bit-equal to ``packed_crossprod_plain`` (or
``packed_crossprod_rect_plain``) and, on packed panels, to the reference's
crossproducts in Pallas interpret mode.  The kernel's constants are read
from its source.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops import grm as ref_grm  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import _kernels  # noqa: E402
from miraculix_tpu_torch.ops.common import decode_planar16  # noqa: E402
from miraculix_tpu_torch.ops.grm import (  # noqa: E402
    _mirror_merge, packed_crossprod_plain, packed_crossprod_rect_plain)

CPU = "cpu"
SRC = (Path(_kernels.__file__).parent / "csrc" / "crossprod.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)[,;]", SRC).group(1))


TILE, DW, STAGES, GROUP = (_const(n) for n in ("TILE", "DW", "STAGES",
                                                 "GROUP"))
WARPS, WM, WN = _const("WARPS"), _const("WM"), _const("WN")
THREADS = 32 * WARPS
ROW_BYTES = 16 * DW            # one decoded int8 row of a stage
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3     # a lane's group and its thread in the group


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


def _plain(za, zb=None):
    """packed_crossprod(_rect)_plain on uint32 words, as int64."""
    ta = torch.from_numpy(za.view(np.int32))
    if zb is None:
        return packed_crossprod_plain(ta).numpy().astype(np.int64)
    tb = torch.from_numpy(zb.view(np.int32))
    return packed_crossprod_rect_plain(ta, tb).numpy().astype(np.int64)


# -- the replay ---------------------------------------------------------------

def int8_quads(w):
    """decode.cuh int8_quads: register q = (w >> 2q) & 0x03030303; the
    word's 16 bytes are registers 0..3 side by side, little-endian."""
    regs = np.stack([(w >> np.uint32(2 * q)) & np.uint32(0x03030303)
                     for q in range(4)], axis=-1).astype("<u4")
    return regs.view(np.uint8).reshape(*w.shape, 16)


def swizzle(r, c):
    """Byte offset of the 16-byte chunk c of row r in a decoded tile."""
    return r * ROW_BYTES + ((c ^ (r & 7)) << 4)


def load_stage(z, row0, k0):
    """Raw words [k0, k0 + DW) of rows [row0, row0 + TILE), zero past the
    panel (cp.async with a source size of 0)."""
    out = np.zeros((TILE, DW), np.uint32)
    r1, k1 = min(z.shape[0], row0 + TILE), min(z.shape[1], k0 + DW)
    if r1 > row0 and k1 > k0:
        out[: r1 - row0, : k1 - k0] = z[row0:r1, k0:k1]
    return out


def decode_stage(raw):
    """The swizzled int8 tile of one stage, and each thread's store
    addresses [4, THREADS]: thread = (row tid >> 1, words 4 (tid & 1)..+3)."""
    dec = np.zeros(TILE * ROW_BYTES, np.uint8)
    tid = np.arange(THREADS)
    r, h = tid >> 1, tid & 1
    addrs = []
    for i in range(4):
        a = swizzle(r, 4 * h + i)
        dec[a[:, None] + np.arange(16)] = int8_quads(raw[r, 4 * h + i])
        addrs.append(a)
    return dec, np.stack(addrs)


def ldmatrix_x4(smem, addr):
    """ldmatrix .x4 .b16: lanes 8j..8j+7 give the row addresses of matrix j;
    lane l gets bytes 4 (l % 4)..+3 of row l // 4 of each matrix j as its
    register j.  addr [..., 32] -> registers [..., 32, 4] uint32."""
    regs = []
    for j in range(4):
        row = addr[..., 8 * j + LANE // 4]
        b = smem[row[..., None] + (4 * T)[:, None] + np.arange(4)]
        regs.append(b.astype("<u4") @ (256 ** np.arange(4)).astype("<u4"))
    return np.stack(regs, axis=-1).astype(np.uint32)


# m16n8k32 .s8 fragment ownership (PTX ISA): element e of lane (g, t) is
# byte e % 4 of register e // 4
E16, E8 = np.arange(16), np.arange(8)
A_ROW = G[:, None] + 8 * ((E16[None] & 4) >> 2)       # g for e in 0-3, 8-11
A_COL = 4 * T[:, None] + (E16[None] & 3) + 16 * (E16[None] >= 8)
B_K = 4 * T[:, None] + (E8[None] & 3) + 16 * (E8[None] >= 4)
B_N = np.broadcast_to(G[:, None], (32, 8))
C_ROW = G[:, None] + 8 * (np.arange(4)[None] >= 2)
C_COL = 2 * T[:, None] + (np.arange(4)[None] & 1)


def _reg_bytes(regs):
    return regs.astype("<u4").view(np.uint8).reshape(*regs.shape[:-1], -1)


def a_matrix(regs):
    """A fragments [..., 32, 4] -> the 16 x 32 int8 matrices they hold."""
    a = np.zeros(regs.shape[:-2] + (16, 32), np.int64)
    a[..., A_ROW, A_COL] = _reg_bytes(regs)
    return a


def b_matrix(regs):
    """B fragments [..., 32, 2] -> the 32 x 8 (k x n) matrices they hold."""
    b = np.zeros(regs.shape[:-2] + (32, 8), np.int64)
    b[..., B_K, B_N] = _reg_bytes(regs)
    return b


def fragments(a_dec, b_dec, kk):
    """Every warp's A fragments [WARPS, 4 (m16), 32, 4] and B fragments
    [WARPS, 4 (n8), 32, 2] of k32 step kk, loaded as the kernel addresses
    them, with the addresses [A: WARPS, 4, 32; B: WARPS, 2, 32]."""
    warp = np.arange(WARPS)[:, None, None]
    am, bn = (warp >> 2) * WM, (warp & 3) * WN
    a_addr = swizzle(am + 16 * np.arange(4)[None, :, None] + (LANE & 15),
                     2 * kk + (LANE >> 4))
    b_addr = swizzle(bn + 16 * np.arange(2)[None, :, None] + (LANE & 7)
                     + ((LANE >> 4) << 3), 2 * kk + ((LANE >> 3) & 1))
    r = ldmatrix_x4(b_dec, b_addr)                        # [W, 2, 32, 4]
    b = np.stack([r[..., 0:2], r[..., 2:4]], axis=2).reshape(WARPS, 4, 32, 2)
    return ldmatrix_x4(a_dec, a_addr), b, a_addr, b_addr


def mma_stage(a_dec, b_dec, acc):
    """acc [WARPS, 4 (m16), 4 (n8), 32, 4] += one stage's mmas."""
    for kk in range(ROW_BYTES // 32):
        a, b, _, _ = fragments(a_dec, b_dec, kk)
        d = (a_matrix(a)[:, :, None].astype(np.float64)
             @ b_matrix(b)[:, None].astype(np.float64))   # [W, 4, 4, 16, 8]
        acc += d[..., C_ROW, C_COL].astype(np.int64)


def epilogue(acc):
    """The tile [TILE, TILE] as the epilogue stages it from the C
    fragments."""
    tile = np.full((TILE, TILE), -1, np.int64)
    warp = np.arange(WARPS)[:, None, None, None, None]
    mi = np.arange(4)[None, :, None, None, None]
    ni = np.arange(4)[None, None, :, None, None]
    rows = (warp >> 2) * WM + 16 * mi + C_ROW[None, None, None]
    cols = (warp & 3) * WN + 8 * ni + C_COL[None, None, None]
    tile[rows, cols] = acc
    assert (tile >= 0).all()                   # every output owned once
    return tile


def tile_product(za, zb, row0, col0, same):
    """The kernel's tile_product, in its order: the cp.async ring (stage s
    in slot s % STAGES, refilled with stage s + STAGES), the decode one
    stage ahead into buffer s & 1, the stage's mmas."""
    nst = -(-za.shape[1] // DW)
    raw = np.zeros((STAGES, 2, TILE, DW), np.uint32)
    dec = np.zeros((2, 2, TILE * ROW_BYTES), np.uint8)
    acc = np.zeros((WARPS, 4, 4, 32, 4), np.int64)

    def load(s):
        raw[s % STAGES, 0] = load_stage(za, row0, s * DW)
        if not same:
            raw[s % STAGES, 1] = load_stage(zb, col0, s * DW)

    def decode(s):
        dec[s & 1, 0] = decode_stage(raw[s % STAGES, 0])[0]
        if not same:
            dec[s & 1, 1] = decode_stage(raw[s % STAGES, 1])[0]

    for s in range(min(STAGES, nst)):
        load(s)
    decode(0)
    for s in range(nst):
        if s + STAGES < nst:
            load(s + STAGES)
        if s + 1 < nst:
            decode(s + 1)
        mma_stage(dec[s & 1, 0], dec[s & 1, 0 if same else 1], acc)
    return epilogue(acc)


def store_tile(out, tile, row0, col0, mirror):
    r1, c1 = min(out.shape[0], row0 + TILE), min(out.shape[1], col0 + TILE)
    out[row0:r1, col0:c1] = tile[: r1 - row0, : c1 - col0]
    if mirror:
        out[col0:c1, row0:r1] = tile[: r1 - row0, : c1 - col0].T


def upper_pair(p):
    """decode.cuh upper_pair: p = bj (bj + 1) / 2 + bi, bi <= bj."""
    bj = int((math.sqrt(8.0 * p + 1.0) - 1.0) * 0.5)
    while bj * (bj + 1) // 2 > p:
        bj -= 1
    while (bj + 1) * (bj + 2) // 2 <= p:
        bj += 1
    return p - bj * (bj + 1) // 2, bj


def band_pair(p, nt):
    """K3's walk: bands of GROUP tile rows, each its triangle, then its
    columns to the right with the band's rows innermost."""
    b0 = 0
    while True:
        h = min(GROUP, nt - b0)
        tri = h * (h + 1) // 2
        cnt = tri + h * (nt - b0 - h)
        if p < cnt:
            if p < tri:
                bi, bj = upper_pair(p)
                return b0 + bi, b0 + bj
            q = p - tri
            return b0 + q % h, b0 + h + q // h
        p -= cnt
        b0 += GROUP


def group_pair(p, ta, tb):
    """The rectangular grid's walk: GROUP tile rows per column."""
    per = GROUP * tb
    b0 = p // per * GROUP
    h = min(GROUP, ta - b0)
    return b0 + p % per % h, p % per // h


def k3(z):
    rows = z.shape[0]
    nt = -(-rows // TILE)
    out = np.full((rows, rows), -1, np.int64)
    for p in range(nt * (nt + 1) // 2):
        bi, bj = band_pair(p, nt)
        store_tile(out, tile_product(z, z, bi * TILE, bj * TILE, bi == bj),
                   bi * TILE, bj * TILE, bi != bj)
    return out


def rect(za, zb, upper=False, one_buffer=False, unwritten=-1):
    """B8 (B12 with ``upper``); ``one_buffer``: za and zb start at one
    address (the kernel's za == zb)."""
    (ra, _), (rb, _) = za.shape, zb.shape
    ta, tb = -(-ra // TILE), -(-rb // TILE)
    out = np.full((ra, rb), unwritten, np.int64)
    for p in range(ta * tb):
        bi, bj = group_pair(p, ta, tb)
        if upper and bj < bi:
            continue
        same = one_buffer and ra == rb and bi == bj
        store_tile(out, tile_product(za, zb, bi * TILE, bj * TILE, same),
                   bi * TILE, bj * TILE, False)
    return out


# -- the word map and the layouts ---------------------------------------------

def test_word_to_int8_quads_map():
    """Byte 4q + b of a word's 16 bytes is plane 4b + q, for every plane
    and code; the kernel's constants are the ones this replay assumes."""
    assert (TILE, WARPS * WM * WN) == (128, TILE * TILE)
    assert TILE * DW == 4 * THREADS        # decode: 4 words a thread
    codes = np.arange(4, dtype=np.uint32)
    for plane in range(16):
        w = codes << np.uint32(2 * plane)
        quads = int8_quads(w)
        q, b = plane % 4, plane // 4
        np.testing.assert_array_equal(quads[:, 4 * q + b], codes)
        others = np.delete(quads, 4 * q + b, axis=1)
        assert not others.any()


def test_quads_dot_is_the_crossproduct():
    """Rows of int8 quads (word w -> bytes 16w..16w+15) dot to the plain
    crossproduct: one k order shared by both operands."""
    z = _words(np.random.default_rng(0), 40, 9)
    q = int8_quads(z).reshape(40, -1).astype(np.int64)
    np.testing.assert_array_equal(q @ q.T, _plain(z))
    dec = decode_planar16(torch.from_numpy(z.view(np.int32)),
                          torch.float64).numpy()
    np.testing.assert_array_equal(np.sort(q, axis=1), np.sort(dec, axis=1))


def _groups(addr):
    """16-byte bank groups (of 8) of byte addresses."""
    return (addr // 16) % 8


def test_shared_memory_phases_are_conflict_free():
    """Every 8-lane phase of the decode's 16-byte stores, its 16-byte raw
    reads and each ldmatrix matrix touch 8 distinct bank groups; the
    epilogue's row and mirror reads 32 distinct banks."""
    raw = _words(np.random.default_rng(1), TILE, DW)
    dec, stores = decode_stage(raw)
    phases = stores.reshape(4, THREADS // 8, 8)
    assert all(len(set(p)) == 8 for p in _groups(phases).reshape(-1, 8))
    tid = np.arange(THREADS)
    reads = 4 * ((tid >> 1) * DW + 4 * (tid & 1))
    assert all(len(set(p)) == 8 for p in _groups(reads).reshape(-1, 8))
    for kk in range(ROW_BYTES // 32):
        _, _, a_addr, b_addr = fragments(dec, dec, kk)
        for addr in (a_addr, b_addr):
            assert all(len(set(p)) == 8
                       for p in _groups(addr).reshape(-1, 8))
    ld = TILE + int(re.search(r"OUT_LD = TILE \+ (\d+);", SRC).group(1))
    for i in range(TILE // 32):
        r = LANE + 32 * i
        assert len(set((r * ld + 5) % 32)) == 32        # mirror: column 5
        assert len(set((5 * ld + r) % 32)) == 32        # row 5


def test_fragments_hold_the_decoded_tile():
    """Through the swizzle and ldmatrix, each warp's A fragments are its 64
    rows and its B fragments its 32 rows of the stage's int8 K slice, in
    the mma's ownership; the ownership maps are one-to-one."""
    for row, col, shape in ((A_ROW, A_COL, (16, 32)), (B_K, B_N, (32, 8)),
                            (C_ROW, C_COL, (16, 8))):
        flat = np.ravel_multi_index((row.ravel(), col.ravel()), shape)
        assert np.array_equal(np.sort(flat), np.arange(np.prod(shape)))
    rng = np.random.default_rng(2)
    za, zb = _words(rng, TILE, DW), _words(rng, TILE, DW)
    qa = int8_quads(za).reshape(TILE, ROW_BYTES)
    qb = int8_quads(zb).reshape(TILE, ROW_BYTES)
    da, db = decode_stage(za)[0], decode_stage(zb)[0]
    for kk in range(ROW_BYTES // 32):
        a, b, _, _ = fragments(da, db, kk)
        ks = slice(32 * kk, 32 * kk + 32)
        for w in range(WARPS):
            am, bn = (w >> 2) * WM, (w & 3) * WN
            for i in range(4):
                np.testing.assert_array_equal(
                    a_matrix(a[w, i]), qa[am + 16 * i: am + 16 * i + 16, ks])
                np.testing.assert_array_equal(
                    b_matrix(b[w, i]), qb[bn + 8 * i: bn + 8 * i + 8, ks].T)


@pytest.mark.parametrize("kw", [8, 12, 64, 1024])
def test_whole_16_byte_copies_where_kw_is_a_multiple_of_4(kw):
    """The 16-byte copy path (kw % 4 == 0) zero-fills whole 4-word chunks:
    a chunk that starts inside the row ends inside it."""
    for k0 in range(0, kw, DW):
        for c in (0, 4):
            assert (k0 + c < kw) == (k0 + c + 3 < kw)


# -- tiles and walks ----------------------------------------------------------

@pytest.mark.parametrize("rows,kw,same", [(128, 8, False), (128, 8, True),
                                          (97, 37, False), (128, 33, True),
                                          (64, 100, False)])
def test_tile_product_replay_is_exact(rows, kw, same):
    """One tile through the ring (past its depth at kw 37 and 100), the
    decode, fragments and epilogue; rows past the panel and words past kw
    read as 0."""
    rng = np.random.default_rng(rows + kw)
    za = _words(rng, rows, kw)
    zb = za if same else _words(rng, rows, kw)
    tile = tile_product(za, zb, 0, 0, same)
    np.testing.assert_array_equal(tile[:rows, :rows], _plain(za, zb))
    assert not tile[rows:].any() and not tile[:, rows:].any()


@pytest.mark.parametrize("nt", [1, 2, 7, 8, 9, 17, 130])
def test_band_walk_covers_the_upper_pairs_once(nt):
    pairs = [band_pair(p, nt) for p in range(nt * (nt + 1) // 2)]
    assert sorted(pairs) == [(i, j) for i in range(nt)
                             for j in range(i, nt)]


@pytest.mark.parametrize("ta,tb", [(1, 1), (1, 5), (5, 1), (8, 3), (9, 4),
                                   (36, 32), (64, 64)])
def test_group_walk_covers_the_grid_once(ta, tb):
    pairs = [group_pair(p, ta, tb) for p in range(ta * tb)]
    assert sorted(pairs) == [(i, j) for i in range(ta) for j in range(tb)]


def test_walks_keep_few_panels_in_flight():
    """At the smoke's shapes, any 264 consecutive blocks (two an SM on 132
    SMs) touch few row and column panels.  A window spans at most two bands
    (2 GROUP row panels) and one column per band row group, plus a band
    triangle's GROUP columns: 3 GROUP + 264 / GROUP + 1 = 58 panels.  K3 at
    16,384 rows reads 55 (its column-major upper-pair order 131), the
    grm_blocked tile 8,192 x 8,192 reads 49 (a row-major grid 69)."""
    def most_panels(pairs, window=264):
        return max(len({i for i, _ in pairs[s:s + window]})
                   + len({j for _, j in pairs[s:s + window]})
                   for s in range(0, len(pairs) - window + 1, 8))
    limit = 3 * GROUP + 264 // GROUP + 1
    nt, grid = 128, 64
    k3_walk = [band_pair(p, nt) for p in range(nt * (nt + 1) // 2)]
    assert most_panels(k3_walk) <= limit
    assert most_panels([upper_pair(p) for p in range(len(k3_walk))]) > limit
    assert most_panels([group_pair(p, grid, grid)
                        for p in range(grid * grid)]) <= limit
    assert most_panels([divmod(p, grid) for p in range(grid * grid)]) > limit


@pytest.mark.parametrize("rows,kw", [(1, 1), (129, 9), (300, 37)])
def test_k3_replay_equals_plain(rows, kw):
    z = _words(np.random.default_rng(rows * kw), rows, kw)
    np.testing.assert_array_equal(k3(z), _plain(z))


@pytest.mark.parametrize("ra,rb,kw", [(300, 129, 13), (129, 300, 13),
                                      (1, 257, 3)])
def test_b8_replay_equals_plain(ra, rb, kw):
    rng = np.random.default_rng(ra + rb + kw)
    za, zb = _words(rng, ra, kw), _words(rng, rb, kw)
    np.testing.assert_array_equal(rect(za, zb), _plain(za, zb))


@pytest.mark.parametrize("ra,rb", [(300, 129), (129, 300)])
def test_b8_replay_on_row_views_of_one_buffer(ra, rb):
    """Two row views of one buffer (one start address, two ends) do not
    share a decode: each side reads to its own end."""
    z = _words(np.random.default_rng(ra), 300, 11)
    np.testing.assert_array_equal(rect(z[:ra], z[:rb], one_buffer=True),
                                  _plain(z[:ra], z[:rb]))


@pytest.fixture(scope="module")
def panel():
    """300 animals x 500 SNPs, packed by both packages (512 x 128 words:
    four tiles a side, sixteen stages)."""
    g = bed.simulate_genotypes(300, 500, seed=11)
    ref, port = mx.from_dense(g), mt.from_dense(g, device=CPU)
    z = port.zq_n.numpy().view(np.uint32)
    np.testing.assert_array_equal(z, np.asarray(ref.zq_n).view(np.uint32))
    return ref, z


def test_k3_replay_equals_plain_and_reference(panel):
    ref, z = panel
    want = np.asarray(ref_grm.packed_crossprod(ref.zq_n, interpret=True))
    got = k3(z)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _plain(z))


def test_b12_replay_through_the_mirror_merge(panel):
    """B12 leaves exactly the tiles wholly below the diagonal unwritten; the
    merge at the library's tile edge restores them, equal to the
    reference's masked grid (wrap=False) and to plain."""
    ref, z = panel
    got = rect(z, z, upper=True, one_buffer=True, unwritten=-7)
    blk = np.arange(z.shape[0]) // TILE
    np.testing.assert_array_equal(got == -7, blk[None, :] < blk[:, None])
    merged = _mirror_merge(torch.from_numpy(got), TILE).numpy()
    want = np.asarray(ref_grm.packed_crossprod(
        ref.zq_n, tile_i=128, tile_j=256, wrap=False, interpret=True))
    np.testing.assert_array_equal(merged, want)
    np.testing.assert_array_equal(merged, _plain(z))


def test_b8_replay_equals_reference(panel):
    ref, z = panel
    want = np.asarray(ref_grm.packed_crossprod_rect(
        ref.zq_n[:300], ref.zq_n[:129], tile_m=128, tile_kw=128,
        interpret=True))
    got = rect(z[:300], z[:129], one_buffer=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _plain(z[:300], z[:129]))

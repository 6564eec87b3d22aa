"""The weighted crossproduct kernel's (B9) arithmetic and layout, on the CPU.

``csrc/crossprod_weighted.cu`` cannot run here, so these tests replay in
numpy what it does: the pre-pass's three masked bf16 digits of w, in the
mma k order (lane (g, t) holds planes t, t+8 at k 2t, 2t+1 and planes t+4,
t+12 at k 2t+8, 2t+9) as pairs [word][t][digit]; each lane's A and B
registers (one shift, a mask and OR and one bf16x2 subtraction of a raw
word; B times the digit pair, one bf16x2 product); the mma.m16n8k16 sums
over the PTX ISA's fragment ownership, each digit's sum from zero over one
stage, the digits promoted smallest first into an f32 total; the upper tile
walk with its mirror, and the full grid.  The replay is held to the
reference's ``_plane_prod_weighted`` (called directly), to its
``packed_crossprod_weighted`` in Pallas interpret mode and to the port's
plain version, at the reference tests' 5e-6 of max; a replay that keeps one
or two digits fails that tolerance.  The kernel's constants and the
expressions the replay copies are read from its source.
"""
import inspect
import math
import re
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops import grm as ref_grm  # noqa: E402
from test_torch_tall import _bf16_pair  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import _kernels  # noqa: E402
from miraculix_tpu_torch.ops import grm as pt_grm  # noqa: E402

CSRC = Path(_kernels.__file__).parent / "csrc"
SRC = (CSRC / "crossprod_weighted.cu").read_text()
FLAT = " ".join(SRC.split())
EDGE, KS, STAGES, MIN_BLOCKS = map(int, re.search(
    r"using Cfg = Shape<(\d+), (\d+), (\d+), (\d+)>;", SRC).groups())
DIGITS = int(re.search(r"constexpr int DIGITS = (\d+);", SRC).group(1))
TILE = 32 * EDGE
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3     # a lane's group and its thread in the group
# the k order: k 2t, 2t+1, 2t+8, 2t+9 hold planes t, t+8, t+4, t+12
K_PLANE = np.zeros(16, int)
for _t in range(4):
    K_PLANE[[2 * _t, 2 * _t + 1, 2 * _t + 8, 2 * _t + 9]] = \
        [_t, _t + 8, _t + 4, _t + 12]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_digits3():
    """The reference's own split, ``_digits3`` of
    ``miraculix_tpu/ops/grm.py:_plane_prod_weighted``, run from its source."""
    src = inspect.getsource(ref_grm._plane_prod_weighted)
    body = re.search(r"\n(    def _digits3\(wz\):.*?)\n\n", src, re.S).group(1)
    ns = {"jax": jax, "jnp": jnp, "mask": jnp.int32(-65536)}
    exec(textwrap.dedent(body), ns)
    return ns["_digits3"]


def split3(x: np.ndarray) -> np.ndarray:
    """split3 of the source: float32 [...] -> its digits float32 [3, ...]:
    h1 = x & 0xFFFF0000, h2 = (x - h1) & 0xFFFF0000, h3 = x - h1 - h2."""
    x = np.asarray(x, np.float32)
    mask = np.uint32(0xFFFF0000)
    h1 = (x.view(np.uint32) & mask).view(np.float32)
    r1 = x - h1
    h2 = (r1.view(np.uint32) & mask).view(np.float32)
    return np.stack([h1, h2, r1 - h2])


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 values exact in bf16 -> their bf16 bits (asserting so)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    assert not (u & np.uint32(0xFFFF)).any(), "not exact in bf16"
    return u >> np.uint32(16)


def _weights(rng, n, lo=-8.0, hi=7.0, signs=True):
    """Weights log-uniform over [10^lo, 10^hi], of both signs."""
    w = (10.0 ** rng.uniform(lo, hi, n)).astype(np.float32)
    if signs:
        w *= rng.choice(np.float32([-1.0, 1.0]), n)
    return w


def _geno_words(rng, rows, kw):
    """Random planar16 words whose fields are 0, 1 or 2 (genotypes)."""
    z = rng.integers(0, 2 ** 32, size=(rows, kw), dtype=np.uint64).astype(
        np.uint32)
    return z & ~(((z & (z >> np.uint32(1))) & np.uint32(0x55555555))
                 << np.uint32(1))


def prepass(w16: np.ndarray) -> np.ndarray:
    """The digit buffer as weighted_digits writes it: uint32 [kwp, 4 t,
    DIGITS, 2] (.x: the digit of planes t (low half) and t+8; .y: planes
    t+4, t+12), kwp = kw rounded up to whole stages, zero past kw."""
    kw = w16.shape[1]
    kwp = -(-kw // KS) * KS
    wp = np.zeros((16, kwp), np.float32)
    wp[:, :kw] = w16
    bits = _bf16_bits(split3(wp))                     # [3, 16, kwp]
    out = np.zeros((kwp, 4, DIGITS, 2), np.uint32)
    for t in range(4):
        for d in range(DIGITS):
            out[:, t, d, 0] = bits[d, t] | bits[d, t + 8] << np.uint32(16)
            out[:, t, d, 1] = bits[d, t + 4] | bits[d, t + 12] << np.uint32(16)
    return out


def _plane_pair(x: np.ndarray, shift: int) -> np.ndarray:
    """decode.cuh's plane_pair_bf16 on x = word >> 2t, as float32 pairs."""
    v = ((x >> np.uint32(shift)) & np.uint32(0x00030003)) \
        | np.uint32(0x43004300)
    return _bf16_pair(v) - np.float32(128.0)


def _padded(z: np.ndarray, rows: int, kwp: int) -> np.ndarray:
    """Words of ``rows`` rows (a multiple of 16) and kwp words, zero past
    the panel: what the stage copies fill in."""
    zp = np.zeros((rows, kwp), np.uint32)
    zp[:z.shape[0], :z.shape[1]] = z
    return zp


def a_fragments(z: np.ndarray) -> np.ndarray:
    """The A matrices [row tiles, words, 16 rows, 16 k] that the lanes' A
    registers hold: lane (g, t) shifts the words of rows g and g+8 by 2t
    and takes the plane pairs at bit 0 (a[0], a[1]) and bit 8 (a[2],
    a[3])."""
    rt = z.shape[0] // 16
    zt = z.reshape(rt, 16, -1).transpose(0, 2, 1)         # [tile, w, row]
    x0 = zt[:, :, G] >> (2 * T).astype(np.uint32)         # [tile, w, lane]
    x1 = zt[:, :, G + 8] >> (2 * T).astype(np.uint32)
    regs = [_plane_pair(x0, 0), _plane_pair(x1, 0), _plane_pair(x0, 8),
            _plane_pair(x1, 8)]                            # [tile, w, lane, 2]
    a = np.full((rt, zt.shape[1], 16, 16), np.nan, np.float32)
    for r, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for h in range(2):
            a[:, :, G + dr, 2 * T + dk + h] = regs[r][..., h]
    assert not np.isnan(a).any(), "an A entry no lane holds"
    return a


def b_fragments(z: np.ndarray, dg: np.ndarray) -> np.ndarray:
    """The B matrices [column tiles, words, DIGITS, 16 k, 8 columns] of
    digit d: lane (g, t) decodes the word of column g shifted by 2t at bit
    0 (b.x) and bit 8 (b.y) and multiplies each pair by its digit pair
    (bf16x2: exact, checked)."""
    ct = z.shape[0] // 8
    zt = z.reshape(ct, 8, -1).transpose(0, 2, 1)          # [tile, w, col]
    y = zt[:, :, G] >> (2 * T).astype(np.uint32)          # [tile, w, lane]
    regs = [_plane_pair(y, 0), _plane_pair(y, 8)]          # [tile, w, lane, 2]
    b = np.full((ct, zt.shape[1], DIGITS, 16, 8), np.nan, np.float32)
    for d in range(DIGITS):
        for r in range(2):
            wd = _bf16_pair(dg[:, T, d, r])                # [w, lane, 2]
            prod = regs[r] * wd[None]
            _bf16_bits(prod)                               # exact in bf16
            for h in range(2):
                b[:, :, d, 2 * T + 8 * r + h, G] = prod[..., h]
    assert not np.isnan(b).any(), "a B entry no lane holds"
    return b


def upper_pair(p):
    """decode.cuh upper_pair: p = bj (bj + 1) / 2 + bi, bi <= bj."""
    bj = int((math.sqrt(8.0 * p + 1.0) - 1.0) * 0.5)
    while bj * (bj + 1) // 2 > p:
        bj -= 1
    while (bj + 1) * (bj + 2) // 2 <= p:
        bj += 1
    return p - bj * (bj + 1) // 2, bj


def tile_pairs(rows, full):
    nt = -(-rows // TILE)
    if full:
        return [(bi, bj) for bi in range(nt) for bj in range(nt)]
    return [upper_pair(p) for p in range(nt * (nt + 1) // 2)]


def stage_sums(a, b, w0):
    """Each digit's mma sum over the stage's words [w0, w0 + KS) of one
    (row tile, column tile): float64 (the products z_i * (z_j * h_d) are
    exact and a stage's sum of them fits), then the f32 accumulator."""
    ws = slice(w0, w0 + KS)
    return np.einsum("wrk,wdkc->drc", a[ws].astype(np.float64),
                     b[ws].astype(np.float64)).astype(np.float32)


def replay(z: np.ndarray, w16: np.ndarray, full: bool = False) -> np.ndarray:
    """The kernel's result [rows, rows]: each block (tile pair) runs its
    warps' 32 x 32 tiles stage by stage, each digit's sum from zero, the
    digits added smallest first and then to the f32 total; the lanes'
    accumulators stored through the C fragment layout, and the mirror of
    an off-diagonal pair of the upper walk."""
    rows, kw = z.shape
    kwp = -(-kw // KS) * KS
    nt = -(-rows // TILE)
    zp = _padded(z, nt * TILE, kwp)
    a = a_fragments(zp)                   # [row tile 16, w, 16, 16]
    b = b_fragments(zp, prepass(w16))   # [col tile 8, w, d, 16, 8]
    out = np.full((rows, rows), np.nan, np.float32)
    c_row = G[:, None] + 8 * (np.arange(4)[None, :] >> 1)    # [lane, e]
    c_col = 2 * T[:, None] + (np.arange(4)[None, :] & 1)
    for bi, bj in tile_pairs(rows, full):
        mirror = not full and bi != bj
        for warp in range(EDGE * EDGE):
            wr = (warp % EDGE) * 32
            wc = (warp // EDGE) * 32
            for mi in range(2):
                for u in range(4):
                    it = (bi * TILE + wr) // 16 + mi
                    jt = (bj * TILE + wc) // 8 + u
                    acc = np.zeros((16, 8), np.float32)
                    for w0 in range(0, kwp, KS):
                        d = stage_sums(a[it], b[jt], w0)
                        total = d[DIGITS - 1]
                        for p in range(DIGITS - 2, -1, -1):
                            total = total + d[p]
                        acc += total
                    r = bi * TILE + wr + 16 * mi + c_row
                    c = bj * TILE + wc + 8 * u + c_col
                    ok = (r < rows) & (c < rows)
                    vals = acc[c_row, c_col]
                    out[r[ok], c[ok]] = vals[ok]
                    if mirror:
                        out[c[ok], r[ok]] = vals[ok]
    assert not np.isnan(out).any(), "an output no block writes"
    return out


def _w16(w, kw):
    wp = np.zeros(16 * kw, np.float32)
    wp[:len(w)] = w
    return wp.reshape(16, kw)


def _decode(z):
    return np.concatenate([(z >> np.uint32(2 * m)) & np.uint32(3)
                           for m in range(16)], axis=1).astype(np.float64)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------


def test_replay_follows_the_source():
    """The constants and the expressions this replay copies stand in the
    kernel's source (and the bf16 mma in mma.cuh); no f32-FMA product."""
    assert DIGITS == 3 and KS % 4 == 0 and STAGES >= 2 and EDGE >= 1
    mma = " ".join((CSRC / "mma.cuh").read_text().split())
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    for expr in (
            "__float_as_uint(x) & 0xFFFF0000u",
            "const float h1 = mask_hi(x);", "const float r1 = x - h1;",
            "const float h2 = mask_hi(r1);", "const float h3 = r1 - h2;",
            "const int plane[4] = {t, t + 8, t + 4, t + 12};",
            "make_uint2(h[0][d] | h[1][d] << 16, h[2][d] | h[3][d] << 16)",
            "dg[i * DIGITS + d]", "const int sh = 2 * t;",
            "wa[i] = *reinterpret_cast<const uint2*>(za + 8 * i * ZS + 2 * q)",
            "a[mi][0] = mx::plane_pair_bf16(x0, 0);",
            "a[mi][1] = mx::plane_pair_bf16(x1, 0);",
            "a[mi][2] = mx::plane_pair_bf16(x0, 8);",
            "a[mi][3] = mx::plane_pair_bf16(x1, 8);",
            "b[u][0] = mx::plane_pair_bf16(y, 0);",
            "b[u][1] = mx::plane_pair_bf16(y, 8);",
            "make_uint2(hmul2(b[u][0], wd[dd].x), hmul2(b[u][1], wd[dd].y))",
            "wd[dd] = ds[kk * 4 * DIGITS + dd];",
            "if (kk == 0) mx::mma_bf16_zero(d[dd][mi][u], a[mi], bw);",
            "float sum = d[P - 1][mi][u][e];",
            "for (int p = P - 2; p >= 0; --p) sum += d[p][mi][u][e];",
            "acc[mi][u][e] += sum;",
            "const int wr = (warp % S::EDGE) * 32, "
            "wc = (warp / S::EDGE) * 32;",
            "const int r = row0 + wr + 16 * mi + g + 8 * (e >> 1);",
            "const int c = col0 + wc + 8 * u + 2 * t + (e & 1);",
            "const bool mirror = !full && bi != bj;",
            "mx::upper_pair(blockIdx.x, bi, bj);"):
        assert expr in FLAT or expr in mma, expr
    # one promotion a stage, after its last K-step
    assert re.search(r"\}\s*mx::promote<DIGITS, MI, NT>\(acc, d\);[^\n]*"
                     r"\s*\}\s*mx::cp_async_wait<0>", SRC)
    assert "fmaf" not in SRC and "geno(" not in SRC


def test_split_is_the_references_and_exact():
    """The mask split equals the reference's own ``_digits3`` bit for bit
    (on w * z, as the reference splits it), each digit is exact in bf16,
    and the three sum to w exactly, over weights of both signs from 1e-8
    to 1e7, zeros and f32's extremes of that range."""
    rng = np.random.default_rng(0)
    w = _weights(rng, 20000)
    w[:6] = [0.0, -0.0, 1e-8, -1e7, np.float32(1) / 3, 2.0 ** 24 + 1]
    mine = split3(w)
    ref = _reference_digits3()(jnp.asarray(w))
    for d in range(DIGITS):
        r = np.asarray(ref[d].astype(jnp.float32))
        np.testing.assert_array_equal(mine[d].view(np.uint32),
                                      r.view(np.uint32))
        _bf16_bits(mine[d])
    total = mine[0] + mine[1]
    np.testing.assert_array_equal(mine[2] + total, w)   # exact, any order
    np.testing.assert_array_equal(mine[0] + (mine[1] + mine[2]), w)
    assert (np.abs(mine[1]) <= np.abs(w) * 2.0 ** -7).all()
    assert (np.abs(mine[2]) <= np.abs(w) * 2.0 ** -15).all()


@pytest.mark.parametrize("z", [0, 1, 2])
def test_z_times_digits_are_the_digits_of_z_times_w(z):
    """z * digits(w) = digits(z * w) bit for bit for a genotype z, and each
    product is exact in bf16 (the kernel's __hmul2 of a decoded pair by a
    digit pair rounds nothing): the digits the kernel multiplies are those
    the reference splits from w * z."""
    rng = np.random.default_rng(z)
    w = _weights(rng, 20000)
    zw = split3(np.float32(z) * w)
    dz = np.float32(z) * split3(w)
    np.testing.assert_array_equal(zw, dz)     # by value: z = 0 signs zeros
    ref = _reference_digits3()(jnp.float32(z) * jnp.asarray(w))
    for d in range(DIGITS):
        _bf16_bits(dz[d])
        np.testing.assert_array_equal(np.asarray(ref[d].astype(jnp.float32)),
                                      dz[d])


@pytest.mark.parametrize("kw", [1, 31, 32, 33, 70])
def test_prepass_order_and_zeros(kw):
    """Each digit pair holds, at k = 2t, 2t+1 (.x) and 2t+8, 2t+9 (.y), the
    digit of w at plane K_PLANE[k] of word s; zero past kw (up to whole
    stages).  The weights h1 and h1 + h2 split as (h1, 0, 0) and (h1, h2,
    0): the kernel on them is the kernel at one and two digits, the grade
    controls of the card test and the smoke."""
    rng = np.random.default_rng(kw)
    w16 = _weights(rng, 16 * kw).reshape(16, kw)
    dg = prepass(w16)
    assert dg.shape == (-(-kw // KS) * KS, 4, DIGITS, 2)
    digits = split3(w16)
    for s in range(dg.shape[0]):
        for t in range(4):
            for d in range(DIGITS):
                pair = np.concatenate([_bf16_pair(dg[s, t, d, 0]),
                                       _bf16_pair(dg[s, t, d, 1])])
                ks = (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)
                want = [digits[d, K_PLANE[k], s] if s < kw else 0.0
                        for k in ks]
                np.testing.assert_array_equal(pair, np.float32(want))
    one = prepass(digits[0])
    assert not one[:, :, 1:].any()
    np.testing.assert_array_equal(one[:, :, 0], dg[:, :, 0])
    two = prepass(digits[0] + digits[1])
    assert not two[:, :, 2:].any()
    np.testing.assert_array_equal(two[:, :, :2], dg[:, :, :2])


def test_fragments_hold_the_planes_in_one_k_order():
    """Lane (g, t)'s A registers hold, at k, plane K_PLANE[k] of the words
    of rows g and g+8; its B registers of digit d hold plane K_PLANE[k] of
    the word of column g times that plane's digit: both sides share one k
    order, so each K-step sums z_i z_j h_d over the word's 16 planes."""
    assert sorted(K_PLANE.tolist()) == list(range(16))
    rng = np.random.default_rng(5)
    z = _geno_words(rng, 32, 9)
    z[:3, 0] = [0x00000000, 0x55555555, 0xAAAAAAAA]
    w16 = _weights(rng, 16 * 9).reshape(16, 9)
    dg = prepass(w16)
    a = a_fragments(_padded(z, 32, dg.shape[0]))
    b = b_fragments(_padded(z, 32, dg.shape[0]), dg)
    digits = split3(w16)
    for r in range(32):
        for w in range(9):
            planes = ((z[r, w] >> (2 * K_PLANE).astype(np.uint32)) & 3)
            np.testing.assert_array_equal(a[r // 16, w, r % 16], planes)
            for d in range(DIGITS):
                np.testing.assert_array_equal(
                    b[r // 8, w, d, :, r % 8],
                    planes.astype(np.float32) * digits[d, K_PLANE, w])
    assert not a[:, 9:].any() and not b[:, 9:].any()   # words past kw


def test_stage_sums_add_up_to_the_weighted_product():
    """Per stage, the three digits' sums of one tile add up to the
    float64 weighted product of the stage's words (the digits sum to w)."""
    rng = np.random.default_rng(6)
    kw = 2 * KS
    z = _geno_words(rng, 16, kw)
    w16 = _weights(rng, 16 * kw, -3, 3, signs=False).reshape(16, kw)
    a = a_fragments(z).astype(np.float64)
    b = b_fragments(z, prepass(w16)).astype(np.float64)
    dz = _decode(z)
    for w0 in (0, KS):
        d = np.einsum("wrk,wdkc->drc", a[0, w0:w0 + KS], b[0, w0:w0 + KS])
        cols = np.concatenate([m * kw + np.arange(w0, w0 + KS)
                               for m in range(16)])
        want = (dz[:, cols] * w16.reshape(-1)[cols].astype(np.float64)) \
            @ dz[:8, cols].T
        np.testing.assert_allclose(d.sum(axis=0), want, rtol=1e-13)


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 129, 200, 257])
def test_walk_covers_every_output(rows):
    """The upper walk visits each tile pair (bi <= bj) once and, with the
    mirror, writes every output; the full grid visits every tile."""
    nt = -(-rows // TILE)
    pairs = tile_pairs(rows, False)
    assert sorted(pairs) == sorted((i, j) for j in range(nt)
                                   for i in range(j + 1))
    hits = np.zeros((nt * TILE, nt * TILE), int)
    for bi, bj in pairs:
        hits[bi * TILE:(bi + 1) * TILE, bj * TILE:(bj + 1) * TILE] += 1
        if bi != bj:
            hits[bj * TILE:(bj + 1) * TILE, bi * TILE:(bi + 1) * TILE] += 1
    assert (hits == 1).all()
    assert len(tile_pairs(rows, True)) == nt * nt


@pytest.mark.parametrize("rows,kw,snps", [(150, 37, 590), (65, 33, 528),
                                          (129, 31, 400), (64, 5, 80)])
@pytest.mark.parametrize("full", [False, True])
def test_replay_matches_plain(rows, kw, snps, full):
    """Ragged rows (off the 64-row tile) and words (off the 32-word stage):
    the replay within 1e-6 of each output's sum of |terms| of the port's
    plain version on mixed-sign weights, and symmetric bit for bit."""
    rng = np.random.default_rng(rows + kw)
    z = _geno_words(rng, rows, kw)
    w = _weights(rng, snps, -4, 4)
    got = replay(z, _w16(w, kw), full=full)
    zt = torch.from_numpy(z.view(np.int32))
    want = pt_grm.packed_crossprod_weighted_plain(zt, w).double().numpy()
    scale = pt_grm.packed_crossprod_weighted_plain(zt, np.abs(w)).double()
    assert np.all(np.abs(got - want) <= 1e-6 * scale.numpy() + 1e-30)
    np.testing.assert_array_equal(got, got.T)


def test_promotion_keeps_positive_sums():
    """Positive weights over 65,536 terms (the sums grow without
    cancelling): the replay's per-stage promotions stay within 4e-6 (the
    smoke's limit) of each output's float64 product."""
    rng = np.random.default_rng(4)
    kw = 4096
    z = _geno_words(rng, 16, kw)
    w16 = rng.uniform(0.5, 2.0, (16, kw)).astype(np.float32)
    got = replay(z, w16)
    dz = _decode(z)
    want = (dz * w16.reshape(-1).astype(np.float64)) @ dz.T
    assert np.all(np.abs(got - want) <= 4e-6 * want)


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(150, 700, seed=31)
    ref, port = mx.from_dense(g), mt.from_dense(g, device="cpu")
    w = np.random.default_rng(0).uniform(0.1, 3.0, 700).astype(np.float32)
    z = port.zq_n.numpy().view(np.uint32)
    w16 = _w16(w, z.shape[1])
    want = {tri: np.asarray(ref_grm.packed_crossprod_weighted(
        ref.zq_n, jnp.asarray(w), tile_m=128, tile_kw=128, interpret=True,
        triangle=tri), np.float64)[:150, :150] for tri in (True, False)}
    return ref, port, w, z, w16, replay(z, w16), want


def test_replay_matches_the_references_plane_product(panel):
    """On a packed panel (150 x 700 SNPs, 256 x 128 words), the replay
    against the reference's ``_plane_prod_weighted`` called directly on
    the whole panel (its jnp body, no Pallas call), at 5e-6 of max."""
    ref, _, _, z, w16, got, _ = panel
    zq = jnp.asarray(np.asarray(ref.zq_n))
    want = np.asarray(ref_grm._plane_prod_weighted(zq, zq, jnp.asarray(w16)),
                      np.float64)
    assert _rel(got, want) < 5e-6


@pytest.mark.parametrize("triangle", [True, False])
def test_replay_matches_reference_and_plain(panel, triangle):
    """The replay (upper walk and full grid) against the reference's
    ``packed_crossprod_weighted`` in interpret mode and the port's plain
    version, at 5e-6 of max (tests/test_torch_grm_family.py's tolerance)."""
    _, port, w, z, w16, tri, want = panel
    got = tri if triangle else replay(z, w16, full=True)
    assert _rel(got[:150, :150], want[triangle]) < 5e-6
    plain = pt_grm.packed_crossprod_weighted_plain(port.zq_n, w).numpy()
    assert _rel(got, plain) < 5e-6
    np.testing.assert_array_equal(got, tri)


@pytest.mark.parametrize("digits", [1, 2])
def test_fewer_digits_fail_the_tolerance(panel, digits):
    """The grade control: the replay with one or two of the three digits
    (on the weights h1 and h1 + h2, whose splits have only those) misses
    the reference by more than 5e-6 of max (a split that folds to fewer
    digits would show)."""
    _, _, _, z, w16, _, want = panel
    got = replay(z, split3(w16)[:digits].sum(axis=0))
    assert _rel(got[:150, :150], want[True]) > 5e-6

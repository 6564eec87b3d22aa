"""The wide kernel's (B3, B4, B5, B11) arithmetic and layouts, on the CPU.

``csrc/wide_dgemm.cu`` cannot run here, so these tests replay in numpy what
it does: the pre-pass's bf16 parts of B in mma B-fragment order (rows
m*kw + w in the A fragment's k order, zero past ``cols``, ``n`` and kw),
each lane's A registers (one shift, a mask and OR, one bf16x2 subtraction
of a raw word: the plane pairs (p, p+8)), the mma.m16n8k16 sums over the
PTX ISA's fragment ownership, each part's sum promoted every PROMOTE words
into an f32 total (smallest part first), the contraction splits and their
reduction in split order, and the epilogue.  The replay is held to
``packed_matmul_plain`` and, on a packed panel, to the reference's
``packed_matmul`` in Pallas interpret mode.  The instances' constants are
read from the kernel's source; the split rule and the chunk widths are
checked as the launcher computes them.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops.dgemm import packed_matmul as ref_pmm  # noqa: E402
from test_torch_tall import (_b_values, _bf16_pair,  # noqa: E402
                             _words_all_codes)

import miraculix_tpu as mx  # noqa: E402
import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import _kernels  # noqa: E402
from miraculix_tpu_torch.ops.dgemm import (  # noqa: E402
    packed_matmul_plain, rhs_values, tall_rhs_parts, wide_rhs)

SRC = (Path(_kernels.__file__).parent / "csrc" / "wide_dgemm.cu").read_text()
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3     # a lane's group and its thread in the group
WARPS = int(re.search(r"constexpr int WARPS = (\d+);", SRC).group(1))
PRE_WORDS = int(re.search(r"constexpr int PRE_WORDS = (\d+);", SRC).group(1))
MODES = {1: "bf16", 2: "split", 3: "f32"}   # parts -> tall_rhs_parts mode


class Shape:
    """The instances of one part count, from their ``using NAME =
    Shape<MI, NT_MAX, KS, STAGES, PROMOTE>;`` line."""

    def __init__(self, name):
        m = re.search(rf"using {name} = Shape<(\d+), (\d+), (\d+), (\d+), "
                      rf"(\d+)>;", SRC)
        self.MI, self.NT_MAX, self.KS, self.STAGES, self.PROMOTE = map(
            int, m.groups())
        self.BM = 16 * self.MI * WARPS


SHAPES = {1: Shape("One"), 2: Shape("Two"), 3: Shape("Three")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiles(n, passes):
    """The launcher's column chunks: the fewest of at most NT_MAX n8 tiles,
    of equal tiles -> (chunks, n8 tiles a chunk)."""
    t8 = -(-n // 8)
    chunks = -(-t8 // SHAPES[passes].NT_MAX)
    return chunks, -(-t8 // chunks)


# the A fragment's k order: lane (g, t) holds k 2t, 2t+1 (a[0], a[1]) and
# 2t+8, 2t+9 (a[2], a[3]) = planes 2t, 2t+8 and 2t+1, 2t+9
K_PLANE = np.array([2 * ((k % 8) // 2) + k // 8 + 8 * (k % 2)
                    for k in range(16)])


def _plane_pair(x: np.ndarray, shift: int) -> np.ndarray:
    """decode.cuh's plane_pair_bf16 on x = word >> 4t, as float32 pairs."""
    v = ((x >> np.uint32(shift)) & np.uint32(0x00030003)) \
        | np.uint32(0x43004300)
    return _bf16_pair(v) - np.float32(128.0)


def a_fragments(z: np.ndarray) -> np.ndarray:
    """The A matrices [row tiles, kw, 16 rows, 16 k] that the lanes' A
    registers hold: lane (g, t) shifts the words of rows g and g+8 by 4t,
    and takes the plane pairs at bit 0 (a[0], a[1]) and bit 2 (a[2],
    a[3]); rows past the panel are zero, as the stage copies fill them."""
    rows, kw = z.shape
    rt = -(-rows // 16)
    zp = np.zeros((rt * 16, kw), np.uint32)
    zp[:rows] = z
    zt = zp.reshape(rt, 16, kw).transpose(0, 2, 1)      # [tile, w, row]
    x0 = zt[:, :, G] >> (4 * T).astype(np.uint32)       # [tile, w, lane]
    x1 = zt[:, :, G + 8] >> (4 * T).astype(np.uint32)
    regs = [_plane_pair(x0, 0), _plane_pair(x1, 0), _plane_pair(x0, 2),
            _plane_pair(x1, 2)]                          # [tile, w, lane, 2]
    a = np.full((rt, kw, 16, 16), np.nan, np.float32)
    for r, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for h in range(2):
            a[:, :, G + dr, 2 * T + dk + h] = regs[r][..., h]
    assert not np.isnan(a).any(), "a fragment entry no lane holds"
    return a


def prepass(b: np.ndarray, kw: int, passes: int) -> np.ndarray:
    """The parts buffer as wide_parts writes it: uint16 [chunks, kwp,
    passes, nt, lane, 4] (.x low, .x high, .y low, .y high): lane (g, t) of
    tile u holds column 8u + g at planes 2t, 2t+8, 2t+1, 2t+9 of word w
    (B row m*kw + w; zero past cols, n and kw, up to whole stages)."""
    cols, n = b.shape
    chunks, nt = tiles(n, passes)
    ks = SHAPES[passes].KS
    kwp = -(-kw // ks) * ks
    assert kwp % PRE_WORDS == 0
    parts = [p.view(torch.int16).numpy().view(np.uint16) for p in
             tall_rhs_parts(torch.from_numpy(b), MODES[passes])]
    out = np.full((chunks, kwp, passes, nt, 32, 4), 0xDEAD, np.uint16)
    planes = np.stack([2 * T, 2 * T + 8, 2 * T + 1, 2 * T + 9], axis=1)
    for c in range(chunks):
        for w in range(kwp):
            for u in range(nt):
                j = c * 8 * nt + 8 * u + G                 # [lane]
                row = planes * kw + w                      # [lane, 4]
                ok = (w < kw) & (j < n)[:, None] & (row < cols)
                for pp in range(passes):
                    vals = parts[pp][np.minimum(row, cols - 1),
                                     np.minimum(j, n - 1)[:, None]]
                    out[c, w, pp, u] = np.where(ok, vals, 0)
    assert not (out == 0xDEAD).any(), "the pre-pass left parts unwritten"
    return out


def b_fragments(parts: np.ndarray) -> np.ndarray:
    """B matrices [chunks, kwp, passes, nt, 16 k, 8 columns] from the parts
    buffer: b.x holds k 2t, 2t+1 of column g, b.y k 2t+8, 2t+9."""
    vals = (parts.astype(np.uint32) << np.uint32(16)).view(np.float32)
    bm = np.full(parts.shape[:4] + (16, 8), np.nan, np.float32)
    for r, dk in enumerate((0, 1, 8, 9)):
        bm[..., 2 * T + dk, G] = vals[..., r]
    assert not np.isnan(bm).any()
    return bm


def replay(z: np.ndarray, b: np.ndarray, passes: int,
           split_words: int) -> np.ndarray:
    """The kernel's result [rows, n]: per (row tile, chunk, split), each
    part's mma sums from zero over PROMOTE words (float64: the products of
    bf16 values are exact and a group's sum fits), the parts added smallest
    first and then to the f32 total, in f32; lanes' accumulators stored
    through the C fragment layout; split partials summed in split order."""
    rows, kw = z.shape
    n = b.shape[1]
    sh = SHAPES[passes]
    assert split_words % sh.KS == 0 and sh.KS % sh.PROMOTE == 0
    chunks, nt = tiles(n, passes)
    a = a_fragments(z).astype(np.float64)
    bm = b_fragments(prepass(b, kw, passes)).astype(np.float64)
    splits = -(-kw // split_words)
    out = np.zeros((rows, n), np.float32)
    c_row = G[:, None] + 8 * (np.arange(4)[None, :] >> 1)    # [lane, e]
    c_col = 2 * T[:, None] + (np.arange(4)[None, :] & 1)
    for s in range(splits):
        w0, w1 = s * split_words, min(kw, (s + 1) * split_words)
        w1 = w0 + -(-(w1 - w0) // sh.KS) * sh.KS    # whole stages (padding)
        acc = np.zeros((a.shape[0], chunks, nt, 16, 8), np.float32)
        for g0 in range(w0, w1, sh.PROMOTE):
            ws = slice(g0, g0 + sh.PROMOTE)
            aw = np.zeros((a.shape[0], sh.PROMOTE, 16, 16))
            live = max(0, min(kw, g0 + sh.PROMOTE) - g0)   # zero past kw
            aw[:, :live] = a[:, g0:g0 + live]
            d = np.einsum("iwrk,cwpukj->picurj", aw, bm[:, ws]).astype(
                np.float32)
            total = d[passes - 1]
            for p in range(passes - 2, -1, -1):
                total = total + d[p]
            acc += total
        part = np.zeros((rows, n), np.float32)
        lanes = acc[..., c_row, c_col]                # [tile, c, u, lane, e]
        for i in range(acc.shape[0]):
            for c in range(chunks):
                for u in range(nt):
                    r = 16 * i + c_row
                    col = 8 * nt * c + 8 * u + c_col
                    ok = (r < rows) & (col < n)
                    part[r[ok], col[ok]] = lanes[i, c, u][ok]
        out = part if s == 0 else out + part
    return out


def _plain(z, b, rhs):
    zt = torch.from_numpy(z.view(np.int32))
    kw = dict(split=rhs != "f32", single_bf16=rhs == "bf16")
    return packed_matmul_plain(zt, torch.from_numpy(b), **kw).double().numpy()


# ---------------------------------------------------------------------------


def test_shapes_follow_the_source():
    """The replay's constants: three part counts, 8 warps a block, chunks
    of at most 64 columns for one pass and 32 for two or three, stages of
    whole promotion groups, a promotion group of at most 32 words."""
    assert WARPS == 8 and PRE_WORDS == 4
    for passes, sh in SHAPES.items():
        assert sh.NT_MAX <= (8 if passes == 1 else 4)
        assert sh.KS % 4 == 0 and sh.KS % sh.PROMOTE == 0
        assert 1 <= sh.PROMOTE <= 32 and sh.STAGES >= 2
    mma = (Path(_kernels.__file__).parent / "csrc" / "mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    assert "mx::mma_bf16_zero(" in SRC and "mx::mma_bf16(" in SRC
    assert "fmaf" not in SRC and "rhs_value" not in SRC


def test_k_order_is_a_permutation_and_the_lanes_decode_it():
    """Lane (g, t)'s A registers hold, at k, plane K_PLANE[k] of the words
    of rows g and g+8, for words holding every code; K_PLANE covers each
    plane once."""
    assert sorted(K_PLANE.tolist()) == list(range(16))
    rng = np.random.default_rng(0)
    z = _words_all_codes(rng, (40, 9))
    z[:4, 0] = [0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF]
    a = a_fragments(z)
    for r in range(40):
        for w in range(9):
            want = (z[r, w] >> (2 * K_PLANE).astype(np.uint32)) & 3
            np.testing.assert_array_equal(a[r // 16, w, r % 16], want)
    zero = a_fragments(z[:17])[1, :, 1:]       # rows past the panel
    assert not zero.any()


@pytest.mark.parametrize("cols,kw,n,passes", [
    (590, 37, 70, 1), (80, 5, 65, 2), (16, 1, 9, 3), (100, 8, 32, 2)])
def test_prepass_order_and_zeros(cols, kw, n, passes):
    """Each fragment half holds B'[K_PLANE[k] * kw + w, column] of the
    part, k = 2t, 2t+1 (.x) and 2t+8, 2t+9 (.y), and zero where that row is
    at or past ``cols``, the column past n, or the word past kw."""
    rng = np.random.default_rng(cols + n)
    b = _b_values(rng, cols, n)
    parts = prepass(b, kw, passes)
    bm = b_fragments(parts)
    chunks, nt = tiles(n, passes)
    want_parts = [p.to(torch.float32).numpy() for p in
                  tall_rhs_parts(torch.from_numpy(b), MODES[passes])]
    for c in range(chunks):
        for w in range(bm.shape[1]):
            for pp in range(passes):
                for u in range(nt):
                    for k in range(16):
                        row = K_PLANE[k] * kw + w
                        for q in range(8):
                            j = 8 * nt * c + 8 * u + q
                            ok = w < kw and row < cols and j < n
                            want = want_parts[pp][row, j] if ok else 0.0
                            assert bm[c, w, pp, u, k, q] == want
    assert bm.shape[1] % SHAPES[passes].KS == 0


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_parts_sum_to_the_plain_rhs(passes):
    """The pre-pass's parts add up to the plain version's RHS values bit for
    bit: hi (bf16), hi + lo (split and hilo), B itself (f32)."""
    rng = np.random.default_rng(passes)
    b = _b_values(rng, 64, 11)
    parts = tall_rhs_parts(torch.from_numpy(b), MODES[passes])
    total = parts[-1].to(torch.float32)
    for p in parts[-2::-1]:
        total = p.to(torch.float32) + total
    for rhs in {1: ("bf16",), 2: ("split", "hilo"), 3: ("f32",)}[passes]:
        np.testing.assert_array_equal(
            total.numpy(), rhs_values(torch.from_numpy(b), rhs).numpy())


@pytest.mark.parametrize("rows,kw,cols,n", [
    (300, 37, 590, 65), (129, 5, 80, 130), (40, 40, 640, 33),
    (17, 3, 1, 8)])
@pytest.mark.parametrize("rhs", ["bf16", "split", "hilo", "f32"])
def test_replay_matches_plain(rows, kw, cols, n, rhs):
    """The replayed kernel, with the contraction split in two where it can
    be, within 1e-6 of each output's sum of |terms| of the plain version:
    ragged rows, words, B rows and columns (65 columns: chunks of 40 or 24,
    130: of 48 or 32)."""
    rng = np.random.default_rng(rows * kw + n)
    z = _words_all_codes(rng, (rows, kw))
    z &= ~(((z & (z >> np.uint32(1))) & np.uint32(0x55555555))
           << np.uint32(1))                      # codes 0..2: genotypes
    b = rng.standard_normal((cols, n)).astype(np.float32)
    passes = _kernels.WIDE_PASSES[rhs]
    ks = SHAPES[passes].KS
    per = ks * max(1, -(-kw // ks) // 2)
    got = replay(z, b, passes, per)
    want = _plain(z, b, rhs)
    scale = _plain(z, np.abs(rhs_values(torch.from_numpy(b), rhs).numpy()),
                   "f32")
    assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)


def test_promotion_keeps_positive_sums():
    """A positive B over a long contraction (the sums grow without
    cancelling): the replay's promoted f32 sums stay within 4e-6 (the
    smoke's limit) of each output's float64 product of the parts, for every
    part count."""
    rng = np.random.default_rng(4)
    kw = 512
    z = _words_all_codes(rng, (16, kw))
    b = np.abs(rng.standard_normal((16 * kw, 8))).astype(np.float32)
    d = np.stack([(z >> np.uint32(2 * m)) & 3 for m in range(16)], axis=1)
    d = d.reshape(16, 16 * kw).astype(np.float64)    # column m*kw + w
    for passes, rhs in ((1, "bf16"), (2, "split"), (3, "f32")):
        got = replay(z, b, passes, kw + (-kw % SHAPES[passes].KS))
        want = d @ rhs_values(torch.from_numpy(b), rhs).double().numpy()
        assert np.all(np.abs(got - want) <= 4e-6 * want)


def test_chunks_cover_the_columns():
    """Chunks of whole n8 tiles cover every column once, none empty, none
    wider than the instance allows, the fewest such; the smoke's widths."""
    for passes, sh in SHAPES.items():
        for n in range(1, 700):
            chunks, nt = tiles(n, passes)
            assert 1 <= nt <= sh.NT_MAX
            assert (chunks - 1) * 8 * nt < n <= chunks * 8 * nt
            assert chunks == -(-n // (8 * sh.NT_MAX))
    assert tiles(130, 1) == (3, 6) and tiles(65, 1) == (2, 5)
    assert tiles(65, 2) == (3, 3) and tiles(128, 2) == (4, 4)
    assert tiles(600, 2) == (19, 4) and tiles(32, 2) == (1, 4)
    assert tiles(130, 3) == (6, 3) and tiles(65, 3) == (3, 3)


def test_split_rule_takes_whole_stages_and_fills_the_card():
    """The launcher's split rule at the smoke's shapes ('n' 16,384 x 4,096
    words, 't' 65,536 x 1,024; one block an SM on 132 SMs): whole stages a
    split, every word in one split, the last wave >= WIDE_FILL full where
    some split count reaches it, at least WIDE_SPLIT_WORDS words a split,
    and the fewest splits that do; short contractions do not split."""
    for rows, kw in ((16384, 4096), (65536, 1024)):
        for rhs, n in (("bf16", 130), ("bf16", 65), ("split", 65),
                       ("split", 128), ("split", 600), ("hilo", 32),
                       ("f32", 130), ("f32", 65)):
            passes = _kernels.WIDE_PASSES[rhs]
            sh = SHAPES[passes]
            chunks, nt = tiles(n, passes)
            info = {"rows": sh.BM, "cols": 8 * nt, "words": sh.KS,
                    "blocks_per_sm": 1}
            per = _kernels.wide_split_words(rows, kw, n, info, 132)
            splits = -(-kw // per)
            assert per % sh.KS == 0 and per >= _kernels.WIDE_SPLIT_WORDS
            assert (splits - 1) * per < kw <= splits * per
            blocks = -(-rows // sh.BM) * chunks * splits
            assert blocks / (-(-blocks // 132) * 132) >= _kernels.WIDE_FILL
            fewer = -(-rows // sh.BM) * chunks * (splits - 1)
            assert splits == 1 or \
                fewer / (-(-fewer // 132) * 132) < _kernels.WIDE_FILL
    info = {"rows": 256, "cols": 48, "words": 16, "blocks_per_sm": 1}
    assert _kernels.wide_split_words(16384, 4096, 130, info, 132) == 2048
    assert _kernels.wide_split_words(40, 100, 130, info, 132) == 112
    assert _kernels.wide_split_words(40, 3, 130, info, 132) == 16


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(70, 700, seed=41)
    return g, mx.from_dense(g), mt.from_dense(g, device="cpu")


@pytest.mark.parametrize("n,opts", [
    (32, dict(split=True)),                       # B4: host hi||lo
    (65, dict(split=True)),                       # B3: in-kernel split
    (65, dict(split=True, per_plane=False)),      # B11
    (65, dict(single_bf16=True)),                 # B5 bf16
    (70, dict(split=False)),                      # B5 f32
])
def test_replay_matches_reference(panel, n, opts):
    """On a packed panel (70 x 700 SNPs, 128 words, split in two), the
    replay against the reference's packed_matmul in interpret mode: 1e-5
    of max |reference| for bf16, 1e-4 for the split and f32 tiers (as the
    port's wide tests), and 1e-6 of the sums of |terms| against plain."""
    g, ref, port = panel
    b = np.random.default_rng(n + 7).standard_normal((700, n)).astype(
        np.float32)
    want = np.asarray(ref_pmm(ref.zq_n, b, interpret=True, **opts),
                      np.float64)
    rhs = wide_rhs(n, opts.get("split", True), opts.get("single_bf16", False))
    z = port.zq_n.numpy().view(np.uint32)
    got = replay(z, b, _kernels.WIDE_PASSES[rhs], 64)
    assert got.shape == want.shape
    tol = 1e-5 if rhs == "bf16" else 1e-4
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    scale = _plain(z, np.abs(rhs_values(torch.from_numpy(b), rhs).numpy()),
                   "f32")
    assert np.all(np.abs(got - _plain(z, b, rhs)) <= 1e-6 * scale + 1e-30)

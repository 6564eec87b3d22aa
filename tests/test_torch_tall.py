"""The tall kernel's arithmetic, replayed on the CPU.

``csrc/tall_dgemm.cu`` cannot run here, so these tests replay what it does
in numpy and torch: the bf16 parts of B that its pre-pass writes, the
``__byte_perm`` + shift/mask/OR decode of packed words into bf16 pairs, and
the mma.m16n8k16 fragment layouts from the parts buffer to the output
(``tall_replay``).  The plain version's split mode is held to the
reference's tall split (Pallas interpret mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops.dgemm import _tall_split_rows  # noqa: E402
from miraculix_tpu.ops.dgemm import packed_matmul_tall as ref_tall  # noqa: E402

import miraculix_tpu as mx  # noqa: E402
import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch._kernels import TALL_PASSES as PASSES  # noqa: E402
from miraculix_tpu_torch.ops.dgemm import (  # noqa: E402
    packed_matmul_tall_plain, tall_rhs_parts)

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _b_values(rng, rows, n):
    """Standard normal values, values at 2^60 and 2^-60 of them, and
    signed zeros."""
    b = rng.standard_normal((rows, n)).astype(np.float32)
    b[1::5] *= np.float32(2.0 ** 60)
    b[2::5] *= np.float32(2.0 ** -60)
    b[3::7] = 0.0
    b[4::7] = -0.0
    return b


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int16).numpy()


def test_split_parts_equal_the_reference_split_bit_for_bit():
    """hi/lo against _tall_split_rows: one word per contraction row with
    plane 0 = 1 and every other plane 0 makes its per-plane dot return the
    RHS rows themselves, hi rows first, then lo."""
    rng = np.random.default_rng(0)
    n, ts = 3, 16
    b = _b_values(rng, ts, n)
    words = np.eye(ts, dtype=np.int32)          # word w of row s: s == w
    got = np.asarray(_tall_split_rows(jnp.asarray(b.T), jnp.asarray(words)),
                     np.float32)                # [2n, 16 * ts], plane 0 first
    hi, lo = tall_rhs_parts(torch.from_numpy(b), "split")
    want_hi = np.ascontiguousarray(got[:n, :ts].T)
    want_lo = np.ascontiguousarray(got[n:, :ts].T)
    np.testing.assert_array_equal(hi.to(torch.float32).numpy(), want_hi)
    np.testing.assert_array_equal(lo.to(torch.float32).numpy(), want_lo)
    # the bits too (the product of one term is exact, signs of zero aside)
    nz = b != 0
    assert np.array_equal(_bits(hi)[nz], _bits(torch.from_numpy(want_hi)
                                               .to(torch.bfloat16))[nz])
    # and bf16 mode's one part is split mode's hi
    (hi1,) = tall_rhs_parts(torch.from_numpy(b), "bf16")
    assert np.array_equal(_bits(hi1), _bits(hi))


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 60, 2.0 ** -60])
def test_f32_parts_sum_to_b_bit_for_bit(scale):
    rng = np.random.default_rng(1)
    b = (rng.standard_normal((257, 9)) * scale).astype(np.float32)
    b[::11] = 0.0
    b[5::11] = -0.0
    parts = tall_rhs_parts(torch.from_numpy(b), "f32")
    assert len(parts) == 3 and all(p.dtype == torch.bfloat16 for p in parts)
    total = (parts[0].to(torch.float32) + parts[1].to(torch.float32)
             + parts[2].to(torch.float32))
    np.testing.assert_array_equal(total.numpy(), b)
    # each part is at most half a bf16 ulp of what it leaves behind
    rest = torch.from_numpy(b)
    for p in parts[:2]:
        rest = rest - p.to(torch.float32)
        assert bool((rest.abs() <= p.to(torch.float32).abs() * 2.0 ** -8).all())


# ---------------------------------------------------------------------------
# The decode and the fragment layouts, replayed
# ---------------------------------------------------------------------------

def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) for selectors without sign flags:
    byte i of the result is byte (sel >> 4i) & 7 of the 8 bytes y:x."""
    src = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(np.shape(x), np.uint64)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((src >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _bf16_pair(v: np.ndarray) -> np.ndarray:
    """uint32 holding two bf16 values -> float32 [..., 2] (low half first)."""
    lo = (v & np.uint32(0xFFFF)).astype(np.uint32) << np.uint32(16)
    hi = v & np.uint32(0xFFFF0000)
    return np.stack([lo.view(np.float32), hi.view(np.float32)], axis=-1)


def _plane_pair(pair: np.ndarray, shift: int) -> np.ndarray:
    """decode.cuh's plane_pair_bf16, as float32 pairs: the OR builds
    (128 + g0, 128 + g1) and the bf16x2 subtraction of 128 is exact."""
    v = ((pair >> np.uint32(shift)) & np.uint32(0x00030003)) \
        | np.uint32(0x43004300)
    return _bf16_pair(v) - np.float32(128.0)


def _words_all_codes(rng, shape):
    """Random words whose 2-bit fields take every code 0..3."""
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def test_decode_recovers_every_plane_and_code():
    rng = np.random.default_rng(2)
    w0 = _words_all_codes(rng, 4096)
    w1 = _words_all_codes(rng, 4096)
    w0[:4] = [0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF]
    w1[:4] = [0xFFFFFFFF, 0xAAAAAAAA, 0x55555555, 0x00000000]
    lows = _byte_perm(w0, w1, 0x5410)
    highs = _byte_perm(w0, w1, 0x7632)
    for m in range(16):
        pair = _plane_pair(lows if m < 8 else highs, 2 * (m % 8))
        want0 = (w0 >> np.uint32(2 * m)) & np.uint32(3)
        want1 = (w1 >> np.uint32(2 * m)) & np.uint32(3)
        np.testing.assert_array_equal(pair[:, 0], want0.astype(np.float32))
        np.testing.assert_array_equal(pair[:, 1], want1.astype(np.float32))
    # every code occurs in every plane of the sample
    for m in range(16):
        assert set(((w0 >> np.uint32(2 * m)) & np.uint32(3)).tolist()) \
            == {0, 1, 2, 3}


def _tall_layout(contract, n, passes):
    """The launcher's shapes (csrc/tall_dgemm.cu): chunks of <= 64 columns
    (32 for two or three passes), 8-column tiles per chunk (5 to 7 round
    up to 8), mma steps of 16 rows padded to whole 128-row staged tiles."""
    chunks = -(-n // (64 if passes == 1 else 32))
    cw = -(-n // chunks)
    t = -(-cw // 8)
    nt = t if t <= 4 else 8
    ks = max(1, -(-contract // 128)) * 8
    return chunks, cw, nt, ks


def _prepass(b: np.ndarray, mode: str) -> np.ndarray:
    """The pre-pass kernel's parts buffer, uint16 [chunks, ks, P, nt, lane,
    4], written as the kernel writes it: fragment lane (g, t) of tile
    ``ntile`` packs column g at rows 2t, 2t+1 (.x) and 2t+8, 2t+9 (.y)."""
    contract, n = b.shape
    passes = PASSES[mode]
    chunks, cw, nt, ks_total = _tall_layout(contract, n, passes)
    parts = [_bits(p).view(np.uint16) for p in
             tall_rhs_parts(torch.from_numpy(b), mode)]
    out = np.full((chunks * ks_total * passes * nt * 32, 4), 0xDEAD,
                  np.uint16)
    for blk in range(chunks * nt):                # blockIdx.x
        c, ntile = divmod(blk, nt)
        for ks in range(ks_total):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                q = ntile * 8 + g
                j = c * cw + q
                col = q < cw and j < n
                for pp in range(passes):
                    idx = (((c * ks_total + ks) * passes + pp) * nt * 32
                           + ntile * 32 + lane)
                    for r in range(4):            # x.lo, x.hi, y.lo, y.hi
                        s = ks * 16 + 2 * t + (r & 1) + 8 * (r >> 1)
                        out[idx, r] = parts[pp][s, j] \
                            if col and s < contract else 0
    assert not (out == 0xDEAD).any(), "the pre-pass left parts unwritten"
    return out.reshape(-1)


def tall_replay(zq: np.ndarray, b: np.ndarray, mode: str) -> np.ndarray:
    """The main kernel's arithmetic per lane: A fragments decoded from the
    words of rows 2t, 2t+1, 2t+8, 2t+9, B fragments read from the parts
    buffer at [chunk][step][part][tile][lane], mma.m16n8k16 on those
    fragments (float64: every bf16 product is exact), and the epilogue's
    ct[c0 + q, m*kwi + w] stores.  Returns ct [n, 16*kwi]."""
    spad, kwi = zq.shape
    contract, n = b.shape
    passes = PASSES[mode]
    chunks, cw, nt, ks_total = _tall_layout(contract, n, passes)
    parts = _prepass(b, mode).reshape(chunks, ks_total, passes, nt, 32, 2, 2)
    zpad = np.zeros((ks_total * 16, kwi), np.uint32)
    zpad[:contract] = zq[:contract].view(np.uint32)
    ct = np.full((n, 16 * kwi), np.nan)
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    for c in range(chunks):
        c0, ncols = c * cw, min(cw, n - c * cw)
        for w in range(kwi):
            acc = np.zeros((nt, 16, 8))
            for ks in range(ks_total):
                rows = zpad[ks * 16:(ks + 1) * 16, w]
                r0, r1 = rows[2 * t], rows[2 * t + 1]
                r2, r3 = rows[2 * t + 8], rows[2 * t + 9]
                a = np.zeros((16, 16))
                for lane in range(32):
                    sh = 2 * g[lane]
                    frag = [_plane_pair(_byte_perm(x, y, sel), sh)
                            for x, y, sel in ((r0[lane], r1[lane], 0x5410),
                                              (r0[lane], r1[lane], 0x7632),
                                              (r2[lane], r3[lane], 0x5410),
                                              (r2[lane], r3[lane], 0x7632))]
                    gl, tl = g[lane], t[lane]
                    a[gl, 2 * tl:2 * tl + 2] = frag[0]
                    a[gl + 8, 2 * tl:2 * tl + 2] = frag[1]
                    a[gl, 2 * tl + 8:2 * tl + 10] = frag[2]
                    a[gl + 8, 2 * tl + 8:2 * tl + 10] = frag[3]
                for u in range(nt):
                    for pp in range(passes):
                        frag = parts[c, ks, pp, u]          # [lane, reg, half]
                        vals = (frag.astype(np.uint32) << np.uint32(16)) \
                            .view(np.float32)
                        bm = np.zeros((16, 8))
                        for lane in range(32):
                            gl, tl = g[lane], t[lane]
                            bm[2 * tl:2 * tl + 2, gl] = vals[lane, 0]
                            bm[2 * tl + 8:2 * tl + 10, gl] = vals[lane, 1]
                        acc[u] += a @ bm
            for u in range(nt):
                for lane in range(32):
                    gl, tl = g[lane], t[lane]
                    for e in range(4):
                        q = u * 8 + 2 * tl + (e & 1)
                        m = gl + 8 * (e >> 1)
                        if q < ncols:
                            ct[c0 + q, m * kwi + w] = acc[u, m, q % 8]
    return ct


@pytest.mark.parametrize("contract,kwi,n", [(40, 3, 12), (17, 2, 1),
                                            (33, 1, 70)])
@pytest.mark.parametrize("mode", ["split", "bf16", "f32"])
def test_fragment_replay_matches_plain(contract, kwi, n, mode):
    """Every output of the replayed kernel equals the plain product, with
    B different in every row and column and words holding all four
    codes; ragged contraction, word and column counts (70 columns: two
    chunks of 35 padded to 8 tiles in one pass, three of 24 padded to 4
    tiles in two or three)."""
    rng = np.random.default_rng(contract * 100 + n)
    zq = _words_all_codes(rng, (contract + 5, kwi)).view(np.int32)
    b = _b_values(rng, contract, n) / np.float32(2.0 ** 40)
    b[2::5] = rng.standard_normal((len(b[2::5]), n))   # keep every row live
    got = tall_replay(zq, b, mode)
    want = packed_matmul_tall_plain(torch.from_numpy(zq), torch.from_numpy(b),
                                    mode=mode).T.double().numpy()
    assert not np.isnan(got).any()
    scale = packed_matmul_tall_plain(
        torch.from_numpy(zq), torch.from_numpy(np.abs(b)), mode=mode
    ).T.double().numpy()
    assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)


# ---------------------------------------------------------------------------
# The plain split mode against the reference's tall split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(100, 2000, seed=31)
    return mx.from_dense(g), mt.from_dense(g, device=CPU)


@pytest.mark.parametrize("n", [1, 32, 64])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_plain_split_matches_reference_tall_split(panel, trans, n):
    ref, port = panel
    zq_ref = ref.zq_t if trans == "n" else ref.zq_n
    zq = port.zq_t if trans == "n" else port.zq_n
    contract = 2000 if trans == "n" else 100
    b = np.random.default_rng(n).standard_normal((contract, n)) \
        .astype(np.float32)
    want = np.asarray(ref_tall(zq_ref, b, mode="split", interpret=True),
                      np.float64)
    got = packed_matmul_tall_plain(zq, torch.from_numpy(b)).double().numpy()
    assert got.shape == want.shape
    # both sum the same hi + lo products in f32: 1e-6 relative to the sums
    # of |terms|, far inside the reference's own 1e-4 (a plain f32 product
    # by B itself differs by ~3e-6 of max)
    scale = packed_matmul_tall_plain(zq, torch.from_numpy(np.abs(b))) \
        .double().numpy()
    assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)

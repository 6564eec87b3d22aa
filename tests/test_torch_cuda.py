"""The port's CUDA kernels against their plain torch versions, on the GPU.

Marked ``cuda``: every test skips where no CUDA device is present.  Run on a
GPU host with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` because the suite's conftest configures jax, which the
port does not need).  Shapes here are deliberately ragged: row counts off
the kernels' row tiles, word counts off their word steps, odd RHS widths.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu_torch import _kernels  # noqa: E402
from miraculix_tpu_torch.ops.common import (  # noqa: E402
    decode_planar16, packed_row_sq_stats, packed_row_sq_stats_plain)
from miraculix_tpu_torch.ops.dgemm import (  # noqa: E402
    packed_matmul_exact, packed_matmul_int8, packed_matmul_int8_plain,
    packed_matmul_tall, packed_matmul_tall_plain, rhs_values)
from miraculix_tpu_torch.ops.grm import (  # noqa: E402
    packed_crossprod, packed_crossprod_plain, packed_crossprod_rect,
    packed_crossprod_rect_plain, packed_crossprod_weighted,
    packed_crossprod_weighted_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _words(rng, rows, kw):
    w = rng.integers(0, 2 ** 32, size=(rows, kw), dtype=np.uint64)
    # genotype fields hold 0/1/2 only: clear the high bit of every 11 field
    w = w.astype(np.uint32)
    both = (w & (w >> np.uint32(1))) & np.uint32(0x55555555)
    w &= ~(both << np.uint32(1))
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("spad,kwi,contract,n", [
    (256, 128, 256, 1), (300, 37, 290, 3), (1000, 64, 999, 12),
    (4096, 96, 4000, 33), (700, 160, 700, 64), (64, 5, 1, 7),
    (700, 160, 700, 100)])
@pytest.mark.parametrize("with_cv", [False, True])
def test_tall_dgemm_matches_plain(dev, spad, kwi, contract, n, with_cv):
    rng = np.random.default_rng(spad + kwi + n)
    zq = _words(rng, spad, kwi).to(dev)
    b = torch.as_tensor(rng.standard_normal((contract, n)),
                        dtype=torch.float32, device=dev)
    cv = torch.as_tensor(rng.standard_normal(contract), dtype=torch.float32,
                         device=dev) if with_cv else None
    got = packed_matmul_tall(zq, b, center_vec=cv)
    want = packed_matmul_tall_plain(zq, b, center_vec=cv)
    # error bound relative to the sums of |terms|: a sum that cancels (a
    # one-column v of mixed-sign cv) is no more accurate than its terms
    scale = packed_matmul_tall_plain(zq, b.abs(), center_vec=None if cv is None
                                     else cv.abs())
    if cv is None:
        got, want, scale = (got,), (want,), (scale,)
    for x, y, s in zip(got, want, scale):
        assert x.shape == y.shape
        assert float((x - y).abs().max()) <= 1e-5 * float(s.max())


@pytest.mark.parametrize("spad,kwi,contract,n", [
    (300, 37, 290, 1), (1000, 64, 999, 33), (700, 160, 700, 128),
    (64, 5, 1, 100), (4096, 96, 4000, 65)])
@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_tall_modes_match_plain(dev, spad, kwi, contract, n, mode):
    """The bf16 mode against a plain version that rounds B the same way."""
    rng = np.random.default_rng(spad * n)
    zq = _words(rng, spad, kwi).to(dev)
    b = torch.as_tensor(rng.standard_normal((contract, n)),
                        dtype=torch.float32, device=dev)
    got = packed_matmul_tall(zq, b, mode=mode)
    want = packed_matmul_tall_plain(zq, b, mode=mode)
    scale = packed_matmul_tall_plain(zq, rhs_values(b, mode).abs())
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(scale.max())


TALL_SHAPES = [(contract, kwi) for contract in (1, 15, 17, 999, 16385)
               for kwi in (1, 5, 33, 130)]


def _all_codes(rng, rows, kw):
    """Random words whose 2-bit fields take all four codes (3 included)."""
    w = rng.integers(0, 2 ** 32, size=(rows, kw), dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


def _wide_range(rng, rows, n, dev):
    """B with entries over 2^-30..2^30, both signs and exact zeros, so that
    every row and column differs."""
    b = rng.standard_normal((rows, n)) * np.exp2(
        rng.integers(-30, 31, size=(rows, n)))
    b[rng.random((rows, n)) < 0.1] = 0.0
    return torch.as_tensor(b, dtype=torch.float32, device=dev)


def _tall_case(dev, rng, contract, kwi, n, mode, with_cv):
    zq = _all_codes(rng, contract + 3, kwi).to(dev)
    b = _wide_range(rng, contract, n, dev)
    cv = _wide_range(rng, contract, 1, dev)[:, 0] if with_cv else None
    got = packed_matmul_tall(zq, b, center_vec=cv, mode=mode)
    want = packed_matmul_tall_plain(zq, b, center_vec=cv, mode=mode)
    scale = packed_matmul_tall_plain(
        zq, rhs_values(b, {"split": "hilo"}.get(mode, mode)).abs(),
        center_vec=None if cv is None else cv.abs(), mode="f32")
    if cv is None:
        got, want, scale = (got,), (want,), (scale,)
    else:
        scale = (scale[0], cv.abs() @ b.abs())
    for x, y, s in zip(got, want, scale):
        assert x.shape == y.shape and bool(torch.isfinite(x).all())
        # each output within 1e-5 of its own sum of |terms|
        assert bool(((x - y).abs() <= 1e-5 * s).all()), \
            (contract, kwi, n, mode, float(((x - y).abs() / s).max()))
    return zq, b, cv, got


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 63, 64])
@pytest.mark.parametrize("with_cv", [False, True])
def test_tall_split_widths_and_shapes(dev, n, with_cv):
    """The split mode (K1/K2) at every 8-column tile edge up to 64, over
    ragged contractions and word counts, against the plain hi + lo
    product; two launches give the same bits (no atomics)."""
    rng = np.random.default_rng(n + 100 * with_cv)
    for contract, kwi in TALL_SHAPES:
        zq, b, cv, got = _tall_case(dev, rng, contract, kwi, n, "split",
                                    with_cv)
        again = packed_matmul_tall(zq, b, center_vec=cv)
        for x, y in zip(got, again if cv is not None else (again,)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 63, 64,
                               65, 96, 127, 128])
@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_tall_mode_widths_and_shapes(dev, n, mode):
    rng = np.random.default_rng(n * 7 + len(mode))
    for contract, kwi in TALL_SHAPES:
        zq, b, _, (got,) = _tall_case(dev, rng, contract, kwi, n, mode,
                                      False)
        assert torch.equal(got, packed_matmul_tall(zq, b, mode=mode))


@pytest.mark.parametrize("n", [1, 9, 64, 128])
def test_tall_f32_mode_against_float64(dev, n):
    """The f32 mode's three bf16 parts sum to B: each output within 1e-5 of
    its sum of |terms| of the float64 product."""
    rng = np.random.default_rng(n + 5)
    for contract, kwi in TALL_SHAPES:
        zq = _all_codes(rng, contract, kwi).to(dev)
        b = _wide_range(rng, contract, n, dev)
        got = packed_matmul_tall(zq, b, mode="f32").double()
        d = decode_planar16(zq, torch.float64)
        want = d.T @ b.double()
        scale = d.T @ b.double().abs()
        assert bool(((got - want).abs() <= 1e-5 * scale).all())


def _lo_biased(b):
    """``b`` with f32-mode parts hi = bf16(b), mid = 1.5 * 2^(e-9), lo =
    1.5 * 2^(e-18) for 2^e <= |hi| (exact in f32): the positive lo products
    add up over the contraction instead of cancelling."""
    hi = b.to(torch.bfloat16).to(torch.float32)
    e = torch.floor(torch.log2(hi.abs()))
    return hi + 1.5 * torch.exp2(e - 9) + 1.5 * torch.exp2(e - 18)


@pytest.mark.parametrize("n", [1, 8, 33, 128])
def test_tall_f32_mode_runs_its_third_pass(dev, n):
    """The f32 mode stands far closer to the float64 product than the split
    grade (hi + mid, no third pass) does, on a B whose lo parts add up."""
    rng = np.random.default_rng(n + 9)
    zq = _all_codes(rng, 16385, 33).to(dev)
    b = _lo_biased(torch.as_tensor(rng.standard_normal((16385, n)),
                                   dtype=torch.float32, device=dev))
    d = decode_planar16(zq, torch.float64)
    want = d.T @ b.double()
    err = float((packed_matmul_tall(zq, b, mode="f32").double() - want)
                .abs().max())
    two_parts = float((d.T @ rhs_values(b, "hilo").double() - want)
                      .abs().max())
    assert err <= 0.25 * two_parts, (err, two_parts)


@pytest.mark.parametrize("mode", ["split", "bf16", "f32"])
def test_tall_positive_rhs_long_sums(dev, mode):
    """A positive B, whose sums grow without cancelling, over 16,384 rows
    and 4,096 words (one contraction split): each output within 1e-5 of
    the float64 product of the mode's parts.  Tensor-core accumulators run
    over the whole split truncate their addends and miss this."""
    rng = np.random.default_rng(len(mode))
    zq = _all_codes(rng, 16384, 4096).to(dev)
    b = torch.as_tensor(np.abs(rng.standard_normal((16384, 16))),
                        dtype=torch.float32, device=dev)
    got = packed_matmul_tall(zq, b, mode=mode).double()
    want = decode_planar16(zq, torch.float64).T @ rhs_values(
        b, {"split": "hilo"}.get(mode, mode)).double()
    assert bool(((got - want).abs() <= 1e-5 * want).all()), \
        float(((got - want).abs() / want).max())


def test_tall_contraction_past_65535_row_blocks(dev):
    """A contraction longer than 65,535 x 128 rows (an 8.4M-SNP panel at
    'n') runs, with cv, against the float64 product."""
    contract = 65535 * 128 + 1000
    rng = np.random.default_rng(12)
    zq = _all_codes(rng, contract, 1).to(dev)
    b = torch.as_tensor(rng.standard_normal((contract, 1)),
                        dtype=torch.float32, device=dev)
    cv = torch.as_tensor(rng.standard_normal(contract), dtype=torch.float32,
                         device=dev)
    got, v = packed_matmul_tall(zq, b, center_vec=cv)
    d = decode_planar16(zq, torch.float64)
    bh = rhs_values(b, "hilo").double()
    assert bool(((got.double() - d.T @ bh).abs()
                 <= 1e-5 * (d.T @ bh.abs())).all())
    cvd, bd = cv.double(), b.double()
    assert bool(((v.double() - cvd @ bd).abs()
                 <= 1e-5 * (cvd.abs() @ bd.abs())).all())


@pytest.mark.parametrize("rows,kw,cols", [
    (300, 37, 590), (129, 5, 80), (1000, 128, 2048), (64, 3, 1)])
@pytest.mark.parametrize("n", [65, 97, 130, 513])
@pytest.mark.parametrize("rhs", ["split", "f32", "bf16", "hilo"])
def test_wide_dgemm_matches_plain(dev, rows, kw, cols, n, rhs):
    """Rows off the 128-row tile, words off the 4-word step, B shorter than
    16*kw, and column counts that leave ragged chunks."""
    rng = np.random.default_rng(rows * kw + n)
    zq = _words(rng, rows, kw).to(dev)
    b = torch.as_tensor(rng.standard_normal((cols, n)), dtype=torch.float32,
                        device=dev)
    got = _kernels.wide_dgemm(zq, b, rhs)
    d = decode_planar16(zq, torch.float32)[:, :cols]
    want = d @ rhs_values(b, rhs)
    scale = d @ rhs_values(b, rhs).abs()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(scale.max())


def _wide_check(got, zq, b, rhs, rtol=1e-5):
    """``got`` against the float64 product of the instance's parts: each
    output within ``rtol`` of its sum of |terms|."""
    d = decode_planar16(zq, torch.float64)[:, :b.shape[0]]
    bh = rhs_values(b, rhs).double()
    want, scale = d @ bh, d @ bh.abs()
    assert got.shape == want.shape
    err = ((got.double() - want).abs() / scale.clamp_min(1e-300)).max()
    assert float(err) <= rtol, float(err)


@pytest.mark.parametrize("rows,kw", [(255, 15), (256, 32), (257, 33),
                                     (511, 31), (130, 48), (16, 1)])
@pytest.mark.parametrize("n", [1, 8, 9, 24, 25, 32, 33, 64, 65, 130])
@pytest.mark.parametrize("rhs", ["bf16", "split", "f32"])
def test_wide_dgemm_tile_stage_and_chunk_edges(dev, rows, kw, n, rhs):
    """Rows at and off the 128- and 256-row blocks, words at and off the
    16- and 32-word stages, widths at the chunk edges (64 columns for one
    pass, 32 for two, 24 for three) and at the n8 tile edge; B's rows end
    inside a word's planes.  Codes 0..3 and B over 2^-30..2^30 with
    zeros."""
    rng = np.random.default_rng(rows * 1000 + kw * 10 + n)
    zq = _all_codes(rng, rows, kw).to(dev)
    b = _wide_range(rng, max(1, 16 * kw - 7), n, dev)
    _wide_check(_kernels.wide_dgemm(zq, b, rhs), zq, b, rhs)


@pytest.mark.parametrize("rhs", ["split", "f32"])
def test_wide_dgemm_positive_rhs_longest_contraction(dev, rhs):
    """A positive, lo-biased B at the smoke's longest contraction (4,096
    words, 65,536 terms): its sums grow without cancelling, so tensor-core
    accumulators run over a whole split would truncate them.  Each output
    within 4e-6 of its float64 product of the instance's parts, while the
    bf16 grade stands outside that limit; f32 also stands 4x closer than
    its first two parts (hi + lo) alone, so its third pass runs."""
    rng = np.random.default_rng(len(rhs))
    zq = _words(rng, 300, 4096).to(dev)
    b = _lo_biased(torch.as_tensor(np.abs(rng.standard_normal((65536, 33))),
                                   dtype=torch.float32, device=dev))
    got = _kernels.wide_dgemm(zq, b, rhs)
    _wide_check(got, zq, b, rhs, rtol=4e-6)
    d = decode_planar16(zq, torch.float64)
    want = d @ rhs_values(b, rhs).double()
    one = d @ rhs_values(b, "bf16").double()
    assert float(((one - want).abs() / want).max()) > 4e-6
    if rhs == "f32":
        two = d @ rhs_values(b, "hilo").double()
        assert float((got.double() - want).abs().max()) \
            <= 0.25 * float((two - want).abs().max())


def _wide_stage(rhs, n):
    """Words a stage of the instance that ``rhs`` at n columns launches."""
    passes = _kernels.WIDE_PASSES[rhs]
    return _kernels.wide_info()[(passes, _kernels.wide_tiles(n, passes)[1])
                                ]["words"]


@pytest.mark.parametrize("stages", [1, 2, 3, 64, None])
@pytest.mark.parametrize("rhs", ["bf16", "split", "f32"])
def test_wide_dgemm_every_split_count(dev, stages, rhs):
    """The contraction split in splits of one, two and three stages (the
    last split short), in one split, and by the launcher's rule, over 1,021
    words (the last stage short)."""
    rng = np.random.default_rng(stages or 7)
    zq = _words(rng, 700, 1021).to(dev)
    b = torch.as_tensor(rng.standard_normal((16 * 1021, 70)),
                        dtype=torch.float32, device=dev)
    per = None if stages is None else stages * _wide_stage(rhs, 70)
    got = _kernels.wide_dgemm(zq, b, rhs, split_words=per)
    _wide_check(got, zq, b, rhs)


def test_wide_dgemm_split_counts_agree_and_repeat(dev):
    """No atomics: one split count gives the same bits every run."""
    rng = np.random.default_rng(3)
    zq = _words(rng, 1000, 512).to(dev)
    b = torch.as_tensor(rng.standard_normal((8192, 130)),
                        dtype=torch.float32, device=dev)
    stage = _wide_stage("split", 130)
    for per in (stage, 4 * stage, 512):
        first = _kernels.wide_dgemm(zq, b, "split", split_words=per)
        assert torch.equal(first, _kernels.wide_dgemm(zq, b, "split",
                                                      split_words=per))


def _wide_instances():
    """(parts, tiles) of every instance, from the source's Shape lines."""
    src = (Path(_kernels.__file__).parent / "csrc" /
           "wide_dgemm.cu").read_text()
    most = [int(re.search(rf"using {name} = Shape<\d+, (\d+),", src)
                .group(1)) for name in ("One", "Two", "Three")]
    return [(p, nt) for p in (1, 2, 3) for nt in range(1, most[p - 1] + 1)]


@pytest.mark.parametrize("passes,nt", _wide_instances())
def test_wide_dgemm_instances_do_not_spill(dev, passes, nt):
    """Every instance the library holds compiles without spills, fits a
    block on an SM, and computes its product (one chunk of nt tiles)."""
    info = _kernels.wide_info()
    assert set(info) >= {(passes, nt)}
    i = info[(passes, nt)]
    assert i["local_bytes"] == 0 and i["blocks_per_sm"] >= 1, i
    rhs = {1: "bf16", 2: "split", 3: "f32"}[passes]
    n = 8 * nt - 3 if nt > 1 else 5
    assert _kernels.wide_tiles(n, passes) == (1, nt)
    rng = np.random.default_rng(passes * 10 + nt)
    zq = _words(rng, 300, 77).to(dev)
    b = torch.as_tensor(rng.standard_normal((16 * 77, n)),
                        dtype=torch.float32, device=dev)
    _wide_check(_kernels.wide_dgemm(zq, b, rhs), zq, b, rhs)


@pytest.mark.parametrize("rows,kw", [(64, 16), (65, 17), (200, 33),
                                     (513, 128), (1, 1)])
def test_crossprod_matches_plain(dev, rows, kw):
    zq = _words(np.random.default_rng(rows * kw), rows, kw).to(dev)
    assert torch.equal(packed_crossprod(zq), packed_crossprod_plain(zq))


@pytest.mark.parametrize("ra,rb,kw", [(64, 64, 16), (300, 700, 37),
                                      (65, 1, 17), (1, 129, 5),
                                      (513, 200, 128)])
def test_crossprod_rect_matches_plain(dev, ra, rb, kw):
    """B8: ra != rb, rows off the row tile, kw off the word step."""
    rng = np.random.default_rng(ra * rb + kw)
    za = _words(rng, ra, kw).to(dev)
    zb = _words(rng, rb, kw).to(dev)
    got = packed_crossprod_rect(za, zb)
    assert got.shape == (ra, rb)
    assert torch.equal(got, packed_crossprod_rect_plain(za, zb))
    # triangle=False: the same kernel on (zq, zq)
    assert torch.equal(packed_crossprod(za, triangle=False),
                       packed_crossprod_plain(za))


@pytest.mark.parametrize("ra,rb", [(300, 700), (700, 300), (65, 129),
                                   (700, 700)])
def test_crossprod_rect_row_views_of_one_buffer(dev, ra, rb):
    """B8 on two row views that start at one address but end at different
    rows (`.contiguous()` keeps the shared pointer): the diagonal tiles must
    read each operand to its own end."""
    z = _words(np.random.default_rng(ra + rb), 700, 37).to(dev)
    za, zb = z[:ra], z[:rb]
    assert za.data_ptr() == zb.data_ptr()
    assert torch.equal(packed_crossprod_rect(za, zb),
                       packed_crossprod_rect_plain(za, zb))


@pytest.mark.parametrize("rows,kw", [(64, 16), (65, 17), (200, 33),
                                     (513, 128), (1, 1)])
def test_crossprod_tri_matches_k3(dev, rows, kw):
    """B12 (masked grid + mirror merge) bit-equal to K3 and to plain."""
    zq = _words(np.random.default_rng(rows + kw), rows, kw).to(dev)
    got = packed_crossprod(zq, wrap=False)
    assert torch.equal(got, packed_crossprod(zq))
    assert torch.equal(got, packed_crossprod_plain(zq))


ALL_TWOS = int(np.uint32(0xAAAAAAAA).view(np.int32))   # code 2 everywhere


def _three_routes_equal_plain(zq):
    """K3, B12 (masked grid + mirror merge) and B8 (triangle=False) on one
    panel, each bit-equal to the plain product."""
    want = packed_crossprod_plain(zq)
    for got in (packed_crossprod(zq), packed_crossprod(zq, wrap=False),
                packed_crossprod(zq, triangle=False)):
        assert got.shape == want.shape and got.dtype == torch.int32
        assert torch.equal(got, want)


def test_crossprod_tile_is_the_kernels(dev):
    """The tile edge the mirror merge uses is the library's, and the
    kernels hold two blocks an SM without spilling."""
    src = (Path(_kernels.__file__).parent / "csrc"
           / "crossprod.cu").read_text()
    assert _kernels.crossprod_tile() == int(
        re.search(r"constexpr int TILE = (\d+);", src).group(1))
    for info in _kernels.crossprod_info().values():
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2


@pytest.mark.parametrize("rows", [1, 127, 128, 129, 255, 257, 513])
@pytest.mark.parametrize("kw", [1, 31, 33, 129])
def test_crossprod_routes_at_tile_and_stage_edges(dev, rows, kw):
    """K3 == B12 == B8 == plain with rows on and off the 128-row tile and
    words off the 8-word stage, the 4-word copy and the 4-stage ring."""
    _three_routes_equal_plain(
        _words(np.random.default_rng(1000 * rows + kw), rows, kw).to(dev))


@pytest.mark.parametrize("ra,rb,kw", [(127, 257, 33), (257, 127, 33),
                                      (129, 513, 31), (513, 129, 129),
                                      (1, 255, 1), (255, 1, 129),
                                      (1100, 300, 64)])
def test_crossprod_rect_at_tile_and_stage_edges(dev, ra, rb, kw):
    """B8 with ra != rb both ways, off the tile and the stage; 1100 rows
    are more than one band of 8 tile rows."""
    rng = np.random.default_rng(ra * rb + kw)
    za, zb = _words(rng, ra, kw).to(dev), _words(rng, rb, kw).to(dev)
    assert torch.equal(packed_crossprod_rect(za, zb),
                       packed_crossprod_rect_plain(za, zb))
    assert torch.equal(packed_crossprod_rect(zb, za),
                       packed_crossprod_rect_plain(zb, za))


@pytest.mark.parametrize("rows", [300, 1300])
def test_crossprod_all_two_panel(dev, rows):
    """Every code 2 at kw 4,096: the largest sums the smoke's shapes reach
    (4 * 16 * 4,096 = 262,144 in every entry), through all three routes
    and B8 with ra != rb."""
    kw = 4096
    zq = torch.full((rows, kw), ALL_TWOS, dtype=torch.int32, device=dev)
    full = torch.full((rows, rows), 4 * 16 * kw, dtype=torch.int32,
                      device=dev)
    assert torch.equal(packed_crossprod_plain(zq), full)
    _three_routes_equal_plain(zq)
    assert torch.equal(packed_crossprod_rect(zq[:129], zq), full[:129])


@pytest.mark.parametrize("rows,kw", [(300, 37), (513, 128)])
def test_crossprod_missing_indicator_packings(dev, rows, kw):
    """0/1 packings (every field 00 or 01), as the missing and called
    indicators are: random ones, and the corrected LD path's own packing
    against the genotype words (B8 as ld_windowed launches it)."""
    from miraculix_tpu_torch import from_dense
    from miraculix_tpu_torch.io import bed
    from miraculix_tpu_torch.ops.grm import missing_indicator_packing_t

    rng = np.random.default_rng(rows + kw)
    ind = _words(rng, rows, kw) & 0x55555555
    _three_routes_equal_plain(ind.to(dev))
    g = from_dense(bed.simulate_genotypes(kw * 16, rows, seed=kw,
                                          missing_rate=0.05),
                   keep_missing_info=True, device=dev)
    mi = missing_indicator_packing_t(g)
    assert int(mi.count_nonzero()) > 0
    for za, zb in ((mi, g.zq_t), (g.zq_t[:129], mi), (mi[:200], mi)):
        assert torch.equal(packed_crossprod_rect(za, zb),
                           packed_crossprod_rect_plain(za, zb))
    _three_routes_equal_plain(mi)


@pytest.mark.parametrize("rows,kw,snps", [(64, 16, 256), (65, 17, 270),
                                          (200, 33, 500), (513, 128, 2048),
                                          (1, 5, 3),
                                          # tile edges (64-row tiles)
                                          (127, 20, 320), (128, 20, 320),
                                          (129, 20, 319), (255, 9, 144),
                                          (257, 12, 190),
                                          # stage edges (32-word stages)
                                          (100, 31, 496), (100, 33, 528),
                                          (70, 32, 512), (70, 64, 1000)])
@pytest.mark.parametrize("triangle", [True, False])
def test_crossprod_weighted_matches_plain(dev, rows, kw, snps, triangle):
    """B9 against its f64 plain version, each output's error bounded by its
    own sum of |terms| (all terms are >= 0 here, so that is the output);
    the plain product with w rounded once to bf16 reads above the limit."""
    rng = np.random.default_rng(rows * kw + triangle)
    zq = _words(rng, rows, kw).to(dev)
    w = torch.as_tensor(rng.uniform(0.01, 3.0, snps), dtype=torch.float32,
                        device=dev)
    got = packed_crossprod_weighted(zq, w, triangle=triangle)
    want = packed_crossprod_weighted_plain(zq, w).double()
    control = packed_crossprod_weighted_plain(
        zq, w.to(torch.bfloat16).to(torch.float32)).double()

    def rel(x):
        return float(((x - want).abs() / want.clamp(min=1e-30)).max())
    assert got.shape == (rows, rows)
    assert torch.equal(got, got.T)
    assert rel(got.double()) <= 4e-6
    if rows > 1:   # one output of a 3-term sum may land on bf16 exactly
        assert rel(control) > 4e-6


def _weighted_f64(zq, w):
    """(decode(zq) diag(w) decode(zq)^T, the same with |w|) in float64: the
    exact product and each output's sum of |terms|."""
    kw = zq.shape[1]
    wd = torch.zeros(16 * kw, dtype=torch.float64, device=zq.device)
    wd[:w.shape[0]] = w.double()
    d = decode_planar16(zq, torch.float64)
    return (d * wd) @ d.T, (d * wd.abs()) @ d.T


def _weighted_rel(got, want, scale):
    diff = (got.double() - want).abs()
    return float(torch.where(scale > 0, diff / scale.clamp(min=1e-300),
                             diff * torch.inf).nan_to_num(0.0).max())


def _gcta_weights(rng, snps, signs=False):
    """GCTA's 1 / (2pq m) over allele frequencies down to 2pq = 2e-12
    (weights from ~1e-5 to ~1e7 at m = 65,536), or those weights with
    random signs."""
    p = np.concatenate([rng.uniform(1e-12, 0.5, snps - snps // 8),
                        10.0 ** rng.uniform(-12, -2, snps // 8)])
    rng.shuffle(p)
    w = 1.0 / (2.0 * p * (1.0 - p) * snps)
    if signs:
        w *= rng.choice([-1.0, 1.0], snps)
    return w


@pytest.mark.parametrize("rows,kw,kind", [
    (200, 4096, "positive"), (129, 4096, "gcta"), (300, 1000, "gcta"),
    (129, 4096, "mixed"), (257, 700, "mixed"), (65, 4096, "tiny")])
def test_crossprod_weighted_long_sums(dev, rows, kw, kind):
    """B9 over up to 65,536 terms against the float64 product, each output's
    error within 4e-6 of its sum of |terms| (the smoke's limit): positive
    weights (the sums grow without cancelling), GCTA-range weights
    (1e-5 .. 1e7), the same with mixed signs, and weights from 1e-8 up."""
    rng = np.random.default_rng(rows + kw)
    zq = _words(rng, rows, kw).to(dev)
    snps = 16 * kw - 5
    w = {"positive": lambda: rng.uniform(0.5, 2.0, snps),
         "gcta": lambda: _gcta_weights(rng, snps),
         "mixed": lambda: _gcta_weights(rng, snps, signs=True),
         "tiny": lambda: 10.0 ** rng.uniform(-8, -6, snps)}[kind]()
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    want, scale = _weighted_f64(zq, w)
    got = packed_crossprod_weighted(zq, w)
    assert bool(torch.isfinite(got).all())
    assert _weighted_rel(got, want, scale) <= 4e-6


@pytest.mark.parametrize("rows,kw", [(200, 4096), (129, 300)])
def test_crossprod_weighted_needs_every_digit(dev, rows, kw):
    """The grade control inside the kernel: on w's first masked digit h1
    alone, and on h1 + h2 (weights whose split is (h1, 0, 0) and (h1, h2,
    0)), the product reads above the 4e-6 limit that w's three digits
    meet, on GCTA-range weights."""
    rng = np.random.default_rng(kw)
    zq = _words(rng, rows, kw).to(dev)
    w = torch.as_tensor(_gcta_weights(rng, 16 * kw), dtype=torch.float32,
                        device=dev)
    want, scale = _weighted_f64(zq, w)
    h1 = (w.view(torch.int32) & -65536).view(torch.float32)
    h2 = ((w - h1).view(torch.int32) & -65536).view(torch.float32)
    rel = [_weighted_rel(packed_crossprod_weighted(zq, v), want, scale)
           for v in (h1, h1 + h2, w)]
    assert rel[2] <= 4e-6 < min(rel[0], rel[1])
    assert rel[0] > rel[1]


def test_crossprod_weighted_called_indicator(dev):
    """The pair denominators' product: the called-indicator packing of a
    panel with 5% missing calls at w = 2pq, against the float64 product."""
    from miraculix_tpu_torch import from_dense
    from miraculix_tpu_torch.io import bed
    from miraculix_tpu_torch.ops.grm import called_indicator_packing

    g = from_dense(bed.simulate_genotypes(300, 5000, seed=3,
                                          missing_rate=0.05),
                   keep_missing_info=True, device=dev)
    ind = called_indicator_packing(g)
    f = g.freq.to(torch.float32)
    w = 2.0 * f * (1.0 - f)
    want, scale = _weighted_f64(ind, w)
    got = packed_crossprod_weighted(ind, w)
    assert _weighted_rel(got, want, scale) <= 4e-6
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("rows,kw", [(300, 37), (129, 64)])
def test_crossprod_weighted_repeats_and_is_symmetric(dev, rows, kw):
    """Two calls give the same bits, the full grid is symmetric bit for bit
    and equals the triangle with its mirror, on mixed-sign weights."""
    rng = np.random.default_rng(rows * kw)
    zq = _words(rng, rows, kw).to(dev)
    w = torch.as_tensor(_gcta_weights(rng, 16 * kw, signs=True),
                        dtype=torch.float32, device=dev)
    tri = packed_crossprod_weighted(zq, w)
    full = packed_crossprod_weighted(zq, w, triangle=False)
    assert torch.equal(tri, packed_crossprod_weighted(zq, w))
    assert torch.equal(full, packed_crossprod_weighted(zq, w,
                                                       triangle=False))
    assert torch.equal(full, full.T) and torch.equal(tri, tri.T)
    assert torch.equal(tri, full)


def test_crossprod_weighted_does_not_spill(dev):
    """The kernel compiles without spills and fits a block on an SM."""
    info = _kernels.weighted_info()
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1
    assert info["threads"] == 32 * (info["tile"] // 32) ** 2


@pytest.mark.parametrize("rows,kw,cols", [
    (1, 5, 80), (65, 37, 590), (300, 130, 2080), (16385, 21, 336)])
@pytest.mark.parametrize("n", [1, 7, 8, 96, 1000])
def test_matmul_int8_matches_plain(dev, rows, kw, cols, n):
    """B10 against its plain version, exactly, at the launcher's instance
    and splits: rows off both instances' row tiles (128, 256), kw off the
    4-word chunk and the stages, digit RHS shorter than 16*kw, widths on
    both instances and ragged column groups.  The digits are the extremes
    (-64, 64 and the int8 ends) in every byte lane, against words of all
    2s and random words."""
    rng = np.random.default_rng(rows * kw + n)
    zq = _words(rng, rows, kw)
    zq[: rows // 2 + 1, : kw // 2 + 1] = int(np.uint32(0xAAAAAAAA).view(
        np.int32))
    zq = zq.to(dev)
    d = rng.choice(np.array([-128, -64, -1, 0, 1, 64, 127]), size=(cols, n))
    d[::3] = np.where(d[::3] > 0, 64, -64)
    d = torch.as_tensor(d, dtype=torch.int8, device=dev)
    got = packed_matmul_int8(zq, d)
    assert got.shape == (rows, n) and got.dtype == torch.int32
    assert torch.equal(got, packed_matmul_int8_plain(zq, d))


def _forced(zq, d, **how):
    """B10 with its instance or splits forced (``matmul_int8_quads``'s
    options) on the digit quads of ``d``."""
    return _kernels.matmul_int8_quads(
        zq, _kernels.digit_quads(d, zq.shape[1]), d.shape[1], **how)


@pytest.mark.parametrize("rows,kw,cols", [(65, 37, 590), (16385, 21, 336)])
@pytest.mark.parametrize("n", [1, 8, 16])
def test_matmul_int8_wide_tile_at_narrow_widths(dev, rows, kw, cols, n):
    """The wide instance (96 columns a block) where the launcher would pick
    the narrow one, and past it."""
    rng = np.random.default_rng(rows + n)
    zq = _words(rng, rows, kw).to(dev)
    d = torch.as_tensor(rng.choice(np.array([-64, -1, 0, 1, 64]),
                                   size=(cols, n)), dtype=torch.int8,
                        device=dev)
    assert torch.equal(_forced(zq, d, instance="wide"),
                       packed_matmul_int8_plain(zq, d))


@pytest.mark.parametrize("n", [9, 96, 97])
def test_matmul_int8_narrow_tile_at_wide_widths(dev, n):
    """The narrow instance over many column groups of 8."""
    rng = np.random.default_rng(n)
    zq = _words(rng, 300, 130).to(dev)
    d = torch.as_tensor(rng.integers(-64, 65, size=(2000, n)),
                        dtype=torch.int8, device=dev)
    assert torch.equal(_forced(zq, d, instance="narrow"),
                       packed_matmul_int8_plain(zq, d))


@pytest.mark.parametrize("instance", ["narrow", "wide"])
@pytest.mark.parametrize("rows,kw,n,split_words", [
    (300, 130, 8, 32), (300, 130, 96, 32), (1000, 1024, 12, 64),
    (129, 77, 5, 32), (4097, 512, 96, 160)])
def test_matmul_int8_split_paths(dev, instance, rows, kw, n, split_words):
    """Forced contraction splits (whole stages: multiples of 32 words fit
    both instances) with their atomic adds, the last split short, both
    copy paths (kw % 4)."""
    rng = np.random.default_rng(rows + kw + n)
    zq = _words(rng, rows, kw).to(dev)
    d = torch.as_tensor(rng.integers(-64, 65, size=(16 * kw - 3, n)),
                        dtype=torch.int8, device=dev)
    assert torch.equal(
        _forced(zq, d, instance=instance, split_words=split_words),
        packed_matmul_int8_plain(zq, d))


@pytest.mark.parametrize("cols,kw,n", [(80, 5, 1), (590, 37, 7),
                                       (2080, 130, 96), (336, 21, 97),
                                       (16 * 64, 64, 8)])
def test_matmul_int8_layout_prepass_matches_plain(dev, cols, kw, n):
    """The digit-quad pre-pass on the card equals its plain version byte for
    byte: partial planes, kw off the 4-word chunk, ragged widths."""
    rng = np.random.default_rng(cols + n)
    d = torch.as_tensor(rng.integers(-128, 128, size=(cols, n)),
                        dtype=torch.int8)
    got = _kernels.digit_quads(d.to(dev), kw)
    assert torch.equal(got.cpu(), _kernels.digit_quads(d, kw))


def test_matmul_int8_instances_fit_as_designed(dev):
    """No spills; one wide block (160 KB) and two narrow ones (80 KB) an
    SM; the geometry the splits assume."""
    info = _kernels.matmul_int8_info()
    assert info["wide"]["blocks_per_sm"] >= 1
    assert info["narrow"]["blocks_per_sm"] >= 2
    for name, (rows, cols) in (("narrow", (128, 8)), ("wide", (256, 96))):
        assert info[name]["local_bytes"] == 0
        assert (info[name]["rows"], info[name]["cols"]) == (rows, cols)


@pytest.mark.parametrize("digit", [64, -64])
@pytest.mark.parametrize("n", [8, 96])
def test_matmul_int8_largest_sums_at_the_chunk_cap(dev, digit, n):
    """All-2 words by all-+-64 digits at kw = 2^19, the f64 tier's chunk
    cap: every output is +-2 * 64 * 16 * 2^19 = +-2^30, the largest sum
    the f64 tier produces; saturation or overflow of the s32 path, or a
    split added twice, would show.  Rows off 16 and the launcher's splits."""
    kw = 2 ** 19
    zq = torch.full((40, kw), int(np.uint32(0xAAAAAAAA).view(np.int32)),
                    dtype=torch.int32, device=dev)
    d = torch.full((16 * kw, n), digit, dtype=torch.int8, device=dev)
    got = packed_matmul_int8(zq, d)
    assert torch.equal(got, torch.full((40, n), digit * 2 * 16 * kw,
                                       dtype=torch.int32, device=dev))
    assert torch.equal(got, packed_matmul_int8_plain(zq[:1], d).expand(40, n))


def test_matmul_int8_rejects_what_it_cannot_hold_exactly(dev):
    zq = _words(np.random.default_rng(0), 64, 8).to(dev)
    with pytest.raises(ValueError, match=r"\[-128, 127\]"):
        packed_matmul_int8(zq, torch.full((128, 2), 200, device=dev))
    with pytest.raises(ValueError, match="overflow"):
        packed_matmul_int8(torch.zeros((1, 2 ** 20), dtype=torch.int32,
                                       device=dev),
                           torch.zeros((1, 1), dtype=torch.int8, device=dev))


@pytest.mark.parametrize("kw_cap", [128, 2 ** 19])
def test_packed_matmul_exact_matches_cpu(dev, kw_cap):
    """The f64 tier on the card (digits and recombination on the device)
    against the CPU path and a float64 oracle, with the packed-word axis
    chunked at 128 words (4 chunks) and unchunked."""
    rng = np.random.default_rng(kw_cap)
    zq = _words(rng, 300, 512)
    b = rng.standard_normal((8000, 3)) * np.exp2(
        rng.integers(-20, 20, size=(1, 3)))
    got = packed_matmul_exact(zq.to(dev), b, _kw_cap=kw_cap)
    cpu = packed_matmul_exact(zq, b, _kw_cap=kw_cap)
    want = decode_planar16(zq, torch.float64)[:, :8000].numpy() @ b
    assert got.dtype == np.float64
    scale = np.abs(want).max()
    assert np.abs(got - cpu).max() / scale < 1e-12
    assert np.abs(got - want).max() / scale < 1e-13


def test_dgemm_f64_matches_cpu(dev):
    """dgemm(precision="f64") on the card against the CPU path at 1e-12, in
    every centering mode, with the missing correction and normalize.  The
    normalizing scale is the panel's stored f32 sum (as in the reference),
    whose order of addition differs between the two devices: each side's
    normalized result is compared times its own scale."""
    from miraculix_tpu_torch import dgemm, from_dense
    from miraculix_tpu_torch.io import bed

    g = bed.simulate_genotypes(300, 2000, seed=5, missing_rate=0.02)
    rng = np.random.default_rng(5)
    user = rng.standard_normal(2000)
    panels = {d: from_dense(g, keep_missing_info=True, device=d)
              for d in ("cpu", dev)}
    for trans, rows in (("n", 2000), ("t", 300)):
        b = rng.standard_normal((rows, 12))
        for center in (False, True, "colmeans", user):
            for norm in (False, True):
                got, want = (dgemm(panels[d], b, trans=trans, center=center,
                                   precision="f64", ignore_missings=False,
                                   normalize=norm) * (np.sqrt(float(
                                       panels[d].sigma2 if trans == "t"
                                       else panels[d].pseudo_sigma2))
                                       if norm else 1.0)
                             for d in (dev, "cpu"))
                assert isinstance(got, np.ndarray) and got.dtype == np.float64
                assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def test_dense_solvers_put_arrays_on_the_card(dev):
    """numpy inputs of the dense solvers go to the card unless the caller
    names another device, and agree with the CPU's results."""
    from miraculix_tpu_torch import solve

    rng = np.random.default_rng(3)
    m = rng.standard_normal((40, 40))
    a, b = m @ m.T + 40.0 * np.eye(40), rng.standard_normal((40, 2))
    for fn, args in ((solve.dense_solve, (a, b)), (solve.chol2inv, (a,)),
                     (solve.sqrt_posdef, (a,)), (solve.sqrt_rhs, (a, b)),
                     (solve.solve_posdef, (a, b)),
                     (solve.solve_relmat, (a, 0.7, b[:, 0])),
                     (solve.x_cinv_y_logdet, (b, a, b))):
        got, want = fn(*args)[0], fn(*args, device="cpu")[0]
        assert got.is_cuda and got.dtype == torch.float64
        assert float((got.cpu() - want).abs().max()) <= 1e-10 * float(
            want.abs().max())


@pytest.mark.parametrize("bs,lower,dtype", [
    (77, True, torch.float32), (300, False, torch.float32),
    (512, True, torch.float32), (128, False, torch.float64)])
def test_sparse_solver_matches_cpu(dev, bs, lower, dtype):
    """The card's analysis (float32: the device inversion; float64: the
    host's) and sweeps against the CPU solver at a ragged n, with TF32 on
    for the caller: the solver's products must not take it."""
    from miraculix_tpu_torch.solve.sparse import (SparseTriangularSolver,
                                                  simulate_pedigree_factor)

    n = 2999
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=7, seed=bs)
    r, c = (r, c) if lower else (c, r)
    rng = np.random.default_rng(bs)
    b = rng.standard_normal((n, 5))
    perm = rng.permutation(n) + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    cpu = SparseTriangularSolver(r, c, v, n, bs=bs, lower=lower, dtype=dtype,
                                 device="cpu")
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gpu = SparseTriangularSolver(r, c, v, n, bs=bs, lower=lower,
                                     dtype=dtype, device=dev)
        assert gpu._dinv.is_cuda and gpu._dtype == dtype

        def rel(x, y):
            return float((x.cpu() - y).abs().max() / y.abs().max())

        assert rel(gpu._dinv, cpu._dinv) < tol
        for trans in ("n", "t"):
            assert rel(gpu.solve(b, trans=trans),
                       cpu.solve(b, trans=trans)) < tol, trans
            assert rel(gpu.matvec(b, trans=trans),
                       cpu.matvec(b, trans=trans)) < tol, trans
        assert rel(gpu.solve_lltx(b, perm=perm, refine=1),
                   cpu.solve_lltx(b, perm=perm, refine=1)) < tol
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    x, res = gpu.solve_f64(b, trans="t")
    assert res <= 1e-12
    np.testing.assert_allclose(x, cpu.solve_f64(b, trans="t")[0], rtol=0,
                               atol=1e-10 * np.abs(x).max())


def test_sparse_solver_defaults_to_float32_on_the_card(dev):
    from miraculix_tpu_torch.solve.sparse import (SparseTriangularSolver,
                                                  simulate_pedigree_factor)

    r, c, v = simulate_pedigree_factor(1000, seed=1)
    slv = SparseTriangularSolver(r, c, v, 1000)
    assert slv.device.type == "cuda" and slv._dtype == torch.float32


@pytest.mark.parametrize("n_anim,n_geno,snps", [(300, 97, 1001),
                                                (257, 257, 600)])
def test_single_step_matches_cpu(dev, n_anim, n_geno, snps):
    """SingleStepHInv, ssgblup and single-step REML on the card against
    their CPU paths (ragged panels; every animal genotyped in the second,
    so A11 is empty)."""
    from miraculix_tpu_torch import from_dense, pedigree
    from miraculix_tpu_torch import ssgblup as ss
    from miraculix_tpu_torch.io import bed

    sire, dam = pedigree.simulate_pedigree(n_anim, n_founders=13, seed=2)
    geno = bed.simulate_genotypes(n_geno, snps, seed=3)
    geno_ids = np.arange(n_anim - n_geno, n_anim) + 1
    rng = np.random.default_rng(4)
    v = rng.standard_normal((n_anim, 3))
    obs_ids = np.sort(rng.choice(n_anim, size=n_anim // 2,
                                 replace=False)) + 1
    y = rng.standard_normal(len(obs_ids))
    out = {}
    for d in ("cpu", dev):
        hinv = ss.SingleStepHInv(sire, dam, from_dense(geno, device=d),
                                 geno_ids)
        assert hinv.ainv.rows.device.type == torch.device(d).type
        res = ss.ssgblup(y, hinv, obs_ids=obs_ids, h2=0.4)
        h2, det = ss.estimate_h2_reml_ss(y, hinv, obs_ids=obs_ids,
                                         n_probes=4, max_iter=3)
        out[str(d)] = (hinv.matvec(v).cpu().numpy(), res, h2, det)
    (mv_c, res_c, h2_c, det_c), (mv_g, res_g, h2_g, det_g) = out.values()
    assert np.abs(mv_g - mv_c).max() / np.abs(mv_c).max() < 1e-4
    assert np.abs(res_g.u - res_c.u).max() / np.abs(res_c.u).max() < 1e-3
    assert abs(res_g.iterations - res_c.iterations) <= 2
    assert abs(h2_g - h2_c) < 1e-3 and det_g["iterations"] == \
        det_c["iterations"]


def _streamed_fileset(tmp_path, indiv, snps, seed):
    from miraculix_tpu_torch.io import bed

    path = str(tmp_path / "s.bed")
    bed.write_bed(path, bed.simulate_genotypes(indiv, snps, seed=seed,
                                               missing_rate=0.02))
    return path


def test_streamed_chunks_are_pinned(dev, tmp_path):
    import miraculix_tpu_torch as mt

    path = _streamed_fileset(tmp_path, 300, 1000, 1)
    sg = mt.StreamedGeno.from_bed(path, chunk_snps=300, device=dev)
    host = mt.from_bed(path, device_put=False, device=dev)
    for g in sg.chunks + [host]:
        assert g.host_resident and g.device.type == "cuda"
        for t in (g.zq_n, g.zq_t, g.freq, g.pseudo_freq):
            assert t.device.type == "cpu" and t.is_pinned()


@pytest.mark.parametrize("indiv,snps,chunk", [(300, 1000, 300),
                                              (257, 2049, 512),
                                              (1000, 700, 129)])
def test_half_cached_streamed_matches_resident(dev, tmp_path, indiv, snps,
                                               chunk):
    """Half the chunks cached, the rest streaming through the staging
    buffers on the side stream, at ragged chunk sizes: the products of the
    resident panel ('t' bit for bit, 'n' and the matvec to f32 partials);
    every chunk product one kernel launch and no plain version called."""
    import miraculix_tpu_torch as mt
    from miraculix_tpu_torch import streamed

    path = _streamed_fileset(tmp_path, indiv, snps, indiv + snps)
    sg = mt.StreamedGeno.from_bed(path, chunk_snps=chunk, device=dev)
    res = mt.from_bed(path, device=dev)
    half = sg.n_chunks // 2
    assert sg.cache_to_device(sum(c.nbytes for c in sg.chunks[:half])) \
        == half
    rng = np.random.default_rng(indiv)
    x = rng.standard_normal((indiv, 3)).astype(np.float32)
    bn = rng.standard_normal((snps, 70)).astype(np.float32)   # the wide one
    streamed.reset_stream_counts()
    _kernels.reset_launch_counts()
    mv = sg.grm_matvec(x)
    got_t = sg.dgemm(x, trans="t")
    got_n = sg.dgemm(bn, trans="n", center="colmeans")
    got_64 = sg.dgemm(bn[:, :12].astype(np.float64), trans="n",
                      precision="f64")
    launched = sum(_kernels.LAUNCHES.values())
    assert launched == streamed.STREAM["products"] == sg.n_chunks * 5
    assert sum(_kernels.PLAIN_CALLS.values()) == 0
    assert streamed.STREAM["h2d_copies"] == 4 * (sg.n_chunks - half)
    assert streamed.copy_seconds() > 0
    want = mt.grm_matvec(res, torch.from_numpy(x).to(dev)).cpu().numpy()
    assert np.abs(mv - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(
        got_t, mt.dgemm(res, x, trans="t").cpu().numpy())
    want = mt.dgemm(res, bn, trans="n", center="colmeans").cpu().numpy()
    assert np.abs(got_n - want).max() <= 1e-6 * np.abs(want).max()
    want = mt.dgemm(res, bn[:, :12].astype(np.float64), trans="n",
                    precision="f64")
    assert np.abs(got_64 - want).max() <= 1e-12 * np.abs(want).max()


def test_side_stream_copy_matches_synchronous_copy(dev, tmp_path):
    """The overlapped pass (copies on the side stream, events) gives what
    the same pass gives with every chunk copied synchronously first, over
    many passes that reuse both staging buffers."""
    import miraculix_tpu_torch as mt
    from miraculix_tpu_torch.geno import _moved

    path = _streamed_fileset(tmp_path, 512, 3000, 9)
    sg = mt.StreamedGeno.from_bed(path, chunk_snps=400, device=dev)
    sync = [_moved(c, dev) for c in sg.chunks]
    torch.cuda.synchronize()
    rng = np.random.default_rng(2)
    for _ in range(3):
        x = torch.as_tensor(rng.standard_normal((512, 2)),
                            dtype=torch.float32, device=dev)
        got = sg.grm_matvec(x)
        want = torch.zeros_like(got)
        for g in sync:
            want += mt.dgemm(g, mt.dgemm(g, x, trans="t"), trans="n")
        assert torch.equal(got, want)


def test_cache_to_device_default_budget_is_read_once(dev, tmp_path,
                                                     monkeypatch):
    """With no budget, cache_to_device() takes half the free memory of its
    first call: a second call, after the cached chunks lowered the free
    memory, keeps the same chunks and returns the same count."""
    import miraculix_tpu_torch as mt

    path = _streamed_fileset(tmp_path, 512, 3200, 11)
    sg = mt.StreamedGeno.from_bed(path, chunk_snps=400, device=dev)
    total = sg.nbytes()

    def mem_get_info(device=None):     # 1.1 panels free before caching
        held = sum(c.nbytes for c in sg.chunks if not c.host_resident)
        return int(1.1 * total) - held, 80 << 30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    first = sg.cache_to_device()
    assert first == 4 and sg.n_chunks == 8
    assert sg.cache_to_device() == first
    assert sum(not c.host_resident for c in sg.chunks) == first


def test_host_resident_panel_launches_kernels_only(dev, tmp_path):
    """A host-resident GenoMatrix whose compute device is the card: each
    call copies it there and launches the kernels, never a plain version."""
    import miraculix_tpu_torch as mt
    from miraculix_tpu_torch import gblup

    path = _streamed_fileset(tmp_path, 300, 1000, 4)
    host = mt.from_bed(path, device_put=False, device=dev)
    res = mt.from_bed(path, device=dev)
    y = np.random.default_rng(5).standard_normal(300)
    _kernels.reset_launch_counts()
    got = (mt.dgemm(host, np.ones((1000, 2), np.float32)),
           mt.grm(host), gblup.gblup(host, y, n_pcs=2).g_hat)
    assert _kernels.LAUNCHES["tall_dgemm_cv"] > 0
    assert _kernels.LAUNCHES["crossprod"] > 0
    assert sum(_kernels.PLAIN_CALLS.values()) == 0
    assert got[0].device.type == "cuda"
    want = (mt.dgemm(res, np.ones((1000, 2), np.float32)), mt.grm(res),
            gblup.gblup(res, y, n_pcs=2).g_hat)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _sharded_world(tmp_path, dev):
    """A world-1 NCCL group bound to the card, through a FileStore."""
    from miraculix_tpu_torch import parallel

    parallel.init_distributed(num_processes=1, process_id=0,
                              backend="nccl", device_id=dev,
                              init_method=f"file://{tmp_path}/store")


@pytest.mark.parametrize("indiv,snps", [(300, 5000), (1100, 9000)])
def test_sharded_four_shards_on_one_card(dev, tmp_path, indiv, snps):
    """4 shards on cuda:0 in a world-1 NCCL group against the resident
    panel at ragged shapes (a partial and an empty shard at 5,000 SNPs):
    dgemm 'n'/'t' at 1, 33, 65 columns, the raw GRM exactly, CG, the 2D
    GRM; no plain version runs; the group is torn down."""
    import torch.distributed as dist

    import miraculix_tpu_torch as mt
    from miraculix_tpu_torch import parallel
    from miraculix_tpu_torch.io import bed
    from miraculix_tpu_torch.parallel import sharded, sharded2d

    g = bed.simulate_genotypes(indiv, snps, seed=indiv)
    res = mt.from_dense(g, device=dev)
    _sharded_world(tmp_path, dev)
    try:
        mesh = parallel.make_mesh(devices=[dev] * 4)
        sg = parallel.shard_genotypes(g, mesh)
        s2 = parallel.shard_genotypes_2d(g, parallel.make_mesh_2d(
            devices=[dev] * 4))
        rng = np.random.default_rng(snps)
        _kernels.reset_launch_counts()
        for n in (1, 33, 65):
            for trans, rows in (("n", snps), ("t", indiv)):
                b = rng.standard_normal((rows, n)).astype(np.float32)
                got = parallel.host_global(parallel.sharded_dgemm(
                    sg, b, trans))
                want = mt.dgemm(res, b, trans).cpu().numpy()
                assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        k3 = _kernels.LAUNCHES["crossprod"]
        raw = sharded.sharded_crossprod(sg)
        assert _kernels.LAUNCHES["crossprod"] == k3 + 4     # one a shard
        assert raw.is_cuda and torch.equal(
            raw, packed_crossprod(res.zq_n))
        raw2 = parallel.host_global(sharded2d.sharded_crossprod_2d(s2))
        assert np.array_equal(raw2[:indiv, :indiv],
                              raw.cpu().numpy()[:indiv, :indiv])
        rhs = rng.standard_normal(indiv).astype(np.float32)
        r = parallel.sharded_cg_solve(sg, rhs, lam=40.0, tol=1e-4,
                                      precondition=True)
        w = mt.grm_cg_solve(res, rhs, lam=40.0, tol=1e-4, precondition=True)
        x, xw = r.x.cpu().numpy(), w.x.cpu().numpy()
        assert np.abs(x - xw).max() <= 1e-4 * np.abs(xw).max()
        assert abs(r.iterations - w.iterations) <= 2
        assert sum(_kernels.PLAIN_CALLS.values()) == 0
        assert _kernels.LAUNCHES["tall_dgemm"] > 0
        assert _kernels.LAUNCHES["wide_dgemm_split"] > 0
        assert _kernels.LAUNCHES["crossprod_rect"] > 0
        assert parallel.COLLECTIVES["dist.all_gather_into_tensor"]["calls"]
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def _two_rank_worker(rank, store, out):
    import torch.distributed as dist

    import miraculix_tpu_torch as mt
    from miraculix_tpu_torch import parallel
    from miraculix_tpu_torch.io import bed

    dev = torch.device("cuda", rank)
    parallel.init_distributed(num_processes=2, process_id=rank,
                              backend="nccl", device_id=dev,
                              init_method=f"file://{store}")
    g = bed.simulate_genotypes(500, 7000, seed=3)
    sg = parallel.shard_genotypes(g, parallel.make_mesh(devices=[dev] * 2))
    b = np.random.default_rng(1).standard_normal((500, 3)).astype(np.float32)
    got = parallel.host_global(parallel.sharded_dgemm(sg, b, "t"))
    want = mt.dgemm(mt.from_dense(g, device=dev), b, "t").cpu().numpy()
    raw = parallel.host_global(parallel.sharded_grm(sg, scatter=True))
    torch.save({"err": float(np.abs(got - want).max()
                             / np.abs(want).max()),
                "grm": raw}, f"{out}.{rank}")
    dist.destroy_process_group()


def test_sharded_two_ranks_on_two_cards(dev, tmp_path):
    """One NCCL rank per card, 2 shards each (needs two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import torch.multiprocessing as tmp

    out = str(tmp_path / "out")
    tmp.spawn(_two_rank_worker, args=(str(tmp_path / "store"), out),
              nprocs=2)
    r0, r1 = (torch.load(f"{out}.{k}", weights_only=False) for k in (0, 1))
    assert r0["err"] <= 1e-5 and r1["err"] <= 1e-5
    assert np.array_equal(r0["grm"], r1["grm"])


@pytest.mark.parametrize("devices_per_proc", [1, 2])
def test_mp_drive_one_nccl_rank_per_card(dev, devices_per_proc):
    """The multi-process drive (the CPU tests' checklist) with one NCCL
    rank per card and 1 or 2 shards on each (needs two cards)."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two CUDA devices")
    from miraculix_tpu_torch.parallel import mp_check

    _kernels.build()          # once, before the ranks load it
    outs = mp_check.run_cluster(num_processes=count, timeout=600,
                                snps=9000, indiv=600,
                                devices_per_proc=devices_per_proc,
                                backend="nccl")
    for out in outs:
        assert "MP_DRIVE_OK" in out and "kernel launches" in out
        assert "dist.all_reduce" in out



def test_facades_on_the_card_match_the_cpu(dev):
    """The C API, the R API and the MoBPS bridge on a ragged panel (301
    animals x 1,003 SNPs) on the card against their CPU path; on the card
    the kernels run and no plain version does; ``free_compressed`` releases
    the panel's device memory."""
    from miraculix_tpu_torch import api, mobps, rapi
    from miraculix_tpu_torch.formats import Coding, CodedMatrix, encode
    from miraculix_tpu_torch.io import bed, codec
    from miraculix_tpu_torch.utils import panel_cache

    g = bed.simulate_genotypes(301, 1003, seed=16, missing_rate=0.01)
    plink = codec.dense_to_plink(g)
    freq = codec.allele_freq(g)
    rng = np.random.default_rng(16)
    b, bt = rng.standard_normal((1003, 10)), rng.standard_normal((301, 10))
    v, w = rng.standard_normal(1003), rng.standard_normal(301)
    s = (rng.random((32, 301)) < 0.05) * rng.standard_normal((32, 301))
    ia = np.concatenate([[0], np.cumsum((s != 0).sum(axis=1))]) + 1
    ja, a = np.nonzero(s)[1] + 1, s[s != 0]
    m = CodedMatrix(encode(g, Coding.TWO_BIT), Coding.TWO_BIT, 1003, 301)
    pop = mobps.Population(snps=1003, individuals={
        (1, 1, n + 1): mobps.Individual(haplo=np.stack(
            [(g[n] >= 1) & (g[n] != 3), g[n] == 2]).astype(np.uint8))
        for n in range(40)})
    sel = ([1] * 40, [1] * 40, list(range(1, 41)))
    out = {}
    panel_cache.clear()
    api.set_options(use_gpu=True)
    for d in ("cpu", dev):
        _kernels.reset_launch_counts()
        obj = api.plink2compressed(plink, None, 1003, 301, freq, device=d)
        assert obj.device.type == torch.device(d).type
        out[str(d)] = {
            "N": api.dgemm_compressed("N", obj, 10, b),
            "T": api.dgemm_compressed("T", obj, 10, bt),
            "plink": api.dgemm_plink("N", plink, None, 1003, 301, None, 10,
                                     b, device=d),
            "sparse": api.sparse_times_plink("N", "N", plink, None, 1003,
                                             301, 32, ia, ja, a, device=d),
            "geno_vector": rapi.geno_vector(m, v, device=d),
            "rel": rapi.vector_rel_matrix(m, w, device=d),
            "crossprod": rapi.crossprod_int(m, device=d),
            "freq": api.get_compressed_freq(obj),
            "mobps": mobps.compute_relationship(pop, *sel,
                                                device=d).cpu().numpy()}
    api.set_options()
    launched = {k for k, n in _kernels.LAUNCHES.items() if n}
    assert {"tall_dgemm", "tall_dgemm_cv", "crossprod"} <= launched
    assert not _kernels.PLAIN_CALLS
    cpu, gpu = out["cpu"], out[str(dev)]
    for k in cpu:
        if cpu[k].dtype.kind in "iu" or k == "freq":
            np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
        else:
            err = np.abs(gpu[k] - cpu[k]).max() / np.abs(cpu[k]).max()
            assert err <= 1e-5, (k, err)
    panel_cache.clear()
    obj = api.plink2compressed(plink, None, 1003, 301, device=dev)
    nbytes = obj.nbytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    api.free_compressed(obj)
    assert obj.zq_n is None and obj.zq_t is None and obj.freq is None
    assert before - torch.cuda.memory_allocated(dev) >= nbytes


def _row_sq_words(rng, rows, kw, words):
    """"genotypes" (codes 0-2), "any" (every bit pattern: the code 3 and the
    sign bit) or "all_two" (the largest sums)."""
    if words == "genotypes":
        return _words(rng, rows, kw)
    if words == "all_two":
        return torch.full((rows, kw), np.int32(np.uint32(0xAAAAAAAA)).item(),
                          dtype=torch.int32)
    w = rng.integers(0, 2 ** 32, size=(rows, kw), dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("rows", [1, 31, 33, 1000])
@pytest.mark.parametrize("kw", [1, 3, 4, 5, 351, 1408])
@pytest.mark.parametrize("words", ["genotypes", "any", "all_two"])
def test_row_sq_stats_matches_plain(dev, rows, kw, words):
    zq = _row_sq_words(np.random.default_rng(rows * kw), rows, kw,
                       words).to(dev)
    assert torch.equal(packed_row_sq_stats(zq), packed_row_sq_stats_plain(zq))


@pytest.mark.parametrize("rows", [1, 31, 33])
@pytest.mark.parametrize("kw", [2047, 2048, 2051, 62592])
@pytest.mark.parametrize("words", ["any", "all_two"])
def test_row_sq_stats_wide_rows_match_plain(dev, rows, kw, words):
    """Rows past the kernel's warp-a-row width take a block each; all-2
    rows of 62,592 words sum to 4,005,888, exact in f32."""
    zq = _row_sq_words(np.random.default_rng(rows + kw), rows, kw,
                       words).to(dev)
    got = packed_row_sq_stats(zq)
    assert torch.equal(got, packed_row_sq_stats_plain(zq))
    if words == "all_two":
        assert float(got.max()) == 64.0 * kw


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("kw", [5, 351, 1408, 4099, 62592])
def test_row_sq_stats_row_views_off_alignment(dev, offset, kw):
    """A contiguous view that starts ``offset`` words past a 16-byte
    boundary: every row's head is read word by word."""
    rows = 33
    buf = _row_sq_words(np.random.default_rng(kw), rows * kw + offset, 1,
                        "any").to(dev).reshape(-1)
    zq = buf[offset:].view(rows, kw)
    assert zq.is_contiguous() and zq.data_ptr() % 16 == 4 * offset
    assert torch.equal(packed_row_sq_stats(zq), packed_row_sq_stats_plain(zq))


def test_row_sq_stats_one_launch_a_call(dev):
    zq = _row_sq_words(np.random.default_rng(7), 1000, 1408, "any").to(dev)
    _kernels.reset_launch_counts()
    packed_row_sq_stats(zq)
    assert _kernels.LAUNCHES["row_sq_stats"] == 1
    assert sum(_kernels.LAUNCHES.values()) == 1
    assert not _kernels.PLAIN_CALLS


def test_row_sq_stats_refuses_what_it_does_not_take(dev):
    zq = _row_sq_words(np.random.default_rng(8), 64, 16, "any").to(dev)
    for bad in (zq.T, zq[:, ::2], zq.to(torch.int64), zq.reshape(-1),
                zq.cpu()):
        with pytest.raises(ValueError, match="contiguous 2-d torch.int32"):
            _kernels.row_sq_stats(bad)

"""The port's CUDA kernels against their plain torch versions, on the GPU.

Marked ``cuda``: every test skips where no CUDA device is present.  Run on a
GPU host with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` because the suite's conftest configures jax, which the
port does not need).  Shapes here are deliberately ragged: row counts off
the 64-row tile, word counts off the 16/32-word steps, odd RHS widths.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu_torch import _kernels  # noqa: E402
from miraculix_tpu_torch.ops.common import decode_planar16  # noqa: E402
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


@pytest.mark.parametrize("rows,kw", [(64, 16), (65, 17), (200, 33),
                                     (513, 128), (1, 1)])
def test_crossprod_matches_plain(dev, rows, kw):
    zq = _words(np.random.default_rng(rows * kw), rows, kw).to(dev)
    assert torch.equal(packed_crossprod(zq), packed_crossprod_plain(zq))


@pytest.mark.parametrize("ra,rb,kw", [(64, 64, 16), (300, 700, 37),
                                      (65, 1, 17), (1, 129, 5),
                                      (513, 200, 128)])
def test_crossprod_rect_matches_plain(dev, ra, rb, kw):
    """B8: ra != rb, rows off the 64-row tile, kw off the 16-word step."""
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


@pytest.mark.parametrize("rows,kw,snps", [(64, 16, 256), (65, 17, 270),
                                          (200, 33, 500), (513, 128, 2048),
                                          (1, 5, 3)])
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


@pytest.mark.parametrize("rows,kw,cols", [
    (1, 5, 80), (65, 37, 590), (300, 130, 2080), (16385, 21, 336)])
@pytest.mark.parametrize("n", [1, 7, 8, 96, 1000])
def test_matmul_int8_matches_plain(dev, rows, kw, cols, n):
    """B10 against its plain version, exactly: rows off both tile heights,
    kw off the 8- and 16-word steps, digit RHS shorter than 16*kw, widths on
    both tile shapes and ragged column tiles.  The digits are the extremes
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


@pytest.mark.parametrize("rows,kw,cols", [(65, 37, 590), (16385, 21, 336)])
@pytest.mark.parametrize("n", [1, 8, 16])
def test_matmul_int8_wide_tile_at_narrow_widths(dev, monkeypatch, rows, kw,
                                                cols, n):
    """The 64 x 64 tile where the launcher would pick the 256 x 16 one."""
    monkeypatch.setattr(_kernels, "INT8_NARROW_COLS", 0)
    rng = np.random.default_rng(rows + n)
    zq = _words(rng, rows, kw).to(dev)
    d = torch.as_tensor(rng.choice(np.array([-64, -1, 0, 1, 64]),
                                   size=(cols, n)), dtype=torch.int8,
                        device=dev)
    assert torch.equal(packed_matmul_int8(zq, d),
                       packed_matmul_int8_plain(zq, d))


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

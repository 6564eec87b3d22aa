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
    packed_matmul_tall, packed_matmul_tall_plain, rhs_values)
from miraculix_tpu_torch.ops.grm import (  # noqa: E402
    packed_crossprod, packed_crossprod_plain)

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

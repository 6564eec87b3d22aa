"""The port's rectangular, masked and weighted crossproducts and the GRM
family against miraculix_tpu on the same panels.

The reference runs as its own tests run it (Pallas interpret mode on the
CPU; ``tile_m=128, tile_kw=128`` where its tests pass them); the port runs
the plain versions of its kernels.  Crossproducts and indicator packings
are exact and must be equal; tolerances otherwise are the reference tests':
the weighted product 5e-6 of max, grm_blocked 1e-4, grm_yang 2e-6 and
dominance_grm 1e-5 relative to max.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops import grm as ref_grm  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import _kernels  # noqa: E402
from miraculix_tpu_torch.io import bed as pt_bed  # noqa: E402
from miraculix_tpu_torch.ops import grm as pt_grm  # noqa: E402

CPU = "cpu"  # the port's panels are built on the CPU in these tests
FIELDS = ("zq_n", "zq_t", "freq", "pseudo_freq", "miss_rows_n",
          "miss_cols_n")
BUILDS = ["from_dense", "from_reference_state"]


def _port(ref, g, build, tracked=False):
    if build == "from_dense":
        return mt.from_dense(g, keep_missing_info=tracked, device=CPU)
    state = {k: None if getattr(ref, k) is None else np.asarray(getattr(ref, k))
             for k in FIELDS}
    return mt.from_reference_state(dict(state, snps=ref.snps,
                                        indiv=ref.indiv), device=CPU)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def ragged():
    """700 animals (pads to 768 rows) x 600 SNPs; the first 300 animals are
    the other side of the rectangular product."""
    g = bed.simulate_genotypes(700, 600, seed=3)
    return g, mx.from_dense(g)


@pytest.mark.parametrize("build", BUILDS)
def test_crossprod_rect_equals_reference(ragged, build):
    g, ref = ragged
    port = _port(ref, g, build)
    want = np.asarray(ref_grm.packed_crossprod_rect(
        ref.zq_n[:300], ref.zq_n[:700], tile_m=128, tile_kw=128,
        interpret=True))
    got = mt.packed_crossprod_rect(port.zq_n[:300], port.zq_n[:700])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, g[:300].astype(np.int64) @ g.astype(np.int64).T)
    with pytest.raises(ValueError, match="widths differ"):
        mt.packed_crossprod_rect(port.zq_n, port.zq_n[:, :64])


@pytest.mark.parametrize("route", ["rect", "tri"])
def test_crossprod_routes_equal_reference(ragged, route):
    """triangle=False (the reference's _crossprod_kernel) and wrap=False
    (its _crossprod_tri_kernel, reached with tile_i != tile_j)."""
    g, ref = ragged
    port = _port(ref, g, "from_dense")
    if route == "rect":
        want = ref_grm.packed_crossprod(ref.zq_n, triangle=False,
                                        tile_m=128, interpret=True)
        got = mt.packed_crossprod(port.zq_n, triangle=False)
    else:
        want = ref_grm.packed_crossprod(ref.zq_n, tile_i=128, tile_j=256,
                                        wrap=False, interpret=True)
        got = mt.packed_crossprod(port.zq_n, wrap=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows", [64, 300, 768])
def test_mirror_merge_restores_the_lower_tiles(rows):
    """B12 leaves the tiles wholly below the diagonal unwritten; the merge
    must take every such entry from its mirror and no other."""
    rng = np.random.default_rng(rows)
    full = torch.as_tensor(rng.integers(0, 1000, (rows, rows)),
                           dtype=torch.int32)
    full = full + full.T
    tile = _kernels.CROSSPROD_TILE
    blk = torch.arange(rows) // tile
    below = blk[None, :] < blk[:, None]
    written = torch.where(below, torch.full_like(full, -7), full)
    np.testing.assert_array_equal(pt_grm._mirror_merge(written, tile), full)


@pytest.mark.parametrize("triangle", [True, False])
def test_crossprod_weighted_matches_reference(triangle):
    g = bed.simulate_genotypes(150, 700, seed=31)
    ref = mx.from_dense(g)
    port = mt.from_dense(g, device=CPU)
    w = np.random.default_rng(0).uniform(0.1, 3.0, 700)
    want = np.asarray(ref_grm.packed_crossprod_weighted(
        ref.zq_n, jnp.asarray(w, jnp.float32), tile_m=128, tile_kw=128,
        interpret=True, triangle=triangle), np.float64)[:150, :150]
    got = pt_grm.packed_crossprod_weighted(port.zq_n, w, triangle=triangle)
    assert got.dtype == torch.float32
    assert _rel(got.numpy()[:150, :150], want) < 5e-6
    oracle = (g.astype(np.float64) * w[None, :]) @ g.astype(np.float64).T
    assert _rel(got.numpy()[:150, :150], oracle) < 5e-6
    with pytest.raises(ValueError, match="entries"):
        pt_grm.packed_crossprod_weighted(port.zq_n, np.ones(16 * 128 + 1))


@pytest.fixture(scope="module")
def missing():
    g = bed.simulate_genotypes(120, 500, seed=33, missing_rate=0.1)
    return g, mx.from_dense(g, keep_missing_info=True)


@pytest.mark.parametrize("with_use", [False, True])
@pytest.mark.parametrize("build", BUILDS)
def test_pairwise_nonmissing_equals_reference(missing, build, with_use):
    g, ref = missing
    port = _port(ref, g, build, tracked=True)
    use = None
    if with_use:
        use = np.zeros(500, bool)
        use[::3] = True
    np.testing.assert_array_equal(
        pt_grm.called_indicator_packing(port, use=use).numpy().view(
            np.uint32),
        np.asarray(ref_grm.called_indicator_packing(ref, use=use)))
    want = np.asarray(ref_grm.pairwise_nonmissing(ref, use=use, tile_m=128,
                                                  tile_kw=128))
    got = mt.pairwise_nonmissing(port, use=use)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("source", ["genomatrix", "dense", "bed"])
def test_grm_blocked_matches_reference(tmp_path, source):
    g = bed.simulate_genotypes(700, 400, seed=7)
    if source == "genomatrix":
        ref_src, port_src = mx.from_dense(g), mt.from_dense(g, device=CPU)
        kw = {}
    elif source == "dense":
        ref_src = port_src = g
        kw = dict(device=CPU)
    else:
        ref_src = port_src = str(tmp_path / "p.bed")
        pt_bed.write_bed(port_src, g)
        kw = dict(device=CPU)
    want = ref_grm.grm_blocked(ref_src, row_block=512)
    got = mt.grm_blocked(port_src, row_block=512, **kw)
    assert got.dtype == np.float32 and got.shape == (700, 700)
    assert np.abs(got.astype(np.float64) - want).max() < 1e-4
    if source == "genomatrix":
        unscaled = mt.grm_blocked(port_src, row_block=512, scale=False)
        assert np.abs(unscaled - ref_grm.grm_blocked(
            ref_src, row_block=512, scale=False)).max() < 1e-3


@pytest.mark.parametrize("build", BUILDS)
def test_grm_yang_matches_reference(build):
    g = bed.simulate_genotypes(100, 600, seed=17)
    g[:, 5] = 0   # monomorphic: weighted 0, not a blow-up
    ref = mx.from_dense(g)
    port = _port(ref, g, build)
    want = np.asarray(ref_grm.grm_yang(ref))
    got = mt.grm_yang(port).numpy()
    assert _rel(got, want) < 2e-6
    np.testing.assert_array_equal(got, got.T)
    f = np.asarray(ref.freq, np.float64)
    zc = g.astype(np.float64) - 2 * f[None, :]
    pq2 = 2 * f * (1 - f)
    use = pq2 > 1e-12
    oracle = (zc[:, use] / pq2[use][None, :]) @ zc[:, use].T / use.sum()
    assert _rel(got, oracle) < 5e-6


def test_grm_yang_missing_paths():
    g = bed.simulate_genotypes(110, 600, seed=36, missing_rate=0.05)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        mt.grm_yang(mt.from_dense(g, keep_missing_info=True, device=CPU))
    with pytest.raises(ValueError, match="keep_missing_info"):
        mt.grm_yang(mt.from_dense(g, device=CPU), pair_denominator=True)
    # a tracked panel that records no missing entry: pair denominators are
    # the co-called counts, here all 600 minus the excluded SNPs
    clean = bed.simulate_genotypes(110, 600, seed=36)
    clean[:, 9] = 2
    ref = mx.from_dense(clean, keep_missing_info=True)
    port = _port(ref, clean, "from_reference_state")
    assert port.miss_rows_n is not None and port.miss_rows_n.numel() == 0
    want = np.asarray(ref_grm.grm_yang(ref, pair_denominator=True))
    assert _rel(mt.grm_yang(port, pair_denominator=True).numpy(), want) < 2e-6


@pytest.mark.parametrize("kind", ["dense", "genomatrix", "missing"])
def test_dominance_grm_matches_reference(kind):
    g = bed.simulate_genotypes(96, 700, seed=13,
                               missing_rate=0.05 if kind == "missing" else 0)
    if kind == "dense":
        want = np.asarray(ref_grm.dominance_grm(g))
        got = mt.dominance_grm(g, device=CPU)
    else:
        want = np.asarray(ref_grm.dominance_grm(mx.from_dense(g)))
        got = mt.dominance_grm(mt.from_dense(g, device=CPU))
    assert got.device.type == "cpu"
    assert _rel(got.numpy(), want) < 1e-5
    if kind == "dense":
        het = (g == 1).astype(np.float64)
        hc = het - het.mean(axis=0, keepdims=True)
        p = g.mean(axis=0) / 2.0
        pq = 2.0 * p * (1.0 - p)
        assert _rel(got.numpy(), (hc @ hc.T) / np.sum(pq * (1.0 - pq))) < 1e-5

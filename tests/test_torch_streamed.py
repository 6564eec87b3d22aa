"""The port's out-of-core StreamedGeno and its host-resident GenoMatrix
against miraculix_tpu.streamed on the same .bed filesets (96 x 700 in
chunks of 256 SNPs, the last ragged; clean and with 5% missing calls), as
tests/test_streamed.py runs the reference.

Tolerances: dgemm 'n' and 't' in every centering mode within 1e-5 of max
|reference|; the f64 tier 1e-12 relative; grm_diag 1e-6 relative; the CG
within one iteration of the reference's.  Against the port's resident
panel: the chunked 't' product reads each SNP row's whole contraction in
one product, so it is equal bit for bit; the 'n' product sums f32 chunk
partials (1e-6 of max).  Each reference call is made once per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402
from miraculix_tpu.streamed import StreamedGeno as RefStreamed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import _kernels, streamed  # noqa: E402
from miraculix_tpu_torch.solve.cg import grm_diag, grm_matvec  # noqa: E402

CPU = "cpu"
CHUNK = 256
CENTERS = ["rowmeans", "none", "colmeans", "user"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The panels are small: one torch thread runs their many small ops
    without the thread contention of a loaded host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _center(name, snps):
    if name == "user":
        return np.random.default_rng(5).uniform(0.0, 2.0, size=snps)
    return {"rowmeans": True, "none": False, "colmeans": "colmeans"}[name]


@pytest.fixture(scope="module", params=[0.0, 0.05], ids=["clean", "missing"])
def panel(request, tmp_path_factory):
    """(genotypes, .bed path, reference StreamedGeno, port StreamedGeno,
    port resident GenoMatrix) of one 96 x 700 panel."""
    g = ref_bed.simulate_genotypes(96, 700, seed=31 if not request.param
                                   else 33, missing_rate=request.param)
    path = str(tmp_path_factory.mktemp("sg") / "panel.bed")
    ref_bed.write_bed(path, g)
    return (g, path, RefStreamed.from_bed(path, chunk_snps=CHUNK),
            mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK, device=CPU),
            mt.from_bed(path, device=CPU))


@pytest.fixture(scope="module")
def products(panel):
    """(trans, center) -> (reference streamed, port streamed, port
    resident) dgemm on 8 columns of one draw."""
    g, _, ref, port, res = panel
    rng = np.random.default_rng(0)
    out = {}
    for trans in ("n", "t"):
        b = rng.standard_normal((700 if trans == "n" else 96, 8)).astype(
            np.float32)
        for name in CENTERS:
            c = _center(name, 700)
            out[trans, name] = (
                np.asarray(ref.dgemm(b, trans=trans, center=c)),
                port.dgemm(b, trans=trans, center=c),
                mt.dgemm(res, b, trans=trans, center=c).numpy())
    return out


def _zc(g, freq):
    return np.where(g == 3, 0, g).astype(np.float64) - 2.0 * np.asarray(
        freq, np.float64)[None, :]


def test_chunking_covers_panel(panel):
    g, _, ref, port, res = panel
    assert port.n_chunks == ref.n_chunks == 3
    assert port.bounds == ref.bounds and port.bounds[-1] == (512, 700)
    assert (port.snps, port.indiv) == (700, 96)
    # both frequency caches bit for bit: the reference's streamed ones and
    # the resident panel's (the whole-panel pseudo-frequencies from the
    # chunks' additive sums and called counts)
    np.testing.assert_array_equal(port.freq, ref.freq)
    np.testing.assert_array_equal(port.pseudo_freq, ref.pseudo_freq)
    np.testing.assert_array_equal(port.freq, res.freq.numpy())
    np.testing.assert_array_equal(port.pseudo_freq, res.pseudo_freq.numpy())
    assert port.nbytes() == sum(c.nbytes for c in port.chunks)
    assert port.nbytes() == ref.nbytes()
    assert port.sigma2 == pytest.approx(float(ref.sigma2), rel=1e-12)
    for c, (s0, s1) in zip(port.chunks, port.bounds):
        assert c.host_resident and c.device == torch.device(CPU)
        assert c.snps == s1 - s0 and c.indiv == 96
        np.testing.assert_array_equal(c.freq.numpy(), port.freq[s0:s1])


@pytest.mark.parametrize("trans", ["n", "t"])
@pytest.mark.parametrize("center", CENTERS)
def test_streamed_dgemm_matches_reference(products, trans, center):
    want, got, resident = products[trans, center]
    assert got.dtype == np.float32
    assert _rel(got, want) < 1e-5
    if trans == "t":     # each SNP row is one chunk's whole contraction
        np.testing.assert_array_equal(got, resident)
    else:                # f32 chunk partials summed
        assert _rel(got, resident) < 1e-6


def test_streamed_dgemm_checks_shapes(panel):
    port = panel[3]
    with pytest.raises(ValueError, match="indiv"):
        port.dgemm(np.zeros((700, 2)), trans="t")
    with pytest.raises(ValueError, match="snps"):
        port.dgemm(np.zeros((96, 2)), trans="n")


@pytest.fixture(scope="module")
def matvecs(panel):
    g, _, ref, port, res = panel
    x = np.random.default_rng(1).standard_normal((96, 3)).astype(np.float32)
    return x, np.asarray(ref.grm_matvec(x)), port.grm_matvec(x)


def test_streamed_grm_matvec(panel, matvecs):
    g, _, ref, port, res = panel
    x, want, got = matvecs
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert _rel(got, want) < 1e-5
    assert _rel(got, grm_matvec(res, torch.from_numpy(x)).numpy()) < 1e-6
    zc = _zc(g, res.freq.numpy())
    assert _rel(got, zc @ (zc.T @ x.astype(np.float64))) < 1e-5
    # a tensor in gives a tensor on the compute device; 1-D in, 1-D out
    t = port.grm_matvec(torch.from_numpy(x))
    assert torch.is_tensor(t) and t.device == torch.device(CPU)
    np.testing.assert_array_equal(t.numpy(), got)
    np.testing.assert_array_equal(port.grm_matvec(x[:, 0]), got[:, 0])


@pytest.fixture(scope="module")
def solves(panel):
    """(precondition -> (reference, port)) cg_solve of one RHS at lam 1."""
    _, _, ref, port, _ = panel
    y = np.random.default_rng(2).standard_normal(96)
    return y, {pc: (ref.cg_solve(y, lam=1.0, tol=1e-6, maxiter=300,
                                 precondition=pc),
                    port.cg_solve(y, lam=1.0, tol=1e-6, maxiter=300,
                                  precondition=pc))
               for pc in (False, True)}


@pytest.mark.parametrize("precondition", [False, True],
                         ids=["cg", "pcg"])
def test_streamed_cg_matches_reference(panel, solves, precondition):
    g, _, ref, port, res = panel
    y, fits = solves
    (x_r, it_r, rel_r), (x, it, rel) = fits[precondition]
    assert abs(it - it_r) <= 1 and it < 300
    assert x.dtype == np.float64 and x.shape == (96,)
    assert float(rel.max()) <= 1e-6
    zc = _zc(g, res.freq.numpy())
    a = zc @ zc.T / port.sigma2 + np.eye(96)
    assert np.linalg.norm(a @ x - y) / np.linalg.norm(y) < 1e-4
    assert _rel(x, x_r) < 1e-4


def test_streamed_grm_diag(panel):
    g, _, ref, port, res = panel
    got = port.grm_diag()
    assert got.dtype == np.float64
    assert _rel(got, np.asarray(ref.grm_diag())) < 1e-6
    zc = _zc(g, res.freq.numpy())
    np.testing.assert_allclose(got, np.sum(zc * zc, axis=1), rtol=1e-6)
    np.testing.assert_allclose(port.grm_diag(center=False),
                               grm_diag(res, center=False).numpy(), rtol=1e-6)


@pytest.mark.parametrize("trans", ["n", "t"])
def test_streamed_f64_tier(panel, trans):
    """precision='f64' streams without rounding through f32: the RHS and
    the chunk accumulator stay float64 (the reference runs under x64, as
    the test suite sets it)."""
    g, _, ref, port, res = panel
    rows = 700 if trans == "n" else 96
    b = np.random.default_rng(11).standard_normal((rows, 2))
    got = port.dgemm(b, trans=trans, center=True, precision="f64")
    want = np.asarray(ref.dgemm(b, trans=trans, center=True,
                                precision="f64"))
    assert got.dtype == np.float64
    assert _rel(got, want) < 1e-12
    zc = _zc(g, port.freq)
    exact = zc @ b if trans == "n" else zc.T @ b
    assert _rel(got, exact) < 1e-12


def test_cache_to_device_hybrid(tmp_path):
    """Hybrid cached/streamed: the budget caps the chunks cached (leading
    ones), the result is the same, and caching is idempotent; streamed
    chunks are copied into the staging buffers on every pass and cached
    ones never."""
    path = str(tmp_path / "p.bed")
    g = ref_bed.simulate_genotypes(64, 520, seed=7)
    ref_bed.write_bed(path, g)
    ref = RefStreamed.from_bed(path, chunk_snps=CHUNK)
    port = mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK, device=CPU)
    assert port.n_chunks == 3
    first = port.chunks[0].nbytes
    assert first == int(ref.chunks[0].zq_n.nbytes + ref.chunks[0].zq_t.nbytes)
    assert ref.cache_to_device(budget_bytes=first) == 1
    assert port.cache_to_device(budget_bytes=first) == 1
    assert not port.chunks[0].host_resident            # on the device now
    assert port.chunks[1].host_resident and port.chunks[2].host_resident
    x = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    streamed.reset_stream_counts()
    got = port.grm_matvec(x)
    assert streamed.STREAM == {"passes": 1, "products": 6, "row_stats": 0,
                               "h2d_copies": 2,
                               "h2d_bytes": port.chunks[1].nbytes
                               + port.chunks[2].nbytes}
    assert streamed.copy_seconds() > 0
    assert _rel(got, np.asarray(ref.grm_matvec(x))) < 1e-5
    # the budget given stays the container's default
    assert port.cache_to_device() == 1 and port.chunks[1].host_resident
    # idempotent; a budget for the whole panel caches the rest
    assert port.cache_to_device(budget_bytes=port.nbytes()) == 3
    assert ref.cache_to_device(budget_bytes=ref.nbytes()) == 3
    assert not any(c.host_resident for c in port.chunks)
    streamed.reset_stream_counts()
    np.testing.assert_array_equal(port.grm_matvec(x), got)
    assert streamed.STREAM["h2d_copies"] == 0
    assert streamed.STREAM["passes"] == 1
    assert port.cache_to_device(budget_bytes=first) == 1   # never uncaches
    assert not port.chunks[2].host_resident


def test_cache_to_device_default_budget_on_the_cpu(panel):
    """On a CPU compute device the default budget is the whole panel."""
    _, path, _, _, _ = panel
    port = mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK, device=CPU)
    assert port.cache_to_device() == port.n_chunks
    assert "3 cached" in repr(port)


def test_streamed_products_take_one_product_a_chunk(panel):
    """Each pass counts its chunk products, and on a CPU compute device
    each is one call of a plain version (on the card each is one kernel
    launch and no plain call, tests/test_torch_cuda.py)."""
    _, path, _, _, _ = panel
    port = mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK, device=CPU)
    port.cache_to_device(budget_bytes=port.chunks[0].nbytes)
    x = np.ones((96, 1), np.float32)
    streamed.reset_stream_counts()
    _kernels.reset_launch_counts()
    port.grm_matvec(x)
    port.dgemm(x, trans="t")
    port.grm_diag()
    assert streamed.STREAM["passes"] == 3
    assert streamed.STREAM["products"] == 3 * (2 + 1 + 1)
    assert sum(_kernels.PLAIN_CALLS.values()) == streamed.STREAM["products"]
    assert streamed.STREAM["h2d_copies"] == 3 * 2


def test_streamed_row_statistics_count_one_a_chunk(panel):
    """grm_diag's pass and the linear scan's row-statistics pass each count
    one row statistic a chunk, apart from the chunk products (on the card
    each is one row_sq_stats launch, chip_smoke.py; on the CPU the plain
    loop, which is no product and counts in no PLAIN_CALLS)."""
    _, path, _, _, _ = panel
    port = mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK, device=CPU)
    port.cache_to_device(budget_bytes=port.chunks[0].nbytes)
    y = np.random.default_rng(1).standard_normal(96)
    streamed.reset_stream_counts()
    _kernels.reset_launch_counts()
    port.grm_diag()
    assert streamed.STREAM["row_stats"] == port.n_chunks
    assert streamed.STREAM["products"] == port.n_chunks
    mt.gwas_linear(port, y)
    assert streamed.STREAM["row_stats"] == 2 * port.n_chunks
    assert sum(_kernels.PLAIN_CALLS.values()) == streamed.STREAM["products"]


def test_host_panel_computing_on_the_card_never_takes_a_plain_version(
        panel):
    """A host-resident panel (or a streamed container) whose compute device
    is the card computes there: where this torch has no CUDA, the move to
    the card raises, and no product fell back to a plain version on the
    CPU.  (On the card the same paths launch kernels only:
    tests/test_torch_cuda.py and chip_smoke.py.)"""
    if torch.cuda.is_available():
        pytest.skip("this build has CUDA: tests/test_torch_cuda.py covers it")
    g, path, _, _, _ = panel
    host = mt.from_bed(path, device_put=False, device="cuda")
    assert host.host_resident and host.device.type == "cuda"
    assert host.zq_n.device.type == CPU
    _kernels.reset_launch_counts()
    b = np.ones((700, 1), np.float32)
    for call in (lambda: mt.dgemm(host, b),
                 lambda: mt.grm(host),
                 lambda: mt.grm_diag(host),
                 lambda: mt.grm_matvec(host, np.ones((96, 1), np.float32)),
                 lambda: mt.gblup.gblup(host, np.ones(96), n_pcs=0)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    assert sum(_kernels.PLAIN_CALLS.values()) == 0
    with pytest.raises((RuntimeError, AssertionError)):
        mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK, device="cuda")


@pytest.mark.parametrize("entry", ["from_dense", "from_bed"])
def test_host_resident_panel_matches_resident(panel, entry):
    """``device_put=False`` keeps the words and frequency caches in host
    memory (the reference's numpy arrays, bit for bit); every entry point
    gives the resident panel's results."""
    g, path, _, _, res = panel
    arg = g if entry == "from_dense" else path
    host = getattr(mt, entry)(arg, device_put=False, device=CPU)
    ref = getattr(mx, entry)(arg, device_put=False)
    assert host.host_resident and not res.host_resident
    assert "host-resident" in repr(host)
    for k in ("zq_n", "zq_t"):
        np.testing.assert_array_equal(getattr(host, k).numpy().view(
            np.uint32), np.asarray(getattr(ref, k)).view(np.uint32))
        np.testing.assert_array_equal(getattr(host, k).numpy(),
                                      getattr(res, k).numpy())
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.standard_normal((96, 2)), dtype=torch.float32)
    bn = torch.as_tensor(rng.standard_normal((700, 2)), dtype=torch.float32)
    for name, fn in (
            ("dgemm n", lambda p: mt.dgemm(p, bn)),
            ("dgemm t", lambda p: mt.dgemm(p, v, trans="t")),
            ("grm", lambda p: mt.grm(p)),
            ("grm_diag", lambda p: mt.grm_diag(p)),
            ("grm_matvec", lambda p: mt.grm_matvec(p, v)),
            ("grm_cg_solve", lambda p: mt.grm_cg_solve(p, v, lam=1.0,
                                                       tol=1e-5).x),
            ("ld", lambda p: mt.ld(p)),
            ("ld_windowed", lambda p: torch.as_tensor(
                mt.ld_windowed(p, 16)[0])),
            ("grm_blocked", lambda p: torch.as_tensor(
                mt.grm_blocked(p, row_block=512))),
            ("ld_blocked", lambda p: torch.as_tensor(
                mt.ld_blocked(p, row_block=512))),
            ("subset_snps", lambda p: mt.subset_snps(p, [3, 5, 600]).zq_n),
            ("snp_sums", lambda p: p.snp_sums())):
        got, want = fn(host), fn(res)
        assert got.device == torch.device(CPU), name
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=name)

"""The port's 2D-sharded layer (``miraculix_tpu_torch.parallel.sharded2d``)
against the reference's on the same words: the reference's 70 x 900 panel
(seed 11, tests/test_sharded2d.py) on 2 x 4 and 4 x 2 meshes, the
reference on the conftest's virtual CPU devices, the port on
``make_mesh_2d(devices=["cpu"] * 8, di=...)``.

Tolerances: packings bit-equal, the raw integer crossproduct exactly equal
to Z Z^T; products, GRMs and diagonals within 1e-5 of max |reference|; CG
solutions within 1e-4 of max |x| with iterations within 1; the multi-trait
V-solve within 1e-4 of the reference's and 3e-4 of a dense float64 solve
(the reference's own limit).  Each reference call is made once per
module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from miraculix_tpu import gblup as ref_gblup  # noqa: E402
from miraculix_tpu import parallel as rpar  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402

from miraculix_tpu_torch import gblup as pt_gblup  # noqa: E402
from miraculix_tpu_torch import parallel  # noqa: E402
from miraculix_tpu_torch.parallel import sharded, sharded2d  # noqa: E402

MESHES = [2, 4]      # di: 2 x 4 and 4 x 2
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def ref_state_2d(rsg) -> dict:
    return dict(snps=rsg.snps, indiv=rsg.indiv, ipd=rsg.ipd, spd=rsg.spd,
                axes=rsg.axes, zq_n=np.asarray(rsg.zq_n),
                zq_t=np.asarray(rsg.zq_t), freq=np.asarray(rsg.freq))


class Case:
    def __init__(self, di, geno, path):
        self.geno = geno
        self.rmesh = rpar.make_mesh_2d(8, di=di)
        self.rsg = rpar.shard_genotypes_2d(geno, self.rmesh)
        self.mesh = parallel.make_mesh_2d(devices=["cpu"] * 8, di=di)
        self.sg = parallel.shard_genotypes_2d(geno, self.mesh)
        self.path = path
        rng = np.random.default_rng(di)
        self.b_n = rng.standard_normal((900, 3)).astype(np.float32)
        self.b_t = rng.standard_normal((70, 3)).astype(np.float32)
        self.rhs = rng.standard_normal(70).astype(np.float32)
        self._ref = {}

    def ref(self, key, fn):
        if key not in self._ref:
            self._ref[key] = fn()
        return self._ref[key]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    geno = ref_bed.simulate_genotypes(70, 900, seed=11)
    path = str(tmp_path_factory.mktemp("s2d") / "panel.bed")
    ref_bed.write_bed(path, geno)
    made = {}

    def get(di):
        if di not in made:
            made[di] = Case(di, geno, path)
        return made[di]
    return get


def _global_2d(sg) -> tuple:
    """(zq_n, zq_t, freq) of a port ShardedGeno2D in the reference's global
    layout."""
    m = sg.mesh
    ai, ak = sg.axes
    n_parts = parallel._collectives.gather_shards(m, sg.zq_n)
    t_parts = parallel._collectives.gather_shards(m, sg.zq_t)
    f_parts = parallel._collectives.gather_shards(m, sg.freq)
    di, dk = m.shape[ai], m.shape[ak]
    zq_n = torch.cat([torch.cat(n_parts[a * dk:(a + 1) * dk], dim=1)
                      for a in range(di)]).numpy().view(np.uint32)
    zq_t = torch.cat([torch.cat([t_parts[a * dk + b] for a in range(di)],
                                dim=1) for b in range(dk)]).numpy()
    freq = torch.cat(f_parts[:dk]).numpy()
    return zq_n, zq_t.view(np.uint32), freq


@pytest.mark.parametrize("di", MESHES)
def test_words_equal_reference(cases, di):
    c = cases(di)
    st = ref_state_2d(c.rsg)
    assert (c.sg.ipd, c.sg.spd) == (st["ipd"], st["spd"])
    assert c.mesh.shape == {"i": di, "k": 8 // di}
    zq_n, zq_t, freq = _global_2d(c.sg)
    assert np.array_equal(zq_n, st["zq_n"].view(np.uint32))
    assert np.array_equal(zq_t, st["zq_t"].view(np.uint32))
    assert np.array_equal(freq, st["freq"])
    back = parallel.from_reference_state(st, c.mesh)
    assert isinstance(back, parallel.ShardedGeno2D)
    assert all(torch.equal(a, b) for a, b in zip(
        back.zq_n + back.zq_t, c.sg.zq_n + c.sg.zq_t))


@pytest.mark.parametrize("di", MESHES)
def test_from_bed_equals_reference(cases, di):
    c = cases(di)
    got = parallel.shard_genotypes_2d_from_bed(c.path, c.mesh)
    want = ref_state_2d(rpar.shard_genotypes_2d_from_bed(c.path, c.rmesh))
    zq_n, zq_t, freq = _global_2d(got)
    assert np.array_equal(zq_n, want["zq_n"].view(np.uint32))
    assert np.array_equal(zq_t, want["zq_t"].view(np.uint32))
    assert np.array_equal(freq, want["freq"])


@pytest.mark.parametrize("trans", ["n", "t"])
@pytest.mark.parametrize("di", MESHES)
def test_sharded_dgemm_2d(cases, di, trans):
    c = cases(di)
    if trans == "n":
        want = np.asarray(rpar.sharded_dgemm_2d(c.rsg, rpar.pad_snp_vec(
            c.rsg, jnp.asarray(c.b_n)), trans="n"))
        got = parallel.sharded_dgemm_2d(c.sg, parallel.pad_snp_vec(
            c.sg, c.b_n), trans="n")
    else:
        want = np.asarray(rpar.sharded_dgemm_2d(c.rsg, rpar.pad_indiv_vec(
            c.rsg, jnp.asarray(c.b_t)), trans="t"))
        got = parallel.sharded_dgemm_2d(c.sg, parallel.pad_indiv_vec(
            c.sg, c.b_t), trans="t")
    assert isinstance(got, parallel.RowSharded)
    assert _rel(parallel.host_global(got), want) <= TOL


def _raw(c):
    """The port's raw 2D crossproduct, made once a mesh (its plain version
    multiplies the padded float64 decodes: ~10 s a call here)."""
    return c.ref("raw", lambda: sharded2d.sharded_crossprod_2d(c.sg))


@pytest.mark.parametrize("di", MESHES)
def test_sharded_grm_2d(cases, di):
    c = cases(di)
    raw = parallel.host_global(_raw(c))
    z = c.geno.astype(np.int64)
    assert raw.dtype == np.int32 and np.array_equal(raw[:70, :70], z @ z.T)
    assert not raw[70:].any() and not raw[:, 70:].any()
    want = np.asarray(rpar.sharded_grm_2d(c.rsg))
    # the public call at 2 x 4; at 4 x 2 its finish on the kept raw
    got = parallel.host_global(
        parallel.sharded_grm_2d(c.sg) if di == 2 else sharded._finish(
            _raw(c), c.sg.ipd, 70, c.sg.sigma2, True, "i"))
    assert _rel(got, want) <= TOL
    assert not got[70:].any() and not got[:, 70:].any()


@pytest.mark.parametrize("di", MESHES)
def test_sharded_grm_diag_2d(cases, di):
    """The reference's shard_map of its row statistics compiles for ~12 s a
    mesh: 2 x 4 is held to it, 4 x 2 to the float64 diagonal."""
    c = cases(di)
    got = parallel.host_global(parallel.sharded_grm_diag_2d(c.sg))
    if di == 2:
        want = np.asarray(rpar.sharded_grm_diag_2d(c.rsg))[:70]
    else:
        one = parallel.shard_genotypes(c.geno, parallel.make_mesh(
            devices=["cpu"]))
        fg = one.global_freq()[:900].astype(np.float64)
        want = ((c.geno - 2.0 * fg) ** 2).sum(axis=1)
    assert _rel(got[:70], want) <= TOL


@pytest.mark.parametrize("precondition", [False, True])
@pytest.mark.parametrize("di", MESHES)
def test_sharded_cg_solve_2d(cases, di, precondition):
    c = cases(di)
    r = rpar.sharded_cg_solve_2d(c.rsg, jnp.asarray(c.rhs), lam=30.0,
                                 tol=1e-5, maxiter=2000,
                                 precondition=precondition)
    res = parallel.sharded_cg_solve_2d(c.sg, c.rhs, lam=30.0, tol=1e-5,
                                       maxiter=2000,
                                       precondition=precondition)
    x = parallel.host_global(res.x)
    assert x.shape == np.asarray(r.x).shape
    assert _rel(x[:70], np.asarray(r.x)[:70]) <= 1e-4
    assert not x[70:].any()
    assert abs(res.iterations - int(r.iterations)) <= 1


@pytest.mark.parametrize("di", MESHES)
def test_multi_v_solver_2d(cases, di):
    """The 2D multi-trait V-solve against the reference's ("sharded2d")
    and a dense float64 Kronecker solve."""
    c = cases(di)
    n, t, m = 70, 2, 3
    f = c.sg.freq
    fg = np.concatenate([x.numpy() for x in
                         parallel._collectives.gather_shards(
                             c.mesh, f)[:c.mesh.shape["k"]]])[:900]
    zc = c.geno.astype(np.float64) - 2 * fg.astype(np.float64)
    gs = zc @ zc.T / float(c.sg.sigma2)
    sgm = np.array([[1.0, 0.4], [0.4, 0.9]])
    sem = np.array([[0.8, 0.1], [0.1, 1.1]])
    b3 = np.random.default_rng(7).standard_normal((n, t, m))
    x_ref, it_ref = ref_gblup._multi_v_solver(
        c.rsg, t, np.diag(gs), cg_tol=1e-6, cg_maxiter=3000)(b3, sgm, sem)
    x3, it = pt_gblup._multi_v_solver(c.sg, t, np.diag(gs), cg_tol=1e-6,
                                      cg_maxiter=3000)(b3, sgm, sem)
    assert _rel(x3, x_ref) <= 1e-4 and abs(it - it_ref) <= 2
    dense = np.linalg.solve(np.kron(gs, sgm) + np.kron(np.eye(n), sem),
                            b3.reshape(n * t, m))
    rel = (np.linalg.norm(x3.reshape(n * t, m) - dense, axis=0)
           / np.linalg.norm(dense, axis=0))
    assert rel.max() < 3e-4


@pytest.mark.parametrize("di", MESHES)
def test_2d_equals_1d(cases, di):
    c = cases(di)
    one = parallel.shard_genotypes(c.geno, parallel.make_mesh(
        devices=["cpu"] * 4))
    for trans, b in (("n", c.b_n), ("t", c.b_t)):
        want = parallel.host_global(parallel.sharded_dgemm(one, b, trans))
        pad = (parallel.pad_snp_vec if trans == "n"
               else parallel.pad_indiv_vec)(c.sg, b)
        got = parallel.host_global(parallel.sharded_dgemm_2d(c.sg, pad,
                                                             trans))
        assert _rel(got[: want.shape[0]], want) <= TOL
    raw1 = sharded.sharded_crossprod(one).numpy()
    raw2 = parallel.host_global(_raw(c))
    assert np.array_equal(raw2[:70, :70], raw1[:70, :70])
    v = c.b_t[:, :2]
    assert _rel(sharded2d.grm_matvec_2d(c.sg, v).numpy(),
                parallel.sharded_grm_matvec(one, v).numpy()) <= TOL


@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_from_bed_numpy_path(cases, layout):
    """Without the native codec both ingestions take their numpy path, to
    the same words."""
    from miraculix_tpu_torch.io import native

    c = cases(2)
    mesh = (c.mesh if layout == "2d"
            else parallel.make_mesh(devices=["cpu"] * 2))
    read = (parallel.shard_genotypes_2d_from_bed if layout == "2d"
            else parallel.shard_genotypes_from_bed)
    dense = (parallel.shard_genotypes_2d if layout == "2d"
             else parallel.shard_genotypes)(c.geno, mesh)
    with native.disabled():
        got = read(c.path, mesh)
    assert all(torch.equal(a, b) for a, b in zip(
        got.zq_n + got.zq_t + got.freq, dense.zq_n + dense.zq_t + dense.freq))

"""The port's SNP-sharded layer (``miraculix_tpu_torch.parallel.sharded``)
against the reference's on the same words: the reference's 80 x 5,000
panel (seed 21, tests/test_sharded.py) on the conftest's virtual CPU
devices, the port on ``make_mesh(devices=["cpu"] * D)`` at D = 1, 2, 4 and
8, plus an uneven 8,300-SNP panel on 4 shards whose last shard is empty.

Tolerances: packings, frequencies and the raw integer crossproduct equal
bit for bit; products, GRMs, diagonals and statistics within 1e-5 of max
|reference| (the port's plain products sum in float64, the reference's in
f32); CG solutions within 1e-4 of max |x|, iterations within 1.  Every op
runs at D = 4 and 8; D = 1, 2 and the uneven panel run the words, dgemm,
GRM and CG.  Each reference call is made once per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from miraculix_tpu import parallel as rpar  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402
from miraculix_tpu.ops.grm import packed_crossprod as ref_crossprod  # noqa

from miraculix_tpu_torch import _kernels, parallel  # noqa: E402
from miraculix_tpu_torch.parallel import sharded  # noqa: E402

CASES = ["D1", "D2", "D4", "D8", "uneven"]
FULL = ["D4", "D8"]          # every op; the others run the core ops
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
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def ref_state(rsg) -> dict:
    """The reference ShardedGeno's fields as numpy (global arrays)."""
    return dict(snps=rsg.snps, indiv=rsg.indiv, spd=rsg.spd, axis=rsg.axis,
                zq_n=np.asarray(rpar.host_global(rsg.zq_n)),
                zq_t=np.asarray(rpar.host_global(rsg.zq_t)),
                freq=np.asarray(rpar.host_global(rsg.freq)))


class Case:
    """One panel on D shards in both packages, with the reference's
    results computed on first use and kept."""

    def __init__(self, name, tmp):
        d = 4 if name == "uneven" else int(name[1:])
        snps, seed = (8300, 23) if name == "uneven" else (5000, 21)
        self.geno = ref_bed.simulate_genotypes(80, snps, seed=seed)
        self.path = str(tmp / f"{name}.bed")
        ref_bed.write_bed(self.path, self.geno)
        self.rmesh = rpar.make_mesh(d)
        self.rsg = rpar.shard_genotypes(self.geno, self.rmesh)
        self.mesh = parallel.make_mesh(devices=["cpu"] * d)
        self.sg = parallel.shard_genotypes(self.geno, self.mesh)
        rng = np.random.default_rng(d + snps)
        self.b_n = rng.standard_normal((snps, 3)).astype(np.float32)
        self.b_t = rng.standard_normal((80, 3)).astype(np.float32)
        self.w = (rng.random(snps) < 0.7).astype(np.float32)
        self.rhs = rng.standard_normal(80).astype(np.float32)
        self._ref = {}

    def ref(self, key, fn):
        if key not in self._ref:
            self._ref[key] = np.asarray(fn(), np.float64)
        return self._ref[key]

    def w_ref(self):
        w = np.zeros(self.rsg.freq.shape[0], np.float32)
        w[: self.w.shape[0]] = self.w
        return jax.device_put(w, NamedSharding(self.rmesh, P(self.rsg.axis)))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    made = {}

    def get(name):
        if name not in made:
            made[name] = Case(name, tmp)
        return made[name]
    return get


@pytest.mark.parametrize("name", CASES)
def test_words_equal_reference(cases, name):
    c = cases(name)
    st = ref_state(c.rsg)
    assert c.sg.spd == st["spd"]
    words = sharded._global_words(c.sg)
    assert np.array_equal(words[0], st["zq_n"].view(np.uint32))
    assert np.array_equal(words[1], st["zq_t"].view(np.uint32))
    assert np.array_equal(words[2], st["freq"])
    assert np.array_equal(c.sg.global_freq(), st["freq"])
    # the reference's state carried across: the same shards
    back = parallel.from_reference_state(st, c.mesh)
    assert all(torch.equal(a, b) for a, b in zip(
        back.zq_n + back.zq_t + back.freq, c.sg.zq_n + c.sg.zq_t + c.sg.freq))
    assert float(back.sigma2) == pytest.approx(float(c.rsg.sigma2),
                                               rel=1e-6)
    if name == "uneven":           # the last shard holds no SNP
        assert c.sg.spd * 3 >= c.sg.snps
        assert not c.sg.freq[3].any() and not c.sg.zq_t[3].any()


@pytest.mark.parametrize("name", ["D2", "D8", "uneven"])
def test_from_bed_equals_reference(cases, name):
    c = cases(name)
    got = parallel.shard_genotypes_from_bed(c.path, c.mesh)
    want = ref_state(rpar.shard_genotypes_from_bed(c.path, c.rmesh))
    words = sharded._global_words(got)
    assert np.array_equal(words[0], want["zq_n"].view(np.uint32))
    assert np.array_equal(words[1], want["zq_t"].view(np.uint32))
    assert np.array_equal(words[2], want["freq"])


@pytest.mark.parametrize("name,trans,center", [
    (name, trans, center) for name in CASES for trans in ("n", "t")
    for center in ((False, True) if name in FULL else (True,))])
def test_sharded_dgemm(cases, name, trans, center):
    c = cases(name)
    b = c.b_n if trans == "n" else c.b_t
    want = c.ref(("dgemm", trans, center), lambda: rpar.host_global(
        rpar.sharded_dgemm(c.rsg, jnp.asarray(b), trans=trans,
                           center=center)))
    out = parallel.sharded_dgemm(c.sg, b, trans=trans, center=center)
    assert isinstance(out, torch.Tensor if trans == "n"
                      else parallel.RowSharded)
    assert _rel(parallel.host_global(out), want) <= TOL


@pytest.mark.parametrize("name,scatter", [
    (name, scatter) for name in CASES
    for scatter in ((False, True) if name in FULL else (False,))])
def test_sharded_grm(cases, name, scatter):
    c = cases(name)
    raw = c.ref("raw", lambda: ref_crossprod(jnp.asarray(
        rpar.host_global(c.rsg.zq_n)), interpret=True))
    got_raw = parallel.host_global(sharded.sharded_crossprod(
        c.sg, scatter=scatter))
    assert got_raw.dtype == np.int32 and np.array_equal(got_raw, raw)
    want = c.ref(("grm", scatter), lambda: rpar.host_global(
        rpar.sharded_grm(c.rsg, scatter=scatter)))
    got = parallel.host_global(parallel.sharded_grm(c.sg, scatter=scatter))
    assert _rel(got, want) <= TOL
    if scatter:
        assert not got[80:].any() and not got[:, 80:].any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", FULL)
def test_sharded_grm_matvec(cases, name, weighted):
    c = cases(name)
    want = c.ref(("mv", weighted), lambda: rpar.sharded_grm_matvec(
        c.rsg, jnp.asarray(c.b_t),
        snp_weights=c.w_ref() if weighted else None))
    got = parallel.sharded_grm_matvec(c.sg, c.b_t,
                                      snp_weights=c.w if weighted else None)
    assert _rel(got.numpy(), want) <= TOL


def _oracle(c):
    """(per-SNP sum z^2, diag(Z_c Z_c^T)) in float64 from the dense panel."""
    z = c.geno.astype(np.float64)
    f = c.sg.global_freq()[: c.sg.snps].astype(np.float64)
    return (z * z).sum(axis=0), ((z - 2.0 * f) ** 2).sum(axis=1)


@pytest.mark.parametrize("name", FULL)
def test_sharded_row_stats(cases, name):
    """The reference's shard_map of its row statistics compiles for ~12 s a
    mesh: it runs at D = 8; D = 4 is held to the float64 oracle."""
    c = cases(name)
    sq = parallel.host_global(parallel.sharded_snp_sq_stats(c.sg))
    want = (c.ref("sq", lambda: rpar.sharded_snp_sq_stats(c.rsg))
            if name == "D8" else _oracle(c)[0])
    assert np.array_equal(sq, want)
    i2 = parallel.host_global(parallel.sharded_indicator2_dgemm_t(
        c.sg, c.b_t))
    assert _rel(i2, c.ref("i2", lambda: rpar.sharded_indicator2_dgemm_t(
        c.rsg, jnp.asarray(c.b_t)))) <= TOL


@pytest.mark.parametrize("kind", ["grm_diag", "weighted"])
@pytest.mark.parametrize("name", FULL)
def test_sharded_diagonals(cases, name, kind):
    c = cases(name)
    if kind == "grm_diag":
        want = (c.ref("diag", lambda: rpar.sharded_grm_diag(c.rsg))
                if name == "D8" else _oracle(c)[1])
        got = parallel.sharded_grm_diag(c.sg)
    else:
        want = c.ref("wdiag", lambda: rpar.sharded_weighted_grm_diag(
            c.rsg, c.w_ref()))
        got = parallel.sharded_weighted_grm_diag(c.sg, c.w)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("name", CASES)
def test_sharded_cg_solve(cases, name):
    c = cases(name)
    if ("cg", "it") not in c._ref:
        r = rpar.sharded_cg_solve(c.rsg, jnp.asarray(c.rhs), lam=40.0,
                                  tol=1e-5, maxiter=2000, precondition=True)
        c._ref["cg"] = np.asarray(r.x, np.float64)
        c._ref["cg", "it"] = int(r.iterations)
    res = parallel.sharded_cg_solve(c.sg, c.rhs, lam=40.0, tol=1e-5,
                                    maxiter=2000, precondition=True)
    assert _rel(res.x.numpy(), c._ref["cg"]) <= 1e-4
    assert abs(res.iterations - c._ref["cg", "it"]) <= 1


@pytest.mark.parametrize("name", FULL)
def test_sharded_loco_cg_solve(cases, name):
    c = cases(name)
    rhs = np.stack([c.rhs, c.b_t[:, 0]], axis=1)
    ref = rpar.sharded_loco_cg_solve(
        c.rsg, c.w_ref(), jnp.asarray(rhs), jnp.float32(900.0),
        jnp.float32(1.5), tol=1e-5, maxiter=500, mesh=c.rmesh,
        interpret=True)
    res = parallel.sharded_loco_cg_solve(c.sg, c.w, rhs, 900.0, 1.5,
                                         tol=1e-5, maxiter=500)
    assert _rel(res.x.numpy(), np.asarray(ref.x)) <= 1e-4
    assert abs(res.iterations - int(ref.iterations)) <= 1


@pytest.mark.parametrize("name", ["D2", "D8"])
def test_d_shards_equal_one_shard(cases, name):
    c, one = cases(name), cases("D1")
    for trans, b in (("n", c.b_n), ("t", c.b_t)):
        got = parallel.host_global(parallel.sharded_dgemm(c.sg, b, trans))
        want = parallel.host_global(parallel.sharded_dgemm(one.sg, b, trans))
        assert _rel(got, want) <= TOL
    assert np.array_equal(sharded.sharded_crossprod(c.sg).numpy(),
                          sharded.sharded_crossprod(one.sg).numpy())


def test_checkpoints_cross_load(cases, tmp_path):
    """A checkpoint of either package loads in the other and computes the
    same product (the wide path too: > 64 columns)."""
    c = cases("D8")
    b = np.random.default_rng(3).standard_normal((5000, 72)).astype(
        np.float32)
    theirs, ours = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    rpar.save_sharded(theirs, c.rsg)
    parallel.save_sharded(ours, c.sg)
    mine = parallel.load_sharded(theirs, c.mesh)
    back = rpar.load_sharded(ours, c.rmesh)
    want = parallel.sharded_dgemm(c.sg, b).numpy()
    assert np.array_equal(parallel.sharded_dgemm(mine, b).numpy(), want)
    assert _rel(np.asarray(rpar.sharded_dgemm(back, jnp.asarray(b))),
                want) <= TOL
    with pytest.raises(ValueError):
        parallel.load_sharded(ours, parallel.make_mesh(devices=["cpu"] * 4))


def test_guards(cases, monkeypatch):
    c = cases("D2")
    big = dataclass_replace(c.sg, snps=2 ** 29)
    with pytest.raises(ValueError, match="overflow"):
        parallel.sharded_grm(big)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="devices="):
        parallel.make_mesh_2d(4)
    with pytest.raises(ValueError, match="another mesh"):
        parallel.sharded_dgemm(c.sg, c.b_n,
                               mesh=parallel.make_mesh(devices=["cpu"] * 2))


def test_cpu_mesh_runs_plain_versions(cases):
    """On CPU shards every product takes the plain versions (the card's
    launches are counted by the smoke instead)."""
    c = cases("D2")
    _kernels.reset_launch_counts()
    parallel.reset_collective_counts()
    parallel.sharded_grm_matvec(c.sg, c.b_t)
    assert not any(_kernels.LAUNCHES.values())
    assert _kernels.PLAIN_CALLS["packed_matmul_tall"] == 4
    assert parallel.COLLECTIVES["psum"]["calls"] == 1
    assert not any(k.startswith("dist.") for k in parallel.COLLECTIVES)


def dataclass_replace(sg, **kw):
    """``sg`` with fields replaced, its shards shared (no re-check)."""
    import copy
    out = copy.copy(sg)
    for k, v in kw.items():
        setattr(out, k, v)
    return out


def test_public_names_and_signatures():
    """The reference's ``parallel.__all__`` (and ``from_reference_state``)
    with the reference's parameters, less its TPU-only ``interpret``; the
    port adds only keyword-only device, group and bootstrap options."""
    import inspect

    assert set(rpar.__all__) | {"from_reference_state"} == set(
        parallel.__all__)
    for name in rpar.__all__:
        want = inspect.signature(getattr(rpar, name)).parameters
        got = inspect.signature(getattr(parallel, name)).parameters
        if inspect.isclass(getattr(rpar, name)):
            continue
        kept = [p for p in want if p != "interpret"]
        assert list(got)[: len(kept)] == kept, name
        extra = [got[p] for p in list(got)[len(kept):]]
        assert all(p.kind == p.KEYWORD_ONLY for p in extra), name


def test_run_cluster_signature_matches_reference():
    """``mp_check.run_cluster`` takes the reference's parameters with the
    reference's defaults (timeout 900 s); the port's two additions are
    keyword-only."""
    import inspect

    from miraculix_tpu.parallel import mp_check as rmp
    from miraculix_tpu_torch.parallel import mp_check

    want = inspect.signature(rmp.run_cluster).parameters
    got = inspect.signature(mp_check.run_cluster).parameters
    assert list(got)[: len(want)] == list(want)
    for name, p in want.items():
        assert (got[name].kind, got[name].default) == (p.kind, p.default), \
            name
    extra = {n: got[n] for n in list(got)[len(want):]}
    assert list(extra) == ["collective_timeout", "backend"]
    assert all(p.kind == p.KEYWORD_ONLY for p in extra.values())


@pytest.mark.parametrize("n_local", [1, 2])
def test_psum_hands_distributed_contiguous_copies(monkeypatch, n_local):
    """A line spanning processes ends in an in-place ``all_reduce``: NCCL
    refuses strided tensors (the tall kernel's output is a transposed
    view), so the collective gets a contiguous tensor of its own and the
    caller's parts stay as they were."""
    from miraculix_tpu_torch.parallel import _collectives as col

    mesh = parallel.make_mesh(devices=["cpu"] * n_local)
    seen = []

    def all_reduce(t, group=None):
        seen.append(t.is_contiguous())
        t.mul_(2.0)

    monkeypatch.setattr(col.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(mesh, "line_group", lambda line: "a group")
    parts = [torch.arange(6.0).reshape(2, 3).T + j for j in range(n_local)]
    keep = [p.clone() for p in parts]
    out = col.psum(mesh, "k", parts)
    assert seen == [True]
    assert torch.equal(out[0], 2.0 * sum(keep))
    assert all(torch.equal(p, k) for p, k in zip(parts, keep))

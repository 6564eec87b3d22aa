"""The "sharded" kind of the port's SingleStepHInv and its ssgblup solve
on a ShardedGeno (2 CPU shards) against the reference's sharded kind on
the same pedigree and genotypes (its virtual CPU devices), and against
the port's resident GenoMatrix.

Tolerances, as the port's resident tests hold single-step: the H^-1
product within 1e-4 of max |reference|, EBVs and fixed effects within
1e-3 of max, outer iterations within 2.  Each reference call is made once
per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import parallel as rpar  # noqa: E402
from miraculix_tpu import pedigree as ref_ped  # noqa: E402
from miraculix_tpu import ssgblup as ref_ss  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import parallel  # noqa: E402
from miraculix_tpu_torch import ssgblup as pt_ss  # noqa: E402

CPU = "cpu"
N_ANIM, N_GENO, N_SNPS = 2000, 48, 600
SS_KW = dict(blend=0.05, inner_tol=1e-6, inner_maxiter=4000)


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


@pytest.fixture(scope="module")
def single_step():
    """A 2,000-animal pedigree, 48 animals genotyped at 600 SNPs on 2
    shards: the reference's and the port's sharded H^-1 and a solve each,
    and the port's resident H^-1 and solve."""
    sire, dam = ref_ped.simulate_pedigree(N_ANIM, n_founders=40, seed=4)
    rng = np.random.default_rng(9)
    geno_ids = np.sort(rng.choice(N_ANIM, size=N_GENO, replace=False)) + 1
    geno = ref_bed.simulate_genotypes(N_GENO, N_SNPS, seed=11)
    obs = np.sort(rng.choice(N_ANIM, size=1500, replace=False)) + 1
    y = 1.0 + rng.standard_normal(1500)
    hinv = (ref_ss.SingleStepHInv(sire, dam, rpar.shard_genotypes(
                geno, rpar.make_mesh(2)), geno_ids, **SS_KW),
            pt_ss.SingleStepHInv(sire, dam, parallel.shard_genotypes(
                geno, parallel.make_mesh(devices=[CPU] * 2)), geno_ids,
                **SS_KW),
            pt_ss.SingleStepHInv(sire, dam, mt.from_dense(geno, device=CPU),
                                 geno_ids, **SS_KW))
    solves = tuple(m.ssgblup(y, h, obs_ids=obs, h2=0.4, tol=1e-5,
                             maxiter=2000)
                   for m, h in zip((ref_ss, pt_ss, pt_ss), hinv))
    return hinv, solves


def test_single_step_hinv_matches_reference(single_step):
    (ref, port, resident), _ = single_step
    assert port._kind == ref._kind == "sharded"
    v = np.random.default_rng(0).standard_normal((N_ANIM, 2)).astype(
        np.float32)
    assert _rel(port.matvec(v), ref.matvec(v)) < 1e-4
    assert _rel(port.matvec(v), resident.matvec(v)) < 1e-4


def test_ssgblup_matches_reference(single_step):
    _, (want, got, resident) = single_step
    assert _rel(got.u, want.u) < 1e-3 and _rel(got.u, resident.u) < 1e-3
    assert np.abs(got.beta - want.beta).max() < 1e-3 * np.abs(
        want.beta).max()
    assert abs(got.iterations - want.iterations) <= 2

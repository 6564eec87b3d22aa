"""Driver entry points, torch twin of the reference's ``__graft_entry__``:
a one-device forward step and a multi-shard dry run.

    from miraculix_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()            # on the card; entry(device="cpu")
    out = fn(*args)
    dryrun_multichip(4)           # 4 shards on the card(s); device="cpu"
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def entry(device=None):
    """The flagship op: centered dgemm_compressed ('n') on a packed 512 x
    4,096 genotype panel by 8 columns (seed 0), the hot path of the whole
    package (GBLUP, CG and the GRM all reduce to it).  The panel goes to
    ``device`` (the CUDA card unless another is named).  Returns (fn,
    example_args)."""
    from . import dgemm, from_dense
    from .io import bed

    g = bed.simulate_genotypes(512, 4096, seed=0)
    gm = from_dense(g, device=device)
    b = np.random.default_rng(0).standard_normal((4096, 8)).astype(np.float32)

    def fn(gm, b):
        return dgemm(gm, b, trans="n", center=True)

    return fn, (gm, b)


def _shard_devices(n_devices: int, device) -> list:
    """``n_devices`` shards on ``device``, or round-robin over the visible
    cards (repeated on one card where there are fewer cards)."""
    if device is not None:
        return [torch.device(device)] * n_devices
    from .parallel._collectives import default_devices

    return default_devices(n_devices)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Full distributed GBLUP step over an ``n_devices``-shard mesh, both
    layouts, on tiny shapes:

    1D (SNP-sharded): .bed ingestion by shard ranges, a sharded checkpoint
    round trip, sharded dgemm both orientations, the reduced GRM and a
    preconditioned CG; AI-REML, the linear scan and one LOCO mixed scan;
    single-step GBLUP with its genomic block on the mesh.

    2D (individuals x SNPs blocks): .bed ingestion by blocks, dgemm with
    row-sharded inputs and outputs, the GRM and the fully sharded CG.

    With ``n_devices >= 8`` the run ends with a real 2-process gloo
    cluster on the CPU (``parallel.mp_check.run_cluster``): range-confined
    ingestion, sharded products and CG against a float64 oracle and the
    collective checkpoint, across process boundaries.

    The shards go on ``device`` when it is given, else on the CUDA cards."""
    from . import gblup, gwas
    from . import pedigree as ped
    from . import ssgblup as ss
    from . import parallel
    from .io import bed
    from .parallel import host_global

    devices = _shard_devices(n_devices, device)
    mesh = parallel.make_mesh(devices=devices)
    g = bed.simulate_genotypes(32, 600, seed=1)
    sg = parallel.shard_genotypes(g, mesh)
    ones = np.ones((600, 1), np.float32)

    with tempfile.TemporaryDirectory() as tmp:
        # multi-host ingestion: each process reads only its shards' SNP
        # ranges from the fileset
        bed_path = os.path.join(tmp, "dryrun.bed")
        bed.write_bed(bed_path, g)
        sg_bed = parallel.shard_genotypes_from_bed(bed_path, mesh)
        c_bed = host_global(parallel.sharded_dgemm(sg_bed, ones, trans="n",
                                                   center=False))
        # sharded checkpoint round trip
        ckpt = os.path.join(tmp, "ckpt.npz")
        parallel.save_sharded(ckpt, sg_bed)
        sg_re = parallel.load_sharded(ckpt, mesh)
        c_re = host_global(parallel.sharded_dgemm(sg_re, ones, trans="n",
                                                  center=False))
        np.testing.assert_allclose(c_re, c_bed, rtol=1e-5)
        if n_devices >= 2:
            mesh2d = parallel.make_mesh_2d(devices=devices)
            sg2_bed = parallel.shard_genotypes_2d_from_bed(bed_path, mesh2d)
            host_global(parallel.sharded_dgemm_2d(
                sg2_bed, parallel.pad_snp_vec(sg2_bed, ones), trans="n"))

    rng = np.random.default_rng(1)
    b_n = rng.standard_normal((600, 2)).astype(np.float32)
    b_t = rng.standard_normal((32, 2)).astype(np.float32)

    c_n = parallel.sharded_dgemm(sg, b_n, trans="n", center=True)
    c_t = parallel.sharded_dgemm(sg, b_t, trans="t", center=True)
    grm = parallel.sharded_grm(sg, scale=True)
    res = parallel.sharded_cg_solve(
        sg, rng.standard_normal(32).astype(np.float32), lam=50.0, tol=1e-3,
        maxiter=50, precondition=True)
    for out in (c_n, c_t, grm, res.x):
        assert np.isfinite(host_global(out)).all()

    # application layer on the mesh: distributed AI-REML (HE start and a
    # ridge block CG per AI step, all through the sharded operators)
    yv = rng.standard_normal(32)
    h2_hat, det = gblup.estimate_h2_reml(sg, yv, n_probes=4, max_iter=3,
                                         cg_tol=1e-3, cg_maxiter=60)
    assert np.isfinite(h2_hat), det

    # sharded GWAS: the linear scan and one LOCO mixed fold through the
    # masked operator
    scan = gwas.gwas_linear(sg, yv)
    assert np.isfinite(scan.beta).all()
    chrom = np.repeat([1, 2], 300)
    loco = gwas.gwas_mixed_loco(sg, yv, chrom, h2=0.5, n_gamma_snps=4,
                                tol=1e-3, maxiter=40)
    assert np.isfinite(loco.chi2).all()

    # sharded single-step GBLUP: pedigree + genomic H^-1 MME with the
    # genomic block on the mesh
    sire, dam = ped.simulate_pedigree(80, n_founders=12, seed=3)
    geno_ids = np.arange(48, 80) + 1
    sg_small = parallel.shard_genotypes(
        bed.simulate_genotypes(32, 400, seed=5), mesh)
    hinv = ss.SingleStepHInv(sire, dam, sg_small, geno_ids,
                             inner_tol=1e-4, inner_maxiter=200)
    res_ss = ss.ssgblup(rng.standard_normal(60), hinv,
                        obs_ids=np.arange(1, 61), h2=0.5, tol=1e-3,
                        maxiter=200)
    assert np.isfinite(res_ss.u).all()

    if n_devices >= 2:
        mesh2 = parallel.make_mesh_2d(devices=devices)
        sg2 = parallel.shard_genotypes_2d(g, mesh2)
        c2n = parallel.sharded_dgemm_2d(
            sg2, parallel.pad_snp_vec(sg2, b_n), trans="n")
        c2t = parallel.sharded_dgemm_2d(
            sg2, parallel.pad_indiv_vec(sg2, b_t), trans="t")
        grm2 = parallel.sharded_grm_2d(sg2)
        res2 = parallel.sharded_cg_solve_2d(
            sg2, rng.standard_normal(32).astype(np.float32), lam=50.0,
            tol=1e-3, maxiter=50, precondition=True)
        for out in (c2n, c2t, grm2, res2.x):
            assert np.isfinite(host_global(out)).all()

    if n_devices >= 8:
        # real process boundaries: a 2-process gloo cluster in
        # subprocesses, independent of this process's devices
        from .parallel import mp_check

        outs = mp_check.run_cluster(num_processes=2, timeout=1100)
        assert all("MP_DRIVE_OK" in o for o in outs)

"""Single-step GBLUP end to end: pedigree + partial genotyping + phenotypes
on a subset: the evaluation MiXBLUP runs with the reference's sparse-solve
and packed-GEMM engines (solve_cuda.cu / mod5codesapi.f90), composed here
into one matrix-free solve on the device.

    python -m miraculix_tpu_torch.examples.ssgblup_pipeline [--device cuda]

Sizes: ``MX_EX_ANIM`` animals (2,000), ``MX_EX_GENO`` of them genotyped
(600) at ``MX_EX_SNPS`` SNPs (20,000).
"""
import argparse
import os
import sys

import numpy as np

import miraculix_tpu_torch as mt
from miraculix_tpu_torch import pedigree as ped
from miraculix_tpu_torch import ssgblup as ss
from miraculix_tpu_torch.geno import resolve_device
from miraculix_tpu_torch.io import bed

H2 = 0.4
MAXITER = 2000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # env knobs so the test suite can smoke-run this at tiny shapes
    n_anim = int(os.environ.get("MX_EX_ANIM", 2000))
    n_geno = int(os.environ.get("MX_EX_GENO", 600))
    n_snps = int(os.environ.get("MX_EX_SNPS", 20_000))

    rng = np.random.default_rng(1)
    print(f"pedigree: {n_anim} animals, {n_geno} genotyped, {n_snps} SNPs")
    sire, dam = ped.simulate_pedigree(n_anim, n_founders=80, seed=4)
    f = ped.inbreeding(sire, dam)
    print(f"inbreeding: mean F = {f.mean():.4f}, max F = {f.max():.4f}")

    # genotype the youngest animals (selection candidates), phenotype the
    # rest
    geno_ids = np.arange(n_anim - n_geno, n_anim) + 1
    geno = bed.simulate_genotypes(n_geno, n_snps, seed=11)
    gm = mt.from_dense(geno, device=dev)

    obs_ids = np.arange(1, n_anim - n_geno + 1)          # older, phenotyped
    u_true = rng.standard_normal(n_anim)                  # toy breeding values
    y = 2.0 + u_true[obs_ids - 1] + rng.standard_normal(len(obs_ids))

    hinv = ss.SingleStepHInv(sire, dam, gm, geno_ids, blend=0.05)
    res = ss.ssgblup(y, hinv, obs_ids=obs_ids, h2=H2, tol=1e-5,
                     maxiter=MAXITER)
    print(f"outer CG iterations: {res.iterations}  "
          f"residual: {res.residual_norm:.2e}")
    print(f"intercept estimate: {res.beta[0]:.3f} (true 2.0)")

    # the point of single-step: UNphenotyped, genotyped candidates get
    # genomically-informed EBVs; compare to the pedigree-only fit
    lam = (1 - H2) / H2
    a = ped.a_matrix(sire, dam)
    w = np.zeros((len(y), n_anim))
    w[np.arange(len(y)), obs_ids - 1] = 1.0
    x = np.ones((len(y), 1))
    mme = np.vstack([
        np.column_stack([x.T @ x, x.T @ w]),
        np.column_stack([w.T @ x, w.T @ w + lam * np.linalg.inv(a)]),
    ])
    u_ped = np.linalg.solve(mme, np.concatenate([x.T @ y, w.T @ y]))[1:]

    cand = geno_ids - 1
    print(f"candidate EBV shift (ssGBLUP vs pedigree BLUP): "
          f"mean |delta| = {np.abs(res.u[cand] - u_ped[cand]).mean():.4f}")
    if not (np.isfinite(res.u).all() and res.iterations < MAXITER):
        print(f"FAIL: EBVs not finite or the outer CG did not converge "
              f"within {MAXITER} iterations")
        return 1
    print("ssGBLUP done")
    return 0


if __name__ == "__main__":
    sys.exit(main())

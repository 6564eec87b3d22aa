"""The whole workflow on one simulated dataset: QC -> GRM (+ GCTA
fileset) -> REML h2 -> GBLUP -> marker backsolve -> prediction of new
animals -> LOCO mixed-model GWAS -> PCA -> LD scores.

    python -m miraculix_tpu_torch.examples.full_pipeline [--device cuda]

Sizes: ``MX_EX_N`` training animals (500), ``MX_EX_NEW`` new ones (120),
``MX_EX_SNPS`` SNPs (20,000).
"""
import argparse
import os
import sys
import tempfile

import numpy as np

import miraculix_tpu_torch as mt
from miraculix_tpu_torch import gblup, qc
from miraculix_tpu_torch.geno import resolve_device
from miraculix_tpu_torch.io import bed
from miraculix_tpu_torch.io.grm_io import write_gcta_grm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix="mx_pipeline_")
    # env knobs so the test suite can smoke-run this at tiny shapes
    n = int(os.environ.get("MX_EX_N", 500))
    n_new = int(os.environ.get("MX_EX_NEW", 120))
    snps = int(os.environ.get("MX_EX_SNPS", 20_000))

    # --- a deliberately messy panel: missing calls + rare variants -----
    g_all = bed.simulate_genotypes(n + n_new, snps, seed=1,
                                   missing_rate=0.02, maf_range=(0.005, 0.5))
    raw = os.path.join(work, "raw.bed")
    bed.write_bed(raw, g_all[:n])

    # --- 1. QC ----------------------------------------------------------
    clean = os.path.join(work, "clean.bed")
    keep_s, keep_i = qc.qc_filter(raw, clean, maf=0.01, geno=0.1, mind=0.1)
    print(f"QC: kept {keep_s.sum()}/{snps} SNPs, {keep_i.sum()}/{n} indiv")

    # --- 2. GRM + GCTA interchange --------------------------------------
    gm = mt.from_bed(clean, device=dev)
    grm_mat = mt.grm(gm, scale=True).cpu().numpy()
    write_gcta_grm(os.path.join(work, "panel"), grm_mat, gm.snps)
    unrelated = qc.rel_cutoff(grm_mat, cutoff=0.35)
    print(f"GRM {grm_mat.shape[0]}^2 written (GCTA fileset); "
          f"{unrelated.sum()} pass --rel-cutoff 0.35")

    # --- 3. phenotypes + REML h2 ----------------------------------------
    geno_clean, _ = bed.read_bed_genotypes(clean)
    y, bv = gblup.simulate_phenotypes(geno_clean, h2=0.6, n_qtl=500, seed=2)
    h2_hat, det = gblup.estimate_h2_reml(gm, y, n_probes=16, seed=3)
    print(f"AI-REML: h2 = {h2_hat:.3f} (SE {det['se_h2']:.3f}, "
          f"true 0.6, {det['iterations']} AI steps)")

    # --- 4. GBLUP + accuracy ---------------------------------------------
    res = gblup.gblup(gm, y, h2=h2_hat, n_pcs=5, tol=1e-6)
    cor = np.corrcoef(res.g_hat, bv)[0, 1]
    print(f"GBLUP: cor(EBV, true BV) = {cor:.3f}")

    # --- 5. backsolve + indirect prediction of NEW animals ---------------
    alpha = gblup.snp_effects(gm, res)
    g_new = g_all[n:][:, keep_s]
    g_new = np.where(g_new == 3, 0, g_new)
    gm_new = mt.from_dense(g_new, device=dev)
    pred = gblup.predict(gm_new, alpha, gm.freq.cpu().numpy())
    # true BVs of the new animals under the same QTL model are unknown here
    # (simulate_phenotypes draws its own QTLs); report the sanity stats
    print(f"indirect predictions for {n_new} new animals: "
          f"sd {pred.std():.3f} (training EBV sd {res.g_hat.std():.3f})")

    # --- 6. LOCO mixed-model GWAS ---------------------------------------
    chrom = np.repeat(np.arange(1, 11), int(np.ceil(gm.snps / 10)))[: gm.snps]
    scan = mt.gwas_mixed_loco(gm, y, chrom, h2=h2_hat, n_gamma_snps=24,
                              tol=1e-6)
    top = np.argsort(scan.p)[:5]
    print(f"LOCO GWAS: lambda-ish gamma {scan.gamma:.3f}, top hits "
          f"{list(top)}")

    # --- 7. population structure: top PCs (gcta --pca role) --------------
    w_pc, pcs = gblup.randomized_grm_pca(gm, k=5, seed=0)
    print(f"PCA: top-5 GRM eigenvalues "
          f"{np.round(w_pc / float(gm.sigma2), 3)}")

    # --- 8. LD scores (gcta --ld-score role) -----------------------------
    lds = mt.ld_score(gm, window=256)
    print(f"LD scores: mean {lds.mean():.2f}, max {lds.max():.2f} "
          f"(window 256, adjusted r^2)")
    print(f"pipeline artifacts in {work}")
    finite = all(np.isfinite(a).all() for a in (
        grm_mat, res.g_hat, alpha, pred, scan.chi2, w_pc, pcs, lds))
    if not (finite and np.isfinite(h2_hat) and cor > 0):
        print("FAIL: a non-finite result or EBVs uncorrelated with the "
              "true breeding values")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

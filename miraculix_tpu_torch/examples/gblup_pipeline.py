"""GBLUP end to end: simulate -> ingest -> GRM-PCA -> BLUE/BLUP.

The port of the reference's examples/gblup/calculate_gblup.jl
(simulate_population.R provides phenotypes there; here simulate_phenotypes).

    python -m miraculix_tpu_torch.examples.gblup_pipeline [--snps 50000]
                   [--indiv 10000] [--h2 0.5] [--mesh N] [--device cuda]
"""
import argparse
import sys

import numpy as np

import miraculix_tpu_torch as mt
from miraculix_tpu_torch.gblup import (gblup, randomized_grm_pca,
                                       simulate_phenotypes)
from miraculix_tpu_torch.geno import resolve_device
from miraculix_tpu_torch.io import bed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snps", type=int, default=20000)
    ap.add_argument("--indiv", type=int, default=4000)
    ap.add_argument("--h2", type=float, default=0.5)
    ap.add_argument("--pcs", type=int, default=10)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over N devices (0 = a single device)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    geno = bed.simulate_genotypes(args.indiv, args.snps, seed=0)
    y, bv_true = simulate_phenotypes(geno, h2=args.h2, seed=1)

    if args.mesh:
        from miraculix_tpu_torch.parallel.sharded import (mesh_on,
                                                          shard_genotypes)

        g = shard_genotypes(geno, mesh_on(args.mesh, dev))
    else:
        g = mt.from_dense(geno, device=dev)

    w, _ = randomized_grm_pca(g, k=args.pcs)
    print("top GRM eigenvalues:", np.round(w[:5], 1))

    res = gblup(g, y, h2=args.h2, n_pcs=args.pcs, solver="cg")
    cor = np.corrcoef(res.g_hat, bv_true)[0, 1]
    print(f"CG iterations: {res.cg_iterations}")
    print(f"cor(estimated BV, true BV) = {cor:.3f}")
    if not (np.isfinite(res.g_hat).all() and cor > 0):
        print("FAIL: breeding values not finite or not correlated with "
              "the true ones")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Conjugate-gradient solve on the GRM using only dgemm_compressed: the
port of the reference's examples/iterative_solver/grm_solve_cg.jl, with the
whole loop on the device (their stated wish: "A further boost ... if the
whole PCG is transferred to the GPU", src/cuda/dgemm_compressed_cuda.cu:
251-253).

    python -m miraculix_tpu_torch.examples.grm_solve_cg [--snps 50000]
                                       [--indiv 10000] [--device cuda]
"""
import argparse
import sys
import time

import numpy as np

import miraculix_tpu_torch as mt
from miraculix_tpu_torch.geno import resolve_device
from miraculix_tpu_torch.io import bed
from miraculix_tpu_torch.solve.cg import grm_cg_solve

MAXITER = 2000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snps", type=int, default=20000)
    ap.add_argument("--indiv", type=int, default=4000)
    ap.add_argument("--lam", type=float, default=100.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    geno = bed.simulate_genotypes(args.indiv, args.snps, seed=0)
    gm = mt.from_dense(geno, device=dev)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(args.indiv).astype(np.float32)

    t0 = time.time()
    res = grm_cg_solve(gm, b, lam=args.lam, tol=1e-4, maxiter=MAXITER)
    x = res.x.cpu().numpy()
    dt = time.time() - t0
    print(f"CG converged in {int(res.iterations)} iterations, {dt:.2f}s "
          f"(residual {float(res.residual_norm.max()):.2e})")
    if not (np.isfinite(x).all() and int(res.iterations) < MAXITER):
        print(f"FAIL: CG did not converge within {MAXITER} iterations")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

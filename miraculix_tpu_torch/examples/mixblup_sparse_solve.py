"""MiXBLUP-style sparse triangular solve: init once, solve many.

The reference serves this path through sparse2gpu / dcsrtrsv_solve_gpu /
free_sparse_gpu (src/cuda/solve_cuda.cu:281-882) with the Fortran layer
composing L(L^T x) = B plus a row permutation
(src/bindings/Fortran/modmiraculix_gpu.f90:80-157).  Here the factor is a
simulated pedigree-shaped lower triangle; the solver is the blocked O(nnz)
substitution (miraculix_tpu_torch.solve.sparse).

    python -m miraculix_tpu_torch.examples.mixblup_sparse_solve [n]
                                                        [--device cuda]
"""
import argparse
import sys
import time

import numpy as np

from miraculix_tpu_torch.geno import resolve_device
from miraculix_tpu_torch.solve.sparse import (SparseTriangularSolver,
                                              simulate_pedigree_factor)

RESID_LIMIT = 1e-3   # relative residual of L L^T x = b at refine=1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=200_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, ncol = args.n, 12

    print(f"simulating pedigree factor: n={n}, ~10 nnz/row")
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=9,
                                       bandwidth=max(n // 16, 1), seed=0)
    t0 = time.time()
    slv = SparseTriangularSolver(r, c, v, n, device=dev)  # init-once analysis
    print(f"analysis: {time.time() - t0:.1f} s "
          f"(nnz={slv.nnz}, {slv.nb} blocks of {slv.bs})")

    rng = np.random.default_rng(0)
    b = rng.standard_normal((n, ncol)).astype(np.float32)

    # solve-many lifecycle: repeated L L^T x = b on the same handle
    worst = 0.0
    for rep in range(3):
        t0 = time.time()
        x = slv.solve_lltx(b, refine=1)
        lx = slv.matvec(slv.matvec(x, trans="t")).cpu().numpy()
        resid = float(np.linalg.norm(lx - b) / np.linalg.norm(b))
        worst = max(worst, resid)
        print(f"solve {rep + 1}: {time.time() - t0:.2f} s  "
              f"rel resid {resid:.2e}")

    # permuted variant (c_solve_gpu_perm semantics)
    perm = rng.permutation(n) + 1
    x_p = slv.solve_lltx(b[:, 0], perm=perm)
    print(f"permuted solve ok: |x_p| = {float(x_p.abs().max()):.3f}")
    slv.free()
    if not (worst <= RESID_LIMIT and bool(x_p.isfinite().all())):
        print(f"FAIL: relative residual {worst:.2e} > {RESID_LIMIT:g} or a "
              "non-finite permuted solve")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

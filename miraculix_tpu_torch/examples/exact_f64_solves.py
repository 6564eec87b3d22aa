"""Double-precision results from the tensor cores' exact integer products.

Two layered techniques:

1. ``packed_matmul_exact`` / ``dgemm(precision='f64')``: the RHS expands
   in base-2^7 int8 digits; each digit slice is one EXACT int8 tensor-core
   pass (int32 sums, no rounding) and the partials recombine in float64.
   (Reference counterpart: the double accumulators of
   Vector.matrix.D.cc:42-229 and the CUTLASS f64 path of
   dgemm_compressed_cuda.h:111-698.)

2. ``solve.grm_cg_solve_refined``: iterative refinement.  The inner CG
   runs on the device in fast f32, the outer loop computes float64
   residuals through the exact operator and re-solves for the correction;
   each pass multiplies the error by the inner accuracy (the accuracy class
   of the reference's cuSOLVER double path, solve_cuda.cu:70-279).

    python -m miraculix_tpu_torch.examples.exact_f64_solves [--snps 8192]
                                           [--indiv 1024] [--device cuda]
"""
import argparse
import sys
import time

import numpy as np

import miraculix_tpu_torch as mt
from miraculix_tpu_torch import solve
from miraculix_tpu_torch.geno import resolve_device
from miraculix_tpu_torch.io import bed
from miraculix_tpu_torch.ops.dgemm import packed_matmul_exact

EXACT_RTOL = 1e-12     # the digit product against numpy's float64 product
SOLVE_RTOL = 1e-8      # the refined solve against numpy's float64 solve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snps", type=int, default=8192)
    ap.add_argument("--indiv", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = bed.simulate_genotypes(args.indiv, args.snps, seed=0)
    gm = mt.from_dense(g, device=dev)
    rng = np.random.default_rng(1)

    # --- exact product -------------------------------------------------
    b = rng.standard_normal((args.snps, 8))
    t0 = time.time()
    c = packed_matmul_exact(gm.zq_n, b)[: args.indiv]
    dt = time.time() - t0
    want = g.astype(np.float64) @ b
    rel = np.abs(c - want).max() / np.abs(want).max()
    print(f"exact product: {rel:.2e} relative vs float64 oracle "
          f"({dt*1e3:.0f} ms incl. digit extraction)")

    # --- f64-grade GRM solve -------------------------------------------
    f = gm.freq.cpu().numpy().astype(np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    lam = 10.0
    y = rng.standard_normal(args.indiv)
    t0 = time.time()
    x, outer, inner, relres = solve.grm_cg_solve_refined(
        gm, y, lam=lam, tol=1e-10)
    dt = time.time() - t0
    xs = np.linalg.solve(zc @ zc.T + lam * np.eye(args.indiv), y)
    err = np.abs(x - xs).max() / np.abs(xs).max()
    print(f"refined solve: {err:.2e} relative vs numpy float64 "
          f"({outer} outer / {inner} inner iterations, {dt:.2f} s)")
    ok = rel <= EXACT_RTOL and err <= SOLVE_RTOL
    if not ok:
        print(f"FAIL: exact product limit {EXACT_RTOL:g}, refined solve "
              f"limit {SOLVE_RTOL:g}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

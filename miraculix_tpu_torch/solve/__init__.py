"""Equation-system solvers: CG on the device (GBLUP) with its float64-grade
refinement, dense Cholesky/logdet, relationship-matrix solve, sparse
triangular solves."""
from .cg import (CGResult, cg, grm_cg_solve, grm_cg_solve_refined,
                 grm_diag, grm_matvec, grm_matvec_f64)
from .dense import (DenseSolveResult, RelMatResult, chol2inv, dense_solve,
                    solve_posdef, solve_relmat, sqrt_posdef, sqrt_rhs,
                    x_cinv_y_logdet)
from .sparse import SparseTriangularSolver

__all__ = [
    "CGResult",
    "DenseSolveResult",
    "RelMatResult",
    "SparseTriangularSolver",
    "cg",
    "chol2inv",
    "dense_solve",
    "grm_cg_solve",
    "grm_diag",
    "grm_cg_solve_refined",
    "grm_matvec_f64",
    "grm_matvec",
    "solve_posdef",
    "solve_relmat",
    "sqrt_posdef",
    "sqrt_rhs",
    "x_cinv_y_logdet",
]

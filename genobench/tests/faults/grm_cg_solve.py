"""Faults a ``grm_cg_solve`` job can have."""
from faulting import altered, half_batch, unchanged_state

FAULTS = [
    ("unchanged_state", ("solve.cg", "cg", unchanged_state())),
    ("half_batch", ("ops.dgemm", "packed_matmul_tall", half_batch)),
    ("altered", ("solve.cg", "grm_cg_solve", altered("x", "x"))),
]

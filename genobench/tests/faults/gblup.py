"""Faults a ``gblup`` job can have."""
from faulting import altered, half_batch, unchanged_state

FAULTS = [
    ("unchanged_state", ("solve.cg", "cg", unchanged_state(1))),
    ("half_batch", ("ops.dgemm", "packed_matmul_tall", half_batch)),
    ("altered", ("gblup", "gblup", altered("g_hat", "g_hat"))),
]

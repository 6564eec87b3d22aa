"""Faults a ``gwas_linear`` job can have."""
from faulting import altered, half_batch

FAULTS = [
    ("half_batch", ("ops.dgemm", "packed_matmul_tall", half_batch)),
    ("altered", ("gwas", "gwas_linear", altered("t", "t"))),
]

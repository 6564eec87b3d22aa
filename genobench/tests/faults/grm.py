"""Faults a ``grm`` job can have."""
from faulting import altered, crossprod_half

FAULTS = [
    ("altered", ("ops.grm", "grm", altered(None, "grm"))),
    ("half_batch", ("ops.grm", "packed_crossprod", crossprod_half)),
]

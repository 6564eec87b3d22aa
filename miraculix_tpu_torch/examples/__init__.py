"""The reference's six examples on the port, one module each:

    python -m miraculix_tpu_torch.examples.exact_f64_solves [--snps 8192]
    python -m miraculix_tpu_torch.examples.gblup_pipeline [--mesh N]
    python -m miraculix_tpu_torch.examples.grm_solve_cg [--lam 100]
    python -m miraculix_tpu_torch.examples.mixblup_sparse_solve [n]
    python -m miraculix_tpu_torch.examples.ssgblup_pipeline
    python -m miraculix_tpu_torch.examples.full_pipeline

Each takes the reference script's argv flags and ``MX_EX_*`` environment
knobs, prints its residuals and accuracies, and exits nonzero when one of
its checks fails.  Each also takes ``--device`` (default ``cuda``): on a
host with no CUDA device it exits unless given ``--device cpu``.
"""

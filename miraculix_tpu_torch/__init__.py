"""miraculix_tpu_torch: the PyTorch/CUDA port of miraculix_tpu.

Linear algebra directly on 2-bit-packed genotype matrices, on one NVIDIA
GPU: centered dgemm in both orientations, the exact integer GRM
crossproduct, CG solves, GBLUP, the GWAS scans, the LD family (full,
banded, scores, pruning, out of core) and the GRM family (GCTA, dominance,
out of core).  The packed products run in hand-written CUDA kernels
(``csrc/``, built at first use by ``_kernels``); on CPU tensors every op
takes the plain torch version of its kernel.  Panels go to the CUDA card
unless the caller names another device.  Imports torch and numpy (and scipy
for p-values) only, never jax.
"""
# NB: as in the reference, the gblup ESTIMATOR stays at
# miraculix_tpu_torch.gblup.gblup (re-exporting it would shadow the module)
from .geno import (GenoMatrix, from_bed, from_dense, from_plink,
                   from_reference_state, load, save, subset_snps)
from .gwas import (GWASResult, MixedGWASResult, gwas_linear, gwas_logistic,
                   gwas_mixed, gwas_mixed_loco)
from .ops.dgemm import dgemm, packed_matmul, packed_matmul_tall
from .ops.grm import (dominance_grm, grm, grm_blocked, grm_yang, ld,
                      ld_blocked, ld_prune, ld_score, ld_windowed,
                      packed_crossprod, packed_crossprod_rect,
                      pairwise_nonmissing, snp_crossprod)
from .solve.cg import (CGResult, cg, grm_cg_solve, grm_diag, grm_matvec,
                       jacobi_minv)

__version__ = "0.1.0"

__all__ = [
    "CGResult",
    "GWASResult",
    "GenoMatrix",
    "MixedGWASResult",
    "cg",
    "dgemm",
    "dominance_grm",
    "from_bed",
    "from_dense",
    "from_plink",
    "from_reference_state",
    "grm",
    "grm_blocked",
    "grm_cg_solve",
    "grm_diag",
    "grm_matvec",
    "grm_yang",
    "gwas_linear",
    "gwas_logistic",
    "gwas_mixed",
    "gwas_mixed_loco",
    "jacobi_minv",
    "ld",
    "ld_blocked",
    "ld_prune",
    "ld_score",
    "ld_windowed",
    "load",
    "packed_crossprod",
    "packed_crossprod_rect",
    "packed_matmul",
    "packed_matmul_tall",
    "pairwise_nonmissing",
    "save",
    "snp_crossprod",
    "subset_snps",
]

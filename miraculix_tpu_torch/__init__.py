"""miraculix_tpu_torch: the PyTorch/CUDA port of miraculix_tpu.

Linear algebra directly on 2-bit-packed genotype matrices, on one NVIDIA
GPU: centered dgemm in both orientations (bf16, f32 and exact float64
tiers), the exact integer GRM crossproduct, sparse x genotype products, CG
solves with float64 refinement, dense solvers, GBLUP, the GWAS scans, the
LD family (full, banded, scores, pruning, out of core) and the GRM family
(GCTA, dominance, out of core), all with exact missing-genotype
corrections, and the variance components that feed GBLUP (HE, AI-REML,
bivariate and multi-trait REML), cross-validation and multi-trait GBLUP;
the sparse triangular solver, the pedigree algebra (inbreeding, A and its
sparse inverse) and single-step GBLUP with its REML; panels held in host
memory, whole (``device_put=False``) or as the out-of-core
``StreamedGeno``, whose SNP chunks stream through the same kernels; and
panels sharded over a mesh of devices and processes
(``miraculix_tpu_torch.parallel``: SNP-sharded and 2D-sharded, over
``torch.distributed``), which GBLUP, REML, the scans and single-step take
as they take a panel; and the user surface: ``Options`` and the global
option latch, the reference's storage codings and any-to-any transform
(``formats``), VCF ingestion and GCTA GRM files (``io.vcf``,
``io.grm_io``), panel QC (``qc``), the MoBPS bridge (``mobps``), the
float64 oracles (``ops.ref_impl``), the packed-panel cache, logging and
tracing (``utils``), and the reference's C API and R API as the facades
``api`` and ``rapi`` (submodules, as in the reference).
The packed products run in hand-written CUDA kernels
(``csrc/``, built at first use by ``_kernels``); on CPU tensors every op
takes the plain torch version of its kernel.  Panels go to the CUDA card
unless the caller names another device.  Imports torch and numpy (and scipy
for p-values, the sparse D D^T of the missing corrections and the sparse
solver's float64 residuals) only, never jax.
"""
# NB: as in the reference, the gblup ESTIMATOR stays at
# miraculix_tpu_torch.gblup.gblup (re-exporting it would shadow the module)
from .geno import (GenoMatrix, from_bed, from_dense, from_plink,
                   from_reference_state, load, save, subset_snps)
from .gblup import (MTGBLUPResult, cross_validate, estimate_bivar_reml,
                    estimate_h2_he, estimate_h2_reml, estimate_multi_reml,
                    gblup_from_grm, multi_trait_gblup, run_gblup)
from .gwas import (GWASResult, MixedGWASResult, gwas_linear, gwas_logistic,
                   gwas_mixed, gwas_mixed_loco)
from .ops.dgemm import (dgemm, packed_matmul, packed_matmul_exact,
                        packed_matmul_f64, packed_matmul_int8,
                        packed_matmul_tall)
from .ops.grm import (dominance_grm, grm, grm_blocked, grm_yang, ld,
                      ld_blocked, ld_prune, ld_score, ld_windowed,
                      packed_crossprod, packed_crossprod_rect,
                      pairwise_nonmissing, snp_crossprod)
from .ops.sparse import sparse_times_geno, sparse_times_geno_segsum
# NB: the ssgblup SOLVER stays at miraculix_tpu_torch.ssgblup.ssgblup too
from .pedigree import SparseCOO, a_inverse, a_matrix, inbreeding
from .solve import (CGResult, DenseSolveResult, RelMatResult, chol2inv,
                    dense_solve, grm_cg_solve_refined, grm_matvec_f64,
                    solve_posdef, solve_relmat, sqrt_posdef, sqrt_rhs,
                    SparseTriangularSolver, x_cinv_y_logdet)
from .solve.cg import cg, grm_cg_solve, grm_diag, grm_matvec, jacobi_minv
from .options import Options, get_global_options, set_global_options
from .ssgblup import SingleStepHInv
from .streamed import StreamedGeno

__version__ = "0.1.0"

__all__ = [
    "CGResult",
    "DenseSolveResult",
    "GWASResult",
    "GenoMatrix",
    "MTGBLUPResult",
    "MixedGWASResult",
    "Options",
    "RelMatResult",
    "SingleStepHInv",
    "SparseCOO",
    "SparseTriangularSolver",
    "StreamedGeno",
    "a_inverse",
    "a_matrix",
    "cg",
    "chol2inv",
    "cross_validate",
    "dense_solve",
    "dgemm",
    "dominance_grm",
    "estimate_bivar_reml",
    "estimate_h2_he",
    "estimate_h2_reml",
    "estimate_multi_reml",
    "from_bed",
    "from_dense",
    "from_plink",
    "from_reference_state",
    "gblup_from_grm",
    "get_global_options",
    "grm",
    "grm_blocked",
    "grm_cg_solve",
    "grm_cg_solve_refined",
    "grm_diag",
    "grm_matvec",
    "grm_matvec_f64",
    "grm_yang",
    "gwas_linear",
    "gwas_logistic",
    "gwas_mixed",
    "gwas_mixed_loco",
    "inbreeding",
    "jacobi_minv",
    "ld",
    "ld_blocked",
    "ld_prune",
    "ld_score",
    "ld_windowed",
    "load",
    "multi_trait_gblup",
    "packed_crossprod",
    "packed_crossprod_rect",
    "packed_matmul",
    "packed_matmul_exact",
    "packed_matmul_f64",
    "packed_matmul_int8",
    "packed_matmul_tall",
    "pairwise_nonmissing",
    "run_gblup",
    "save",
    "set_global_options",
    "snp_crossprod",
    "solve_posdef",
    "solve_relmat",
    "sparse_times_geno",
    "sparse_times_geno_segsum",
    "sqrt_posdef",
    "sqrt_rhs",
    "subset_snps",
    "x_cinv_y_logdet",
]

"""Drive the PyTorch/CUDA port once on one GPU, through its kernels.

    python3 chip_smoke.py

Builds the CUDA kernels of ``miraculix_tpu_torch/csrc`` and the native host
codec of ``miraculix_tpu_torch/io/native`` and

0. writes the ``many_indiv`` panel as a .bed fileset and packs it with
   ``from_bed`` through the native codec (the fused ingestion), and once
   through its numpy path, whose words and frequencies must be equal bit
   for bit (both times printed); ``write_bed``, the main ``from_bed`` and
   ``ld_prune`` must have run the native codec (its call counts are
   printed), and the prune scan is timed natively beside the Python greedy
   scan, which must agree;

1. holds each kernel against its plain torch version on the ``many_indiv``
   panel (65,536 SNPs x 16,384 animals), 'n' and 't', at the shapes the
   main paths launch: the tall dgemm kernel in its split mode with and
   without the fused center vector (1, 4, 6, 12, 18, 32, 33 and 64 columns)
   and in its bf16 and f32 modes (1, 8, 32 and 128 columns; max error <= 1e-5
   of max |plain|; the f32 mode on a B whose third bf16 parts add up, with
   the split grade as a second control), its time split by kernel, the tall
   and wide kernels timed side by side at the bf16 and f32 tiers' 65 and
   128 columns, the wide dgemm kernel in its four RHS instances
   (fast split, f32, bf16, bf16 hi||lo: two, three, one and two bf16
   passes; error <= 4e-6 of each output's sum of |terms|), each against a
   plain version that rounds B the same way, the split and f32 instances
   also on a positive B over 65,536 terms held to the float64 product, the
   wide kernel's time split by kernel,
   the integer crossproduct (exactly equal), the rectangular crossproduct
   at an LD row block and a ``grm_blocked`` tile (random and all-2
   genotypes) and the masked-grid crossproduct on the whole square (exactly
   equal, the latter to K3 too), and the weighted crossproduct at the GCTA
   GRM's weights (error <= 4e-6 of each output; its time by kernel, and a
   bf16 library call of its three digit passes beside the f32 one).  Each
   dgemm and weighted check also reads a control, the plain product at the
   other grade (bf16(B) against B, bf16(w) against w; for the weighted one
   also the kernel on w's first digit alone and on its first two, i.e. on
   weights whose split has only those), which must exceed the limit under
   the same metric.  The exact digit kernel of the f64 tier is held to its
   plain version (exactly equal) at the products the f64 paths launch
   (8 and 96 digit columns, 'n' and 't'), with digits over [-64, 64], in
   both its instances, and one ``packed_matmul_exact`` product at 12
   columns is timed by step (digits, layout, kernel, recombination) beside
   the FP64 tensor cores (a float64 ``torch.matmul`` of the decoded
   panel).  The row statistics' kernel is held to its plain 16-plane loop
   (exactly equal) on zq_t and zq_n, on the panel's, random and all-2
   words.  Each kernel is timed beside its plain version, one PyTorch
   library call on the pre-decoded panel, and its bound on the card;
2. runs the main GBLUP path at that size from the launch counters' zero:
   simulate -> write .bed -> ``from_bed`` on the GPU -> ``grm`` (diagonal
   checked against ``grm_diag``) -> simulated phenotypes -> ``gblup`` (CG
   converged, g_hat correlated with the true breeding values); then, from
   the counters' zero, the rest of ``gblup.py`` on that trait (h2 = 0.5),
   a second one genetically correlated 0.5 with it and two independent
   ones: ``estimate_h2_he`` (within 0.15 of 0.5), ``estimate_h2_reml``
   without and with the 3 GWAS covariates (converged, within 0.1, a
   positive SE), ``cross_validate`` over 5 folds (mean correlation >= 0.2),
   ``estimate_bivar_reml`` (converged, both h2 within 0.1, rg within 0.15
   of 0.5), ``estimate_multi_reml`` on the 4 traits (converged, through
   the wide split kernel), ``multi_trait_gblup`` with the bivariate
   components and 10% of trait 2 missing (every cell finite, corr(g_hat,
   BV) >= 0.7 on both traits), ``gblup_from_grm(grm(scale=True))``
   (fitted within 1e-3 of ``gblup(n_pcs=0, tol=1e-6)``) and ``run_gblup``
   with AI-REML on the .bed with the phenotypes in its .fam (exit 0,
   65,536 marker effects written, printed cor(fitted, y) >= 0.7), each
   with its seconds, launches and CG totals; then, each from the counters'
   zero, the f64 tier: ``gblup(solver="refined",
   tol=1e-10)`` and ``grm_matvec_f64`` on 12 columns (converged, g_hat
   within 1e-3 of the f32 run's, the matvec within 1e-12 of a float64
   product over decoded blocks), ``gblup(solver="dense")`` (g_hat within
   1e-3 of the refined one) and ``dgemm(precision="f64")`` 'n' and 't' at 12
   columns (within 1e-12 of the float64 product);
3. runs the main GWAS path on the same panel from the counters' zero:
   ``gwas_linear`` (checked against float64 regressions on 256 SNPs),
   ``gwas_logistic``, ``gwas_mixed`` (65 CG columns: the wide kernel) and
   ``gwas_mixed_loco`` over 4 chromosomes, each with finite statistics and
   the simulated QTL enriched >= 10x in median chi2;
4. runs the bf16/f32 tiers from the counters' zero: ``grm_cg_solve`` at
   both tiers, wide and tall, and ``packed_matmul`` at 32 columns;
5. runs the LD family from the counters' zero on the panel with 8,192
   planted adjacent duplicate pairs: ``ld_windowed``, ``ld_score`` and
   ``ld_prune`` over 4 chromosomes at window 512, ``ld`` and ``ld_blocked``
   on the first chromosome (prune drops exactly one SNP of each pair; the
   scores, the band and the blocked matrix agree with ``ld``);
6. runs the GRM family at 16,384 animals from the counters' zero:
   ``grm_blocked`` against ``grm``, the masked-grid crossproduct against
   K3, ``grm_yang`` against its float64 definition on 256 rows; then, from
   the counters' zero, the missing-aware family on the panel with 0.1% of
   its calls set missing (``from_dense(keep_missing_info=True)``):
   ``grm()`` (corrected by default), ``grm(pair_denominator=True)``,
   ``grm_yang()`` and ``ld()`` on the first chromosome, rows 0-255 against
   their float64 mean-imputed definitions (1e-4 of max |want|), the LD
   diagonal 1 within 1e-6; the host D D^T and the segment sum timed apart;
7. runs the sparse solver and single-step GBLUP at the sizes of the
   reference benchmark's cells, each from the counters' zero: "main sparse
   solve" (``benchmark.py`` "sparse_solve": a simulated pedigree-shaped
   factor, n = 1,000,000, ~9 off-diagonal entries a row within n/16 of the
   diagonal, a float32 ``SparseTriangularSolver`` at bs 512 with its
   device analysis; ``solve_lltx`` on 12 columns timed warm, its relative
   residual at refine 0 and 1 (1 must be lower), ``solve_lltx_f64`` to
   1e-12, ||T X - I|| / (||T|| ||X||) <= 1e-4 on 64 inverted diagonal
   blocks beside the float64 inverse rounded to float32, the peak device
   memory) and "main ssgblup" (``benchmark.py`` "ssgblup": 200,000
   pedigree animals, the youngest 20,000 genotyped at 65,536 SNPs,
   phenotypes on the other 180,000, classical rules, h2 0.4, tol 1e-5:
   converged before 500 outer iterations, every u finite; set-up, first
   and warm solve timed, the tall launches by width); then native
   ``inbreeding`` on 20,000 animals (the first 1,000 against the Python
   oracle within 1e-12, counted in ``native.CALLS``); a dense float64
   oracle on the card at 8,192 animals, 2,048 of them genotyped (rows of
   the many_indiv panel): ``SingleStepHInv.matvec`` within 2e-4 and
   ``ssgblup``'s beta and u within 5e-3 of the dense H^-1 and MME solve;
   and ``run_ssgblup(estimate_h2=True, no_inbreeding=True)`` on the
   many_indiv fileset with a 32,768-animal pedigree whose youngest 16,384
   are the panel's animals (exit 0, an EBV for every animal, single-step
   REML h2 within 0.1 of 0.5, corr(u, BV) >= 0.7 on the genotyped);
8. checks the GPU pipeline against the port's CPU path on small panels
   (GBLUP cg/refined/dense, GRM, the four scans, ``sparse_times_geno``, HE,
   exact-probe AI-REML, ``cross_validate``, two-trait REML with the device
   and the host V-solve, ``multi_trait_gblup``, ``gblup_from_grm`` and
   ``run_gblup``'s marker effects on simulated phenotypes; the sparse
   solver at n = 5,000 and bs 300 in both triangles, orientations and
   precisions, with a permutation and to float64 grade, ``SparseCOO``,
   ``SingleStepHInv.matvec`` and ``ssgblup`` on a 2,000-animal pedigree
   over the 600 x 5,000 panel and exact-probe single-step REML on a
   120-animal one; the f64 dgemm,
   the LD and GRM families with and without the missing corrections on a
   panel with 2% missing genotypes), at 1e-3 (h2 and its SE: absolute), or
   1e-12 for the f64 tier.
9. runs the out-of-core ``StreamedGeno`` on the many_indiv fileset and on
   the "ssgblup" cell's panel, each call held to the resident one;
10. runs the parallel layer in a world-1 NCCL group (a FileStore beside
   the fileset) on a 1D mesh of 4 SNP shards and a 2 x 2 mesh, all on the
   one card, at full width: ``shard_genotypes_from_bed`` (each shard's
   range read alone; words bit-equal to ``shard_genotypes`` of the dense
   panel, frequencies to the resident ``from_bed``'s), ``sharded_dgemm``
   'n' and 't' at 1, 32 and 65 columns (1e-5 of max), the raw sharded
   crossproduct replicated and scattered (exactly equal to K3 on the
   resident panel) and ``sharded_grm`` (1e-5), ``sharded_cg_solve``,
   ``gblup`` and ``estimate_h2_reml`` on the ShardedGeno, the four GWAS
   scans (1e-4), the 2D products, raw crossproduct, CG and 4-trait REML,
   ``save_sharded``/``load_sharded``, and ``ssgblup`` on the "ssgblup"
   cell sharded 4 ways; each call beside the resident one with its
   launches, no plain version, and its collectives' calls and bytes; the
   group is destroyed before the phase ends;
11. runs the user surface on the many_indiv fileset, each call from the
   counters' zero with its seconds and launches: the C API in the flow of
   the reference's tests/dgemm_compressed/test.jl (``set_options`` ->
   ``read_bed`` -> ``plink_transpose_packed`` -> ``plink2compressed`` ->
   ``dgemm_compressed`` 'N' and 'T' at 10 columns, within 1e-5 of max of
   float64 products of the panel decoded on the host from the .bed bytes;
   ``get_compressed_freq`` bit-equal to ``from_bed``'s; a second
   ``plink2compressed`` a cache hit with no pack; ``dgemm_plink``
   uncentered (K1) and centered (K2) equal within 1e-5 to
   ``dgemm_compressed`` under the same options; ``sparse_times_plink`` at
   32 and 1,000 rows over the animals and 32 over the SNPs at 1% density
   against float64 S @ Z; ``free_compressed`` lowering
   ``torch.cuda.memory_allocated`` by at least the two packings, the next
   ``plink2compressed`` a miss; one ``dgemm_compressed`` under
   ``device_trace``); the R API on a TWO_BIT ``CodedMatrix`` of the panel
   (``geno_vector``, ``vector_geno``, ``vector_rel_matrix`` against
   float64, ``crossprod`` and ``crossprod_int`` equal to ``snp_crossprod``,
   ``allele_freq``, the ``transpose`` round trip); MoBPS's
   ``compute_relationship`` on 1,024 reconstructed animals (its diagonal
   equal to ``grm`` of ``compute_snps``' genotypes, the matrix within 1e-5
   of the float64 GRM definition); and, timed on the host, ``snp_stats``
   (counts equal to numpy's on 256 SNPs), ``qc_filter(maf=0.01,
   geno=0.05, hwe=1e-6)`` read back by ``from_bed``, ``rel_cutoff`` on the
   panel's GRM and its GCTA files written and read back bit-equal;
12. runs the CLI's 15 subcommands in process (``cli.main(["--device",
   "cuda:0", ...])``) on the many_indiv fileset, its .bim put on phase 3's
   4 chromosomes, each from the counters' zero with its seconds and
   launches, exit 0 and no plain version, each output held to the library
   call of an earlier phase on the same panel or the library call on the
   same input: ``simulate`` on the 600 x 5,000 small panel (.bed
   byte-equal to ``simulate_genotypes`` + ``write_bed``), ``validate``,
   ``ingest`` (``geno.load`` bit-equal to ``from_bed``), ``grm`` with
   ``--gcta-out`` (1e-6 of max, the GCTA files bit-equal), ``--method yang
   --pair-denom`` (B9, one call) and ``--blocked`` (B8; 1e-5), ``ld
   --window 512 --score`` and ``--prune-r2`` (1e-5, the prune lists
   equal), ``qc --rel-cutoff`` on a 600 x 5,000 panel with missing calls
   and rare variants (the fileset byte-equal
   to ``qc_filter``'s, the IDs to ``rel_cutoff``'s), ``pedigree`` on a
   2,000-animal pedigree (F as ``inbreeding``'s), ``gwas``
   linear, ``--mixed --loco``, ``--logistic``, ``--stream-chunk 16384`` and
   ``--mesh 4`` (four shards on the one card; 1e-4), ``gblup --estimate-h2
   --h2-method reml --effects-out`` and ``score`` (1e-3), ``pca -k 10``,
   ``reml`` HE, AI-REML, ``--bivar`` and ``--multi`` on 4 traits (phase 2's
   estimates within 1e-3), ``ssgblup`` on phase 7's 32,768-animal pedigree
   at the h2 of phase 7's single-step REML (EBVs within 1e-3 of phase 7's
   ``run_ssgblup``) and ``bench --grm``; ``entry()`` against
   ``ref_impl.dgemm_oracle`` (1e-5) and ``dryrun_multichip(4)`` with its
   shards on the one card, neither running a plain version; then the six
   examples as subprocesses at their default sizes, all at once (exit 0,
   one wall time for the six);
13. runs the benchmark suite in process (``benchmark.main([..., "--device",
   "cuda:0"])``, one (suite, panel) a run, each from the counters' zero,
   every row printed with its seconds, launches and peak device memory) at
   the reference's sizes: ``dgemm`` and ``grm`` on xsmall, small and
   many_indiv with the f32 ``torch.matmul`` comparator, ``grm`` on the
   1,048,576-SNP x 21,248-animal ref panel (words hashed on the card; rows
   0-255 of the timed product exactly equal to the plain product of the
   same words), ``ld`` on xsmall, ``dgemm_exact`` (8 columns) and
   ``solve_refined`` on small, ``gwas`` on medium, ``sparse_solve``,
   ``ssgblup``, ``gblup_fullscale`` (1,048,576 x 100,096 in 16 regenerated
   chunks), ``ld_banded`` (1,048,576 x 512) and ``scaling`` (one card):
   no plain version, no share above the detected card's peak, every
   number finite, the sparse residuals (< 1e-4; f64 grade <= 1e-12), the
   refined solve's float64 residual (<= 1e-10), the full-scale CG
   converged within 60 iterations, single-step under 500; then the chunk
   generator's ms a chunk.

Cuts from the reference's own runs: phase 7's ``run_ssgblup`` pedigree has
32,768 animals (65,536 took the phase 70 s); phase 11 reconstructs 1,024
MoBPS animals; phase 12 runs the full LD matrix (``ld`` without
``--window``) on the 600 x 5,000 small panel only (65,536^2 is 17 GB),
the subcommands that launch no kernel at many_indiv (``simulate``, ``qc``'s
filters and ``pedigree``: host work that phases 0, 11 and 7 already do at
full size) on 600 x 5,000 panels and a 2,000-animal pedigree,
``grm --method yang --pair-denom`` as one call (each reads the panel with
its missing coordinates, ~12 s; the VanRaden ``--pair-denom`` path runs in
the CPU tests) and ``ssgblup`` without ``--estimate-h2`` (phase 7 runs the
single-step REML).

Kernel bounds and the suite's shares use the detected card's dense peaks
(``benchmark.device_peaks``), printed beside its name and power limit.

Earlier lines report the compiler's registers and spills (and, for the
integer, wide and weighted kernels, their shared memory and resident blocks
an SM), per-phase seconds, errors, kernel rates beside their bounds, launch
counts (the tall kernel's also by mode and width over the main paths, each
of which phase 1 must have checked), the card's
name and power limit, and one JSON object of kernel results; the last line
is ``{"ok": true, "device": {...}}``.  Any failed check exits nonzero and
prints no result line.
"""
from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

N_SNPS, N_INDIV = 65536, 16384   # miraculix_tpu/benchmark.py "many_indiv"
SEED = 0
MISSING_RATE = 0.001  # the missing-aware phase: a 99.9% call rate
F64_RTOL = 1e-12      # the f64 tier vs float64 products, relative to max
KERNEL_RTOL = 1e-5    # tall kernel vs plain, relative to max |plain|
# wide kernel vs plain, relative to each output's sum of |terms|: on the
# H100 the sound instances read <= 3.5e-7 on random B and <= 8.1e-7 on a
# positive B, the other-grade controls >= 5.6e-5 at 'n' (65,536 terms), so
# the limit sits 5-10x from each
WIDE_RTOL = 4e-6
DIAG_RTOL = 1e-4      # grm() diagonal vs grm_diag(scale=True)
MIN_BV_CORR = 0.7     # corr(g_hat, true BV), in-sample, h2 = 0.5
SMALL_RTOL = 1e-3     # GPU vs CPU path on the small panel
SMALL_ATOL = 1e-3     # the same for h2 and its SE, absolute
LINEAR_RTOL = 1e-4    # gwas_linear vs f64 regressions, relative to max |x|
QTL_ENRICH = 10.0     # median chi2 over the QTL / median over all SNPs
GWAS_TOL, GWAS_MAXITER = 1e-2, 300   # absolute CG residual norm (|rhs| ~ 1e2)
N_QTL = 100           # gblup.simulate_phenotypes' default
# the variance components of the many_indiv traits (h2 = 0.5; traits 1 and
# 2 genetically correlated 0.5 in the sample): |estimate - simulated|
HE_TOL, REML_TOL, RG_TOL, RG_TRUE = 0.15, 0.1, 0.15, 0.5
CV_MIN_CORR = 0.2     # mean corr(yhat, y) over 5 folds
LD_WINDOW, LD_R2 = 512, 0.2   # plink --indep-pairwise 512 ... 0.2
LD_BLOCK = 4096               # ld_windowed's row block: [4096, 4608] products
# the tall kernel's phase-1 widths: every (mode, width) the main paths
# launch (1: the u solve and g_hat; 4, 6 and 64: the refined and dense
# GBLUP and f64 paths; 12: GBLUP's CG right-hand sides; 18: its PCA sketch;
# 32: the tiers phase; 33: gwas_mixed_loco's CG, the most launched; the
# script fails if a main path launches one not checked here) and the
# bf16/f32 tiers' widest (128).  The variance-component paths add, as read
# off the tall histogram of a run: 2 (AI-REML's second solve [G_s P y, P
# y]; the two-trait G_s Y, multi_trait_gblup's residual solve and BLUP),
# 8 (multi-trait REML's HE start, max(n_probes, 8) probes), 16 (HE's
# probes; the bivariate probes, 2 traits x 8), 21 (AI-REML's block with 3
# covariates: p + 1 + 16), 22 (the bivariate block, t (t p + 1 + 8)) and 52
# (the 4-trait block, 4 (4 + 1 + 8)); 4, 6, 12, 18 and 32 recur there (the
# 4-trait Y and probes, multi_trait_gblup's t (t p + 1), the bivariate AI
# block t t (t + 1), REML's block p + 1 + 16); the 4-trait AI block (80
# columns) takes the wide kernel.  Phase 11 adds 10 (the C API's
# dgemm_compressed and dgemm_plink, centered and not, at the reference's
# tests/dgemm_compressed/test.jl width); its sparse products at 32 rows
# take f32 32.  Phase 12 adds 3 (the CLI's gwas --logistic, no covariates:
# the score pass [y - mu | w | w x] with x the intercept) and 5
# (dryrun_multichip's LOCO CG: 4 sampled SNPs beside y).  Phase 13 adds
# f32 8 (the suite's dgemm_exact beside its exact tier)
TALL_NCOLS = (32, 1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 16, 18, 21, 22, 33, 52,
              64, 128)
# phase 7: the sparse solve of benchmark.py's "sparse_solve" cell (n, RHS
# columns; a float32 solver at bs 512) and its limit on ||T X - I|| /
# (||T|| ||X||) over 64 inverted diagonal blocks; the single-step cells:
# benchmark.py's "ssgblup" (animals, genotyped; phenotypes on the rest),
# the dense-oracle check (animals, genotyped rows of many_indiv) with its
# outer CG tolerance, and run_ssgblup's pedigree (its youngest 16,384 are
# the panel's animals; 32,768 animals, as 65,536 took the phase 70 s on an
# H100 80GB HBM3 at 700 W)
SPARSE_N, SPARSE_NCOL, SPARSE_TX_RTOL = 1_000_000, 12, 1e-4
SS_CELL, SS_MAXITER = (200_000, 20_000), 500
SS_ORACLE, SS_ORACLE_TOL = (8192, 2048), 1e-6
SS_PIPELINE = 32_768
# phase 8's single-step REML with exact probes (animals, genotyped rows and
# SNPs of the small panel): its CPU side runs the plain dgemm in every inner
# CG iteration, so the cell is the reference tests' (tests/test_ssgblup.py)
SS_SMALL_REML = (120, 48, 600)

# phase 9: SNPs a chunk of the streamed panels (4 chunks of ~128 MB of
# words at many_indiv, ~167 MB in the "ssgblup" cell; 2 of them cached);
# gwas_mixed's CG tolerance there, resident (absolute, |rhs| ~ 1e2) and
# streamed (relative), both ~1e-6 of |rhs| so the two scans agree to 1e-4
STREAM_CHUNK = 16384
STREAM_MIXED_TOL = (1e-4, 1e-6)
# phase 11: MoBPS offspring reconstructed for compute_relationship, cut
# from the panel's 16,384 animals: the reconstruction is a Python loop an
# animal (a few ms each at 65,536 SNPs)
MOBPS_ANIMALS = 1024
# phase 12: the examples, run as subprocesses at their default sizes, all
# at once, and the seconds they may take together
EXAMPLES = ("exact_f64_solves", "gblup_pipeline", "grm_solve_cg",
            "mixblup_sparse_solve", "ssgblup_pipeline", "full_pipeline")
EXAMPLE_TIMEOUT = 300
# phase 13: the benchmark suite through benchmark.main, one (suite, panel) a
# run, at the reference's sizes and defaults; dgemm_exact at its cell's own
# 8 columns (main's --ncol default is 32); the limits its rows are held to
SUITE_RUNS = (
    *(["--suite", s, "--panels", p, "--comparator"] for s in ("dgemm", "grm")
      for p in ("xsmall", "small", "many_indiv")),
    ["--suite", "grm", "--panels", "ref_many_snps"],
    ["--suite", "ld", "--panels", "xsmall"],
    ["--suite", "dgemm_exact", "--panels", "small", "--ncol", "8"],
    ["--suite", "solve_refined", "--panels", "small"],
    ["--suite", "gwas", "--panels", "medium"],
    ["--suite", "sparse_solve"], ["--suite", "ssgblup"],
    ["--suite", "gblup_fullscale"], ["--suite", "ld_banded"],
    ["--suite", "scaling"])
SUITE_SPARSE_RESID, SUITE_SPARSE_F64 = 1e-4, 1e-12
SUITE_REFINED_RESID = 1e-10
SUITE_CG_MAX, SUITE_SS_MAX = 60, 500
SUITE_EXACT_ROWS = 256   # the ref panel's block held to the plain product

SOURCES = {  # kernel -> (source, TPU kernel it replaces)
    "tall_dgemm": ("miraculix_tpu_torch/csrc/tall_dgemm.cu",
                   "miraculix_tpu/ops/dgemm.py:146"),
    "tall_dgemm_cv": ("miraculix_tpu_torch/csrc/tall_dgemm.cu",
                      "miraculix_tpu/ops/dgemm.py:219"),
    "tall_dgemm_bf16": ("miraculix_tpu_torch/csrc/tall_dgemm.cu",
                        "miraculix_tpu/ops/dgemm.py:146"),
    "tall_dgemm_f32": ("miraculix_tpu_torch/csrc/tall_dgemm.cu",
                       "miraculix_tpu/ops/dgemm.py:146"),
    "wide_dgemm_split": ("miraculix_tpu_torch/csrc/wide_dgemm.cu",
                         "miraculix_tpu/ops/dgemm.py:104,78"),
    "wide_dgemm_f32": ("miraculix_tpu_torch/csrc/wide_dgemm.cu",
                       "miraculix_tpu/ops/dgemm.py:274"),
    "wide_dgemm_bf16": ("miraculix_tpu_torch/csrc/wide_dgemm.cu",
                        "miraculix_tpu/ops/dgemm.py:256"),
    "wide_dgemm_hilo": ("miraculix_tpu_torch/csrc/wide_dgemm.cu",
                        "miraculix_tpu/ops/dgemm.py:54"),
    "crossprod": ("miraculix_tpu_torch/csrc/crossprod.cu",
                  "miraculix_tpu/ops/grm.py:148,175"),
    "crossprod_rect": ("miraculix_tpu_torch/csrc/crossprod.cu",
                       "miraculix_tpu/ops/grm.py:71"),
    "crossprod_tri": ("miraculix_tpu_torch/csrc/crossprod.cu",
                      "miraculix_tpu/ops/grm.py:85"),
    "crossprod_weighted": ("miraculix_tpu_torch/csrc/crossprod_weighted.cu",
                           "miraculix_tpu/ops/grm.py:450"),
    "matmul_int8": ("miraculix_tpu_torch/csrc/matmul_int8.cu",
                    "miraculix_tpu/ops/dgemm.py:625"),
    # the reference's packed_row_sq_stats is plain jnp, no Pallas kernel
    "row_sq_stats": ("miraculix_tpu_torch/csrc/row_sq_stats.cu", None),
}
# the unit and passes that bound each kernel: one rule for the products,
# the bf16 tensor-core passes that the tier's grade needs (genotypes are
# exact in bf16; B takes one bf16 piece at the bf16 tier, hi + lo at the
# split tier, three pieces for its 24 bits at the f32 tier), as the tall and
# wide kernels run them.  The integer crossproducts and the exact digit
# product are one int8 pass; the weighted one is f32 grade.  The row
# statistics take no pass of a unit: one read of the words bounds them.
UNIT = {"tall_dgemm": ("bf16", 2), "tall_dgemm_cv": ("bf16", 2),
        "tall_dgemm_bf16": ("bf16", 1), "tall_dgemm_f32": ("bf16", 3),
        "wide_dgemm_split": ("bf16", 2), "wide_dgemm_hilo": ("bf16", 2),
        "wide_dgemm_bf16": ("bf16", 1), "wide_dgemm_f32": ("bf16", 3),
        "crossprod": ("int8", 1), "crossprod_rect": ("int8", 1),
        "crossprod_tri": ("int8", 1), "crossprod_weighted": ("bf16", 3),
        "matmul_int8": ("int8", 1), "row_sq_stats": ("int8", 0)}


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(name: str, macs: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for ``macs``
    multiply-adds and ``nbytes`` moved once: the larger of operations over
    the unit's peak and bytes over the HBM rate, the detected card's dense
    peaks (``benchmark.device_peaks``)."""
    from miraculix_tpu_torch.benchmark import device_peaks

    peaks = device_peaks("cuda")
    unit, passes = UNIT[name]
    t_ops = 2.0 * macs * passes / peaks[unit]
    t_bytes = nbytes / peaks["hbm"]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def lo_biased(b):
    """``b`` with its f32-mode parts set to hi = bf16(b), mid = 1.5 *
    2^(e-9) and lo = 1.5 * 2^(e-18) for 2^e <= |hi| (exact in f32).  The
    positive lo products add up over the contraction instead of cancelling,
    so that a product without them (the split grade, hi + mid) stands well
    outside the f32 mode's limit."""
    import torch

    hi = b.to(torch.bfloat16).to(torch.float32)
    e = torch.floor(torch.log2(hi.abs()))
    return hi + 1.5 * torch.exp2(e - 9) + 1.5 * torch.exp2(e - 18)


def host_cpu() -> str:
    """The host CPU's model name, as ``lscpu`` reports it (the native
    codec's times are the host's)."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    names = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
             if ln.startswith("Model name")]
    return names[0] if names else "unknown"


def median_chi2_ratio(chi2, qtl) -> float:
    import numpy as np

    return float(np.median(chi2[qtl]) / np.median(chi2))


def more_traits(geno, bv, simulate_phenotypes):
    """Traits 2-4 beside ``simulate_phenotypes(geno, h2=0.5, n_qtl=N_QTL,
    seed=SEED)``'s (whose breeding values are ``bv``), and the animals
    whose trait 2 the multi-trait GBLUP treats as missing (10%).  Trait 2's
    genetic values come from the same QTL and correlate RG_TRUE with
    ``bv`` in the sample (a second effect vector, its part along ``bv``
    removed); traits 3 and 4 are independent; all have h2 = 0.5.
    Returns (bv2, y2, y3, y4, missing animals)."""
    import numpy as np

    qtl = np.random.default_rng(SEED).choice(geno.shape[1], size=N_QTL,
                                             replace=False)
    vrng = np.random.default_rng(SEED + 9)
    zq = np.where(geno[:, qtl] == 3, 0, geno[:, qtl]).astype(np.float64)
    other = (zq - zq.mean(0)) @ vrng.standard_normal(N_QTL)
    other -= bv * (other @ bv) / (bv @ bv)
    bv2 = RG_TRUE * bv + np.sqrt(1.0 - RG_TRUE ** 2) * other / other.std()
    y2 = bv2 + vrng.standard_normal(geno.shape[0])
    y3, _ = simulate_phenotypes(geno, h2=0.5, n_qtl=N_QTL, seed=SEED + 3)
    y4, _ = simulate_phenotypes(geno, h2=0.5, n_qtl=N_QTL, seed=SEED + 4)
    gone = np.random.default_rng(SEED + 10).choice(
        geno.shape[0], size=geno.shape[0] // 10, replace=False)
    return bv2, y2, y3, y4, gone


def pedigree_bv(sire, dam, var, rng):
    """Breeding values with variance ``var`` drawn down a pedigree: the
    parents' mean plus Mendelian sampling (var/2 with both parents known,
    3 var/4 with one, var for founders; inbreeding ignored)."""
    import numpy as np

    u = np.zeros(len(sire) + 1)
    for i in range(1, len(sire) + 1):
        s, d = sire[i - 1], dam[i - 1]
        known = int(s > 0) + int(d > 0)
        u[i] = (0.5 * (u[s] + u[d]) + np.sqrt(var * (1.0 - 0.25 * known))
                * rng.standard_normal())
    return u[1:]


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def device_busy(label, fn):
    """One call of ``fn`` under torch.profiler: its wall seconds (with the
    profiler's own cost), the union of its device events' intervals, the
    idle share and the device events by name (the top 4).  Returns (wall
    seconds, [(name, start us, end us)] of the device events)."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(a, b) for _, a, b in events]
    busy = _union_us(spans)     # union of the events' intervals, in us
    top = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                 key=lambda e: -e.device_time_total)[:4]
    log(f"profiled {label}: wall {wall:.4f} s, device busy "
        f"{busy / 1e6:.4f} s over {len(spans)} device events, idle share "
        f"{1 - busy / 1e6 / wall:.3f}; "
        + "; ".join(f"{e.key[:48]} {e.device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in top))
    return wall, events


def single_step(dev, sync_time, take_counts, oracle_rows, bed_path, bv):
    """Phase 7: the sparse solver and single-step GBLUP at the reference
    benchmark's sizes, then native inbreeding, the dense-oracle check and
    the ``run_ssgblup`` pipeline with single-step REML, each counted.
    Returns the "ssgblup" cell for phase 9: its panel written as a .bed
    beside ``bed_path``, its pedigree and records, and the warm resident
    solve's EBVs, outer iterations and seconds."""
    import numpy as np
    import torch

    from miraculix_tpu_torch import _kernels, from_dense, grm, pedigree
    from miraculix_tpu_torch import ssgblup as ssg
    from miraculix_tpu_torch.io import bed, native
    from miraculix_tpu_torch.solve.sparse import (SparseTriangularSolver,
                                                  simulate_pedigree_factor)

    # -- 7a. the sparse triangular solve (benchmark.py "sparse_solve") ------
    t_phase = time.perf_counter()
    n = SPARSE_N
    t0 = time.perf_counter()
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=9, bandwidth=n // 16,
                                       seed=0)
    log(f"phase pedigree factor simulated (host): "
        f"{time.perf_counter() - t0:.3f} s, nnz {len(v)}")
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    slv, secs = sync_time(lambda: SparseTriangularSolver(
        r, c, v, n, dtype=torch.float32))
    log(f"phase main sparse solve analysis: {secs:.3f} s (n {n}, nnz "
        f"{slv.nnz}, bs {slv.bs}, {slv.nb} blocks, device inversion); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB")
    b = np.random.default_rng(0).standard_normal((n, SPARSE_NCOL))
    bt = torch.as_tensor(b, dtype=torch.float32, device=dev)
    ln, lt = slv._host_csr("n"), slv._host_csr("t")

    def rel_residual(x):
        x = x.cpu().numpy().astype(np.float64) if torch.is_tensor(x) else x
        return float(np.linalg.norm(b - ln @ (lt @ x)) / np.linalg.norm(b))

    x0, secs = sync_time(lambda: slv.solve_lltx(bt))
    warm = [sync_time(lambda: slv.solve_lltx(bt))[1] for _ in range(3)]
    per = float(np.median(warm))
    x1, secs1 = sync_time(lambda: slv.solve_lltx(bt, refine=1))
    rel0, rel1 = rel_residual(x0), rel_residual(x1)
    log(f"phase main sparse solve_lltx ({SPARSE_NCOL} columns, f32): first "
        f"{secs:.3f} s, warm {', '.join(f'{t:.4f}' for t in warm)} s, "
        f"median {per:.4f} s = {2 * slv.nnz * SPARSE_NCOL / per:.4g} nnz/s;"
        f" refine=1 {secs1:.3f} s; rel residual refine=0 {rel0:.3g}, "
        f"refine=1 {rel1:.3g}")
    device_busy("sparse solve_lltx", lambda: slv.solve_lltx(bt))
    (x64, rel64), secs = sync_time(lambda: slv.solve_lltx_f64(b, tol=1e-12))
    check64 = rel_residual(x64)
    log(f"phase main sparse solve_lltx_f64(tol=1e-12): {secs:.3f} s, rel "
        f"residual {rel64:.3g} (recomputed {check64:.3g})")
    check(max(rel64, check64) <= 1e-12,
          "solve_lltx_f64 did not reach 1e-12")
    check(rel1 < rel0, "refine=1 did not lower the f32 residual")
    # T_i X_i - I on 64 diagonal blocks, beside the float64 inverse rounded
    # to float32 (the storage floor)
    pick = np.linspace(0, slv.nb - 1, 64).astype(np.int64)
    bs = slv.bs
    r0, c0 = r - 1, c - 1
    blk = r0 // bs
    on = (blk == c0 // bs) & np.isin(blk, pick)
    tb = np.zeros((slv.nb, bs, bs))
    np.add.at(tb, (blk[on], r0[on] % bs, c0[on] % bs), v[on])
    pad = np.arange(n, slv.npad)
    tb[pad // bs, pad % bs, pad % bs] = 1.0
    tb = torch.as_tensor(tb[pick], device=dev)
    xb = slv._dinv[torch.as_tensor(pick, device=dev)].double()
    eye = torch.eye(bs, dtype=torch.float64, device=dev)

    def tx_rel(x):
        num = torch.linalg.norm(tb @ x - eye, dim=(1, 2))
        return float((num / (torch.linalg.norm(tb, dim=(1, 2))
                             * torch.linalg.norm(x, dim=(1, 2)))).max())

    dev_rel = tx_rel(xb)
    floor_rel = tx_rel(torch.linalg.inv(tb).float().double())
    log(f"check sparse analysis on 64 diagonal blocks: max ||T X - I|| / "
        f"(||T|| ||X||) device {dev_rel:.3g}, float64 inverse rounded to "
        f"float32 {floor_rel:.3g} (limit {SPARSE_TX_RTOL:g})")
    check(dev_rel <= SPARSE_TX_RTOL, "the device analysis' inverted blocks "
          "are off the float32 storage floor")
    take_counts("sparse solve")
    slv.free()
    del slv, r, c, v, b, bt, x0, x1, x64, tb, xb, ln, lt
    torch.cuda.empty_cache()

    # -- 7b. single-step GBLUP (benchmark.py "ssgblup") --------------------
    n_anim, n_geno = SS_CELL
    t0 = time.perf_counter()
    sire, dam = pedigree.simulate_pedigree(n_anim, n_founders=n_anim // 100,
                                           seed=3)
    t_ped = time.perf_counter() - t0
    t0 = time.perf_counter()
    gsim = bed.simulate_genotypes(n_geno, N_SNPS, seed=11)
    t_sim = time.perf_counter() - t0
    gss, secs = sync_time(lambda: from_dense(gsim))
    ss_bed = bed_path[:-4] + ".ss.bed"       # phase 9 streams it
    t0 = time.perf_counter()
    bed.write_bed(ss_bed, gsim)
    t_bed = time.perf_counter() - t0
    del gsim
    log(f"phase single-step cell (host): simulate_pedigree({n_anim}) "
        f"{t_ped:.3f} s, simulate_genotypes({n_geno}, {N_SNPS}) "
        f"{t_sim:.3f} s, from_dense {secs:.3f} s, write_bed {t_bed:.3f} s")
    geno_ids = np.arange(n_anim - n_geno, n_anim) + 1
    obs_ids = np.arange(1, n_anim - n_geno + 1)
    y = 2.0 + np.random.default_rng(1).standard_normal(len(obs_ids))
    _kernels.reset_launch_counts()
    hinv, secs = sync_time(lambda: ssg.SingleStepHInv(
        sire, dam, gss, geno_ids, blend=0.05, f=np.zeros(n_anim)))
    log(f"phase main SingleStepHInv set-up: {secs:.3f} s (A^-1 nnz "
        f"{hinv.ainv.nnz})")

    def solve():
        return ssg.ssgblup(y, hinv, obs_ids=obs_ids, h2=0.4, tol=1e-5,
                           maxiter=SS_MAXITER)

    res, secs_first = sync_time(solve)
    before = collections.Counter(_kernels.TALL_WIDTHS)
    res, secs = sync_time(solve)
    widths = collections.Counter(_kernels.TALL_WIDTHS) - before
    log(f"phase main ssgblup: first {secs_first:.3f} s, warm {secs:.3f} s, "
        f"outer CG iterations {res.iterations}, residual "
        f"{res.residual_norm:.3g}; tall launches over the warm solve by "
        f"(mode, n): {dict(widths)}")
    device_busy("ssgblup", solve)
    take_counts("ssgblup")
    check(res.iterations < SS_MAXITER and bool(np.isfinite(res.u).all())
          and res.u.shape == (n_anim,),
          "ssgblup did not converge or gave non-finite values")
    cell = dict(bed=ss_bed, sire=sire, dam=dam, geno_ids=geno_ids,
                obs_ids=obs_ids, y=y, u=res.u, iterations=res.iterations,
                secs=secs)
    del hinv, gss, res
    torch.cuda.empty_cache()

    # -- 7c. native inbreeding against its oracle ---------------------------
    _kernels.reset_launch_counts()
    sire, dam = pedigree.simulate_pedigree(20_000, n_founders=200, seed=3)
    native.reset_call_counts()
    t0 = time.perf_counter()
    f = pedigree.inbreeding(sire, dam)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_py = pedigree._inbreeding_py(sire[:1000], dam[:1000])
    secs_py = time.perf_counter() - t0
    err = float(np.abs(f[:1000] - f_py).max())
    log(f"phase inbreeding (native, 20,000 animals): {secs:.3f} s, mean F "
        f"{f.mean():.4f}, max {f.max():.4f}; the Python oracle on the first "
        f"1,000: {secs_py:.3f} s, max_abs_err {err:.3g}; native calls "
        f"{native.CALLS['inbreeding']}")
    check(native.CALLS["inbreeding"] == 1, "inbreeding did not run natively")
    check(err <= 1e-12, "native inbreeding disagrees with its oracle")

    # -- 7d. the dense-oracle check -----------------------------------------
    n_anim, n_geno = SS_ORACLE
    t0 = time.perf_counter()
    orng = np.random.default_rng(SEED + 9)
    sire, dam = pedigree.simulate_pedigree(n_anim, n_founders=n_anim // 100,
                                           seed=4)
    geno_ids = np.sort(orng.choice(n_anim, size=n_geno, replace=False)) + 1
    gor = from_dense(oracle_rows)
    hinv = ssg.SingleStepHInv(sire, dam, gor, geno_ids, blend=0.05)
    t_set = time.perf_counter() - t0
    t0 = time.perf_counter()
    a = torch.as_tensor(pedigree.a_matrix(sire, dam), device=dev)
    t_a = time.perf_counter() - t0
    gi = torch.as_tensor(geno_ids - 1, device=dev)
    ainv = torch.linalg.inv(a)
    gw = 0.95 * grm(gor, scale=True).double() + 0.05 * torch.eye(
        n_geno, dtype=torch.float64, device=dev)
    blk = torch.linalg.inv(gw) - torch.linalg.inv(a[gi][:, gi])
    hd = ainv.clone()
    hd[gi[:, None], gi[None, :]] += blk
    del a, ainv, gw, blk
    vv = orng.standard_normal((n_anim, 4))
    want = hd @ torch.as_tensor(vv, device=dev)
    got = hinv.matvec(vv).double()
    rel_mv = float((got - want).abs().max() / want.abs().max())
    # records on 3/4 of the animals, intercept and a covariate
    n_obs = 3 * n_anim // 4
    obs_ids = np.sort(orng.choice(n_anim, size=n_obs, replace=False)) + 1
    xmat = np.column_stack([np.ones(n_obs), orng.standard_normal(n_obs)])
    u_true = pedigree_bv(sire, dam, 0.4, orng)
    y = xmat @ [1.0, 0.5] + u_true[obs_ids - 1] + 0.7 * orng.standard_normal(
        n_obs)
    res, secs = sync_time(lambda: ssg.ssgblup(
        y, hinv, obs_ids=obs_ids, x=xmat, h2=0.4, tol=SS_ORACLE_TOL,
        maxiter=5000))
    lam = 0.6 / 0.4
    ob = torch.as_tensor(obs_ids - 1, device=dev)
    xd = torch.as_tensor(xmat, device=dev)
    mme = torch.zeros((2 + n_anim, 2 + n_anim), dtype=torch.float64,
                      device=dev)
    mme[:2, :2] = xd.T @ xd
    xtw = torch.zeros((2, n_anim), dtype=torch.float64,
                      device=dev).index_add_(1, ob, xd.T)
    mme[:2, 2:], mme[2:, :2] = xtw, xtw.T
    mme[2:, 2:] = lam * hd
    mme[2 + ob, 2 + ob] += 1.0       # W'W: one record an animal
    yd = torch.as_tensor(y, device=dev)
    rhs = torch.cat([xd.T @ yd, torch.zeros(n_anim, dtype=torch.float64,
                                            device=dev).index_add_(0, ob, yd)])
    z = torch.linalg.solve(mme, rhs).cpu().numpy()
    err_b = float(np.abs(res.beta - z[:2]).max())
    rel_u = float(np.abs(res.u - z[2:]).max() / np.abs(z[2:]).max())
    log(f"check single-step dense oracle ({n_anim} animals, {n_geno} "
        f"genotyped x {N_SNPS} SNPs; set-up {t_set:.3f} s, tabular A "
        f"{t_a:.3f} s): hinv.matvec rel={rel_mv:.3g} (limit 2e-4); "
        f"ssgblup {secs:.3f} s, {res.iterations} outer iterations, beta "
        f"abs={err_b:.3g}, u rel={rel_u:.3g} (limit 5e-3); corr(u, u_true) "
        f"{np.corrcoef(res.u, u_true)[0, 1]:.4f}")
    check(rel_mv <= 2e-4, "hinv.matvec disagrees with the dense H^-1")
    check(err_b <= 5e-3 and rel_u <= 5e-3,
          "ssgblup disagrees with the dense MME solve")
    take_counts("inbreeding and the dense oracle")
    del hd, want, got, mme, hinv, gor
    torch.cuda.empty_cache()

    # -- 7e. run_ssgblup with single-step REML on the many_indiv fileset ----
    n_anim = SS_PIPELINE
    sire, dam = pedigree.simulate_pedigree(n_anim, n_founders=n_anim // 100,
                                           seed=SEED + 12)
    n_geno = len(bv)
    labels = [f"P{i}" for i in range(n_anim - n_geno)] + [
        f"I{i}" for i in range(n_geno)]          # the .fam's IIDs
    ped_path = bed_path[:-4] + ".ped.txt"
    with open(ped_path, "w") as fh:
        fh.writelines(f"{lab} {labels[s - 1] if s else 0} "
                      f"{labels[d - 1] if d else 0}\n"
                      for lab, s, d in zip(labels, sire, dam))
    out = bed_path[:-4] + ".ebv.tsv"
    printed = io.StringIO()
    det = {}
    reml = ssg.estimate_h2_reml_ss

    def recording(*args, **kw):   # the REML's details, which run_ssgblup
        h2, d = reml(*args, **kw)  # only prints in part
        det.update(d, h2=h2)
        return h2, d

    _kernels.reset_launch_counts()
    ssg.estimate_h2_reml_ss = recording
    try:
        with contextlib.redirect_stdout(printed):
            rc, secs = sync_time(lambda: ssg.run_ssgblup(
                bed_path, ped_path, out=out, estimate_h2=True,
                no_inbreeding=True))
    finally:
        ssg.estimate_h2_reml_ss = reml
    widths = dict(_kernels.TALL_WIDTHS)
    for ln in printed.getvalue().splitlines():
        log(f"  run_ssgblup: {ln}")
    with open(out) as fh:
        rows = [ln.split("\t") for ln in fh.read().splitlines()[1:]]
    ebv = {lab: float(e) for lab, e, _ in rows}
    u_g = np.array([ebv[f"I{i}"] for i in range(n_geno)])
    corr = float(np.corrcoef(u_g, bv)[0, 1])
    log(f"phase main run_ssgblup ({n_anim} animals, {n_geno} genotyped, "
        f"estimate_h2): {secs:.3f} s, h2 {det.get('h2', float('nan')):.4f} "
        f"(SE {det.get('se_h2', float('nan')):.4f}), AI steps "
        f"{det.get('iterations')}, MME CG iterations "
        f"{det.get('cg_iterations')}, converged {det.get('converged')}; "
        f"corr(u genotyped, BV) {corr:.4f}; tall launches by (mode, n): "
        f"{widths}")
    take_counts("run_ssgblup")
    check(rc == 0 and len(rows) == n_anim and all(
        np.isfinite(e) for e in ebv.values()),
          f"run_ssgblup: rc {rc}, {len(rows)} EBV rows of {n_anim}")
    check(det.get("converged") and abs(det["h2"] - 0.5) <= REML_TOL,
          f"single-step REML: h2 {det.get('h2')} not within {REML_TOL} of "
          f"0.5 or not converged")
    check(corr >= MIN_BV_CORR, f"run_ssgblup: corr(u, BV) {corr:.4f} < "
          f"{MIN_BV_CORR}")
    cell["run_ssgblup"] = (ped_path, float(min(max(det["h2"], 0.01), 0.99)),
                           out)
    log(f"phase 7 (sparse solve and single-step) total: "
        f"{time.perf_counter() - t_phase:.3f} s")
    return cell


def streamed_phase(dev, sync_time, take_counts, bed_path, y, yb, cov, qtl,
                   resident, secs_of, cell):
    """Phase 9: the out-of-core StreamedGeno on the many_indiv fileset in 4
    chunks, 2 cached and 2 copied to the card on every pass, each streamed
    call held to the resident panel's result and counted from zero: its
    kernel launches must equal its chunk products (chunks x passes x
    products a chunk) and, apart, its ``row_sq_stats`` launches its chunks'
    row statistics (one a chunk in each pass that computes them), no plain
    version may run, and its seconds, copies
    and copy rate are printed beside the resident call's seconds; then the
    "ssgblup" cell's panel streamed the same way, one solve against the
    resident one."""
    import numpy as np
    import torch

    from miraculix_tpu_torch import (StreamedGeno, _kernels, dgemm,
                                     from_bed, gblup, grm_diag, grm_matvec,
                                     gwas_linear, gwas_logistic, gwas_mixed,
                                     streamed)
    from miraculix_tpu_torch import ssgblup as ssg

    t_phase = time.perf_counter()

    def call(name, fn, ref_secs=None):
        streamed.reset_stream_counts()
        _kernels.reset_launch_counts()
        out, secs = sync_time(fn)
        st = dict(streamed.STREAM)
        copy_s = streamed.copy_seconds()
        counts = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        plain = dict(_kernels.PLAIN_CALLS)
        take_counts(f"streamed {name}")
        rate = st["h2d_bytes"] / copy_s / 1e9 if copy_s > 0 else float("nan")
        ref = "n/a" if ref_secs is None else f"{ref_secs:.3f} s"
        log(f"phase streamed {name}: {secs:.3f} s (resident {ref}); "
            f"{st['passes']} passes, {st['products']} chunk products, "
            f"{st['row_stats']} chunk row statistics, "
            f"launches {counts}; host to device {st['h2d_copies']} chunk "
            f"copies, {st['h2d_bytes'] / max(st['passes'], 1) / 1e6:.1f} MB "
            f"a pass, {st['h2d_bytes'] / 1e9:.3f} GB in {copy_s:.4f} s of "
            f"copies = {rate:.2f} GB/s")
        products = sum(v for k, v in counts.items() if k != "row_sq_stats")
        check(products == st["products"],
              f"streamed {name}: {products} product launches for "
              f"{st['products']} chunk products")
        rows = counts.get("row_sq_stats", 0)
        check(rows == st["row_stats"],
              f"streamed {name}: {rows} row_sq_stats launches for "
              f"{st['row_stats']} chunk row statistics")
        check(not plain, f"streamed {name}: plain versions ran: {plain}")
        return out, secs, st

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.abs(got - want).max() / np.abs(want).max())

    # -- 9a. the panel: 4 chunks, 2 of them cached --------------------------
    gm, rsecs = sync_time(lambda: from_bed(bed_path))     # the resident one
    sg, secs = sync_time(lambda: StreamedGeno.from_bed(
        bed_path, chunk_snps=STREAM_CHUNK))
    same = (np.array_equal(sg.freq, gm.freq.cpu().numpy())
            and np.array_equal(sg.pseudo_freq, gm.pseudo_freq.cpu().numpy()))
    pinned = all(t.is_pinned() for c in sg.chunks for t in (c.zq_n, c.zq_t))
    cached = sg.cache_to_device(sg.chunks[0].nbytes + sg.chunks[1].nbytes)
    log(f"phase streamed from_bed: {secs:.3f} s (resident {rsecs:.3f} s), "
        f"{sg.n_chunks} chunks of "
        f"{STREAM_CHUNK} SNPs, {sg.nbytes() / 1e6:.1f} MB of words, pinned "
        f"{pinned}, {cached} cached; freq and pseudo_freq bit-equal to the "
        f"resident from_bed: {same}")
    check(sg.n_chunks == 4 and pinned and same and cached == 2,
          "the streamed many_indiv panel: chunks, pinning, frequencies or "
          "the two cached chunks")

    # -- 9b. the products at the main paths' widths -------------------------
    prng = np.random.default_rng(SEED + 20)
    for trans, rows in (("n", N_SNPS), ("t", N_INDIV)):
        for ncol in (1, 32, 65):
            b = prng.standard_normal((rows, ncol)).astype(np.float32)
            want, rsecs = sync_time(lambda: dgemm(gm, b, trans=trans))
            got, _, _ = call(f"dgemm {trans} ncol={ncol}",
                             lambda: sg.dgemm(b, trans=trans), rsecs)
            want = want.cpu().numpy()
            r = rel(got, want)
            log(f"check streamed dgemm {trans} ncol={ncol} vs resident: "
                f"rel={r:.3g}, bit-equal {np.array_equal(got, want)}")
            check(r <= KERNEL_RTOL, f"streamed dgemm {trans} ncol={ncol}")
        b = prng.standard_normal((rows, 12))
        want, rsecs = sync_time(lambda: dgemm(gm, b, trans=trans,
                                              precision="f64"))
        got, _, _ = call(f"dgemm f64 {trans} ncol=12", lambda: sg.dgemm(
            b, trans=trans, precision="f64"), rsecs)
        r = rel(got, want)
        log(f"check streamed dgemm f64 {trans} ncol=12 vs resident: "
            f"rel={r:.3g}")
        check(got.dtype == np.float64 and r <= F64_RTOL,
              f"streamed dgemm f64 {trans}")
    x1 = torch.as_tensor(prng.standard_normal((N_INDIV, 1)),
                         dtype=torch.float32, device=dev)
    want, rsecs = sync_time(lambda: grm_matvec(gm, x1))
    got, secs, st = call("grm_matvec ncol=1", lambda: sg.grm_matvec(x1),
                         rsecs)
    r = rel(got.cpu(), want.cpu())
    log(f"check streamed grm_matvec vs resident: rel={r:.3g}")
    check(r <= KERNEL_RTOL, "streamed grm_matvec")
    reps = 10

    def passes():
        return [sg.grm_matvec(x1) for _ in range(reps)]

    streamed.reset_stream_counts()
    _, secs = sync_time(passes)
    copy_s = streamed.copy_seconds()
    _, rsecs = sync_time(lambda: [grm_matvec(gm, x1) for _ in range(reps)])
    wall, events = device_busy(f"streamed grm_matvec ncol=1 x{reps}", passes)
    copies = [(a, b) for n, a, b in events if "HtoD" in n]
    kernels = [(a, b) for n, a, b in events if "HtoD" not in n]
    t_copy, t_kern = _union_us(copies) / 1e6, _union_us(kernels) / 1e6
    t_over = t_copy + t_kern - _union_us(copies + kernels) / 1e6
    log(f"phase streamed grm_matvec pass: {1e3 * secs / reps:.3f} ms a pass "
        f"(resident {1e3 * rsecs / reps:.3f} ms; mean of {reps}), "
        f"{st['h2d_bytes'] / 1e6:.1f} MB copied a pass = "
        f"{st['h2d_bytes'] / (secs / reps) / 1e9:.2f} GB/s over the pass; "
        f"the copies' CUDA events {1e3 * copy_s / reps:.3f} ms a pass "
        f"({100 * copy_s / secs:.1f}% of it); under device_busy over "
        f"{reps} passes: copies {1e3 * t_copy:.3f} ms "
        f"({100 * t_copy / wall:.1f}% of {1e3 * wall:.3f} ms), kernels "
        f"{1e3 * t_kern:.3f} ms, "
        f"overlapped {1e3 * t_over:.3f} ms ({len(copies)} copy events of "
        f"{4 * reps} issued, {len(kernels)} other device events)")
    want, rsecs = sync_time(lambda: grm_diag(gm))
    got, _, _ = call("grm_diag", lambda: sg.grm_diag(), rsecs)
    r = rel(got, want.cpu())
    log(f"check streamed grm_diag vs resident: rel={r:.3g}")
    check(r <= 1e-6, "streamed grm_diag")

    # -- 9c. the models ----------------------------------------------------
    res, _, _ = call("gblup", lambda: gblup.gblup(sg, y, h2=0.5, n_pcs=10,
                                                  tol=1e-6),
                     secs_of["gblup"])
    r = rel(res.g_hat, resident["gblup"])
    log(f"  streamed gblup: cg_iterations={res.cg_iterations} converged="
        f"{res.converged}; g_hat vs resident rel={r:.3g}")
    check(res.converged and r <= 1e-3, "streamed gblup")
    (h2r, det), _, _ = call("estimate_h2_reml", lambda: gblup.estimate_h2_reml(
        sg, y), secs_of["estimate_h2_reml"])
    d = abs(h2r - resident["estimate_h2_reml"])
    log(f"  streamed estimate_h2_reml: h2={h2r:.4f} (resident "
        f"{resident['estimate_h2_reml']:.4f}, |diff| {d:.3g}), AI steps "
        f"{det['iterations']}, cg_iterations={det['cg_iterations']}, "
        f"converged={det['converged']}")
    check(det["converged"] and abs(h2r - 0.5) <= REML_TOL and d <= 1e-3,
          "streamed estimate_h2_reml")
    ys4 = resident["ys4"]
    (_, _, dmo), _, sto = call(
        "estimate_multi_reml t=4 (2 of 4 chunks cached)",
        lambda: gblup.estimate_multi_reml(sg, ys4),
        secs_of["estimate_multi_reml t=4"])
    sga = StreamedGeno.from_bed(bed_path, chunk_snps=STREAM_CHUNK)
    n_all = sga.cache_to_device()
    (_, _, dmc), _, stc = call(
        f"estimate_multi_reml t=4 ({n_all} of 4 chunks cached)",
        lambda: gblup.estimate_multi_reml(sga, ys4),
        secs_of["estimate_multi_reml t=4"])
    del sga
    d = float(np.abs(dmo["h2"] - dmc["h2"]).max())
    log(f"  streamed estimate_multi_reml t=4: h2 {np.round(dmo['h2'], 4)} "
        f"streaming, {np.round(dmc['h2'], 4)} cached (|diff| {d:.3g}; "
        f"resident {np.round(resident['estimate_multi_reml t=4'], 4)}); "
        f"AI steps {dmo['iterations']} / {dmc['iterations']}, "
        f"cg_iterations {dmo['cg_iterations']} / {dmc['cg_iterations']}")
    check(dmo["converged"] and dmc["converged"] and d <= 1e-3
          and n_all == 4 and sto["h2d_copies"] > 0
          and stc["h2d_copies"] == 0,
          "streamed estimate_multi_reml: the two regimes")

    # -- 9d. the scans -----------------------------------------------------
    mixed_r, rsecs = sync_time(lambda: gwas_mixed(
        gm, y, covariates=cov, n_gamma_snps=64, tol=STREAM_MIXED_TOL[0],
        maxiter=GWAS_MAXITER))
    resident["gwas_mixed"] = mixed_r
    secs_of["gwas_mixed tight"] = rsecs
    for name, fn, ref_name, stats in (
            ("gwas_linear", lambda: gwas_linear(sg, y, covariates=cov),
             "gwas_linear", ("beta", "se", "t")),
            ("gwas_logistic", lambda: gwas_logistic(sg, yb, covariates=cov),
             "gwas_logistic", ("beta", "se", "t")),
            ("gwas_mixed", lambda: gwas_mixed(
                sg, y, covariates=cov, n_gamma_snps=64,
                tol=STREAM_MIXED_TOL[1], maxiter=GWAS_MAXITER),
             "gwas_mixed tight", ("beta", "chi2"))):
        r, _, _ = call(name, fn, secs_of[ref_name])
        want = resident[name]
        rels = {k: rel(getattr(r, k), getattr(want, k)) for k in stats}
        chi2 = r.chi2 if hasattr(r, "chi2") else r.t ** 2
        ratio = median_chi2_ratio(chi2, qtl)
        log(f"check streamed {name} vs resident: "
            + " ".join(f"{k} rel={v:.3g}" for k, v in rels.items())
            + f"; QTL enrichment {ratio:.4g}"
            + (f"; gamma {r.gamma:.6g} cg_iterations {r.cg_iterations}"
               if hasattr(r, "gamma") else ""))
        check(all(v <= 1e-4 for v in rels.values()) and ratio >= QTL_ENRICH
              and all(np.isfinite(getattr(r, k)).all() for k in stats),
              f"streamed {name}")

    # -- 9e. run_gblup on the fileset, streamed ----------------------------
    # run_gblup's own cache_to_device() holds all 4 chunks at its default
    # budget: this check covers the all-cached regime, the overflow one's
    # model steps are the calls on `sg` above
    effects = bed_path[:-4] + ".streamed.effects"
    printed = io.StringIO()

    def run_pipeline():
        with contextlib.redirect_stdout(printed):
            return gblup.run_gblup(bed_path, estimate_h2=True,
                                   h2_method="reml", effects_out=effects,
                                   stream_chunk=STREAM_CHUNK)

    rc, _, _ = call("run_gblup stream_chunk", run_pipeline,
                    secs_of["run_gblup"])
    lines = printed.getvalue().splitlines()
    for ln in lines:
        if not ln.lstrip().startswith(("cg iter", "ingested")):
            log(f"  run_gblup stream_chunk: {ln}")
    r = rel(np.loadtxt(effects, skiprows=1, usecols=2), resident["run_gblup"])
    log(f"check streamed run_gblup (all chunks cached at the default "
        f"budget) marker effects vs resident: rel={r:.3g}")
    check(rc == 0 and any(ln.startswith("streamed panel") for ln in lines)
          and r <= 1e-3, "streamed run_gblup")
    del sg, gm
    torch.cuda.empty_cache()

    # -- 9f. the "ssgblup" cell's panel, streamed ---------------------------
    n_anim = len(cell["sire"])
    sgs, secs = sync_time(lambda: StreamedGeno.from_bed(
        cell["bed"], chunk_snps=STREAM_CHUNK))
    cached = sgs.cache_to_device(sgs.chunks[0].nbytes + sgs.chunks[1].nbytes)
    log(f"phase streamed ssgblup panel from_bed: {secs:.3f} s, "
        f"{sgs.n_chunks} chunks, {sgs.nbytes() / 1e6:.1f} MB of words, "
        f"{cached} cached")
    check(sgs.n_chunks == 4 and cached == 2, "the streamed ssgblup panel")
    hinv, _, _ = call("SingleStepHInv set-up", lambda: ssg.SingleStepHInv(
        cell["sire"], cell["dam"], sgs, cell["geno_ids"], blend=0.05,
        f=np.zeros(n_anim)))
    res, _, _ = call("ssgblup", lambda: ssg.ssgblup(
        cell["y"], hinv, obs_ids=cell["obs_ids"], h2=0.4, tol=1e-5,
        maxiter=SS_MAXITER), cell["secs"])
    r = rel(res.u, cell["u"])
    log(f"check streamed ssgblup vs resident: u rel={r:.3g}, outer CG "
        f"iterations {res.iterations} (resident {cell['iterations']})")
    check(res.u.shape == (n_anim,) and r <= 1e-3
          and abs(res.iterations - cell["iterations"]) <= 2,
          "streamed ssgblup")
    del hinv, sgs
    torch.cuda.empty_cache()
    log(f"phase 9 (streamed) total: {time.perf_counter() - t_phase:.3f} s")


def sharded_phase(dev, sync_time, take_counts, bed_path, y, yb, cov, chrom,
                  resident, secs_of, cell):
    """Phase 10: the parallel layer on one card, in a world-1 process group
    (NCCL on the card) made through a FileStore beside the fileset: a 1D
    mesh of 4 SNP shards and a 2 x 2 mesh, both on the one device, at
    full width (many_indiv: 4 shards of 16,384 SNPs; the "ssgblup" cell
    sharded 4 ways).  Each call is counted from zero (its kernel launches,
    no plain version, its collectives' calls and bytes), timed beside the
    resident call and held to it; the group is destroyed before the phase
    ends."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from miraculix_tpu_torch import (_kernels, dgemm, from_bed, gblup, grm,
                                     grm_cg_solve, grm_matvec, gwas_linear,
                                     gwas_logistic, gwas_mixed,
                                     gwas_mixed_loco, packed_crossprod,
                                     parallel)
    from miraculix_tpu_torch import ssgblup as ssg
    from miraculix_tpu_torch.io import bed
    from miraculix_tpu_torch.parallel import sharded, sharded2d

    t_phase = time.perf_counter()
    store = os.path.join(os.path.dirname(bed_path), "sharded.store")
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    parallel.init_distributed(num_processes=1, process_id=0,
                              backend=backend, init_method=f"file://{store}",
                              device_id=dev if backend == "nccl" else None)
    log(f"phase sharded: init_distributed({backend}) world "
        f"{dist.get_world_size()}, rank {dist.get_rank()}")

    def call(name, fn, ref_secs=None):
        _kernels.reset_launch_counts()
        parallel.reset_collective_counts()
        out, secs = sync_time(fn)
        counts = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        plain = dict(_kernels.PLAIN_CALLS)
        colls = {k: (v["calls"], v["bytes"])
                 for k, v in parallel.COLLECTIVES.items()}
        take_counts(f"sharded {name}")
        ref = "n/a" if ref_secs is None else f"{ref_secs:.3f} s"
        log(f"phase sharded {name}: {secs:.3f} s (resident {ref}); "
            f"launches {counts}; collectives (calls, bytes) {colls}")
        check(not plain, f"sharded {name}: plain versions ran: {plain}")
        return out, secs

    def rel(got, want):
        got = torch.as_tensor(got).double().cpu()
        want = torch.as_tensor(want).double().cpu()
        return float((got - want).abs().max() / want.abs().max())

    try:
        mesh = parallel.make_mesh(devices=[dev] * 4)
        mesh2 = parallel.make_mesh_2d(devices=[dev] * 4)
        check(mesh.shape == {"k": 4} and mesh2.shape == {"i": 2, "k": 2},
              "sharded meshes")

        # -- 10a. ingestion: each shard's SNP range read alone -------------
        gm, rsecs = sync_time(lambda: from_bed(bed_path, device=dev))
        reads = []
        orig = bed.read_bed_slice_payload

        def instrumented(path, s0, s1):
            reads.append((s0, s1))
            return orig(path, s0, s1)

        bed.read_bed_slice_payload = instrumented
        try:
            sg, _ = call("shard_genotypes_from_bed", lambda: (
                parallel.shard_genotypes_from_bed(bed_path, mesh)), rsecs)
        finally:
            bed.read_bed_slice_payload = orig
        spd = sg.spd
        t0 = time.perf_counter()
        dense, _ = bed.read_bed_genotypes(bed_path)
        sd = parallel.shard_genotypes(dense, mesh)
        t_dense = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(
            sg.zq_n + sg.zq_t + sg.freq, sd.zq_n + sd.zq_t + sd.freq))
        fsame = np.array_equal(sg.global_freq()[: N_SNPS],
                               gm.freq.cpu().numpy())
        log(f"check sharded ingestion: {len(reads)} reads {reads} (spd "
            f"{spd}); words bit-equal to shard_genotypes of the dense panel "
            f"({t_dense:.3f} s to read and pack it): {same}; freq bit-equal "
            f"to the resident from_bed: {fsame}")
        check(reads == [(j * spd, (j + 1) * spd) for j in range(4)]
              and same and fsame, "sharded ingestion")
        del dense, sd

        # -- 10b. the products ---------------------------------------------
        prng = np.random.default_rng(SEED + 30)
        for trans, rows in (("n", N_SNPS), ("t", N_INDIV)):
            for ncol in (1, 32, 65):
                b = torch.as_tensor(prng.standard_normal((rows, ncol)),
                                    dtype=torch.float32, device=dev)
                want, rsecs = sync_time(lambda: dgemm(gm, b, trans=trans))
                out, _ = call(f"sharded_dgemm {trans} ncol={ncol}",
                              lambda: parallel.sharded_dgemm(sg, b, trans),
                              rsecs)
                got = out if trans == "n" else torch.cat(out.blocks)[
                    : N_SNPS]
                r = rel(got, want)
                log(f"check sharded_dgemm {trans} ncol={ncol} vs resident: "
                    f"rel={r:.3g}")
                check(r <= KERNEL_RTOL, f"sharded_dgemm {trans} {ncol}")

        # -- 10c. the GRM: raw exactly, finished to 1e-5 ---------------------
        raw_r, rsecs = sync_time(lambda: packed_crossprod(gm.zq_n))
        raw, _ = call("sharded raw crossproduct",
                      lambda: sharded.sharded_crossprod(sg), rsecs)
        check(torch.equal(raw, raw_r), "sharded raw crossproduct")
        raws, _ = call("sharded raw crossproduct scatter=True",
                       lambda: sharded.sharded_crossprod(sg, scatter=True))
        check(torch.equal(torch.cat(raws.blocks), raw_r),
              "sharded raw crossproduct, scattered")
        del raw, raws
        g_r, rsecs = sync_time(lambda: grm(gm))
        g_s, _ = call("sharded_grm", lambda: parallel.sharded_grm(sg), rsecs)
        r1 = rel(g_s, g_r)
        del g_s
        g_sc, _ = call("sharded_grm scatter=True",
                       lambda: parallel.sharded_grm(sg, scatter=True))
        r2 = rel(torch.cat(g_sc.blocks)[:N_INDIV, :N_INDIV], g_r)
        log(f"check sharded_grm vs resident grm(): rel={r1:.3g}, scatter "
            f"rel={r2:.3g}; raw crossproducts exactly equal")
        check(r1 <= KERNEL_RTOL and r2 <= KERNEL_RTOL, "sharded_grm")
        del g_sc, g_r
        torch.cuda.empty_cache()

        # -- 10d. CG, GBLUP, REML ------------------------------------------
        rhs = torch.as_tensor(prng.standard_normal(N_INDIV),
                              dtype=torch.float32, device=dev)
        lam = 0.5 * float(gm.sigma2)
        w, rsecs = sync_time(lambda: grm_cg_solve(
            gm, rhs, lam=lam, tol=1e-3, precondition=True))
        r, _ = call("sharded_cg_solve precondition=True",
                    lambda: parallel.sharded_cg_solve(
                        sg, rhs, lam=lam, tol=1e-3, precondition=True),
                    rsecs)
        d = rel(r.x, w.x)
        log(f"check sharded_cg_solve vs resident: x rel={d:.3g}, iterations "
            f"{r.iterations} (resident {w.iterations})")
        check(d <= 1e-4 and abs(r.iterations - w.iterations) <= 2,
              "sharded_cg_solve")
        x1 = rhs[:, None]
        reps = 10
        _, rsecs = sync_time(lambda: [grm_matvec(gm, x1)
                                      for _ in range(reps)])
        _, secs = sync_time(lambda: [parallel.sharded_grm_matvec(sg, x1)
                                     for _ in range(reps)])
        log(f"phase sharded grm_matvec ncol=1: {1e3 * secs / reps:.3f} ms "
            f"(resident {1e3 * rsecs / reps:.3f} ms; mean of {reps})")
        device_busy("sharded grm_matvec ncol=1",
                    lambda: parallel.sharded_grm_matvec(sg, x1))
        device_busy("resident grm_matvec ncol=1", lambda: grm_matvec(gm, x1))
        res, _ = call("gblup", lambda: gblup.gblup(sg, y, h2=0.5, n_pcs=10),
                      secs_of["gblup"])
        d = rel(res.g_hat, resident["gblup"])
        log(f"  sharded gblup: cg_iterations={res.cg_iterations} (resident "
            f"{resident['gblup iterations']}), converged={res.converged}; "
            f"g_hat vs resident rel={d:.3g}")
        check(res.converged and d <= 1e-3 and abs(
            res.cg_iterations - resident["gblup iterations"]) <= 2,
              "sharded gblup")
        (h2r, det), _ = call("estimate_h2_reml", lambda: (
            gblup.estimate_h2_reml(sg, y)), secs_of["estimate_h2_reml"])
        d = abs(h2r - resident["estimate_h2_reml"])
        log(f"  sharded estimate_h2_reml: h2={h2r:.4f} (resident "
            f"{resident['estimate_h2_reml']:.4f}, |diff| {d:.3g}), AI steps "
            f"{det['iterations']}, cg_iterations={det['cg_iterations']}")
        check(det["converged"] and d <= 1e-3, "sharded estimate_h2_reml")

        # -- 10e. the scans ----------------------------------------------------
        loco_r, secs_of["gwas_mixed_loco tight"] = sync_time(
            lambda: gwas_mixed_loco(gm, y, chrom, covariates=cov,
                                    n_gamma_snps=32, tol=STREAM_MIXED_TOL[0],
                                    maxiter=GWAS_MAXITER))
        resident["gwas_mixed_loco"] = loco_r
        for name, fn, ref_name, stats in (
                ("gwas_linear", lambda: gwas_linear(sg, y, covariates=cov),
                 "gwas_linear", ("beta", "se", "t")),
                ("gwas_logistic", lambda: gwas_logistic(sg, yb,
                                                        covariates=cov),
                 "gwas_logistic", ("beta", "se", "t")),
                ("gwas_mixed", lambda: gwas_mixed(
                    sg, y, covariates=cov, n_gamma_snps=64,
                    tol=STREAM_MIXED_TOL[0], maxiter=GWAS_MAXITER),
                 "gwas_mixed tight", ("beta", "chi2")),
                ("gwas_mixed_loco", lambda: gwas_mixed_loco(
                    sg, y, chrom, covariates=cov, n_gamma_snps=32,
                    tol=STREAM_MIXED_TOL[0], maxiter=GWAS_MAXITER),
                 "gwas_mixed_loco tight", ("beta", "chi2"))):
            out, _ = call(name, fn, secs_of[ref_name])
            want = resident[name]
            rels = {k: rel(getattr(out, k), getattr(want, k)) for k in stats}
            log(f"check sharded {name} vs resident: "
                + " ".join(f"{k} rel={v:.3g}" for k, v in rels.items())
                + (f"; gamma {out.gamma:.6g} (resident {want.gamma:.6g}) "
                   f"cg_iterations {out.cg_iterations} (resident "
                   f"{want.cg_iterations})" if hasattr(out, "gamma") else ""))
            check(all(v <= 1e-4 for v in rels.values())
                  and all(np.isfinite(getattr(out, k)).all() for k in stats),
                  f"sharded {name}")

        # -- 10f. the 2D layer -------------------------------------------------
        s2, _ = call("shard_genotypes_2d_from_bed", lambda: (
            parallel.shard_genotypes_2d_from_bed(bed_path, mesh2)))
        for trans, rows in (("n", N_SNPS), ("t", N_INDIV)):
            b = torch.as_tensor(prng.standard_normal((rows, 32)),
                                dtype=torch.float32, device=dev)
            want, rsecs = sync_time(lambda: dgemm(gm, b, trans=trans))
            pad = (parallel.pad_snp_vec if trans == "n"
                   else parallel.pad_indiv_vec)(s2, b)
            out, _ = call(f"sharded_dgemm_2d {trans} ncol=32",
                          lambda: parallel.sharded_dgemm_2d(s2, pad, trans),
                          rsecs)
            d = rel(sharded2d.gather_rows(out)[: want.shape[0]], want)
            log(f"check sharded_dgemm_2d {trans} vs resident: rel={d:.3g}")
            check(d <= KERNEL_RTOL, f"sharded_dgemm_2d {trans}")
        raw2, _ = call("sharded raw crossproduct 2d",
                       lambda: sharded2d.sharded_crossprod_2d(s2))
        check(torch.equal(sharded2d.gather_rows(raw2)[:N_INDIV, :N_INDIV],
                          raw_r[:N_INDIV, :N_INDIV]), "2D raw crossproduct")
        del raw2, raw_r
        r2d, _ = call("sharded_cg_solve_2d precondition=True",
                      lambda: parallel.sharded_cg_solve_2d(
                          s2, rhs, lam=lam, tol=1e-3, precondition=True))
        d = rel(sharded2d.gather_rows(r2d.x)[:N_INDIV], r.x)
        log(f"check sharded_cg_solve_2d vs the 1D solve: x rel={d:.3g}, "
            f"iterations {r2d.iterations} (1D {r.iterations})")
        check(d <= 1e-4 and abs(r2d.iterations - r.iterations) <= 1,
              "sharded_cg_solve_2d")
        ys4 = resident["ys4"]
        (_, _, dm), _ = call("estimate_multi_reml t=4 (2D)", lambda: (
            gblup.estimate_multi_reml(s2, ys4)),
            secs_of["estimate_multi_reml t=4"])
        d = float(np.abs(dm["h2"]
                         - resident["estimate_multi_reml t=4"]).max())
        log(f"  sharded estimate_multi_reml t=4 (2D): h2 "
            f"{np.round(dm['h2'], 4)} (|diff| {d:.3g} from the resident "
            f"one), AI steps {dm['iterations']}, cg_iterations "
            f"{dm['cg_iterations']}")
        check(dm["converged"] and d <= 1e-4, "sharded estimate_multi_reml")
        del s2

        # -- 10g. the checkpoint ---------------------------------------------
        ckpt = os.path.join(os.path.dirname(bed_path), "sharded.npz")
        b = torch.as_tensor(prng.standard_normal((N_SNPS, 32)),
                            dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        parallel.save_sharded(ckpt, sg)
        t_save = time.perf_counter() - t0
        sg_re, t_load = sync_time(lambda: parallel.load_sharded(ckpt, mesh))
        same = torch.equal(parallel.sharded_dgemm(sg_re, b),
                           parallel.sharded_dgemm(sg, b))
        log(f"check save_sharded / load_sharded: save {t_save:.3f} s, load "
            f"{t_load:.3f} s, {os.path.getsize(ckpt) / 1e6:.1f} MB; "
            f"products equal: {same}")
        check(same, "the reloaded sharded panel")
        os.remove(ckpt)
        del sg_re, sg, gm
        torch.cuda.empty_cache()

        # -- 10h. the "ssgblup" cell sharded 4 ways ----------------------------
        n_anim = len(cell["sire"])
        sgs, _ = call("ssgblup cell shard_genotypes_from_bed", lambda: (
            parallel.shard_genotypes_from_bed(cell["bed"], mesh)))
        hinv, _ = call("SingleStepHInv set-up", lambda: ssg.SingleStepHInv(
            cell["sire"], cell["dam"], sgs, cell["geno_ids"], blend=0.05,
            f=np.zeros(n_anim)))
        res, _ = call("ssgblup", lambda: ssg.ssgblup(
            cell["y"], hinv, obs_ids=cell["obs_ids"], h2=0.4, tol=1e-5,
            maxiter=SS_MAXITER), cell["secs"])
        d = rel(res.u, cell["u"])
        log(f"check sharded ssgblup vs resident: u rel={d:.3g}, outer CG "
            f"iterations {res.iterations} (resident {cell['iterations']})")
        check(hinv._kind == "sharded" and res.u.shape == (n_anim,)
              and d <= 1e-3 and abs(res.iterations - cell["iterations"]) <= 1,
              "sharded ssgblup")
        del hinv, sgs
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase 10")
    log(f"phase 10 (sharded) total: {time.perf_counter() - t_phase:.3f} s")


def mobps_population(rng, n_founders: int, n_animals: int):
    """A MoBPS population over the many_indiv SNPs: ``n_founders`` sires and
    as many dams with materialized haplotypes (allele frequencies uniform
    in [0.05, 0.5]), and ``n_animals`` offspring (generation 2) whose
    haplotypes are recombination recipes: a sire's two haplotypes for the
    first, a dam's for the second, one breakpoint each, two mutations a
    haplotype.  Returns the population and the offspring's (generation,
    sex, nr) selection."""
    import numpy as np

    from miraculix_tpu_torch import mobps

    p = rng.uniform(0.05, 0.5, N_SNPS)
    ind = {}
    for sex in (1, 2):
        for nr in range(1, n_founders + 1):
            ind[(1, sex, nr)] = mobps.Individual(
                haplo=(rng.random((2, N_SNPS)) < p).astype(np.uint8))
    for nr in range(1, n_animals + 1):
        parents = rng.integers(1, n_founders + 1, 2)
        cuts = rng.integers(1, N_SNPS, 2).astype(np.float64)
        ind[(2, 1 + nr % 2, nr)] = mobps.Individual(
            recombi=tuple([0.0, c, float(N_SNPS)] for c in cuts),
            origins=tuple(mobps.code_origins(np.array(
                [[1, sex, parents[sex - 1], 1], [1, sex, parents[sex - 1],
                                                 2]])) for sex in (1, 2)),
            mutations=tuple(rng.integers(0, N_SNPS, 2) for _ in range(2)))
    sel = ([2] * n_animals, [1 + nr % 2 for nr in range(1, n_animals + 1)],
           list(range(1, n_animals + 1)))
    return mobps.Population(snps=N_SNPS, individuals=ind), sel


def facades_phase(dev, sync_time, take_counts, bed_path):
    """Phase 11: the user surface at full width on the many_indiv fileset.
    The C API in the flow of the reference's tests/dgemm_compressed/test.jl
    (``set_options`` -> ``read_bed`` -> ``plink_transpose_packed`` ->
    ``plink2compressed`` -> ``dgemm_compressed`` 'N'/'T' at 10 columns,
    ``get_compressed_freq``, a cache hit, ``dgemm_plink`` uncentered and
    centered, ``sparse_times_plink`` at 32 and 1,000 rows and over the
    SNPs, ``free_compressed`` and its memory); the R API on a TWO_BIT
    ``CodedMatrix`` of the panel; MoBPS's ``compute_relationship`` on 1,024
    reconstructed animals; QC, ``rel_cutoff`` and the GCTA GRM files (host
    work, timed); the banner and a ``device_trace``.  Each device call is
    counted from zero and printed with its launches; no plain version may
    run.  Products are held to float64 products on the card of the panel
    decoded on the host from the .bed bytes (1e-5 of max |want|)."""
    import numpy as np
    import scipy.sparse
    import torch

    from miraculix_tpu_torch import (_kernels, api, from_bed, from_dense, grm,
                                     mobps, qc, rapi, snp_crossprod)
    from miraculix_tpu_torch.formats import Coding, CodedMatrix, encode
    from miraculix_tpu_torch.io import bed, codec, grm_io, native
    from miraculix_tpu_torch.utils import logging as mlog
    from miraculix_tpu_torch.utils import panel_cache

    t_phase = time.perf_counter()
    with contextlib.redirect_stderr(sys.stdout):   # the banner line
        mlog.print_compile_info()
    panel_cache.clear()

    def call(name, fn):
        _kernels.reset_launch_counts()
        out, secs = sync_time(fn)
        plain = dict(_kernels.PLAIN_CALLS)
        take_counts(f"facades {name}")
        log(f"phase facades {name}: {secs:.3f} s")
        check(not plain, f"facades {name}: plain versions ran: {plain}")
        return out, secs

    def host(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
        log(f"phase facades {name} (host): {secs:.3f} s")
        return out, secs

    def rel(got, want):
        got = got.cpu() if isinstance(got, torch.Tensor) else \
            torch.as_tensor(np.asarray(got))
        got, want = got.double(), torch.as_tensor(want).double().cpu()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"shape {tuple(got.shape)} against {tuple(want.shape)}")
        return float((got - want).abs().max() / want.abs().max())

    def held(name, got, want, tol=1e-5):
        r = rel(got, want)
        log(f"check facades {name}: rel={r:.3g} (limit {tol:g})")
        check(r <= tol, f"facades {name}: rel {r:.3g} > {tol:g}")

    # -- 11a. the C API (tests/dgemm_compressed/test.jl) ---------------------
    api.set_options(use_gpu=True, print_details=0)
    (plink, n_snps, n_indiv), _ = host("read_bed", lambda: bed.read_bed(
        bed_path))
    plink_t, _ = host("plink_transpose_packed", lambda: (
        codec.plink_transpose_packed(plink, n_indiv, n_snps)))
    dense, _ = host("plink_to_dense (the references' panel)",
                    lambda: codec.plink_to_dense(plink, n_indiv))
    freq = codec.allele_freq(dense)
    check((n_snps, n_indiv) == (N_SNPS, N_INDIV), "the fileset's shape")

    blk = 2048

    def f64_blocks():
        """Row blocks of the host-decoded panel, float64 on the card."""
        for r0 in range(0, N_INDIV, blk):
            yield r0, torch.as_tensor(dense[r0:r0 + blk], device=dev).double()

    def zt_times(x):
        """Z^T x in float64 on the card, x [indiv, n]."""
        x = torch.as_tensor(x, device=dev).double()
        return sum(zb.T @ x[r0:r0 + blk] for r0, zb in f64_blocks())

    def z_times(x):
        """Z x in float64 on the card, x [snps, n]."""
        x = torch.as_tensor(x, device=dev).double()
        return torch.cat([zb @ x for _, zb in f64_blocks()])

    rng = np.random.default_rng(SEED + 11)
    b = rng.standard_normal((N_SNPS, 10))
    bt = rng.standard_normal((N_INDIV, 10))
    f2 = torch.as_tensor(2.0 * freq, device=dev)
    want_n = z_times(b) - (f2 @ torch.as_tensor(b, device=dev))[None, :]
    want_t = zt_times(bt) - f2[:, None] * torch.as_tensor(
        bt, device=dev).sum(0)[None, :]

    native.reset_call_counts()
    obj, secs_pack = call("plink2compressed", lambda: api.plink2compressed(
        plink, plink_t, n_snps, n_indiv, freq, 10))
    check(obj.device.type == "cuda" and panel_cache.misses == 1,
          "plink2compressed did not build a panel on the card")
    packed = obj.nbytes
    c, _ = call("dgemm_compressed N ncol=10",
                lambda: api.dgemm_compressed("N", obj, 10, b))
    held("dgemm_compressed N ncol=10 vs float64", c, want_n)
    c_t, _ = call("dgemm_compressed T ncol=10",
                  lambda: api.dgemm_compressed("T", obj, 10, bt))
    held("dgemm_compressed T ncol=10 vs float64", c_t, want_t)
    gm, _ = call("from_bed", lambda: from_bed(bed_path, device=dev))
    f_out = api.get_compressed_freq(obj)
    same = np.array_equal(f_out.astype(np.float32), gm.freq.cpu().numpy()) \
        and np.array_equal(f_out, freq.astype(np.float32).astype(np.float64))
    log(f"check facades get_compressed_freq bit-equal to from_bed's freq: "
        f"{same}")
    check(same, "get_compressed_freq differs from from_bed's freq")
    packs = native.CALLS["pack_planar16"]
    hits = panel_cache.hits
    again, secs_hit = call("plink2compressed again (cache hit)",
                           lambda: api.plink2compressed(
                               plink, plink_t, n_snps, n_indiv, freq, 10))
    log(f"  the digest of {plink.nbytes / 1e6:.1f} MB: {secs_hit:.3f} s "
        f"against {secs_pack:.3f} s for the pack")
    check(again is obj and panel_cache.hits == hits + 1
          and native.CALLS["pack_planar16"] == packs,
          "the second plink2compressed was not a cache hit")
    del again

    cu, _ = call("dgemm_plink N ncol=10 f=None (K1)", lambda: api.dgemm_plink(
        "N", plink, None, n_snps, n_indiv, None, 10, b))
    cc, _ = call("dgemm_plink N ncol=10 f=freq (K2)", lambda: (
        api.dgemm_plink("N", plink, None, n_snps, n_indiv, freq, 10, b)))
    api.set_options(use_gpu=True, do_not_center=1)
    cu_ref = api.dgemm_compressed("N", obj, 10, b)
    api.set_options(use_gpu=True)
    held("dgemm_plink f=None vs dgemm_compressed uncentered", cu, cu_ref)
    held("dgemm_plink f=freq vs dgemm_compressed", cc, c)
    held("dgemm_plink f=None vs float64", cu, want_n + (
        f2 @ torch.as_tensor(b, device=dev))[None, :])
    del want_n, want_t, cu_ref

    def csr(rows, cols, density):
        s = scipy.sparse.random(rows, cols, density=density, format="csr",
                                random_state=rng, data_rvs=rng.standard_normal)
        return s, s.indptr + 1, s.indices + 1, s.data

    for rows, tg in ((32, "N"), (1000, "N"), (32, "T")):
        contract = N_INDIV if tg == "N" else N_SNPS
        s, ia, ja, a = csr(rows, contract, 0.01)
        got, _ = call(f"sparse_times_plink N {tg} n_idx={rows} nnz={s.nnz}",
                      lambda: api.sparse_times_plink(
                          "N", tg, plink, None, n_snps, n_indiv, rows, ia,
                          ja, a))
        sd = torch.as_tensor(s.toarray(), device=dev)
        if tg == "N":
            want = sum(sd[:, r0:r0 + blk] @ zb for r0, zb in f64_blocks())
        else:
            want = torch.cat([sd @ zb.T for _, zb in f64_blocks()], dim=1)
        held(f"sparse_times_plink N {tg} n_idx={rows} vs float64 S @ Z",
             got, want)
        del sd, want

    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    _, secs = sync_time(lambda: api.free_compressed(obj))
    m1 = torch.cuda.memory_allocated(dev)
    log(f"phase facades free_compressed: {secs:.3f} s, memory_allocated "
        f"{m0 / 1e6:.1f} -> {m1 / 1e6:.1f} MB (the packings: "
        f"{packed / 1e6:.1f} MB)")
    check(m0 - m1 >= packed and obj.zq_n is None,
          "free_compressed did not release the panel's device memory")
    misses = panel_cache.misses
    obj2, _ = call("plink2compressed after free_compressed (a miss)",
                   lambda: api.plink2compressed(plink, plink_t, n_snps,
                                                n_indiv, freq, 10))
    check(panel_cache.misses == misses + 1 and obj2.zq_n is not None,
          "plink2compressed after free_compressed was not a miss")
    trace = os.path.join(os.path.dirname(bed_path), "trace")
    with mlog.device_trace(trace):
        call("dgemm_compressed N ncol=10 under device_trace",
             lambda: api.dgemm_compressed("N", obj2, 10, b))
    files = os.listdir(trace)
    log(f"check facades device_trace: {files}")
    check(len(files) == 1 and os.path.getsize(
        os.path.join(trace, files[0])) > 0, "device_trace wrote no trace")
    api.free_compressed(obj2)
    panel_cache.clear()
    api.set_options()
    del obj, obj2, plink_t
    torch.cuda.empty_cache()

    # -- 11b. the R API on a TWO_BIT CodedMatrix of the panel ---------------
    buf, _ = host("encode TWO_BIT", lambda: encode(dense, Coding.TWO_BIT))
    m = CodedMatrix(buf, Coding.TWO_BIT, N_SNPS, N_INDIV)
    _, _ = host("CodedMatrix.dense()", m.dense)
    v1, w1 = rng.standard_normal(N_SNPS), rng.standard_normal(N_INDIV)
    gv, _ = call("rapi.geno_vector ncol=1 (first: decode and pack)",
                 lambda: rapi.geno_vector(m, v1))
    gv, _ = call("rapi.geno_vector ncol=1", lambda: rapi.geno_vector(m, v1))
    held("rapi.geno_vector vs float64", gv, z_times(v1[:, None]))
    vg, _ = call("rapi.vector_geno ncol=1", lambda: rapi.vector_geno(m, w1))
    held("rapi.vector_geno vs float64", vg, zt_times(w1[:, None]))
    vr, _ = call("rapi.vector_rel_matrix ncol=1",
                 lambda: rapi.vector_rel_matrix(m, w1))
    held("rapi.vector_rel_matrix vs float64 Z (Z^T v)", vr,
         z_times(zt_times(w1[:, None])))
    want = snp_crossprod(gm).cpu()
    cp, _ = call("rapi.crossprod", lambda: rapi.crossprod(m))
    same = torch.equal(torch.from_numpy(cp), want)
    del cp
    cpi, _ = call("rapi.crossprod_int", lambda: rapi.crossprod_int(m))
    same_int = cpi.dtype == np.int64 and torch.equal(
        torch.from_numpy(cpi), want.long())
    log(f"check facades rapi.crossprod / crossprod_int equal to "
        f"snp_crossprod(from_bed): {same} / {same_int}")
    check(same and same_int, "rapi.crossprod differs from snp_crossprod")
    del cpi, want
    af, _ = host("rapi.allele_freq", lambda: rapi.allele_freq(m))
    check(np.array_equal(af, freq) and np.array_equal(
        af.astype(np.float32), gm.freq.cpu().numpy()),
        "rapi.allele_freq differs from freq")
    mt_, _ = host("rapi.transpose", lambda: rapi.transpose(m))
    back, _ = host("rapi.transpose back", lambda: rapi.transpose(mt_))
    same = (mt_.snps, mt_.indiv) == (N_INDIV, N_SNPS) and np.array_equal(
        back.buf, m.buf)
    log(f"check facades rapi.transpose round trip: {same}")
    check(same, "rapi.transpose round trip")
    del mt_, back, buf, m
    panel_cache.clear()
    torch.cuda.empty_cache()

    # -- 11c. MoBPS: compute_relationship on 1,024 reconstructed animals ----
    pop, sel = mobps_population(rng, 64, MOBPS_ANIMALS)
    g_mob, _ = call(f"mobps.compute_relationship ({MOBPS_ANIMALS} animals)",
                    lambda: mobps.compute_relationship(pop, *sel))
    geno_mob, _ = host("mobps.compute_snps", lambda: mobps.compute_snps(
        pop, *sel))
    g_ref = grm(from_dense(geno_mob, device=dev))
    same = torch.equal(torch.diagonal(g_mob), torch.diagonal(g_ref))
    z = torch.as_tensor(geno_mob, device=dev).double()
    zc = z - z.mean(0, keepdim=True)
    fm = z.mean(0) / 2.0
    g64 = (zc @ zc.T) / (2.0 * (fm * (1.0 - fm)).sum())
    log(f"check facades compute_relationship diagonal equal to grm(from_"
        f"dense(compute_snps)): {same}")
    check(same, "compute_relationship's diagonal differs from grm's")
    held("compute_relationship vs float64 GRM definition", g_mob, g64)
    del g_mob, g_ref, z, zc, g64, pop

    # -- 11d. QC and GCTA GRM files (host) ------------------------------------
    (counts, imiss), _ = host("qc.snp_stats", lambda: qc.snp_stats(bed_path))
    d256 = dense[:, :256]
    same = all(np.array_equal(counts[:256, v], (d256 == v).sum(axis=0))
               for v in range(4)) and counts.shape == (N_SNPS, 4) \
        and int(imiss.sum()) == int(counts[:, 3].sum())
    log(f"check facades snp_stats counts vs numpy on 256 SNPs: {same}")
    check(same, "snp_stats counts")
    out = os.path.join(os.path.dirname(bed_path), "qc.bed")
    (keep_s, keep_i), _ = host("qc.qc_filter(maf=0.01, geno=0.05, "
                               "hwe=1e-6)", lambda: qc.qc_filter(
                                   bed_path, out, maf=0.01, geno=0.05,
                                   hwe=1e-6))
    gq, _ = call("from_bed of the filtered fileset",
                 lambda: from_bed(out, device=dev))
    log(f"  qc_filter kept {int(keep_s.sum())} SNPs, {int(keep_i.sum())} "
        f"animals")
    check((gq.snps, gq.indiv) == (int(keep_s.sum()), int(keep_i.sum()))
          and keep_i.all() and keep_s.sum() > 0.9 * N_SNPS,
          "qc_filter's fileset")
    del gq
    g_full, _ = call("grm (for rel_cutoff and the GCTA files)",
                     lambda: grm(gm).cpu().numpy())
    keep, _ = host("qc.rel_cutoff(0.125)",
                   lambda: qc.rel_cutoff(g_full, 0.125))
    log(f"  rel_cutoff keeps {int(keep.sum())} of {N_INDIV}")
    check(keep.sum() > 0.99 * N_INDIV, "rel_cutoff on an unrelated panel")
    prefix = os.path.join(os.path.dirname(bed_path), "panel")
    host("grm_io.write_gcta_grm", lambda: grm_io.write_gcta_grm(
        prefix, g_full, N_SNPS))
    (g2, c2, ids), _ = host("grm_io.read_gcta_grm",
                            lambda: grm_io.read_gcta_grm(prefix))
    same = np.array_equal(g2, g_full.astype(np.float64)) \
        and len(ids) == N_INDIV and bool((c2 == N_SNPS).all())
    log(f"check facades GCTA GRM files round trip bit-equal in float32: "
        f"{same}")
    check(same, "the GCTA GRM files")
    del g_full, g2, c2, gm, dense
    torch.cuda.empty_cache()
    log(f"phase 11 (facades) total: {time.perf_counter() - t_phase:.3f} s")


def cli_phase(dev, sync_time, take_counts, bed_path, resident, cell):
    """Phase 12: the CLI's 15 subcommands in process on the many_indiv
    fileset (its .fam carries the phenotypes, its .bim is put on the 4
    chromosomes of phases 3 and 5), each from the counters' zero with its
    seconds and launches, exit 0 and no plain version, and each output held
    to the library call of an earlier phase on the same panel; the six
    examples as subprocesses at their default sizes, all at once; ``entry``
    against ``ref_impl.dgemm_oracle`` and ``dryrun_multichip(4)`` on the
    card.  The subcommands that launch no kernel at many_indiv (``simulate``,
    ``qc``'s filters, ``pedigree``) and the full LD matrix (65,536^2 is 17
    GB) run on 600 x 5,000 panels and a 2,000-animal pedigree,
    ``grm --method yang --pair-denom`` as one call, and ``ssgblup`` without
    ``--estimate-h2``, at the h2 of phase 7's single-step REML
    (``cell["run_ssgblup"]``)."""
    import filecmp

    import numpy as np
    import torch

    from miraculix_tpu_torch import (_kernels, cli, from_bed, gblup, grm,
                                     grm_yang, gwas_linear, gwas_logistic,
                                     gwas_mixed_loco, ld, ld_prune, ld_score,
                                     load, pedigree, qc)
    from miraculix_tpu_torch.entry import dryrun_multichip, entry
    from miraculix_tpu_torch.io import bed, grm_io
    from miraculix_tpu_torch.ops import ref_impl

    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(bed_path), "cli")
    os.makedirs(work)

    def w(name):
        return os.path.join(work, name)

    def run(name, argv):
        """``cli.main(["--device", dev, *argv])`` from the counters' zero:
        exit 0, no plain version; its printed lines, seconds and launches
        logged; returns what it printed."""
        _kernels.reset_launch_counts()
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                rc, secs = sync_time(lambda: cli.main(
                    ["--device", str(dev), *argv]))
        except SystemExit as exc:
            rc, secs = f"SystemExit({exc.code!r})", float("nan")
        plain = dict(_kernels.PLAIN_CALLS)
        for ln in printed.getvalue().splitlines():
            log(f"  cli {name}: {ln}")
        counts = take_counts(f"cli {name}")
        log(f"phase cli {name}: {secs:.3f} s launches="
            f"{ {k: v for k, v in counts.items() if v} }")
        check(rc == 0, f"cli {name}: exit {rc}")
        check(not plain, f"cli {name}: plain versions ran: {plain}")
        return printed.getvalue(), counts

    def held(name, got, want, tol):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"cli {name}: shape {got.shape} against {want.shape} or not "
              f"finite")
        r = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"check cli {name}: rel={r:.3g} (limit {tol:g})")
        check(r <= tol, f"cli {name}: rel {r:.3g} > {tol:g}")

    def near(name, got, want, tol=1e-3):
        d = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        log(f"check cli {name}: {np.round(got, 4)} against {np.round(want, 4)}"
            f" |diff| {d:.3g} (limit {tol:g})")
        check(d <= tol, f"cli {name}: |diff| {d:.3g} > {tol:g}")

    def equal(name, ok):
        log(f"check cli {name}: {ok}")
        check(ok, f"cli {name}")

    def after(out, key):
        """The numbers printed after ``key`` on its line."""
        ln = next(s for s in out.splitlines() if s.startswith(key))
        return [float(t) for t in ln[len(key):].replace("=", " ").split()
                if t.lstrip("-").replace(".", "", 1).isdigit()]

    def scan(path):
        rows = [ln.split("\t") for ln in open(path).read().splitlines()]
        return rows[0], [r[:3] for r in rows[1:]], np.array(
            [[float(x) for x in r[3:]] for r in rows[1:]])

    def held_scan(name, path, want):
        head, ids, got = scan(path)
        equal(f"{name} variant columns", ids == var_ids)
        for j, col in enumerate(head[3:]):
            held(f"{name} {col}", got[:, j], want[col], 1e-4)

    # the fileset: 4 chromosomes in its .bim, the phenotypes of its .fam
    with open(bed_path[:-4] + ".bim") as fh:
        bim = [ln.split() for ln in fh if ln.strip()]
    chrom = np.repeat(np.arange(4), N_SNPS // 4)
    with open(bed_path[:-4] + ".bim", "w") as fh:
        fh.writelines("\t".join([str(c + 1)] + r[1:]) + "\n"
                      for c, r in zip(chrom, bim))
    var_ids = [[str(c + 1), r[1], r[3]] for c, r in zip(chrom, bim)]
    snp_ids = [r[1] for r in bim]
    with open(bed_path[:-4] + ".fam") as fh:
        fam = [ln.split() for ln in fh if ln.strip()]
    y = np.array([float(r[5]) for r in fam])
    gm, _ = sync_time(lambda: from_bed(bed_path, device=dev))

    # -- 12a. info, simulate, validate, ingest -------------------------------
    small = w("small.bed")
    bed.write_bed(small, bed.simulate_genotypes(600, 5000, seed=SEED + 1))
    run("info", ["info"])
    run("simulate (600 x 5,000)", ["simulate", w("sim.bed"), "--snps", "5000",
                                   "--indiv", "600", "--seed",
                                   str(SEED + 1)])
    equal(".bed of simulate byte-equal to simulate_genotypes + write_bed",
          filecmp.cmp(w("sim.bed"), small, shallow=False))
    os.remove(w("sim.bed"))
    out, _ = run("validate", ["validate"])
    equal("validate: every line ok", len(out.splitlines()) == 6 and all(
        ln.endswith(" ok") for ln in out.splitlines()))
    run("ingest", ["ingest", bed_path, "-o", w("panel.npz")])
    gl = load(w("panel.npz"), device=dev)
    equal("ingest: geno.load words and frequencies bit-equal to from_bed's",
          all(torch.equal(a, b) for a, b in (
              (gl.zq_n, gm.zq_n), (gl.zq_t, gm.zq_t), (gl.freq, gm.freq),
              (gl.pseudo_freq, gm.pseudo_freq))))
    del gl
    os.remove(w("panel.npz"))

    # -- 12b. grm ------------------------------------------------------------
    _, counts = run("grm --gcta-out", ["grm", bed_path, "-o", w("grm.npy"),
                                       "--gcta-out", w("panel")])
    g_lib = grm(gm).cpu().numpy()
    g_cli = np.load(w("grm.npy"))
    held("grm vs grm()", g_cli, g_lib, 1e-6)
    g2, c2, ids = grm_io.read_gcta_grm(w("panel"))
    equal("grm --gcta-out read back bit-equal", np.array_equal(
        g2, g_cli.astype(np.float64)) and bool((c2 == N_SNPS).all())
        and ids == [(r[0], r[1]) for r in fam])
    del g2, c2, g_cli
    check(counts["crossprod"] > 0, "cli grm did not launch K3")
    gmiss = from_bed(bed_path, keep_missing_info=True, device=dev)
    for name, flags, want, kernel in (
            ("grm --method yang --pair-denom", ["--method", "yang",
                                                "--pair-denom"],
             lambda: grm_yang(gmiss, pair_denominator=True),
             "crossprod_weighted"),
            ("grm --blocked", ["--blocked"], lambda: g_lib,
             "crossprod_rect")):
        _, counts = run(name, ["grm", bed_path, "-o", w("g.npy"), *flags])
        ref = want()
        held(f"{name} vs the library", np.load(w("g.npy")),
             ref.cpu().numpy() if isinstance(ref, torch.Tensor) else ref,
             1e-5)
        check(counts[kernel] > 0, f"cli {name} did not launch {kernel}")
    del gmiss, g_lib
    for f in ("grm.npy", "g.npy", "panel.grm.bin", "panel.grm.N.bin"):
        os.remove(w(f))
    torch.cuda.empty_cache()

    # -- 12c. ld -------------------------------------------------------------
    run("ld --window 512 --score", ["ld", bed_path, "--window",
                                    str(LD_WINDOW), "--score", "-o",
                                    w("ldscore.tsv")])
    held("ld --score vs ld_score()", np.loadtxt(
        w("ldscore.tsv"), skiprows=1, usecols=1), ld_score(
            gm, window=LD_WINDOW, chrom=chrom), 1e-5)
    run("ld --prune-r2 --window 512", ["ld", bed_path, "--prune-r2",
                                       str(LD_R2), "--window", str(LD_WINDOW),
                                       "-o", w("prune")])
    keep = ld_prune(gm, window=LD_WINDOW, r2_threshold=LD_R2, chrom=chrom)
    kept = open(w("prune") + ".prune.in").read().split()
    dropped = open(w("prune") + ".prune.out").read().split()
    equal(f"ld --prune-r2 lists equal to ld_prune()'s ({len(kept)} kept, "
          f"{len(dropped)} dropped)",
          kept == [s for s, k in zip(snp_ids, keep) if k]
          and dropped == [s for s, k in zip(snp_ids, keep) if not k])
    run("ld (full matrix, 600 x 5,000)", ["ld", small, "-o", w("ld.npy")])
    held("ld (full) vs ld()", np.load(w("ld.npy")),
         ld(from_bed(small, device=dev)).cpu().numpy(), 1e-5)

    # -- 12d. qc, pedigree (600 x 5,000; 2,000 animals) ----------------------
    # a messy 600 x 5,000 panel (missing calls, rare variants), as the
    # full_pipeline example's, so that the filters drop some
    bed.write_bed(w("messy.bed"), bed.simulate_genotypes(
        600, 5000, seed=SEED + 2, missing_rate=0.02, maf_range=(0.005, 0.5)))
    filters = ["--maf", "0.01", "--geno", "0.05", "--hwe", "1e-6"]
    run("qc --rel-cutoff (600 x 5,000)", [
        "qc", w("messy.bed"), "-o", w("qc.bed"), *filters, "--rel-cutoff",
        "0.125"])
    keep_s, _ = qc.qc_filter(w("messy.bed"), w("lib.bed"), maf=0.01,
                             geno=0.05, hwe=1e-6)
    check(0 < keep_s.sum() < 5000, "qc: the messy panel's filters dropped "
          "no SNP or every SNP")
    keep_rel = qc.rel_cutoff(grm(from_bed(w("lib.bed"), device=dev))
                             .cpu().numpy(), 0.125)
    rel_ids = [tuple(ln.split()) for ln in open(w("qc.rel.id"))]
    equal("qc: fileset byte-equal to qc_filter's, --rel-cutoff IDs equal to "
          "rel_cutoff's", all(filecmp.cmp(w("qc" + ext), w("lib" + ext),
                                          shallow=False)
                              for ext in (".bed", ".bim", ".fam"))
          and rel_ids == [i for i, k in zip(bed.read_fam_ids(w("lib.bed")),
                                            keep_rel) if k])
    sire, dam = pedigree.simulate_pedigree(2000, n_founders=80, seed=SEED)
    with open(w("ped.txt"), "w") as fh:
        fh.writelines(f"A{i + 1} {f'A{s}' if s else 0} {f'A{d}' if d else 0}"
                      "\n" for i, (s, d) in enumerate(zip(sire, dam)))
    run("pedigree (2,000 animals)", ["pedigree", w("ped.txt"), "-o",
                                     w("f.tsv")])
    f_cli = {r[0]: float(r[3]) for r in (
        ln.split("\t") for ln in open(w("f.tsv")).read().splitlines()[1:])}
    # F printed to 6 decimals
    near("pedigree F vs inbreeding()", [f_cli[f"A{i + 1}"]
                                        for i in range(2000)],
         pedigree.inbreeding(sire, dam), 1e-6)

    # -- 12e. gwas ------------------------------------------------------------
    def cols(res, *names):
        return {n: getattr(res, "t" if n == "z" else n) for n in names}

    run("gwas", ["gwas", bed_path, "-o", w("lin.tsv")])
    held_scan("gwas", w("lin.tsv"), cols(gwas_linear(gm, y), "beta", "se",
                                         "t", "p"))
    _, counts = run("gwas --mixed --loco", ["gwas", bed_path, "-o",
                                            w("loco.tsv"), "--mixed",
                                            "--loco"])
    held_scan("gwas --mixed --loco", w("loco.tsv"), cols(gwas_mixed_loco(
        gm, y, chrom, h2=0.5), "beta", "chi2", "p"))
    yb = (y > np.median(y)).astype(np.float64)
    for ext in (".bed", ".bim"):
        os.symlink(bed_path[:-4] + ext, w("cc" + ext))
    with open(w("cc.fam"), "w") as fh:
        fh.writelines(" ".join(r[:5] + [str(int(v))]) + "\n"
                      for r, v in zip(fam, yb))
    run("gwas --logistic", ["gwas", w("cc.bed"), "-o", w("cc.tsv"),
                            "--logistic"])
    held_scan("gwas --logistic", w("cc.tsv"), cols(gwas_logistic(gm, yb),
                                                   "beta", "se", "z", "p"))
    _, _, lin = scan(w("lin.tsv"))
    lin = dict(zip(("beta", "se", "t", "p"), lin.T))
    for name, flags in (("gwas --stream-chunk 16384",
                         ["--stream-chunk", str(STREAM_CHUNK)]),
                        ("gwas --mesh 4", ["--mesh", "4"])):
        run(name, ["gwas", bed_path, "-o", w("g.tsv"), *flags])
        held_scan(f"{name} vs the resident scan", w("g.tsv"), lin)

    # -- 12f. gblup, score, pca -----------------------------------------------
    run("gblup --estimate-h2 --h2-method reml --effects-out",
        ["gblup", bed_path, "--estimate-h2", "--h2-method", "reml",
         "--effects-out", w("eff.tsv")])
    eff = np.loadtxt(w("eff.tsv"), skiprows=1, usecols=(2, 3))
    held("gblup effects vs phase 2's run_gblup", eff[:, 0],
         resident["run_gblup"], 1e-3)
    run("score", ["score", bed_path, w("eff.tsv"), "-o", w("scores.tsv")])
    held("score vs predict()", np.loadtxt(w("scores.tsv"), skiprows=1,
                                          usecols=2),
         gblup.predict(gm, eff[:, 0], eff[:, 1]), 1e-3)
    run("pca -k 10", ["pca", bed_path, "-k", "10", "-o", w("pca")])
    w_lib, _ = gblup.randomized_grm_pca(gm, k=10)
    vec = np.loadtxt(w("pca.eigenvec"), usecols=range(2, 12))
    check(vec.shape == (N_INDIV, 10) and bool(np.isfinite(vec).all()),
          "cli pca: eigenvectors malformed")
    held("pca eigenvalues vs randomized_grm_pca()", np.loadtxt(
        w("pca.eigenval")), w_lib / float(gm.sigma2), 1e-5)

    # -- 12g. reml: HE, AI-REML, bivariate, 4 traits --------------------------
    out, _ = run("reml --method he", ["reml", bed_path, "--method", "he"])
    near("reml --method he h2 vs phase 2's", after(out, "HE h2")[0],
         resident["estimate_h2_he"])
    out, _ = run("reml", ["reml", bed_path])
    near("reml h2 vs phase 2's", after(out, "V(G)/Vp")[0],
         resident["estimate_h2_reml"])
    ys4 = resident["ys4"]
    with open(w("t2.txt"), "w") as fh:
        fh.writelines(f"{r[0]} {r[1]} {v:.9g}\n" for r, v in zip(fam,
                                                                 ys4[:, 1]))
    # the library's default of 8 probes, which phase 2 ran
    out, _ = run("reml --bivar", ["reml", bed_path, "--bivar", w("t2.txt"),
                                  "--probes", "8"])
    near("reml --bivar rG, h2 vs phase 2's",
         [after(out, k)[0] for k in ("rG", "h2 (trait 1)", "h2 (trait 2)")],
         resident["estimate_bivar_reml"])
    with open(w("multi.txt"), "w") as fh:
        fh.write("FID IID y1 y2 y3 y4\n")
        fh.writelines(f"{r[0]} {r[1]} " + " ".join(f"{v:.9g}" for v in row)
                      + "\n" for r, row in zip(fam, ys4))
    out, counts = run("reml --multi (4 traits)", ["reml", bed_path, "--multi",
                                                  w("multi.txt"), "--probes",
                                                  "8"])
    near("reml --multi h2 vs phase 2's", [after(out, f"{k + 1}\t")[0]
                                          for k in range(4)],
         resident["estimate_multi_reml t=4"])
    check(counts["wide_dgemm_split"] > 0,
          "cli reml --multi did not launch the wide split kernel")

    # -- 12h. ssgblup, bench --------------------------------------------------
    # phase 7's run_ssgblup on its 32,768-animal pedigree, at the h2 its
    # single-step REML found
    ped, h2_ss, ebv_lib = cell["run_ssgblup"]
    run("ssgblup", ["ssgblup", bed_path, "--pedigree", ped, "-o",
                    w("ebv.tsv"), "--no-inbreeding", "--h2", repr(h2_ss)])
    rows = [ln.split("\t") for ln in open(w("ebv.tsv")).read().splitlines()]
    rows_lib = [ln.split("\t") for ln in open(ebv_lib).read().splitlines()]
    equal("ssgblup animals and genotyped flags equal to phase 7's "
          "run_ssgblup", len(rows) == 1 + SS_PIPELINE and
          [(r[0], r[2]) for r in rows] == [(r[0], r[2]) for r in rows_lib])
    held("ssgblup EBVs vs phase 7's run_ssgblup", [float(r[1]) for r in
                                                   rows[1:]],
         [float(r[1]) for r in rows_lib[1:]], 1e-3)
    out, counts = run("bench --grm", ["bench", "--grm"])
    equal("bench printed its two lines", [ln.split()[0] for ln in
                                          out.splitlines()[:2]]
          == ["dgemm:", "GRM:"])
    check(counts["crossprod"] > 0, "cli bench --grm did not launch K3")

    # -- 12i. the entry and the dry run on the card ---------------------------
    _kernels.reset_launch_counts()
    (fn, args), _ = sync_time(entry)
    got, secs = sync_time(lambda: fn(*args))
    plain = dict(_kernels.PLAIN_CALLS)
    g512 = bed.simulate_genotypes(512, 4096, seed=0)
    want = ref_impl.dgemm_oracle(g512, args[1].astype(np.float64),
                                 args[0].freq.cpu().numpy())
    take_counts("entry")
    check(got.device.type == "cuda", "entry() did not run on the card")
    check(not plain, f"entry(): plain versions ran: {plain}")
    held(f"entry() ({secs:.3f} s) vs dgemm_oracle", got.cpu().numpy(), want,
         1e-5)
    _kernels.reset_launch_counts()
    _, secs = sync_time(lambda: dryrun_multichip(4))
    plain = dict(_kernels.PLAIN_CALLS)
    counts = take_counts("dryrun_multichip(4)")
    log(f"phase dryrun_multichip(4), 4 shards on the card: {secs:.3f} s "
        f"launches={ {k: v for k, v in counts.items() if v} }")
    check(not plain, f"dryrun_multichip: plain versions ran: {plain}")
    del gm
    torch.cuda.empty_cache()

    # -- 12j. the examples, as subprocesses at their default sizes ------------
    # all six at once: one wall time for the six (each contends with the
    # others for the card and the host)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"miraculix_tpu_torch.examples.{name}"],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in EXAMPLES}
    outs = {}
    for name, proc in procs.items():
        try:
            outs[name] = proc.communicate(timeout=max(
                1.0, t0 + EXAMPLE_TIMEOUT - time.perf_counter()))[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            outs[name] = proc.communicate()[0] + "\n(timed out)"
    log(f"phase examples (six subprocesses at once): "
        f"{time.perf_counter() - t0:.3f} s")
    for name, proc in procs.items():
        for ln in outs[name].splitlines():
            log(f"  example {name}: {ln}")
        log(f"check example {name}: exit {proc.returncode}")
        check(proc.returncode == 0, f"example {name}: exit {proc.returncode}")
    log(f"phase 12 (cli, examples, entry) total: "
        f"{time.perf_counter() - t_phase:.3f} s")


def suite_phase(dev, take_counts, event_ms):
    """Phase 13: ``benchmark.main`` in process for every run of
    ``SUITE_RUNS`` (stdout captured, each row parsed), from the counters'
    zero: each row printed with its seconds, launches and peak device
    memory; no plain version, no ``roofline_warning``, every utilization
    share a number <= 1.0 and every number finite; the sparse solve's
    residuals, the refined solve's float64 residual, the full-scale CG's
    convergence and the single-step solve's iterations within their
    limits; rows 0-255 of the ref panel's timed product exactly equal to
    the plain product of the same words; then the full-scale chunk
    generator's ms a chunk, and the full-scale cell's 1-column wide product
    on one generated chunk held to its plain version."""
    import math

    import torch

    from miraculix_tpu_torch import _kernels, benchmark
    from miraculix_tpu_torch.ops import dgemm as dgemm_ops
    from miraculix_tpu_torch.ops import grm as grm_ops

    t_phase = time.perf_counter()
    timed = grm_ops.packed_crossprod
    seen = {}

    def spy(zq, *args, **kwargs):
        """The production call; keeps the ref panel's words and product."""
        out = timed(zq, *args, **kwargs)
        if zq.shape[0] == benchmark.REF_PANEL["rows_pad"]:
            seen["zq"], seen["out"] = zq, out
        return out

    torch.cuda.empty_cache()
    for argv in SUITE_RUNS:
        name = " ".join(a for a in argv[1:] if not a.startswith("--"))
        _kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        grm_ops.packed_crossprod = spy
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                rc = benchmark.main([*argv, "--device", str(dev)])
        finally:
            grm_ops.packed_crossprod = timed
        secs = time.perf_counter() - t0
        plain = dict(_kernels.PLAIN_CALLS)
        counts = take_counts(f"suite {name}")
        rows = [json.loads(ln) for ln in printed.getvalue().splitlines()]
        for row in rows:
            log(f"  suite {name}: {json.dumps(row)}")
        log(f"phase suite {name}: {secs:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
            f"launches={ {k: v for k, v in counts.items() if v} }")
        check(rc == 0 and len(rows) == 1, f"suite {name}: exit {rc}, "
              f"{len(rows)} rows")
        check(not plain, f"suite {name}: plain versions ran: {plain}")
        row = rows[0]
        check(row["suite"] == argv[1], f"suite {name}: row of {row['suite']}")
        shares = {k: v for k, v in row.items() if "utilization" in k}
        check("roofline_warning" not in row and all(
            v is not None and v <= 1.0 for v in shares.values()),
              f"suite {name}: a share above the card's peak: {shares}")
        check(all(math.isfinite(v) for v in row.values()
                  if isinstance(v, float)),
              f"suite {name}: a number is not finite")
        if row["suite"] == "sparse_solve":
            check(row["rel_residual"] < SUITE_SPARSE_RESID
                  and row["f64_grade_rel_residual"] <= SUITE_SPARSE_F64,
                  f"suite {name}: residuals {row['rel_residual']:.3g}, "
                  f"{row['f64_grade_rel_residual']:.3g}")
        elif row["suite"] == "solve_refined":
            check(row["true_f64_rel_residual"] <= SUITE_REFINED_RESID,
                  f"suite {name}: float64 residual "
                  f"{row['true_f64_rel_residual']:.3g}")
        elif row["suite"] == "gblup_fullscale":
            check(row["converged"] and row["cg_iterations"] <= SUITE_CG_MAX,
                  f"suite {name}: converged {row['converged']} in "
                  f"{row['cg_iterations']} iterations")
        elif row["suite"] == "ssgblup":
            check(row["outer_cg_iterations"] < SUITE_SS_MAX,
                  f"suite {name}: {row['outer_cg_iterations']} iterations")
        elif row.get("panel") == "ref_many_snps":
            check("zq" in seen, "the ref panel's product was not taken")
            zq, out = seen.pop("zq"), seen.pop("out")
            k = SUITE_EXACT_ROWS
            want = grm_ops.packed_crossprod_plain(zq[:k])
            ok = torch.equal(out[:k, :k], want)
            log(f"check suite {name}: rows 0-{k - 1} of the timed product "
                f"vs the plain product of the same {zq.shape[1]} words a "
                f"row: equal={ok}")
            check(ok, "the ref panel's timed product disagrees with plain")
            del zq, out, want
        torch.cuda.empty_cache()

    # the full-scale cell's word generator (plain torch), one chunk
    cfg = dict(indiv=100_096, kw_chunk=4096)
    ms = event_ms(lambda: benchmark.hash_chunk_words(
        0, cfg["indiv"], cfg["kw_chunk"], dev), 3)
    nbytes = cfg["indiv"] * cfg["kw_chunk"] * 4
    log(f"time hash_chunk_words (gblup_fullscale's chunk, {cfg['indiv']} x "
        f"{cfg['kw_chunk']} words): {ms:.3f} ms a chunk, "
        f"{nbytes / ms / 1e6:.1f} GB/s of words written")

    # the cell's 'n' pass at its own shape (1 column on one chunk's words)
    # against the plain product of the same words, under phase 1's wide
    # metric: |kernel - plain| over each output's sum of |terms|, with the
    # bf16 grade as the control that must read above the limit
    zq = benchmark.hash_chunk_words(0, cfg["indiv"], cfg["kw_chunk"], dev)
    u = torch.randn((16 * cfg["kw_chunk"], 1), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    got = dgemm_ops.packed_matmul(zq, u)
    want = dgemm_ops.packed_matmul_plain(zq, u)
    scale = dgemm_ops.packed_matmul_plain(zq, u.abs())
    control = dgemm_ops.packed_matmul_plain(zq, u, single_bf16=True)

    def wide_rel(x):
        diff = (x - want).abs()
        zero = torch.zeros((), device=diff.device)
        return float(torch.where(scale > 0, diff / scale, torch.where(
            diff > 0, torch.inf, zero)).max())
    rel, crel = wide_rel(got), wide_rel(control)
    log(f"check suite gblup_fullscale chunk: packed_matmul "
        f"{tuple(zq.shape)} words x 1 column vs plain: max_abs_err="
        f"{float((got - want).abs().max()):.6g} rel={rel:.3g} (limit "
        f"{WIDE_RTOL:g}; bf16 control {crel:.3g})")
    check(bool(torch.isfinite(got).all()) and rel <= WIDE_RTOL < crel,
          "the full-scale chunk's 1-column product disagrees with plain")
    del zq, u, got, want, scale, control
    _kernels.reset_launch_counts()   # the check's launches count nowhere
    torch.cuda.empty_cache()
    log(f"phase 13 (suite) total: {time.perf_counter() - t_phase:.3f} s")


def small_single_step(dev, small, seed):
    """Phase 8's single-step part: the sparse solver (n = 5,000, bs 300:
    lower and upper, 'n' and 't', float32 and float64, ``solve_lltx`` with a
    permutation, ``solve_f64``), ``SparseCOO.matvec``,
    ``SingleStepHInv.matvec`` and ``ssgblup`` on a 2,000-animal pedigree
    whose youngest 600 are the small panel, and single-step REML on the
    reduced cell ``SS_SMALL_REML``, on the CPU and on ``dev``.  Returns
    ({name: (cpu, gpu) arrays}, {name: (cpu, gpu) scalars})."""
    import numpy as np
    import torch

    from miraculix_tpu_torch import from_dense, pedigree
    from miraculix_tpu_torch import ssgblup as ssg
    from miraculix_tpu_torch.solve.sparse import (SparseTriangularSolver,
                                                  simulate_pedigree_factor)

    rng = np.random.default_rng(seed)
    n = 5000
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=9, seed=seed)
    b = rng.standard_normal((n, 3))
    perm = rng.permutation(n) + 1
    sire, dam = pedigree.simulate_pedigree(2000, n_founders=20, seed=seed)
    geno_ids = np.arange(1401, 2001)
    obs_ids = np.sort(rng.choice(2000, size=1500, replace=False)) + 1
    u = pedigree_bv(sire, dam, 0.5, rng)
    y = 1.0 + u[obs_ids - 1] + np.sqrt(0.5) * rng.standard_normal(1500)
    vh = rng.standard_normal((2000, 4))
    na, ng, ns = SS_SMALL_REML
    rsire, rdam = pedigree.simulate_pedigree(na, n_founders=na // 8,
                                             seed=seed + 1)
    rgeno = np.arange(na - ng, na) + 1
    ru = pedigree_bv(rsire, rdam, 0.6, rng)
    ry = 1.5 + ru + np.sqrt(0.4) * rng.standard_normal(na)
    arrays, scalars = {}, {}
    for d in ("cpu", dev):
        out = {}
        for dt in (torch.float32, torch.float64):
            tag = str(dt).split(".")[1]
            for lower in (True, False):
                slv = SparseTriangularSolver(
                    r if lower else c, c if lower else r, v, n, bs=300,
                    lower=lower, dtype=dt, device=d)
                for trans in ("n", "t"):
                    out[f"sparse {tag} {'lower' if lower else 'upper'} "
                        f"{trans}"] = slv.solve(b, trans=trans).cpu().numpy()
                if lower:
                    out[f"sparse {tag} solve_lltx perm"] = slv.solve_lltx(
                        b, perm=perm).cpu().numpy()
                    out[f"sparse {tag} solve_f64"] = slv.solve_f64(b)[0]
        ri, ci, vi = pedigree.a_inverse(sire, dam)
        out["SparseCOO.matvec"] = pedigree.SparseCOO(
            ri, ci, vi, (2000, 2000), device=d).matvec(vh).cpu().numpy()
        gs = from_dense(small, device=d)
        hinv = ssg.SingleStepHInv(sire, dam, gs, geno_ids)
        out["SingleStepHInv.matvec"] = hinv.matvec(vh).cpu().numpy()
        res = ssg.ssgblup(y, hinv, obs_ids=obs_ids, h2=0.5)
        out["ssgblup u"] = res.u
        gr = from_dense(small[:ng, :ns], device=d)
        rh = ssg.SingleStepHInv(rsire, rdam, gr, rgeno)
        h2, det = ssg.estimate_h2_reml_ss(ry, rh, probes=np.eye(na))
        arrays[str(d)] = out
        scalars[str(d)] = {"ss-reml h2": h2, "ss-reml se_h2": det["se_h2"],
                           "ssgblup iterations": res.iterations,
                           "ss-reml AI steps": det["iterations"]}
    return arrays, scalars


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    from miraculix_tpu_torch import _kernels, gblup
    from miraculix_tpu_torch.benchmark import device_peaks
    from miraculix_tpu_torch import (dgemm, dominance_grm, from_bed,
                                     from_dense, grm, grm_blocked,
                                     grm_cg_solve, grm_diag, grm_matvec_f64,
                                     grm_yang, gwas_linear, gwas_logistic,
                                     gwas_mixed, gwas_mixed_loco, ld,
                                     ld_blocked, ld_prune, ld_score,
                                     ld_windowed, packed_crossprod,
                                     packed_crossprod_rect, packed_matmul,
                                     pairwise_nonmissing, sparse_times_geno,
                                     subset_snps)
    from miraculix_tpu_torch.io import bed, native
    from miraculix_tpu_torch.ops.common import (decode_planar16,
                                                packed_row_sq_stats,
                                                packed_row_sq_stats_plain)
    from miraculix_tpu_torch.ops.dgemm import (exact_digits, exact_recombine,
                                               packed_matmul_exact,
                                               packed_matmul_int8,
                                               packed_matmul_int8_plain,
                                               packed_matmul_plain,
                                               packed_matmul_tall,
                                               packed_matmul_tall_plain,
                                               rhs_values)
    from miraculix_tpu_torch.ops.grm import (_ddt_dense, _ld_prune_greedy,
                                             _missing_d_csr,
                                             packed_crossprod_plain,
                                             packed_crossprod_rect_plain,
                                             packed_crossprod_weighted,
                                             packed_crossprod_weighted_plain)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and bool(smi.stdout.strip()),
          "nvidia-smi did not report the card")
    log(smi.stdout.strip().splitlines()[0])   # name, power limit
    peaks = device_peaks(dev)
    log(f"peaks used for the bounds and shares (dense, "
        f"{torch.cuda.get_device_name(0)}): bf16 {peaks['bf16'] / 1e12:g} "
        f"TFLOP/s, int8 {peaks['int8'] / 1e12:g} TOP/s, HBM "
        f"{peaks['hbm'] / 1e12:g} TB/s")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    def codec_calls():
        return {k: v for k, v in native.CALLS.items() if v}

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    codec_lib = native.build()
    check(native.get_lib() is not None, "the native codec did not load")
    log(f"phase codec build: {time.perf_counter() - t0:.3f} s -> {codec_lib}")
    log(f"host cpu: {host_cpu()}, {os.cpu_count()} cores")
    t0 = time.perf_counter()
    lib = _kernels.build()
    log(f"phase build: {time.perf_counter() - t0:.3f} s -> {lib}")
    for ln in (lib.parent / "build.log").read_text().splitlines():
        if "Used" in ln or ("spill" in ln and not ln.strip().startswith("0")):
            log(f"  ptxas: {ln.strip()}")
    for name, info in _kernels.crossprod_info().items():
        log(f"  {name}: {info['registers']} registers, {info['local_bytes']} "
            f"local (spill) bytes a thread, {info['smem_bytes']} bytes of "
            f"dynamic shared memory, {info['blocks_per_sm']} blocks an SM")
    for name, info in _kernels.matmul_int8_info().items():
        log(f"  matmul_int8 {name} instance: {info['registers']} registers, "
            f"{info['local_bytes']} local (spill) bytes a thread, "
            f"{info['smem_bytes']} bytes of dynamic shared memory, "
            f"{info['blocks_per_sm']} blocks an SM; {info['rows']} rows x "
            f"{info['cols']} digit columns a block, {info['words']} words a "
            f"stage, {info['threads']} threads")
    info = _kernels.weighted_info()
    log(f"  crossprod_weighted: {info['registers']} registers, "
        f"{info['local_bytes']} local (spill) bytes a thread, "
        f"{info['smem_bytes']} bytes of dynamic shared memory, "
        f"{info['blocks_per_sm']} blocks an SM; {info['tile']} x "
        f"{info['tile']} tiles of {info['threads']} threads, "
        f"{info['words']} words a stage x {info['stages']}")
    for (passes, nt), info in _kernels.wide_info().items():
        log(f"  wide_dgemm {passes} parts x {nt} tiles: {info['registers']} "
            f"registers, {info['local_bytes']} local (spill) bytes a thread, "
            f"{info['smem_bytes']} bytes of dynamic shared memory, "
            f"{info['blocks_per_sm']} blocks an SM; {info['rows']} rows x "
            f"{info['cols']} columns a block, {info['words']} words a stage "
            f"x {info['stages']}, promoted every {info['promote']} words")

    # -- host set-up: the panel, its .bed fileset, the GPU container -------
    t0 = time.perf_counter()
    geno = bed.simulate_genotypes(N_INDIV, N_SNPS, seed=SEED)
    log(f"phase simulate_genotypes (host): {time.perf_counter() - t0:.3f} s")
    results = {}

    def record(name, err, timing=None):
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timing is not None:
            r.update(timing)

    disagree = []   # phase 1 reports every failed kernel check at once

    def compare(name, label, got, want, control, scale=None):
        """``got`` against ``want``: max |got - want| relative to max |want|
        or, where ``scale`` (each output's sum of |terms|) is given, the
        largest |got - want| / scale.  ``control`` (want's product at the
        other grade, or a list of such products) must read above the limit
        under the same metric."""
        tol = KERNEL_RTOL if scale is None else WIDE_RTOL
        controls = control if isinstance(control, list) else [control]

        def metric(x):
            diff = (x - want).abs()
            if scale is None:
                return float(diff.max()) / float(want.abs().max())
            zero = torch.zeros((), device=diff.device)
            return float(torch.where(scale > 0, diff / scale,
                                     torch.where(diff > 0, torch.inf,
                                                 zero)).max())
        err = float((got - want).abs().max())
        rel, crel = metric(got), [metric(c) for c in controls]
        log(f"check {name} {label}: max_abs_err={err:.6g} rel={rel:.3g} "
            f"(limit {tol:g}; other-grade control "
            f"{' / '.join(f'{c:.3g}' for c in crel)})")
        if not (bool(torch.isfinite(got).all()) and got.shape == want.shape
                and rel <= tol < min(crel)):
            disagree.append(f"{name} {label}")
        record(name, err)

    def timings(name, label, kernel, plain, library, macs, nbytes, reps):
        ms = event_ms(kernel, reps)
        pms = event_ms(plain, 2)
        lms = event_ms(library, 3) if library is not None else None
        bms, by = bound(name, macs, nbytes)
        rate = f" ({2e-9 * macs / ms:.1f} T op/s)" if macs else ""
        log(f"time {name} {label}: kernel {ms:.4f} ms{rate}, "
            f"plain {pms:.4f} ms, "
            f"library {'n/a' if lms is None else f'{lms:.4f} ms'}, "
            f"bound {bms:.4f} ms ({by}; the kernel at "
            f"{100 * bms / ms:.1f}% of it)")
        return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": lms}

    # the .bed/.bim pair outlives phases 0-1's directory: run_gblup reads it
    # (with phenotypes in its .fam) after the GBLUP phases
    fileset = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "panel.bed")
        native.reset_call_counts()
        t0 = time.perf_counter()
        bed.write_bed(path, geno)
        log(f"phase write_bed (host): {time.perf_counter() - t0:.3f} s")
        log(f"codec calls in write_bed: {codec_calls()}")
        check(native.CALLS["dense_to_plink"] > 0
              and native.CALLS["transpose_u8"] > 0,
              "write_bed did not run the native codec")

        # -- 0. the native ingestion against its numpy path, once -----------
        native.reset_call_counts()
        gm, secs = sync_time(lambda: from_bed(path, device=dev))
        log(f"phase from_bed(device=cuda) (host pack + upload): {secs:.3f} s"
            f" (native codec: {codec_calls()})")
        check(native.CALLS["bed_ingest"] == 1,
              "from_bed did not take the fused native ingestion")
        with native.disabled():
            gm_np, secs_np = sync_time(lambda: from_bed(path, device=dev))
        same = {k: bool(torch.equal(getattr(gm, k), getattr(gm_np, k)))
                for k in ("zq_n", "zq_t", "freq", "pseudo_freq")}
        log(f"check from_bed native vs numpy path: {same}; from_bed "
            f"{secs:.3f} s native, {secs_np:.3f} s numpy")
        check(all(same.values()),
              "the native from_bed differs from its numpy path")
        del gm_np

        # -- 1. each kernel against its plain version ----------------------
        rng = np.random.default_rng(SEED)

        def randn(rows, n):
            return torch.as_tensor(rng.standard_normal((rows, n)),
                                   dtype=torch.float32, device=dev)

        # tall schedule: zq_t for 'n' (contract = SNPs), zq_n for 't'
        orient = {"n": (gm.zq_t, N_SNPS), "t": (gm.zq_n, N_INDIV)}
        tall_checked = set()   # (mode, n) checked here, 'n' and 't'
        for trans in ("n", "t"):
            zq, contract = orient[trans]
            dec = decode_planar16(zq[:contract], torch.float32)  # library's
            ones = torch.ones(contract, device=dev)
            cvs = {"n": 2.0 * gm.freq, "t": ones}
            for ncol in TALL_NCOLS:
                cases = []
                if ncol <= 64:   # the split mode's widths (the fast tier)
                    cases += [("tall_dgemm_cv", "centered", cvs[trans],
                               "split"),
                              ("tall_dgemm", "uncentered", None, "split")]
                if ncol in (1, 8, 128) and trans == "n" or ncol == 32:
                    cases += [("tall_dgemm_bf16", "", None, "bf16"),
                              ("tall_dgemm_f32", "", None, "f32")]
                if ncol == 32 and trans == "n":   # checked, not timed
                    cases += [("tall_dgemm", "positive", None, "split")]
                for name, label, cv, mode in cases:
                    # the f32 mode on a B whose third parts add up, so that
                    # the split grade (no third pass) is a second control;
                    # a positive B, whose sums grow without cancelling
                    b = randn(contract, ncol)
                    if mode == "f32":
                        b = lo_biased(b)
                    elif label == "positive":
                        b = b.abs()
                    tag = f"{trans} {label} ncol={ncol}".replace("  ", " ")
                    tall_checked.add((mode, ncol))
                    got = packed_matmul_tall(zq, b, cv, mode=mode)
                    want = packed_matmul_tall_plain(zq, b, cv, mode=mode)
                    control = packed_matmul_tall_plain(
                        zq, b, mode="f32" if mode == "bf16" else "bf16")
                    if mode == "f32" or label == "positive":
                        # held to the float64 product: the plain f32
                        # product (torch.matmul) is itself off by more
                        # than the limit on the lo-biased B (printed)
                        d64 = decode_planar16(zq[:contract], torch.float64)
                        got, plain = got.double(), want.double()
                        want = d64.T @ rhs_values(
                            b, "hilo" if mode == "split" else "f32").double()
                        grades = ("bf16",) if mode == "split" else (
                            "bf16", "hilo")
                        control = [d64.T @ rhs_values(b, r).double()
                                   for r in grades]
                        del d64
                        prel = float((plain - want).abs().max()
                                     / want.abs().max())
                        log(f"check {name} {tag} plain f32 vs float64: "
                            f"rel={prel:.3g}")
                        del plain
                    if cv is None:
                        compare(name, tag + " c", got, want, control)
                    else:
                        compare(name, tag + " c", got[0], want[0], control)
                        # v = cv.b; its control rounds B to bf16
                        compare(name, tag + " v", got[1], want[1],
                                (cvs[trans] @ b.to(torch.bfloat16)
                                 .to(torch.float32)))
                    del got, want, control
                    if label == "positive":
                        continue
                    # the library call multiplies in the instance's type
                    if mode == "bf16":
                        lib_fn = (lambda d=dec.to(torch.bfloat16),
                                  bw=b.to(torch.bfloat16): d.T @ bw)
                    else:
                        lib_fn = (lambda d=dec, bw=b: d.T @ bw)
                    t = timings(
                        name, tag,
                        lambda: packed_matmul_tall(zq, b, cv, mode=mode),
                        lambda: packed_matmul_tall_plain(zq, b, cv,
                                                         mode=mode),
                        lib_fn,
                        contract * zq.shape[1] * 16 * ncol,
                        4 * (contract * zq.shape[1] + contract * ncol
                             + 16 * zq.shape[1] * ncol), 20 if ncol == 1
                        else 5 if ncol == 128 else 10)
                    lib_fn = None
                    if ncol == 32 and trans == "n":
                        record(name, 0.0, t)
            del dec
            torch.cuda.empty_cache()

        # the tall/wide crossover of the bf16 and f32 tiers at 'n' (dgemm
        # sends 65-128 columns to the tall kernel at these tiers): timed
        # only, both kernels are checked elsewhere
        for mode, opts in (("bf16", dict(single_bf16=True)),
                           ("f32", dict(split=False))):
            for ncol in (65, 128):
                b = randn(N_SNPS, ncol)
                tms = event_ms(lambda: packed_matmul_tall(gm.zq_t, b,
                                                          mode=mode), 5)
                wms = event_ms(lambda: packed_matmul(gm.zq_n, b, **opts), 5)
                log(f"time crossover {mode} n ncol={ncol}: tall {tms:.4f} ms, "
                    f"wide {wms:.4f} ms")

        # the tall kernel's device time by kernel: B pre-pass, mma kernel,
        # split reduction (torch.profiler; empty where it sees no device)
        for mode, ncol in (("split", 32), ("f32", 128)):
            b = randn(N_SNPS, ncol)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    packed_matmul_tall(gm.zq_t, b, mode=mode)
                torch.cuda.synchronize()
            by_kernel = collections.Counter()
            for ev in prof.key_averages():
                if ev.device_time_total > 0:
                    key = next((k for k in ("tall_parts", "tall_mma",
                                            "reduce_splits") if k in ev.key),
                               ev.key[:40])
                    by_kernel[key] += ev.device_time_total / 5 / 1e3
            log(f"time tall_dgemm {mode} n ncol={ncol} by kernel (ms): "
                + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()))

        # wide schedule: zq_n for 'n' (rows = animals), zq_t for 't'
        wide_orient = {"n": (gm.zq_n, N_SNPS), "t": (gm.zq_t, N_INDIV)}
        wide_cases = [  # (name, trans, ncol, packed_matmul options); the
            # JSON keeps each name's first case
            ("wide_dgemm_split", "n", 65, dict()),
            ("wide_dgemm_split", "n", 128, dict()),
            ("wide_dgemm_split", "n", 600, dict()),
            ("wide_dgemm_f32", "n", 130, dict(split=False)),
            ("wide_dgemm_f32", "n", 65, dict(split=False)),
            ("wide_dgemm_bf16", "n", 130, dict(single_bf16=True)),
            ("wide_dgemm_bf16", "n", 65, dict(single_bf16=True)),
            ("wide_dgemm_hilo", "n", 32, dict()),
            # the full-scale GBLUP cell's 'n' pass (phase 13): one column
            ("wide_dgemm_hilo", "n", 1, dict()),
            ("wide_dgemm_split", "t", 65, dict()),
            # the 4-trait REML's AI block, t t (t + 1) = 80 columns
            ("wide_dgemm_split", "n", 80, dict()),
            ("wide_dgemm_split", "t", 80, dict()),
            ("wide_dgemm_f32", "t", 130, dict(split=False)),
            ("wide_dgemm_bf16", "t", 130, dict(single_bf16=True)),
            # checked, not timed: a positive B whose sums grow without
            # cancelling over the longest contraction
            ("wide_dgemm_split", "n positive", 65, dict()),
            ("wide_dgemm_f32", "n positive", 130, dict(split=False)),
        ]
        for trans in ("n", "t"):
            zq, cols = wide_orient[trans]
            dec = decode_planar16(zq, torch.float32)[:, :cols]  # library's
            for name, tr, ncol, opts in wide_cases:
                if tr.split()[0] != trans:
                    continue
                b = randn(cols, ncol)
                tag = f"{tr} ncol={ncol}"
                rhs = name.rsplit("_", 1)[1]
                if tr.endswith("positive"):
                    # held to the float64 product of the instance's parts
                    # (a positive lo-biased B: the plain f32 product is
                    # itself off by more than the limit), beside the bf16
                    # grade
                    b = lo_biased(b.abs())
                    d64 = decode_planar16(zq, torch.float64)[:, :cols]
                    want = d64 @ rhs_values(b, rhs).double()
                    control = d64 @ rhs_values(b, "bf16").double()
                    plain = packed_matmul_plain(zq, b, **opts).double()
                    log(f"check {name} {tag} plain f32 vs float64: rel="
                        f"{float(((plain - want).abs() / want).max()):.3g}")
                    del d64, plain
                    compare(name, tag, packed_matmul(zq, b, **opts).double(),
                            want, control, scale=want)
                    del want, control
                    torch.cuda.empty_cache()
                    continue
                got = packed_matmul(zq, b, **opts)
                want = packed_matmul_plain(zq, b, **opts)
                control = packed_matmul_plain(
                    zq, b, **(dict(split=False) if opts.get("single_bf16")
                              else dict(single_bf16=True)))
                # f32 sums of up to 65,536 products that cancel: bound each
                # output's error by its sum of |terms| (relative to max
                # |plain| the sound kernel reached 1.19e-5 at n = 600)
                compare(name, tag, got, want, control,
                        scale=packed_matmul_plain(zq, b.abs(), **opts))
                del got, want, control
                if rhs == "f32":
                    lib_fn = (lambda d=dec, bw=b: d @ bw)
                else:
                    # the bf16 passes the instance runs, in one bf16 call:
                    # [hi || lo] (2n columns) for the split grade
                    dbf = dec.to(torch.bfloat16)
                    bw = b.to(torch.bfloat16)
                    if rhs in ("hilo", "split"):
                        lo = (b - bw.to(torch.float32)).to(torch.bfloat16)
                        bw = torch.cat([bw, lo], dim=1)
                    lib_fn = (lambda d=dbf, bw=bw: d @ bw)
                if rhs in ("hilo", "split"):
                    log(f"time {name} {tag}: f32 library (torch.matmul of "
                        f"the decoded panel by B) "
                        f"{event_ms(lambda: dec @ b, 3):.4f} ms")
                t = timings(name, tag, lambda: packed_matmul(zq, b, **opts),
                            lambda: packed_matmul_plain(zq, b, **opts),
                            lib_fn, zq.shape[0] * cols * ncol,
                            4 * (zq.numel() + cols * ncol
                                 + zq.shape[0] * ncol), 3 if ncol > 128
                            else 10)
                if "ms" not in results[name]:
                    record(name, 0.0, t)
                lib_fn = dbf = None
            del dec
            torch.cuda.empty_cache()

        # the wide kernel's device time by kernel: B pre-pass, mma kernel,
        # split reduction (torch.profiler; empty where it sees no device)
        for rhs, ncol, opts in (("split", 65, dict()),
                                ("bf16", 130, dict(single_bf16=True)),
                                ("f32", 130, dict(split=False))):
            b = randn(N_SNPS, ncol)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    packed_matmul(gm.zq_n, b, **opts)
                torch.cuda.synchronize()
            by_kernel = collections.Counter()
            for ev in prof.key_averages():
                if ev.device_time_total > 0:
                    key = next((k for k in ("wide_parts", "wide_mma",
                                            "reduce_splits") if k in ev.key),
                               ev.key[:40])
                    by_kernel[key] += ev.device_time_total / 5 / 1e3
            log(f"time wide_dgemm_{rhs} n ncol={ncol} by kernel (ms): "
                + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()))

        def exact(name, label, got, want):
            equal = bool(torch.equal(got, want))
            err = float((got - want).abs().max())
            log(f"check {name} {label} {tuple(got.shape)}: equal={equal} "
                f"max_abs_err={err}")
            if not equal:
                disagree.append(f"{name} {label}")
            record(name, err)

        # K3 and B12 on the whole square, B12 against K3 too
        zn = gm.zq_n
        rows, kw = zn.shape
        want = packed_crossprod_plain(zn)
        k3 = packed_crossprod(zn)
        exact("crossprod", "vs plain", k3, want)
        exact("crossprod_tri", "vs plain", packed_crossprod(zn, wrap=False),
              want)
        exact("crossprod_tri", "vs K3", packed_crossprod(zn, wrap=False), k3)
        del want, k3
        torch.cuda.empty_cache()
        tri_macs = rows * (rows + 1) / 2 * 16 * kw
        d8 = decode_planar16(zn, torch.int8)
        for name, kernel in (("crossprod", lambda: packed_crossprod(zn)),
                             ("crossprod_tri",
                              lambda: _kernels.crossprod_tri(zn))):
            record(name, 0.0, timings(
                name, f"rows={rows}", kernel,
                lambda: packed_crossprod_plain(zn),
                lambda: torch._int_mm(d8, d8.T), tri_macs,
                4 * (zn.numel() + rows * rows), 3))
        del d8
        torch.cuda.empty_cache()

        # B8 at an LD row block of zq_t and at an off-diagonal grm_blocked
        # tile of zq_n (the JSON keeps the LD block)
        half = N_INDIV // 2
        for label, za, zb in (
                ("ld block", gm.zq_t[:LD_BLOCK],
                 gm.zq_t[:LD_BLOCK + LD_WINDOW]),
                ("grm_blocked tile", zn[:half], zn[half:2 * half])):
            za, zb = za.contiguous(), zb.contiguous()
            exact("crossprod_rect", label, packed_crossprod_rect(za, zb),
                  packed_crossprod_rect_plain(za, zb))
            da8 = decode_planar16(za, torch.int8)
            db8 = decode_planar16(zb, torch.int8)
            t = timings("crossprod_rect", f"{label} {za.shape[0]}x"
                        f"{zb.shape[0]}x{16 * za.shape[1]}",
                        lambda: packed_crossprod_rect(za, zb),
                        lambda: packed_crossprod_rect_plain(za, zb),
                        lambda: torch._int_mm(da8, db8.T),
                        za.shape[0] * zb.shape[0] * 16 * za.shape[1],
                        4 * (za.numel() + zb.numel()
                             + za.shape[0] * zb.shape[0]), 10)
            if "ms" not in results["crossprod_rect"]:
                record("crossprod_rect", 0.0, t)
            del da8, db8
            torch.cuda.empty_cache()
        # B8 on an all-2 panel at the grm_blocked tile: 4 * 16 * kw =
        # 262,144 in every entry, the largest sums these shapes reach
        twos = torch.full((2 * half, kw), int(np.uint32(0xAAAAAAAA).view(
            np.int32)), dtype=torch.int32, device=dev)
        za, zb = twos[:half], twos[half:]
        got = packed_crossprod_rect(za, zb)
        exact("crossprod_rect", "all-2 grm_blocked tile", got,
              packed_crossprod_rect_plain(za, zb))
        check(bool((got == 4 * 16 * kw).all()),
              "B8 on the all-2 panel: an entry is not 4 * 16 * kw")
        del twos, za, zb, got
        torch.cuda.empty_cache()

        # B9 at grm_yang's weights: 1 / (2pq m); every term is >= 0, so the
        # sum of |terms| of each output is the output itself
        f64 = gm.freq.double()
        pq2 = 2.0 * f64 * (1.0 - f64)
        wy = torch.where(pq2 > 1e-12, 1.0 / (pq2 * float((pq2 > 1e-12).sum())),
                         torch.zeros_like(pq2)).float()
        # w's digits, split as the kernel splits them: h1 = w & 0xFFFF0000,
        # h2 = (w - h1) & 0xFFFF0000, h3 the rest.  (The controls: the plain
        # product with w rounded once to bf16, and the kernel on h1 and on
        # h1 + h2, weights whose split is (h1, 0, 0) and (h1, h2, 0).)
        w16 = torch.cat([wy, torch.zeros(16 * kw - N_SNPS, device=dev)])
        h1 = (w16.view(torch.int32) & -65536).view(torch.float32)
        r1 = w16 - h1
        h2 = (r1.view(torch.int32) & -65536).view(torch.float32)
        got = packed_crossprod_weighted(zn, wy)
        want = packed_crossprod_weighted_plain(zn, wy)
        control = [packed_crossprod_weighted_plain(
            zn, wy.to(torch.bfloat16).to(torch.float32))] + [
            packed_crossprod_weighted(zn, h) for h in (h1, h1 + h2)]
        compare("crossprod_weighted", f"rows={rows}", got, want, control,
                scale=want)
        del got, want, control
        torch.cuda.empty_cache()
        # the library yardstick: the same three bf16 passes in one bf16
        # torch.matmul on the full square, [h1 d | h2 d | h3 d] (16,384 x
        # 196,608) by [d | d | d]^T (z h is exact in bf16)
        dec = decode_planar16(zn, torch.bfloat16)
        lhs = torch.cat([dec * h.to(torch.bfloat16) for h in (h1, h2,
                                                               r1 - h2)], 1)
        rhs = torch.cat([dec, dec, dec], 1)
        del dec
        record("crossprod_weighted", 0.0, timings(
            "crossprod_weighted", f"rows={rows}",
            lambda: packed_crossprod_weighted(zn, wy),
            lambda: packed_crossprod_weighted_plain(zn, wy),
            lambda: lhs @ rhs.T, tri_macs,
            4 * (zn.numel() + 16 * kw + rows * rows), 2))
        del lhs, rhs
        torch.cuda.empty_cache()
        dec = decode_planar16(zn, torch.float32)
        dw = dec * w16
        log(f"time crossprod_weighted rows={rows}: f32 library (torch.matmul "
            f"of the decoded panel times w by its transpose) "
            f"{event_ms(lambda: dw @ dec.T, 2):.4f} ms")
        del dec, dw
        torch.cuda.empty_cache()
        # B9's device time by kernel: digit pre-pass, mma kernel
        # (torch.profiler; empty where it sees no device)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                packed_crossprod_weighted(zn, wy)
            torch.cuda.synchronize()
        by_kernel = collections.Counter()
        for ev in prof.key_averages():
            if ev.device_time_total > 0:
                key = next((k for k in ("weighted_digits", "weighted_mma")
                            if k in ev.key), ev.key[:40])
                by_kernel[key] += ev.device_time_total / 3 / 1e3
        log(f"time crossprod_weighted rows={rows} by kernel (ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()))
        del w16, h1, r1, h2

        # B10 at the f64 paths' products: the 't' and 'n' products of
        # grm_matvec_f64 at 12 columns (8 digits each: 96 digit columns)
        # and of the one-column refined solve and g_hat (8); digits over
        # [-64, 64] with both ends in every plane (the JSON keeps the first
        # case).  The kernel's time is that of the public packed_matmul_int8
        # (argument checks, digit layout, launch), as before the kernel was
        # rewritten; beside it the launcher the f64 tier calls, the layout
        # and the launch alone, and the other instance (narrow at 96
        # columns, wide at 8); both instances are checked exactly.
        for label, zq, cols, ncol in (("n", zn, N_SNPS, 96),
                                      ("t", gm.zq_t, N_INDIV, 96),
                                      ("n", zn, N_SNPS, 8),
                                      ("t", gm.zq_t, N_INDIV, 8)):
            kw = zq.shape[1]
            d = torch.as_tensor(rng.integers(-64, 65, size=(cols, ncol)),
                                dtype=torch.int8, device=dev)
            d[::7] = 64
            d[3::7] = -64
            want = packed_matmul_int8_plain(zq, d)
            exact("matmul_int8", f"{label} ncol={ncol}",
                  packed_matmul_int8(zq, d), want)
            other = "wide" if ncol <= 8 else "narrow"
            dq = _kernels.digit_quads(d, kw)
            exact("matmul_int8", f"{label} ncol={ncol} {other} instance",
                  _kernels.matmul_int8_quads(zq, dq, ncol, instance=other),
                  want)
            d8 = decode_planar16(zq, torch.int8)[:, :cols]
            dpad = torch.zeros((cols, -(-ncol // 8) * 8), dtype=torch.int8,
                               device=dev)
            dpad[:, :ncol] = d
            dpad = dpad.T.contiguous().T    # column-major, as _int_mm takes
            t = timings("matmul_int8", f"{label} ncol={ncol}",
                        lambda: packed_matmul_int8(zq, d),
                        lambda: packed_matmul_int8_plain(zq, d),
                        lambda: torch._int_mm(d8, dpad),
                        zq.shape[0] * cols * ncol,
                        4 * zq.numel() + cols * ncol + 4 * zq.shape[0] * ncol,
                        10)
            if "ms" not in results["matmul_int8"]:
                record("matmul_int8", 0.0, t)
            wrap = event_ms(lambda: _kernels.matmul_int8(zq, d), 10)
            lay = event_ms(lambda: _kernels.digit_quads(d, kw), 10)
            alone = event_ms(lambda: _kernels.matmul_int8_quads(zq, dq, ncol),
                             10)
            oms = event_ms(lambda: _kernels.matmul_int8_quads(
                zq, dq, ncol, instance=other), 10)
            log(f"time matmul_int8 {label} ncol={ncol}: packed_matmul_int8 "
                f"{t['ms']:.4f} ms, the launcher {wrap:.4f} ms (digit layout "
                f"{lay:.4f} ms, {'wide' if other == 'narrow' else 'narrow'} "
                f"instance alone {alone:.4f} ms), {other} instance alone "
                f"{oms:.4f} ms")
            del d, d8, dpad, dq, want
            torch.cuda.empty_cache()

        # one f64 product at 12 columns ('n' and 't'), split into its steps
        # (CUDA events), beside the FP64 tensor cores' yardstick: one
        # float64 torch.matmul of the decoded panel by B
        for label, zq, cols in (("n", zn, N_SNPS), ("t", gm.zq_t, N_INDIV)):
            kw = zq.shape[1]
            b64 = torch.as_tensor(rng.standard_normal((cols, 12)),
                                  dtype=torch.float64, device=dev)
            d, unit = exact_digits(b64, 8)
            dq = _kernels.digit_quads(d, kw)
            prod = _kernels.matmul_int8_quads(zq, dq, d.shape[1])
            got = exact_recombine(prod, unit, 8)
            check(torch.equal(got, packed_matmul_exact(zq, b64,
                                                       as_numpy=False)),
                  "packed_matmul_exact differs from its steps")
            ms_digits = event_ms(lambda: exact_digits(b64, 8), 10)
            ms_layout = event_ms(lambda: _kernels.digit_quads(d, kw), 10)
            ms_b10 = event_ms(lambda: _kernels.matmul_int8_quads(
                zq, dq, d.shape[1]), 10)
            ms_rec = event_ms(lambda: exact_recombine(prod, unit, 8), 10)
            ms_all = event_ms(lambda: packed_matmul_exact(
                zq, b64, as_numpy=False), 10)
            dec64 = decode_planar16(zq, torch.float64)[:, :cols]
            ms_f64 = event_ms(lambda: dec64 @ b64, 5)
            want = dec64 @ b64
            rel = float((got - want).abs().max() / want.abs().max())
            log(f"time packed_matmul_exact {label} ncol=12: {ms_all:.4f} ms "
                f"= digits {ms_digits:.4f} + layout {ms_layout:.4f} + B10 "
                f"{ms_b10:.4f} + recombination {ms_rec:.4f} ms; FP64 tensor "
                f"cores (float64 torch.matmul of the decoded panel) "
                f"{ms_f64:.4f} ms; rel to it {rel:.3g}")
            check(rel <= F64_RTOL, "packed_matmul_exact disagrees with the "
                  "float64 product")
            del b64, d, unit, dq, prod, got, dec64, want
            torch.cuda.empty_cache()

        # R1 at the main paths' packings: zq_t (GWAS's d_s, LD pruning's
        # scales; a warp a row) and zq_n (grm_diag; a block a row), on the
        # panel's words, on random words (the code 3, the sign bit) and on
        # all-2 words (64 a word, the largest sums); bound by one read of the
        # words and the f32 write
        for label, zq in (("t", gm.zq_t), ("n", zn)):
            rows, kw = zq.shape
            gen = torch.Generator(device=dev).manual_seed(SEED)
            bits = torch.randint(-2 ** 31, 2 ** 31, zq.shape, generator=gen,
                                 dtype=torch.int32, device=dev)
            twos = torch.full_like(zq, int(np.uint32(0xAAAAAAAA).view(
                np.int32)))
            for words, w in (("panel", zq), ("random", bits), ("all-2", twos)):
                got = packed_row_sq_stats(w)
                exact("row_sq_stats", f"{label} {words} words", got,
                      packed_row_sq_stats_plain(w))
            check(bool((got == 64 * kw).all()),
                  f"R1 {label} on all-2 words: a row is not 64 * kw")
            del bits, twos, got
            torch.cuda.empty_cache()
            t = timings("row_sq_stats", f"{label} {rows}x{kw}",
                        lambda: packed_row_sq_stats(zq),
                        lambda: packed_row_sq_stats_plain(zq), None, 0,
                        4 * (zq.numel() + rows), 20)
            if "ms" not in results["row_sq_stats"]:
                record("row_sq_stats", 0.0, t)
        del gm, zn
        torch.cuda.empty_cache()
        check(not disagree, f"kernels disagree with their plain versions "
              f"(or a control reads within the limit): {disagree}")

        # -- 2. the main GBLUP path, counted -------------------------------
        launches = {k: 0 for k in _kernels.LAUNCHES}

        tall_hist = collections.Counter()   # (mode, n) -> tall launches

        def take_counts(phase):
            counts = dict(_kernels.LAUNCHES)
            log(f"launches on the main {phase} path: "
                f"{ {k: v for k, v in counts.items() if v} }")
            for k, v in counts.items():
                launches[k] += v
            tall_hist.update(_kernels.TALL_WIDTHS)
            return counts

        _kernels.reset_launch_counts()
        native.reset_call_counts()
        gm, secs = sync_time(lambda: from_bed(path))   # the default device
        check(gm.device.type == "cuda", "from_bed did not default to the card")
        bed_path = os.path.join(fileset.name, "panel.bed")
        for ext in (".bed", ".bim"):
            os.replace(path[:-4] + ext, bed_path[:-4] + ext)
    log(f"phase main from_bed: {secs:.3f} s (native codec: {codec_calls()})")
    check(native.CALLS["bed_ingest"] == 1,
          "the main from_bed did not take the fused native ingestion")
    g_mat, secs = sync_time(lambda: grm(gm))
    log(f"phase main grm: {secs:.3f} s shape={tuple(g_mat.shape)}")
    diag, secs = sync_time(lambda: grm_diag(gm, scale=True))
    log(f"phase main grm_diag: {secs:.3f} s")
    gd = torch.diagonal(g_mat)
    rel = float(((gd - diag).abs() / diag.abs()).max())
    log(f"check grm diagonal vs grm_diag: rel={rel:.3g}")
    check(bool(torch.isfinite(g_mat).all()) and rel <= DIAG_RTOL,
          "grm diagonal disagrees with grm_diag")
    del g_mat, gd, diag
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    y, bv = gblup.simulate_phenotypes(geno, h2=0.5, n_qtl=N_QTL, seed=SEED)
    log(f"phase simulate_phenotypes (host): {time.perf_counter() - t0:.3f} s")
    res, secs = sync_time(lambda: gblup.gblup(gm, y, h2=0.5, n_pcs=10))
    corr = float(np.corrcoef(res.g_hat, bv)[0, 1])
    log(f"phase main gblup: {secs:.3f} s cg_iterations={res.cg_iterations} "
        f"converged={res.converged} corr(g_hat, bv)={corr:.4f}")
    counts = take_counts("gblup")
    check(res.converged, "GBLUP CG did not converge")
    check(res.g_hat.shape == (N_INDIV,) and bool(np.isfinite(res.fitted).all()),
          "GBLUP output malformed")
    check(corr >= MIN_BV_CORR, f"corr(g_hat, bv) {corr:.4f} < {MIN_BV_CORR}")
    check(all(counts[k] > 0 for k in ("tall_dgemm", "tall_dgemm_cv",
                                      "crossprod")),
          "a kernel of the GBLUP path was never launched")
    # what phase 9 holds its streamed calls to: resident results and their
    # seconds (secs_of: each counted call's)
    resident = {"gblup": res.g_hat, "gblup iterations": res.cg_iterations}
    secs_of = {"gblup": secs}
    per_fn = {}   # function -> its launches on a main path

    def counted(name, fn):
        before = dict(_kernels.LAUNCHES)
        out, secs = sync_time(fn)
        secs_of[name] = secs
        per_fn[name] = {k: v - before[k] for k, v in
                        _kernels.LAUNCHES.items() if v - before[k]}
        log(f"phase main {name}: {secs:.3f} s launches={per_fn[name]}")
        return out

    # -- 2a. the rest of gblup.py, counted: HE and AI-REML heritability,
    # cross-validation, bivariate and 4-trait REML, multi-trait GBLUP,
    # GBLUP from a formed GRM and run_gblup on the .bed fileset ---------------
    grng = np.random.default_rng(SEED + 2)
    cov = grng.standard_normal((N_INDIV, 3))     # GWAS's covariates too
    t0 = time.perf_counter()
    bv2, y2, y3, y4, gone = more_traits(geno, bv, gblup.simulate_phenotypes)
    log(f"phase traits 2-4 simulated (host): {time.perf_counter() - t0:.3f} s;"
        f" corr(bv, bv2) = {np.corrcoef(bv, bv2)[0, 1]:.6f}")
    _kernels.reset_launch_counts()
    h2_he, _ = counted("estimate_h2_he", lambda: gblup.estimate_h2_he(gm, y))
    resident["estimate_h2_he"] = h2_he
    log(f"  estimate_h2_he: h2={h2_he:.4f}")
    check(np.isfinite(h2_he) and abs(h2_he - 0.5) <= HE_TOL,
          f"estimate_h2_he: h2 {h2_he:.4f} not within {HE_TOL} of 0.5")
    for label, kw in (("estimate_h2_reml", {}),
                      ("estimate_h2_reml covariates", dict(covariates=cov))):
        h2r, det = counted(label, lambda: gblup.estimate_h2_reml(gm, y, **kw))
        log(f"  {label}: h2={h2r:.4f} se_h2={det['se_h2']:.4f} AI steps "
            f"{det['iterations']} cg_iterations={det['cg_iterations']} "
            f"converged={det['converged']}")
        check(det["converged"], f"{label} did not converge")
        resident[label] = h2r
        check(abs(h2r - 0.5) <= REML_TOL and np.isfinite(det["se_h2"])
              and det["se_h2"] > 0,
              f"{label}: h2 {h2r:.4f} (se {det['se_h2']}) not within "
              f"{REML_TOL} of 0.5")
    cors, mean_cor = counted("cross_validate k=5",
                             lambda: gblup.cross_validate(gm, y, k=5))
    # one matvec (two centered tall launches) per CG iteration, plus each
    # fold's prediction
    cv_iters = per_fn["cross_validate k=5"].get("tall_dgemm_cv", 0) // 2 - 5
    log(f"  cross_validate: fold correlations {np.round(cors, 4)}, mean "
        f"{mean_cor:.4f}, cg_iterations={cv_iters}")
    check(np.isfinite(cors).all() and mean_cor >= CV_MIN_CORR,
          f"cross_validate: mean correlation {mean_cor:.4f} < {CV_MIN_CORR}")
    rg, db = counted("estimate_bivar_reml",
                     lambda: gblup.estimate_bivar_reml(gm, y, y2))
    log(f"  estimate_bivar_reml: rg={rg:.4f} (se {db['se_rg']:.4f}) h2 "
        f"{db['h2_1']:.4f} / {db['h2_2']:.4f} AI steps {db['iterations']} "
        f"cg_iterations={db['cg_iterations']} converged={db['converged']}")
    check(db["converged"], "estimate_bivar_reml did not converge")
    resident["estimate_bivar_reml"] = (rg, db["h2_1"], db["h2_2"])
    check(abs(db["h2_1"] - 0.5) <= REML_TOL
          and abs(db["h2_2"] - 0.5) <= REML_TOL,
          f"estimate_bivar_reml: h2 {db['h2_1']:.4f} / {db['h2_2']:.4f} not "
          f"within {REML_TOL} of 0.5")
    check(abs(rg - RG_TRUE) <= RG_TOL,
          f"estimate_bivar_reml: rg {rg:.4f} not within {RG_TOL} of {RG_TRUE}")
    ys4 = np.stack([y, y2, y3, y4], axis=1)
    _, _, dm = counted("estimate_multi_reml t=4",
                       lambda: gblup.estimate_multi_reml(gm, ys4))
    log(f"  estimate_multi_reml t=4: h2 {np.round(dm['h2'], 4)} rg(1, 2) "
        f"{dm['rg'][0, 1]:.4f} AI steps {dm['iterations']} cg_iterations="
        f"{dm['cg_iterations']} converged={dm['converged']}")
    check(dm["converged"], "estimate_multi_reml t=4 did not converge")
    resident["ys4"], resident["estimate_multi_reml t=4"] = ys4, dm["h2"]
    check(per_fn["estimate_multi_reml t=4"].get("wide_dgemm_split", 0) > 0,
          "estimate_multi_reml t=4 did not launch the wide split kernel")
    # multi-trait GBLUP with the bivariate REML's components on y's scale,
    # trait 2 missing on 10% of the animals
    sd = np.array([y.std(), y2.std()])
    su = np.array([[db["g11"], db["g12"]], [db["g12"], db["g22"]]])
    se = np.array([[db["e11"], db["e12"]], [db["e12"], db["e22"]]])
    ymt = np.stack([y, y2], axis=1)
    ymt[gone, 1] = np.nan
    mtr = counted("multi_trait_gblup t=2", lambda: gblup.multi_trait_gblup(
        gm, ymt, su * np.outer(sd, sd), se * np.outer(sd, sd)))
    acc = [float(np.corrcoef(mtr.g_hat[:, 0], bv)[0, 1]),
           float(np.corrcoef(mtr.g_hat[:, 1], bv2)[0, 1])]
    acc_gone = float(np.corrcoef(mtr.g_hat[gone, 1], bv2[gone])[0, 1])
    log(f"  multi_trait_gblup: corr(g_hat, bv) {acc[0]:.4f} / {acc[1]:.4f}, "
        f"on trait 2's missing cells {acc_gone:.4f}; cg_iterations="
        f"{mtr.cg_iterations}")
    check(mtr.g_hat.shape == (N_INDIV, 2) and bool(np.isfinite(
        mtr.g_hat).all()), "multi_trait_gblup: g_hat malformed or not finite")
    check(min(acc) >= MIN_BV_CORR,
          f"multi_trait_gblup: corr(g_hat, bv) {acc} < {MIN_BV_CORR}")
    g_s = counted("grm scale=True", lambda: grm(gm, scale=True))
    fg = counted("gblup_from_grm", lambda: gblup.gblup_from_grm(g_s, y))
    del g_s
    torch.cuda.empty_cache()
    fp = counted("gblup n_pcs=0 tol=1e-6",
                 lambda: gblup.gblup(gm, y, h2=0.5, n_pcs=0, tol=1e-6))
    rel = float(np.abs(fg.fitted - fp.fitted).max() / np.abs(fp.fitted).max())
    log(f"  gblup_from_grm: cg_iterations={fg.cg_iterations} converged="
        f"{fg.converged}; fitted vs gblup(n_pcs=0) rel={rel:.3g} (its "
        f"cg_iterations={fp.cg_iterations})")
    check(fg.converged and fp.converged, "gblup_from_grm or gblup n_pcs=0 "
          "did not converge")
    check(rel <= 1e-3, "gblup_from_grm disagrees with gblup(n_pcs=0)")
    with open(bed_path[:-4] + ".fam", "w") as fh:
        fh.writelines(f"F{i} I{i} 0 0 0 {v:.9g}\n" for i, v in enumerate(y))
    effects = bed_path[:-4] + ".effects"
    printed = io.StringIO()

    def run_pipeline():
        with contextlib.redirect_stdout(printed):
            return gblup.run_gblup(bed_path, estimate_h2=True,
                                   h2_method="reml", effects_out=effects)

    rc = counted("run_gblup", run_pipeline)
    for ln in printed.getvalue().splitlines():
        log(f"  run_gblup: {ln}")
    with open(effects) as fh:
        rows = sum(1 for _ in fh) - 1
    cor_fit = [float(ln.split("=")[1]) for ln in
               printed.getvalue().splitlines() if ln.startswith("cor(fitted")]
    check(rc == 0 and rows == N_SNPS and len(cor_fit) == 1
          and cor_fit[0] >= MIN_BV_CORR,
          f"run_gblup: rc {rc}, {rows} effect rows, printed cor(fitted, "
          f"phenotype) {cor_fit}")
    resident["run_gblup"] = np.loadtxt(effects, skiprows=1, usecols=2)
    counts = take_counts("variance components")
    check(all(counts[k] > 0 for k in ("tall_dgemm", "tall_dgemm_cv",
                                      "crossprod", "wide_dgemm_split")),
          "a kernel of the variance-component paths was never launched")
    del y2, y3, y4, ys4, ymt, mtr, fg, fp

    # -- 2b. the f64 tier, counted: refined and dense GBLUP, f64 dgemm ------
    frng = np.random.default_rng(SEED + 7)
    v12 = frng.standard_normal((N_INDIV, 12))
    bn12 = frng.standard_normal((N_SNPS, 12))
    bt12 = frng.standard_normal((N_INDIV, 12))
    _kernels.reset_launch_counts()
    res_rf = counted("gblup refined", lambda: gblup.gblup(
        gm, y, h2=0.5, n_pcs=10, solver="refined", tol=1e-10))
    gv = counted("grm_matvec_f64", lambda: grm_matvec_f64(gm, v12))
    log(f"  gblup refined: cg_iterations={res_rf.cg_iterations} "
        f"converged={res_rf.converged}")
    counts = take_counts("gblup refined")
    check(counts["matmul_int8"] > 0 and counts["tall_dgemm_cv"] > 0,
          "refined GBLUP did not launch the digit and tall kernels")
    _kernels.reset_launch_counts()
    res_dn = counted("gblup dense", lambda: gblup.gblup(
        gm, y, h2=0.5, n_pcs=10, solver="dense"))
    take_counts("gblup dense")
    _kernels.reset_launch_counts()
    cn = counted("dgemm f64 n", lambda: dgemm(gm, bn12, trans="n",
                                              precision="f64"))
    ct = counted("dgemm f64 t", lambda: dgemm(gm, bt12, trans="t",
                                              precision="f64"))
    counts = take_counts("dgemm f64")
    check(counts["matmul_int8"] == 2, "f64 dgemm: one digit launch each")
    # float64 references over decoded 2048-row blocks of zq_n, centered by
    # 2f: pass 1 Zc^T v, Zc^T bt and Zc bn; pass 2 Zc (Zc^T v)
    t0 = time.perf_counter()
    f2 = 2.0 * gm.freq.double()
    vt, bnt, btt = (torch.as_tensor(a, device=dev) for a in (v12, bn12, bt12))
    zv = torch.zeros((N_SNPS, 12), dtype=torch.float64, device=dev)
    want_t = torch.zeros_like(zv)
    want_n, want_gv = [], []
    blocks = [(r0, min(r0 + 2048, N_INDIV)) for r0 in range(0, N_INDIV, 2048)]

    def zc_block(r0, r1):
        return decode_planar16(gm.zq_n[r0:r1], torch.float64)[:, :N_SNPS] - f2

    for r0, r1 in blocks:
        zc = zc_block(r0, r1)
        zv += zc.T @ vt[r0:r1]
        want_t += zc.T @ btt[r0:r1]
        want_n.append(zc @ bnt)
    for r0, r1 in blocks:
        want_gv.append(zc_block(r0, r1) @ zv)
    del zc
    torch.cuda.empty_cache()
    log(f"phase float64 references (decoded blocks): "
        f"{time.perf_counter() - t0:.3f} s")

    def f64_rel(got, want):
        want = want.cpu().numpy()
        return float(np.abs(got - want).max() / np.abs(want).max())

    rels = {"grm_matvec_f64": f64_rel(gv, torch.cat(want_gv)),
            "dgemm f64 n": f64_rel(cn, torch.cat(want_n)),
            "dgemm f64 t": f64_rel(ct, want_t)}
    scale = float(np.abs(res_rf.g_hat).max())
    err_rf = float(np.abs(res_rf.g_hat - res.g_hat).max()) / scale
    err_dn = float(np.abs(res_dn.g_hat - res_rf.g_hat).max()) / scale
    log("check f64 tier vs float64 products: "
        + " ".join(f"{k} rel={v:.3g}" for k, v in rels.items())
        + f"; g_hat refined vs cg {err_rf:.3g}, dense vs refined "
        f"{err_dn:.3g} (of max |g_hat|)")
    check(res_rf.converged, "refined GBLUP did not reach tol 1e-10")
    check(all(isinstance(x, np.ndarray) and x.dtype == np.float64
              for x in (gv, cn, ct)), "the f64 tier did not return float64")
    check(all(v <= F64_RTOL for v in rels.values()),
          "the f64 tier disagrees with the float64 products")
    check(err_rf <= 1e-3 and err_dn <= 1e-3,
          "refined or dense GBLUP disagrees with the other solvers")
    del vt, bnt, btt, zv, want_t, want_n, want_gv, gv, cn, ct, res_rf, res_dn
    torch.cuda.empty_cache()

    # -- 3. the main GWAS path, counted ------------------------------------
    qtl = np.random.default_rng(SEED).choice(N_SNPS, size=N_QTL,
                                             replace=False)
    yb = (y > np.median(y)).astype(np.float64)
    chrom = np.repeat(np.arange(4), N_SNPS // 4)

    _kernels.reset_launch_counts()
    scans = {}
    for name, fn in (
            ("gwas_linear", lambda: gwas_linear(gm, y, covariates=cov)),
            ("gwas_logistic", lambda: gwas_logistic(gm, yb, covariates=cov)),
            ("gwas_mixed", lambda: gwas_mixed(
                gm, y, covariates=cov, n_gamma_snps=64, tol=GWAS_TOL,
                maxiter=GWAS_MAXITER)),
            ("gwas_mixed_loco", lambda: gwas_mixed_loco(
                gm, y, chrom, covariates=cov, n_gamma_snps=32, tol=GWAS_TOL,
                maxiter=GWAS_MAXITER))):
        r = scans[name] = counted(name, fn)
        if hasattr(r, "gamma"):
            log(f"  {name}: gamma={r.gamma:.6g} cg_iterations="
                f"{r.cg_iterations} residual_norm="
                f"{np.array2string(r.residual_norm)}")
    take_counts("gwas")
    check(per_fn["gwas_mixed"].get("wide_dgemm_split", 0) > 0,
          "gwas_mixed did not launch the wide kernel")
    lin = scans["gwas_linear"]
    for name, r in scans.items():
        stats = [r.beta, r.p] + ([r.se, r.t] if hasattr(r, "se")
                                 else [r.chi2])
        check(all(s.shape == (N_SNPS,) and bool(np.isfinite(s).all())
                  for s in stats), f"{name}: statistics malformed")
        if hasattr(r, "gamma"):
            check(r.gamma > 0, f"{name}: gamma {r.gamma} <= 0")
            solves = len(r.residual_norm)     # one per chromosome for LOCO
            check(r.cg_iterations < GWAS_MAXITER * solves
                  and bool(np.all(r.residual_norm <= GWAS_TOL)),
                  f"{name}: CG did not converge")
        chi2 = r.chi2 if hasattr(r, "chi2") else r.t ** 2
        ratio = median_chi2_ratio(chi2, qtl)
        log(f"check {name} QTL enrichment: median chi2 over {N_QTL} QTL / "
            f"over all SNPs = {ratio:.4g}")
        check(ratio >= QTL_ENRICH, f"{name}: QTL enrichment {ratio:.4g}")
    # gwas_linear against float64 regressions on 256 decoded SNP columns
    pick = np.sort(grng.choice(N_SNPS, size=256, replace=False))
    x = np.concatenate([np.ones((N_INDIV, 1)), cov], axis=1)
    want = np.zeros((3, 256))
    for j, s in enumerate(pick):
        z = np.where(geno[:, s] == 3, 0, geno[:, s]).astype(np.float64)
        xs = np.concatenate([x, z[:, None]], axis=1)
        coef = np.linalg.lstsq(xs, y, rcond=None)[0]
        resid = y - xs @ coef
        cov_b = (resid @ resid) / lin.df * np.linalg.inv(xs.T @ xs)
        se = np.sqrt(cov_b[-1, -1])
        want[:, j] = coef[-1], se, coef[-1] / se
    for k, f in enumerate(("beta", "se", "t")):
        got = getattr(lin, f)[pick]
        rel = float(np.abs(got - want[k]).max() / np.abs(want[k]).max())
        log(f"check gwas_linear {f} vs f64 regression on 256 SNPs: "
            f"rel={rel:.3g}")
        check(rel <= LINEAR_RTOL, f"gwas_linear {f} vs f64 regression")
    resident.update((k, scans[k]) for k in ("gwas_linear", "gwas_logistic"))
    del scans

    # -- 4. the bf16/f32 tiers, counted ------------------------------------
    _kernels.reset_launch_counts()
    trng = np.random.default_rng(SEED + 3)
    for prec in ("f32", "bf16"):
        for ncol in (130, 32):   # wide (> 128 columns) and tall
            rhs = trng.standard_normal((N_INDIV, ncol))
            r, secs = sync_time(lambda: grm_cg_solve(
                gm, rhs, lam=1.0, scale=True, tol=1e-3, maxiter=5,
                precision=prec))
            first = float(np.linalg.norm(rhs, axis=0).max())
            last = float(r.residual_norm.max())
            log(f"phase main grm_cg_solve precision={prec} ncol={ncol}: "
                f"{secs:.3f} s iterations={r.iterations} residual "
                f"{first:.4g} -> {last:.4g}")
            check(bool(torch.isfinite(r.x).all()) and last < 0.1 * first,
                  f"grm_cg_solve precision={prec} ncol={ncol}")
    b32 = torch.as_tensor(trng.standard_normal((N_SNPS, 32)),
                          dtype=torch.float32, device=dev)
    c32, secs = sync_time(lambda: packed_matmul(gm.zq_n, b32))
    log(f"phase main packed_matmul ncol=32: {secs:.3f} s")
    check(c32.shape == (gm.zq_n.shape[0], 32)
          and bool(torch.isfinite(c32).all()), "packed_matmul ncol=32")
    take_counts("tiers")
    del c32, b32

    # -- 5. the LD family, counted -----------------------------------------
    # SNP 8k+1 := SNP 8k: 8,192 adjacent exact duplicates (r = 1) in an HWE
    # panel whose other pairs have r^2 ~ 1/16,384
    idx = np.arange(N_SNPS)
    idx[1::8] = idx[0::8]
    gl = subset_snps(gm, idx)
    t0 = time.perf_counter()
    _kernels.reset_launch_counts()
    band = counted("ld_windowed", lambda: ld_windowed(gl, window=LD_WINDOW))
    score = counted("ld_score", lambda: ld_score(
        gl, window=LD_WINDOW, adjusted=True, chrom=chrom))
    native.reset_call_counts()
    keep = counted("ld_prune", lambda: ld_prune(
        gl, window=LD_WINDOW, r2_threshold=LD_R2, chrom=chrom))
    log(f"codec calls in ld_prune: {codec_calls()}")
    check(native.CALLS["ld_prune_mask"] == 1,
          "ld_prune did not run the native scan")
    c1 = N_SNPS // 4
    g1 = subset_snps(gl, np.arange(c1))          # chromosome 1
    r_full = counted("ld", lambda: ld(g1))
    r_blk = counted("ld_blocked", lambda: ld_blocked(g1, row_block=8192))
    take_counts("ld")
    for name in ("ld_windowed", "ld_score", "ld_prune", "ld_blocked"):
        check(per_fn[name].get("crossprod_rect", 0) > 0,
              f"{name} did not launch the rectangular kernel")
    dropped = int((~keep).sum())
    one_each = bool((keep[0::8] ^ keep[1::8]).all())
    log(f"check ld_prune: dropped {dropped} SNPs, one of each planted pair: "
        f"{one_each}")
    check(dropped == N_SNPS // 8 and one_each,
          "ld_prune did not drop exactly one SNP of each planted pair")
    ahead = np.arange(N_SNPS)[:, None] + 1 + np.arange(LD_WINDOW)[None, :]
    valid = (ahead < N_SNPS) & (chrom[np.minimum(ahead, N_SNPS - 1)]
                                == chrom[:, None])
    # the host greedy scan alone, on the offender band of ld_windowed's r
    f = gl.freq.cpu().numpy().astype(np.float64)
    offend = valid & (band * band > np.float32(LD_R2))
    maf = np.minimum(f, 1.0 - f)
    t0_scan = time.perf_counter()
    keep_scan = _ld_prune_greedy(offend, maf, N_SNPS, LD_WINDOW)
    t_greedy = time.perf_counter() - t0_scan
    mask = offend.astype(np.uint8)
    t0_scan = time.perf_counter()
    keep_native = native.ld_prune_mask(mask, maf)
    log(f"phase host prune scan ({N_SNPS} SNPs, window {LD_WINDOW}): "
        f"greedy {t_greedy:.3f} s, native "
        f"{time.perf_counter() - t0_scan:.4f} s")
    check(bool(np.array_equal(keep_scan, keep))
          and bool(np.array_equal(keep_native, keep)),
          "ld_prune differs from the greedy scan of ld_windowed's band")
    del mask
    # LD scores recomputed in host f64 from the band: adjusted r^2 over the
    # partners on the same chromosome, both directions
    r2 = band.astype(np.float64) ** 2
    r2 -= (1.0 - r2) / (N_INDIV - 2)
    r2[~valid] = 0.0
    want = 1.0 + r2.sum(axis=1)
    for d in range(LD_WINDOW):
        want[d + 1:] += r2[: N_SNPS - d - 1, d]
    rel = float(np.abs(score - want).max() / np.abs(want).max())
    log(f"check ld_score vs host f64 from the band: rel={rel:.3g}")
    check(rel <= 2e-4, "ld_score disagrees with its band")
    del r2, ahead, valid, offend, want
    diag_err = float((torch.diagonal(r_full) - 1.0).abs().max())
    pairs = torch.arange(0, c1, 8, device=dev)
    r_min = float(r_full[pairs, pairs + 1].min())
    blk_err = float((torch.from_numpy(r_blk).to(dev) - r_full).abs().max())
    sup = torch.arange(c1, device=dev)[:, None] + 1 + torch.arange(
        LD_WINDOW, device=dev)[None, :]
    inside = sup < c1
    want_band = torch.where(inside, torch.gather(r_full, 1, sup.clamp(
        max=c1 - 1)), torch.zeros((), device=dev))
    got_band = torch.where(inside, torch.from_numpy(band[:c1]).to(dev),
                           torch.zeros((), device=dev))
    band_err = float((got_band - want_band).abs().max())
    log(f"check ld on chromosome 1: |diag - 1| {diag_err:.3g}, planted "
        f"pairs r >= {r_min:.8f}, ld_blocked max_abs {blk_err:.3g}, band vs "
        f"superdiagonals max_abs {band_err:.3g}")
    check(diag_err <= 1e-6 and r_min >= 1 - 1e-5, "ld diagonal or pairs")
    check(blk_err <= 2e-4, "ld_blocked disagrees with ld")
    check(band_err <= 2e-5, "ld_windowed disagrees with ld")
    log(f"phase main ld family (with checks): {time.perf_counter() - t0:.3f} s")
    del gl, g1, band, r_full, r_blk, sup, inside, want_band, got_band
    torch.cuda.empty_cache()

    # -- 6. the GRM family at 16,384 animals, counted -----------------------
    t0 = time.perf_counter()
    # the references (grm, K3) are computed before the counts start: their
    # launches belong to no function of this family
    g_mat, k3 = grm(gm), packed_crossprod(gm.zq_n)
    _kernels.reset_launch_counts()
    gb = counted("grm_blocked", lambda: grm_blocked(gm, row_block=8192))
    tri = counted("packed_crossprod(wrap=False)",
                  lambda: packed_crossprod(gm.zq_n, wrap=False))
    gy = counted("grm_yang", lambda: grm_yang(gm))
    take_counts("grm family")
    err = float((torch.from_numpy(gb).to(dev) - g_mat).abs().max())
    log(f"check grm_blocked vs grm: max_abs={err:.3g}")
    check(err <= 1e-4, "grm_blocked disagrees with grm")
    same = bool(torch.equal(tri, k3))
    log(f"check masked-grid crossproduct vs K3: equal={same}")
    check(same, "packed_crossprod(wrap=False) differs from K3")
    del gb, g_mat, tri, k3
    # the f64 definition on rows 0-255: sum_s zc_is zc_js w_s, w = 1/(2pq m)
    f64 = gm.freq.double()
    pq2 = 2.0 * f64 * (1.0 - f64)
    use = pq2 > 1e-12
    w64 = torch.where(use, 1.0 / (pq2 * float(use.sum())),
                      torch.zeros_like(pq2))
    gd = torch.from_numpy(geno).to(dev)
    lhs = (gd[:256].double() - 2.0 * f64) * w64
    want = torch.cat([lhs @ (gd[c:c + 4096].double() - 2.0 * f64).T
                      for c in range(0, N_INDIV, 4096)], dim=1)
    rel = float((gy[:256].double() - want).abs().max() / want.abs().max())
    log(f"check grm_yang rows 0-255 vs f64 definition: rel={rel:.3g}; "
        f"mean diagonal {float(torch.diagonal(gy).mean()):.6f}")
    check(bool(torch.isfinite(gy).all()) and rel <= 1e-5,
          "grm_yang disagrees with its definition")
    log(f"phase main grm family (with checks): "
        f"{time.perf_counter() - t0:.3f} s")
    del gy, gd, lhs, want, gm
    torch.cuda.empty_cache()

    oracle_rows = geno[:SS_ORACLE[1]].copy()   # phase 7's dense-oracle panel

    # -- 6b. the missing-aware GRM family, counted -------------------------
    # 0.1% of the calls set missing (a 99.9% call rate, inside what plink
    # --geno/--mind QC keeps): ~1.07M missing coordinates
    t0 = time.perf_counter()
    mrng = np.random.default_rng(SEED + 6)
    hit = mrng.choice(geno.size, size=int(MISSING_RATE * geno.size),
                      replace=False)
    geno[np.unravel_index(hit, geno.shape)] = 3
    del hit
    log(f"phase missing calls drawn (host): {time.perf_counter() - t0:.3f} s")
    native.reset_call_counts()
    gt, secs = sync_time(lambda: from_dense(geno, keep_missing_info=True))
    nmiss = int(gt.miss_rows_n.numel())
    log(f"phase from_dense(keep_missing_info=True) (host pack + upload): "
        f"{secs:.3f} s, {nmiss} missing calls (native codec: "
        f"{codec_calls()})")
    g1m = subset_snps(gt, np.arange(N_SNPS // 4))        # chromosome 1
    t0 = time.perf_counter()
    _kernels.reset_launch_counts()
    gmc = counted("grm corrected", lambda: grm(gt))
    gpd = counted("grm pair_denominator",
                  lambda: grm(gt, pair_denominator=True))
    gyc = counted("grm_yang corrected", lambda: grm_yang(gt))
    ldc = counted("ld corrected (chromosome 1)", lambda: ld(g1m))
    counts = take_counts("grm missing")
    check(all(counts[k] > 0 for k in ("crossprod", "crossprod_weighted")),
          "the missing-aware GRM family did not launch K3 and B9")
    # the add-back's two halves on their own (outside the counts): the host
    # scipy D D^T of grm() and its segment-sum D Z^T
    t1 = time.perf_counter()
    ia, ja, wd, _, (mi, ms) = _missing_d_csr(gt)
    ddt = _ddt_dense(mi, ms, wd, N_INDIV, N_SNPS, dtype=np.float32)
    t2 = time.perf_counter()
    seg, secs = sync_time(lambda: sparse_times_geno(
        gt, ia, ja, wd, N_INDIV, trans_geno="t"))
    log(f"phase grm() add-back parts: host D D^T {t2 - t1:.3f} s "
        f"(nnz {int(np.count_nonzero(ddt))}), segment-sum D Z^T {secs:.3f} s")
    del ddt, seg, ia, ja, wd, mi, ms
    # float64 mean-imputed definitions on rows 0-255: Zc = z - 2f, 0 where
    # missing; C = the called indicator
    gd = torch.from_numpy(geno).to(dev)
    f64 = gt.freq.double()
    pq2 = 2.0 * f64 * (1.0 - f64)
    use = pq2 > 1e-12
    wy = torch.where(use, 1.0 / (pq2 * float(use.sum())),
                     torch.zeros_like(pq2))

    def zc_rows(r0, r1):
        z = gd[r0:r1]
        return torch.where(z == 3, torch.zeros((), dtype=torch.float64,
                                               device=dev),
                           z.double() - 2.0 * f64)

    lhs = zc_rows(0, 256)
    c_lhs = (gd[:256] != 3).double() * pq2
    num, den, yang = [], [], []
    c1 = N_SNPS // 4
    var1 = torch.zeros(c1, dtype=torch.float64, device=dev)  # chromosome 1
    for r0 in range(0, N_INDIV, 4096):
        zc = zc_rows(r0, r0 + 4096)
        num.append(lhs @ zc.T)
        yang.append((lhs * wy) @ zc.T)
        den.append(c_lhs @ (gd[r0:r0 + 4096] != 3).double().T)
        var1 += (zc[:, :c1] ** 2).sum(dim=0)
    del zc
    num, den, yang = torch.cat(num, 1), torch.cat(den, 1), torch.cat(yang, 1)
    want = {"grm": num / float(gt.sigma2), "grm pair_denominator": num / den,
            "grm_yang": yang}
    got = {"grm": gmc[:256], "grm pair_denominator": gpd[:256],
           "grm_yang": gyc[:256]}
    rels = {k: float((got[k].double() - want[k]).abs().max()
                     / want[k].abs().max()) for k in want}
    dl = torch.diagonal(ldc)[var1 > 0]
    ld_diag = float((dl - 1.0).abs().max())
    log(f"check missing-aware family rows 0-255 vs f64 definitions: "
        + " ".join(f"{k} rel={v:.3g}" for k, v in rels.items())
        + f"; ld diagonal |r - 1| {ld_diag:.3g} over the {dl.numel()} "
        f"SNPs of positive variance")
    check(all(bool(torch.isfinite(x).all()) for x in got.values())
          and all(v <= 1e-4 for v in rels.values()),
          "the missing-aware GRM family disagrees with its definitions")
    check(ld_diag <= 1e-6, "corrected ld diagonal differs from 1")
    log(f"phase main grm missing (with checks): "
        f"{time.perf_counter() - t0:.3f} s")
    del gmc, gpd, gyc, ldc, gd, lhs, c_lhs, num, den, yang, want, got, dl
    del var1
    del gt, g1m, geno
    torch.cuda.empty_cache()

    cell = single_step(dev, sync_time, take_counts, oracle_rows, bed_path,
                       bv)
    del oracle_rows

    # -- 8. GPU vs CPU path on small panels -------------------------------
    small = bed.simulate_genotypes(600, 5000, seed=SEED + 1)
    ys, _ = gblup.simulate_phenotypes(small, h2=0.5, seed=SEED + 1)
    ysb = (ys > np.median(ys)).astype(np.float64)
    covs = np.random.default_rng(SEED + 4).standard_normal((600, 3))
    chroms = np.repeat(np.arange(4), 1250)
    srng = np.random.default_rng(SEED + 8)
    s_csr = (srng.random((50, 600)) < 0.05) * srng.standard_normal((50, 600))
    s_args = (np.concatenate([[0], np.cumsum((s_csr != 0).sum(axis=1))]) + 1,
              np.nonzero(s_csr)[1] + 1, s_csr[s_csr != 0], 50)
    # the rest of gblup.py: a second trait sharing half of the first's
    # genetic values, missing on every 10th animal for multi_trait_gblup;
    # run_gblup on the small panel's fileset with -9 phenotypes (the
    # simulation branch), its marker effects compared
    ys2 = 0.5 * ys + gblup.simulate_phenotypes(small, h2=0.5,
                                               seed=SEED + 2)[0]
    ys12 = np.stack([ys, ys2], axis=1)
    ysm = ys12.copy()
    ysm[::10, 1] = np.nan
    s_su, s_se = np.array([[0.5, 0.2], [0.2, 0.6]]), np.eye(2) * 0.5
    small_set = tempfile.TemporaryDirectory()
    small_bed = os.path.join(small_set.name, "small.bed")
    bed.write_bed(small_bed, small)
    fits, scalars = {}, {}
    t0 = time.perf_counter()
    for d in ("cpu", dev):
        gs = from_dense(small, device=d)
        he, _ = gblup.estimate_h2_he(gs, ys)
        h2x, dx = gblup.estimate_h2_reml(gs, ys, probes=np.eye(600))
        cv_cors, _ = gblup.cross_validate(gs, ys, k=5)
        sg_d, se_d, _ = gblup.estimate_multi_reml(gs, ys12)
        sg_h, se_h, _ = gblup.estimate_multi_reml(gs, ys12, device_cg=False)
        eff = os.path.join(small_set.name, f"effects_{d}.txt")
        with contextlib.redirect_stdout(io.StringIO()):
            gblup.run_gblup(small_bed, pcs=3, effects_out=eff, device=d)
        scalars[str(d)] = {"h2 he": he, "h2 reml exact": h2x,
                           "se_h2 reml exact": dx["se_h2"]}
        fits[str(d)] = {
            "fitted": gblup.gblup(gs, ys, h2=0.5, n_pcs=3, tol=1e-5).fitted,
            "fitted refined": gblup.gblup(gs, ys, h2=0.5, n_pcs=3,
                                          solver="refined",
                                          tol=1e-10).fitted,
            "fitted dense": gblup.gblup(gs, ys, h2=0.5, n_pcs=3,
                                        solver="dense").fitted,
            "sparse dense": sparse_times_geno(
                gs, *s_args, method="dense").cpu().numpy(),
            "sparse segsum": sparse_times_geno(
                gs, *s_args, method="segsum").cpu().numpy(),
            "sparse f64": sparse_times_geno(
                gs, *s_args, method="dense", precision="f64").cpu().numpy(),
            "grm": grm(gs).cpu().numpy(),
            "linear": gwas_linear(gs, ys, covariates=covs).t,
            "logistic": gwas_logistic(gs, ysb, covariates=covs).t,
            "mixed": gwas_mixed(gs, ys, covariates=covs, tol=1e-4).chi2,
            "loco": gwas_mixed_loco(gs, ys, chroms, covariates=covs,
                                    tol=1e-4).chi2,
            "cross_validate": cv_cors,
            "multi_reml Sg device_cg": sg_d, "multi_reml Se device_cg": se_d,
            "multi_reml Sg host": sg_h, "multi_reml Se host": se_h,
            "multi_trait_gblup": gblup.multi_trait_gblup(
                gs, ysm, s_su, s_se).g_hat,
            "gblup_from_grm": gblup.gblup_from_grm(
                grm(gs, scale=True), ys).fitted,
            "run_gblup effects": np.loadtxt(eff, skiprows=1, usecols=2)}
    small_set.cleanup()
    fc, fg = fits["cpu"], fits[str(dev)]
    err_grm = float(np.abs(fg["grm"] - fc["grm"]).max())
    rels = {k: float(np.abs(fg[k] - fc[k]).max() / np.abs(fc[k]).max())
            for k in fc if k != "grm"}
    errs = {k: abs(scalars[str(dev)][k] - v)
            for k, v in scalars["cpu"].items()}
    log(f"check small panel GPU vs CPU ({time.perf_counter() - t0:.3f} s): "
        f"grm max_abs={err_grm:.3g} "
        + " ".join(f"{k} rel={v:.3g}" for k, v in rels.items()) + " "
        + " ".join(f"{k} abs={v:.3g}" for k, v in errs.items()))
    check(err_grm <= 1e-5 and all(
        v <= (F64_RTOL if "f64" in k else SMALL_RTOL)
        for k, v in rels.items()),
          "GPU pipeline disagrees with the CPU path on the small panel")
    check(all(v <= SMALL_ATOL for v in errs.values()),
          "h2 estimates disagree between the GPU and the CPU paths")

    # the sparse solver, the pedigree operator and single-step GBLUP/REML
    t0 = time.perf_counter()
    ss_arrays, ss_scalars = small_single_step(dev, small, SEED + 10)
    fc, fg = ss_arrays["cpu"], ss_arrays[str(dev)]
    rels = {k: float(np.abs(fg[k] - fc[k]).max() / np.abs(fc[k]).max())
            for k in fc}
    sc, sg = ss_scalars["cpu"], ss_scalars[str(dev)]
    errs = {k: abs(sg[k] - sc[k]) for k in ("ss-reml h2", "ss-reml se_h2")}
    log(f"check single-step small panels GPU vs CPU "
        f"({time.perf_counter() - t0:.3f} s): "
        + " ".join(f"{k} rel={v:.3g}" for k, v in rels.items()) + " "
        + " ".join(f"{k} abs={v:.3g}" for k, v in errs.items())
        + f"; CPU {sc}, GPU {sg}")
    check(all(v <= SMALL_RTOL for v in rels.values())
          and all(v <= SMALL_ATOL for v in errs.values()),
          "the sparse solver or single-step GBLUP disagrees between the GPU "
          "and the CPU paths")

    # the LD and GRM families on a panel with 2% missing genotypes and a
    # duplicate of every 50th SNP, tracked (the corrected LD paths) and not
    sm = bed.simulate_genotypes(600, 5000, seed=SEED + 5, missing_rate=0.02)
    sm[:, 1::50] = sm[:, 0::50]
    t0 = time.perf_counter()
    bsm = {"n": srng.standard_normal((5000, 4)),
           "t": srng.standard_normal((600, 4))}
    usm = srng.standard_normal(5000)
    fam = {}
    for d in ("cpu", dev):
        tr = from_dense(sm, keep_missing_info=True, device=d)
        un = from_dense(sm, device=d)
        fam[str(d)] = {
            f"dgemm f64 {trans} {name}": dgemm(
                tr, bsm[trans], trans=trans, center=center, precision="f64",
                ignore_missings=False)
            for trans in ("n", "t")
            for name, center in (("none", False), ("rowmeans", True),
                                 ("colmeans", "colmeans"), ("user", usm))}
        fam[str(d)].update({
            "grm corrected": grm(tr).cpu().numpy(),
            "grm pair_denominator": grm(tr, pair_denominator=True
                                        ).cpu().numpy(),
            "ld corrected": ld(tr).cpu().numpy(),
            "ld_windowed corrected": ld_windowed(tr, 64,
                                                 correct_missing=True),
            "ld_windowed uncorrected": ld_windowed(tr, 64,
                                                   correct_missing=False),
            "ld_score corrected": ld_score(tr, 64),
            "ld_score": ld_score(un, 64, chrom=chroms),
            "ld_prune corrected": ld_prune(tr, 64),
            "ld_prune": ld_prune(un, 64, chrom=chroms),
            "pairwise_nonmissing": pairwise_nonmissing(tr).cpu().numpy(),
            "grm_yang corrected": grm_yang(tr).cpu().numpy(),
            "dominance_grm": dominance_grm(tr).cpu().numpy(),
            "grm_blocked": grm_blocked(sm, row_block=512, device=d),
            "ld_blocked": ld_blocked(tr, row_block=1024)})
    fc, fg = fam["cpu"], fam[str(dev)]
    equal = {k: bool(np.array_equal(fg[k], fc[k])) for k in fc
             if fc[k].dtype in (np.bool_, np.int32)}
    rels = {k: float(np.abs(fg[k] - fc[k]).max() / np.abs(fc[k]).max())
            for k in fc if k not in equal}
    pruned = int((~fc["ld_prune"]).sum())
    log(f"check missing panel GPU vs CPU ({time.perf_counter() - t0:.3f} s): "
        + " ".join(f"{k} equal={v}" for k, v in equal.items()) + " "
        + " ".join(f"{k} rel={v:.3g}" for k, v in rels.items())
        + f"; ld_prune drops {pruned}")
    check(all(equal.values()) and pruned >= 100 and all(
        v <= (F64_RTOL if "f64" in k else SMALL_RTOL)
        for k, v in rels.items()),
          "LD/GRM families disagree between the GPU and the CPU paths")

    # -- 9. the out-of-core streamed panel, counted --------------------------
    streamed_phase(dev, sync_time, take_counts, bed_path, y, yb, cov, qtl,
                   resident, secs_of, cell)

    # -- 10. the parallel layer, 4 shards on the card, counted ---------------
    sharded_phase(dev, sync_time, take_counts, bed_path, y, yb, cov, chrom,
                  resident, secs_of, cell)

    # -- 11. the user surface: C API, R API, MoBPS, QC, GRM files, counted --
    facades_phase(dev, sync_time, take_counts, bed_path)

    # -- 12. the CLI, the examples and the entry, counted ----------------------
    cli_phase(dev, sync_time, take_counts, bed_path, resident, cell)
    fileset.cleanup()

    # -- 13. the benchmark suite at the reference's sizes, counted -----------
    suite_phase(dev, take_counts, event_ms)
    missing = [k for k in SOURCES if launches[k] == 0]
    check(not missing, f"never launched on a main path: {missing}")
    log("tall launches on the main paths by (mode, n): "
        + ", ".join(f"{m} {n}: {c}" for (m, n), c in sorted(tall_hist.items())))
    unchecked = sorted(set(tall_hist) - tall_checked)
    check(not unchecked, f"tall widths launched on a main path but not "
          f"checked in phase 1: {unchecked}")

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k],
                **{f: results[k].get(f) for f in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for k, (src, rep) in SOURCES.items()]
    log(f"chip_smoke total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)

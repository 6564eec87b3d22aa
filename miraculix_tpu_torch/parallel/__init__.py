"""Multi-card and multi-process layer: genotype linear algebra over a mesh
of shards, torch twin of ``miraculix_tpu.parallel``.  1D = SNP-axis
sharding; 2D = individuals x SNPs block sharding for panels where neither
axis fits one card.  The collectives run over ``torch.distributed`` (NCCL
for CUDA shards, gloo for CPU shards); one process may hold several shards,
on one card or several."""
from ._collectives import (COLLECTIVES, Mesh, reset_collective_counts)
from .sharded import (RowSharded, ShardedGeno, host_global, init_distributed,
                      load_sharded, make_mesh, save_sharded, shard_genotypes,
                      shard_genotypes_from_bed, sharded_cg_solve,
                      sharded_dgemm, sharded_grm, sharded_grm_diag,
                      sharded_grm_matvec, sharded_indicator2_dgemm_t,
                      sharded_loco_cg_solve, sharded_snp_sq_stats,
                      sharded_weighted_grm_diag)
from .sharded2d import (ShardedGeno2D, from_reference_state, make_mesh_2d,
                        pad_indiv_vec, pad_snp_vec, shard_genotypes_2d,
                        shard_genotypes_2d_from_bed, sharded_cg_solve_2d,
                        sharded_dgemm_2d, sharded_grm_2d,
                        sharded_grm_diag_2d)

__all__ = [
    "ShardedGeno",
    "ShardedGeno2D",
    "from_reference_state",
    "host_global",
    "init_distributed",
    "load_sharded",
    "make_mesh",
    "make_mesh_2d",
    "pad_indiv_vec",
    "pad_snp_vec",
    "save_sharded",
    "shard_genotypes",
    "shard_genotypes_2d",
    "shard_genotypes_2d_from_bed",
    "shard_genotypes_from_bed",
    "sharded_cg_solve",
    "sharded_cg_solve_2d",
    "sharded_dgemm",
    "sharded_dgemm_2d",
    "sharded_grm",
    "sharded_grm_diag",
    "sharded_grm_diag_2d",
    "sharded_grm_2d",
    "sharded_grm_matvec",
    "sharded_indicator2_dgemm_t",
    "sharded_loco_cg_solve",
    "sharded_snp_sq_stats",
    "sharded_weighted_grm_diag",
]

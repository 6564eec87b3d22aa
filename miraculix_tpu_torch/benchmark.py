"""Benchmark suite: panels x ops, comparator baselines, roofline reporting.

Torch twin of ``miraculix_tpu.benchmark`` (the reference's harnesses
utils/benchmark/benchmark_suite.jl:39-273 and benchmark.f90:150-296).  Each
cell returns the reference's row: the same keys and the same ``suite``,
``panel`` and ``config`` strings.  The comparator is one f32
``torch.matmul`` on the decoded panel.

Timing: a "base" run is one call and a "full" run ``iters + 1`` calls back
to back; each run is timed with CUDA events on the current stream and ends
in an event synchronize (the host clock on the CPU), and the per-call time
is the median of interleaved (full - base) differences over ``iters``, which
takes out each run's fixed launch and synchronize cost.  Cells whose work is
host-orchestrated report wall-clock medians, as in the reference.
Utilization shares are against the detected card's peaks
(:func:`device_peaks`); on the CPU they are None.

Run:  python -m miraculix_tpu_torch.benchmark [--suite dgemm|grm|...|all]
          [--panels small ...] [--comparator] [--device cuda]
Emits one JSON object per config on stdout.  The cells run on the CUDA card
unless ``device`` (``--device``) names another device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .geno import _device, resolve_device

# Panel definitions scaled from the reference's simulated panels
# (utils/genotype_simulation_plink/Makefile:1-9), sized to single-chip HBM.
PANELS: Dict[str, Dict[str, int]] = {
    "xsmall": dict(snps=16384, indiv=2048),
    "small": dict(snps=65536, indiv=4096),
    "medium": dict(snps=262144, indiv=4096),
    "many_snps": dict(snps=1048576, indiv=2048),
    "many_indiv": dict(snps=65536, indiv=16384),
}

# Dense peaks (no sparsity) by card, from NVIDIA's data sheets: bf16 tensor
# FLOP/s, int8 tensor OP/s, HBM bytes/s.  Matched on
# torch.cuda.get_device_name in this order; the SXM part reports itself as
# "H100 80GB HBM3".
_CARD_PEAKS = (
    (("H100 NVL",), dict(bf16=835e12, int8=1671e12, hbm=3.9e12)),
    (("H100 PCIe",), dict(bf16=756e12, int8=1513e12, hbm=2.0e12)),
    (("H100 SXM", "H100 80GB HBM3"), dict(bf16=989e12, int8=1979e12,
                                           hbm=3.35e12)),
)

# bench_grm_ref_panel: real rows, rows padded to the tile, words a row
# (16 * 65,536 = 1,048,576 SNPs), words a generated chunk
REF_PANEL = dict(rows=21248, rows_pad=21504, kw=65536, chunk=4096)

_M32 = 0xFFFFFFFF


def device_peaks(device) -> Optional[dict]:
    """{"bf16", "int8", "hbm"} peaks of the card ``device`` names, found by
    its name; None on the CPU.  An unknown CUDA card raises: no guess."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for keys, peaks in _CARD_PEAKS:
        if any(k in name for k in keys):
            return dict(peaks)
    raise ValueError(f"no peak table for the card {name!r}: add its dense "
                     f"bf16, int8 and HBM rates to benchmark._CARD_PEAKS")


def _share(rate: float, peaks: Optional[dict], unit: str):
    """``rate`` as a share of the card's ``unit`` peak, or None (CPU)."""
    return None if peaks is None else round(rate / peaks[unit], 3)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _elapsed(fn: Callable, device: torch.device) -> float:
    """Seconds of one ``fn()``: CUDA events on the device's current stream,
    ended by an event synchronize; the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _interleaved_per_iter(run_base: Callable, run_full: Callable,
                          iters: int, reps: int = 5,
                          stats: dict = None, *,
                          device=torch.device("cpu")) -> float:
    """Differenced per-iteration time from INTERLEAVED (full, base) pairs.

    The two halves of one difference are adjacent in time, and the MEDIAN
    of the pairwise differences is used (min is optimistically biased when
    per-run noise rivals the differenced signal).  When the problem is
    below the noise floor entirely (median <= 0), fall back to the full-run
    upper bound.

    ``stats`` (optional dict) receives the measurement's error bars:
    ``spread_pct`` = interquartile range of the pairwise estimates as a
    percentage of the median (None after the fallback), and ``n_pairs``.
    """
    diffs, best_full = [], float("inf")
    for _ in range(reps):
        tf = _elapsed(run_full, device)
        diffs.append(tf - _elapsed(run_base, device))
        best_full = min(best_full, tf)
    per = statistics.median(diffs) / iters
    if stats is not None and per > 0:
        d = sorted(x / iters for x in diffs)
        q1, q3 = d[len(d) // 4], d[(3 * len(d)) // 4]
        stats["spread_pct"] = round(100.0 * (q3 - q1) / per, 1)
        stats["n_pairs"] = len(d)
    if per <= 0:
        per = best_full / (iters + 1)
        if stats is not None:
            stats["spread_pct"] = None
            stats["n_pairs"] = len(diffs)
    return per


def _timed_runs(call: Callable, device, iters: int, stats) -> float:
    """Warm both runs once, then :func:`_interleaved_per_iter` of one call
    against ``iters + 1`` calls."""
    def full():
        for _ in range(iters + 1):
            call()

    call()
    full()
    return _interleaved_per_iter(call, full, iters, stats=stats,
                                 device=torch.device(device))


def _timed_scan_zq(fn: Callable, zq, iters: int,
                   stats: dict = None) -> float:
    """Device seconds per call of ``fn(zq)``; ``zq`` is a tensor or any
    panel with a ``device`` (the events run on its stream)."""
    return _timed_runs(lambda: fn(zq), zq.device, iters, stats)


def _timed_scan_b(fn: Callable, zq, b, iters: int,
                  stats: dict = None) -> float:
    """Like :func:`_timed_scan_zq` for ``fn(zq, b)`` (dgemm-style)."""
    return _timed_runs(lambda: fn(zq, b), zq.device, iters, stats)


def _wall_median(fn: Callable, reps: int, device: torch.device) -> float:
    """Median host-clock seconds of ``fn()`` over ``reps`` calls after a
    warm call (kernel build and load), each ended by a synchronize."""
    def once():
        t0 = time.perf_counter()
        fn()
        _sync(device)
        return time.perf_counter() - t0

    once()
    return statistics.median(once() for _ in range(reps))


def _f32_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def bench_dgemm(panel: str, ncol: int = 32, iters: int = 64,
                comparator: bool = False, *, device=None) -> dict:
    """Centered dgemm_compressed 'n' on one card, with roofline ratios.

    ``comparator_dense_xla_s`` keeps the reference's key and holds the time
    of one f32 ``torch.matmul`` of the decoded panel by B, run with
    ``torch.backends.cuda.matmul.allow_tf32`` False (true f32)."""
    from .geno import from_dense
    from .io import bed
    from .ops.dgemm import dgemm
    from .solve.sparse import _full_f32

    dev = _device(device)
    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g, device=dev)  # both orientations: dgemm picks tall/wide
    zq = gm.zq_n
    rng = np.random.default_rng(0)
    b = _f32_tensor(rng.standard_normal((snps, ncol)), dev)
    peaks = device_peaks(dev)

    stats = {}
    per = _timed_scan_b(
        lambda gmx, bc: dgemm(gmx, bc, trans="n", center=True), gm, b, iters,
        stats=stats)
    geno_ops = snps * indiv * ncol / per
    # useful tensor-core work: 2 flops x 2 (hi/lo split) per genotype-column
    mxu_flops = 4.0 * indiv * snps * ncol / per
    hbm_bytes = (zq.numel() * 4 + b.numel() * 4 * 4 + indiv * ncol * 4) / per
    out = {
        "suite": "dgemm",
        "panel": panel,
        "config": f"{snps}x{indiv} ncol={ncol} centered 'n'",
        "seconds_per_call": round(per, 6),
        "geno_col_ops_per_s": geno_ops,
        "mxu_utilization": _share(mxu_flops, peaks, "bf16"),
        "hbm_utilization": _share(hbm_bytes, peaks, "hbm"),
        **stats,
    }
    if peaks is not None and mxu_flops > peaks["bf16"]:
        # above the physical roofline = measurement error, not throughput
        out["roofline_warning"] = True
    if comparator:
        if g.size * 4 > 4e9:  # the reference's cut for a dense f32 panel
            out["comparator_dense_xla_s"] = None
        else:
            dense = _f32_tensor(np.where(g == 3, 0, g), dev)
            with _full_f32():
                per_dense = _timed_scan_b(lambda d, bc: d @ bc, dense, b,
                                          max(2, iters // 4))
            out["comparator_dense_xla_s"] = round(per_dense, 6)
            out["speedup_vs_dense"] = round(per_dense / per, 2)
    return out


def bench_dgemm_exact(panel: str = "small", ncol: int = 8,
                      reps: int = 5, *, device=None) -> dict:
    """The exact f64 tier (integer-digit path): WALL time per call including
    the digit extraction and f64 recombination, the median of ``reps``
    wall clocks, with the f32 tier's wall (the tall kernel's f32 mode) for
    context."""
    from .geno import from_dense
    from .io import bed
    from .ops.dgemm import dgemm, packed_matmul_exact

    dev = _device(device)
    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g, device=dev)
    rng = np.random.default_rng(0)
    b = rng.standard_normal((snps, ncol))

    per = _wall_median(lambda: packed_matmul_exact(gm.zq_n, b), reps, dev)
    b32 = _f32_tensor(b, dev)
    per_f32 = _wall_median(lambda: dgemm(gm, b32, trans="n", center=False,
                                         precision="f32").cpu(), reps, dev)
    geno_ops = snps * indiv * ncol
    return {
        "suite": "dgemm_exact",
        "panel": panel,
        "config": f"{snps}x{indiv} ncol={ncol} exact-f64 (8 int8 digit "
                  "passes, host recombine)",
        "wall_seconds_per_call": round(per, 4),
        "geno_col_ops_per_s": geno_ops / per,
        "f32_highest_wall_s": round(per_f32, 4),
        "slowdown_vs_f32_tier": round(per / max(per_f32, 1e-12), 2),
        "relative_error_grade": "~1e-15 (vs ~1e-7 for f32-HIGHEST)",
    }


def bench_solve_refined(panel: str = "small", reps: int = 3, *,
                        device=None) -> dict:
    """f64-grade GRM solve by iterative refinement (grm_cg_solve_refined):
    WALL time per solve, with the plain f32 CG wall for context and the
    achieved true-f64 relative residual."""
    from .geno import from_dense
    from .io import bed
    from .solve.cg import grm_cg_solve, grm_cg_solve_refined

    dev = _device(device)
    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g, device=dev)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(indiv)
    lam = 100.0
    state = {}

    def refined():
        x, outer, inner, rel = grm_cg_solve_refined(
            gm, b, lam=lam, tol=1e-10)
        state.update(outer=outer, inner=inner, rel=float(rel.max()))

    per = _wall_median(refined, reps, dev)
    per_f32 = _wall_median(lambda: grm_cg_solve(
        gm, np.asarray(b, np.float32), lam=lam, tol=1e-4).x.cpu(), reps, dev)
    return {
        "suite": "solve_refined",
        "panel": panel,
        "config": f"{snps}x{indiv} (G + {lam} I) x = b, tol 1e-10",
        "wall_seconds_per_solve": round(per, 4),
        "outer_iters": state.get("outer"),
        "inner_iters": state.get("inner"),
        "true_f64_rel_residual": state.get("rel"),
        "f32_cg_wall_s": round(per_f32, 4),
        "slowdown_vs_f32_cg": round(per / max(per_f32, 1e-12), 2),
    }


def bench_gwas(panel: str = "medium", reps: int = 3, *, device=None) -> dict:
    """Whole-panel GWAS linear scan WALL time (3 packed passes + host
    epilogue)."""
    from .gblup import simulate_phenotypes
    from .geno import from_dense
    from .gwas import gwas_linear
    from .io import bed

    dev = _device(device)
    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g, device=dev)
    y, _ = simulate_phenotypes(g, h2=0.5, seed=1)
    cov = np.random.default_rng(2).standard_normal((indiv, 3))

    per = _wall_median(lambda: gwas_linear(gm, y, covariates=cov), reps, dev)
    return {
        "suite": "gwas",
        "panel": panel,
        "config": f"{snps}x{indiv} linear scan, 3 covariates",
        "wall_seconds_per_scan": round(per, 4),
        "snps_per_s": snps / per,
    }


def bench_grm(panel: str, iters: int = 8, comparator: bool = False, *,
              device=None) -> dict:
    """Raw integer crossproduct (GRM direction) throughput; the comparator
    is one f32 ``d @ d.T`` of the decoded panel (TF32 off)."""
    from .io import bed, codec
    from .ops.grm import packed_crossprod
    from .solve.sparse import _full_f32

    dev = _device(device)
    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    zq = torch.from_numpy(codec.pack_planar16(g, row_mult=512).view(
        np.int32)).to(dev)
    peaks = device_peaks(dev)

    stats = {}
    per = _timed_scan_zq(lambda z: packed_crossprod(z), zq, iters,
                         stats=stats)
    # device work is the upper triangle; report both conventions
    full_ops = 2.0 * indiv * indiv * snps
    out = {
        "suite": "grm",
        "panel": panel,
        "config": f"{snps}x{indiv} ZZ^T int8",
        "seconds_per_call": round(per, 6),
        "snp_indiv2_ops_per_s": full_ops / per,
        "mxu_utilization_triangle": _share((full_ops / 2) / per, peaks,
                                           "int8"),
        "snps_per_s": round(snps / per, 1),
        **stats,
    }
    if peaks is not None and (full_ops / 2) / per > peaks["int8"]:
        out["roofline_warning"] = True
    if comparator and g.size * 4 <= 4e9:
        dense = _f32_tensor(np.where(g == 3, 0, g), dev)
        with _full_f32():
            per_dense = _timed_scan_zq(lambda d: d @ d.T, dense,
                                       max(2, iters // 2))
        out["comparator_dense_xla_s"] = round(per_dense, 6)
        out["speedup_vs_dense"] = round(
            out["comparator_dense_xla_s"] / per, 2)
    return out


def ref_panel_words(device) -> torch.Tensor:
    """The ``ref_many_snps`` panel's words, built on ``device``: REF_PANEL's
    real rows of :func:`hash_chunk_words` chunks side by side, zero rows
    padding them to ``rows_pad``."""
    rows, rows_pad, kw, chunk = (REF_PANEL[k] for k in (
        "rows", "rows_pad", "kw", "chunk"))
    zq = torch.zeros((rows_pad, kw), dtype=torch.int32, device=device)
    for i in range(kw // chunk):
        zq[:rows, i * chunk:(i + 1) * chunk] = hash_chunk_words(
            i, rows, chunk, device)
    return zq


def bench_grm_ref_panel(iters: int = 2, *, device=None) -> dict:
    """The reference's flagship GRM benchmark: 1M SNPs x 21,000 individuals
    (utils/genotype_simulation_plink/Makefile:1-9, benchmarked there against
    PLINK --make-rel / GCTA).  The packed words are generated on the card
    (:func:`ref_panel_words`), the real row count 21,248 zero-padded to
    21,504, and the timed op is ONE production ``packed_crossprod`` call
    over the whole K axis."""
    from .ops.grm import packed_crossprod

    dev = _device(device)
    rows, rows_pad, kw = (REF_PANEL[k] for k in ("rows", "rows_pad", "kw"))
    full_ops = 2.0 * rows * rows * 16 * kw
    zq = ref_panel_words(dev)
    peaks = device_peaks(dev)

    stats = {}
    per = _timed_scan_zq(lambda z: packed_crossprod(z), zq, iters,
                         stats=stats)
    out = {
        "suite": "grm",
        "panel": "ref_many_snps",
        "config": f"{16 * kw}x{rows} ZZ^T int8 (padded {rows_pad}), "
                  "single-call K grid, on-device gen",
        "seconds_per_call": round(per, 3),
        "snp_indiv2_ops_per_s": full_ops / per,
        "mxu_utilization_triangle": _share((full_ops / 2) / per, peaks,
                                           "int8"),
        **stats,
    }
    if peaks is not None and (full_ops / 2) / per > peaks["int8"]:
        out["roofline_warning"] = True
    return out


def bench_ld(panel: str, iters: int = 4, *, device=None) -> dict:
    """Full LD pipeline (crossproduct + centering + sigma-normalize), the
    reference's LD suite role (benchmark_suite.jl:40, vs plink --r).  Only
    panels whose [snps, snps] f32 output fits one card are timed (larger
    SNP counts go through ops.grm.ld_blocked out-of-core)."""
    from .geno import from_dense
    from .io import bed
    from .ops.grm import ld

    dev = _device(device)
    p = PANELS[panel]
    snps, indiv = p["snps"], p["indiv"]
    if snps * snps * 4 > 8e9:
        return {"suite": "ld", "panel": panel,
                "skipped": "snps^2 f32 output exceeds single-chip HBM; "
                           "use ops.grm.ld_blocked"}
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g, device=dev)

    per = _timed_scan_zq(lambda gmx: ld(gmx), gm, iters)
    return {
        "suite": "ld",
        "panel": panel,
        "config": f"{snps}x{indiv} LD r (centered, normalized)",
        "seconds_per_call": round(per, 6),
        "snp_pairs_per_s": snps * snps / per,
    }


def bench_sparse_solve(n: int = 1_000_000, avg_offdiag: int = 9,
                       ncol: int = 12, iters: int = 4, *,
                       device=None) -> dict:
    """Sparse triangular L Lᵀ x = B solve throughput — the reference's
    sparse-solve benchmark (utils/benchmark/sparse_solve.jl: cuSPARSE SpSM
    vs Pardiso on a Cholesky COO factor, ncol=12).  The factor is a
    simulated pedigree-shaped lower triangle (~``avg_offdiag`` off-diagonal
    entries per row); the solver is the blocked O(nnz) substitution."""
    from .solve.sparse import SparseTriangularSolver, simulate_pedigree_factor

    dev = _device(device)
    r, c, v = simulate_pedigree_factor(n, avg_offdiag=avg_offdiag,
                                       bandwidth=max(n // 16, 1), seed=0)
    t0 = time.perf_counter()
    slv = SparseTriangularSolver(r, c, v, n, dtype=torch.float32, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    b = _f32_tensor(rng.standard_normal((n, ncol)), dev)

    per = _timed_scan_b(lambda s, bc: s.solve_lltx(bc), slv, b, iters)
    # honesty check: O(nnz) residual of the last solve
    x = slv.solve_lltx(b)
    resid = float(torch.linalg.norm(slv.matvec(slv.matvec(x, trans="t")) - b)
                  / torch.linalg.norm(b))
    # f64-grade mixed-precision refinement (reference parity: cuSPARSE
    # solves in true f64): exact host residuals + device substitutions
    # until <= 1e-12 relative
    t0 = time.perf_counter()
    _, rel64 = slv.solve_lltx_f64(b.cpu().numpy().astype(np.float64),
                                  tol=1e-12)
    f64_s = time.perf_counter() - t0
    return {
        "suite": "sparse_solve",
        "config": f"LL^T x=B, n={n}, nnz={slv.nnz}, ncol={ncol}, "
                  f"bs={slv.bs}, f32",
        "init_analysis_s": round(init_s, 3),
        "seconds_per_solve": round(per, 6),
        "nnz_per_s": round(2 * slv.nnz * ncol / per, 1),
        "rel_residual": resid,
        "f64_grade_rel_residual": float(rel64),
        "f64_grade_seconds": round(f64_s, 3),
    }


def bench_ssgblup(n_anim: int = 200_000, n_geno: int = 20_000,
                  snps: int = 65_536, reps: int = 3, *, device=None) -> dict:
    """Single-step GBLUP at production pedigree scale: WALL time of the MME
    solve (nested CGs on the card) plus the host-side set-up splits (the
    pedigree simulation, the H^-1 operator with A^-1).  The reference
    ecosystem runs this workload as MiXBLUP calling the sparse solver +
    packed GEMM."""
    from . import pedigree as ped
    from . import ssgblup as ssb
    from .geno import from_dense
    from .io import bed

    dev = _device(device)
    t0 = time.perf_counter()
    sire, dam = ped.simulate_pedigree(n_anim, n_founders=n_anim // 100,
                                      seed=3)
    t_ped = time.perf_counter() - t0
    geno_ids = np.arange(n_anim - n_geno, n_anim) + 1
    g = bed.simulate_genotypes(n_geno, snps, seed=11)
    gm = from_dense(g, device=dev)
    rng = np.random.default_rng(1)
    obs_ids = np.arange(1, n_anim - n_geno + 1)
    y = 2.0 + rng.standard_normal(len(obs_ids))

    # deep random pedigrees make exact Meuwissen-Luo ancestor sets explode;
    # production benchmarking uses classical rules (f = 0)
    t0 = time.perf_counter()
    hinv = ssb.SingleStepHInv(sire, dam, gm, geno_ids, blend=0.05,
                              f=np.zeros(n_anim))
    _sync(dev)
    t_init = time.perf_counter() - t0
    state = {}

    def solve():
        r = ssb.ssgblup(y, hinv, obs_ids=obs_ids, h2=0.4, tol=1e-5,
                        maxiter=500)
        state.update(iters=int(r.iterations), resid=float(r.residual_norm))

    per = _wall_median(solve, reps, dev)
    return {
        "suite": "ssgblup",
        "config": f"{n_anim} animals, {n_geno} genotyped x {snps} SNPs, "
                  f"phenotypes on the non-genotyped",
        "wall_seconds_per_solve": round(per, 3),
        "outer_cg_iterations": state.get("iters"),
        "residual": state.get("resid"),
        "init_seconds": round(t_init, 2),
        "pedigree_sim_seconds": round(t_ped, 2),
    }


def _hash_u32(x: int) -> int:
    """The chunk generator's splitmix-style avalanche on one uint32."""
    x &= _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _int32(x: int) -> int:
    """A uint32's bits as an int32 value."""
    return x - (1 << 32) if x >> 31 else x


def hash_chunk_words(c: int, indiv: int, kw_chunk: int,
                     device) -> torch.Tensor:
    """Chunk ``c`` of the counter-hashed panel: int32 words [indiv,
    kw_chunk] (planar16 over the chunk's SNPs), every 2-bit field in
    {0, 1, 2}, bit for bit the reference's generator in uint32 arithmetic.
    Word (i, k) hashes its counter i * kw_chunk + k xor the chunk's salt
    (``c`` folded through the hash, so no chunk replays another's stream).
    The uint32 steps run in place on two int32 buffers: products wrap to
    the same low 32 bits, and each right shift is masked to be logical."""
    n = indiv * kw_chunk
    if n > 2 ** 31:
        raise ValueError(f"a chunk of {indiv} x {kw_chunk} words overruns "
                         f"its int32 counter")
    salt = _hash_u32(c * 0x9E3779B9 + 1)
    x = torch.arange(n, dtype=torch.int32, device=device)
    t = torch.empty_like(x)
    x ^= _int32(salt)
    for shift, mult in ((16, 0x7FEB352D), (15, 0x846CA68B), (16, None)):
        torch.bitwise_right_shift(x, shift, out=t)
        t &= (1 << (32 - shift)) - 1
        x ^= t
        if mult is not None:
            x *= _int32(mult)
    # a = r & 0x55..., b = (r >> 1) & 0x55...; words = ((b & ~a) << 1) |
    # (a & ~b), with s = a ^ b: a & ~b = a & s and b & ~a = s ^ (a & s)
    torch.bitwise_and(x, 0x55555555, out=t)      # a
    x.bitwise_right_shift_(1)
    x &= 0x55555555                              # b
    x ^= t                                       # s
    t &= x                                       # a & ~b
    x ^= t                                       # b & ~a
    x.bitwise_left_shift_(1)
    x |= t
    return x.view(indiv, kw_chunk)


def bench_gblup_fullscale(snps: int = 1_048_576, indiv: int = 100_096,
                          chunks: int = 16, h2: float = 0.5,
                          tol: float = 1e-3, maxiter: int = 60, *,
                          device=None) -> dict:
    """BASELINE config 5 at full scale: GBLUP CG on ~1M SNPs x 100K
    individuals, ENTIRELY on one card.

    The packed panel (2 x 25 GB for both orientations) is never stored:
    the SNP axis is chunked and each chunk's words are REGENERATED on the
    card by :func:`hash_chunk_words` whenever the matvec touches them (one
    chunk, 1.64 GB at the default sizes, alive at a time), which keeps the
    whole CG on the card with no host<->device traffic but the CG's stop
    test.  The .bed-backed equivalent is ``cli gblup --stream-chunk``
    (StreamedGeno).

    Single matvec = tall 't' pass + wide 'n' pass per chunk with exact 2f
    centering, i.e. (Zc Zcᵀ)x accumulated over chunks.
    """
    from .ops.dgemm import packed_matmul, packed_matmul_tall
    from .solve.cg import cg

    dev = _device(device)
    if snps % chunks:
        raise ValueError("snps must divide into chunks")
    chunk_snps = snps // chunks
    kw_chunk = chunk_snps // 16
    lam = (1.0 - h2) / h2

    def gen_chunk(c):
        return hash_chunk_words(c, indiv, kw_chunk, dev)

    def compute_freq():
        ones = torch.ones((indiv, 1), dtype=torch.float32, device=dev)
        sums = torch.cat([packed_matmul_tall(gen_chunk(c), ones)[:, 0]
                          for c in range(chunks)])
        return sums / (2.0 * indiv)

    freq = compute_freq()

    def matvec(freqv, lam_s2, x):
        ones_x = torch.sum(x, dim=0)
        y = torch.zeros_like(x)
        for c in range(chunks):
            zq = gen_chunk(c)
            u = packed_matmul_tall(zq, x)                  # Z_ckᵀ x
            f_ck = freqv[c * chunk_snps:(c + 1) * chunk_snps]
            uc = u[:chunk_snps] - 2.0 * f_ck[:, None] * ones_x[None, :]
            y2 = packed_matmul(zq, uc)[:indiv]             # Z_ck uc
            corr = (2.0 * f_ck) @ uc
            del zq          # freed before the next chunk is generated
            y = y + y2 - corr[None, :]
        return y + lam_s2 * x

    def solve(freqv, y):
        s2 = 2.0 * torch.sum(freqv * (1.0 - freqv))
        res = cg(lambda v: matvec(freqv, lam * s2, v), y,
                 tol=tol * float(torch.linalg.norm(y)), maxiter=maxiter)
        return res.x, res.iterations, res.residual_norm

    rng = np.random.default_rng(0)
    y = _f32_tensor(rng.standard_normal((indiv, 1)), dev)

    t0 = time.perf_counter()
    solve(freq, y)
    _sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, iters, resid = solve(freq, y)
    _sync(dev)
    wall = time.perf_counter() - t0
    rel = float(resid[0]) / float(torch.linalg.norm(y))
    return {
        "suite": "gblup_fullscale",
        "config": f"{snps}x{indiv} GBLUP CG on-device, h2={h2}, "
                  f"{chunks} regenerated chunks, ncol=1",
        "cg_iterations": int(iters),
        "rel_residual": rel,
        "wall_s": round(wall, 2),
        "compile_plus_first_run_s": round(first_s, 2),
        "converged": bool(rel <= tol * 1.5),
    }


def bench_scaling(n_devices: Optional[int] = None, snps: int = 131072,
                  indiv: int = 1024, ncol: int = 8, *, device=None) -> dict:
    """SNP-sharded dgemm scaling efficiency across ``n_devices`` shards
    (default: one per visible card, or 1 on the CPU), against one shard.
    With one card this is the one-shard row (``scaling_efficiency`` None);
    on the CPU the shards are CPU shards."""
    from .io import bed
    from .parallel.sharded import mesh_on, shard_genotypes, sharded_dgemm

    dev = _device(device)
    d = n_devices or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    rng = np.random.default_rng(0)
    b = _f32_tensor(rng.standard_normal((snps, ncol)), dev)

    results = {}
    for nd in sorted({1, d}):
        mesh = mesh_on(nd, dev)
        sg = shard_genotypes(g, mesh)
        results[nd] = _timed_scan_b(
            lambda s, bc, m=mesh: sharded_dgemm(s, bc, trans="n", mesh=m),
            sg, b, iters=8)
    eff = None
    if d > 1:
        eff = results[1] / (results[d] * d)
    return {
        "suite": "scaling",
        "devices": d,
        "config": f"{snps}x{indiv} ncol={ncol} sharded 'n'",
        "t_1dev_s": round(results[1], 6),
        f"t_{d}dev_s": round(results[d], 6),
        "scaling_efficiency": round(eff, 3) if eff is not None else None,
    }


def bench_ld_banded(snps: int = 1_048_576, indiv: int = 512,
                    window: int = 512, reps: int = 3, *,
                    device=None) -> dict:
    """Banded LD family at the 1M-SNP scale it was built for: wall times for
    ld_windowed (the O(snps·window) band), ld_score (gcta --ld-score role)
    and ld_prune (plink --indep-pairwise role), medians after a warm-up
    rep."""
    from .geno import from_dense
    from .io import bed
    from .ops.grm import ld_prune, ld_score, ld_windowed

    dev = _device(device)
    g = bed.simulate_genotypes(indiv, snps, seed=0)
    gm = from_dense(g, device=dev)

    tw = _wall_median(lambda: ld_windowed(gm, window), reps, dev)
    ts = _wall_median(lambda: ld_score(gm, window=window), reps, dev)
    tp = _wall_median(lambda: ld_prune(gm, window=window, r2_threshold=0.2),
                      reps, dev)
    return {
        "suite": "ld_banded",
        "config": f"{snps}x{indiv}, window={window}",
        "ld_windowed_s": round(tw, 3),
        "ld_score_s": round(ts, 3),
        "ld_prune_s": round(tp, 3),
        "snps_per_s_windowed": round(snps / tw, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="miraculix_tpu_torch.benchmark")
    ap.add_argument("--suite", default="all",
                    choices=["dgemm", "dgemm_exact", "grm", "ld", "ld_banded",
                             "sparse_solve", "solve_refined", "gwas",
                             "ssgblup", "gblup_fullscale", "scaling",
                             "all"])
    ap.add_argument("--panels", nargs="*", default=["small"])
    ap.add_argument("--ncol", type=int, default=32)
    ap.add_argument("--sparse-n", type=int, default=1_000_000)
    ap.add_argument("--comparator", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the panels go and compute (default: the "
                         "CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def emit(row):
        print(json.dumps(row), flush=True)

    if args.suite in ("dgemm", "all"):
        for p in args.panels:
            if p not in PANELS:
                continue  # grm-only panel names (e.g. ref_many_snps)
            emit(bench_dgemm(p, ncol=args.ncol, comparator=args.comparator,
                             device=dev))
    if args.suite in ("grm", "all"):
        for p in args.panels:
            if p == "ref_many_snps":
                emit(bench_grm_ref_panel(device=dev))
            else:
                emit(bench_grm(p, comparator=args.comparator, device=dev))
    if args.suite in ("ld", "all"):
        for p in args.panels:
            if p in PANELS:
                emit(bench_ld(p, device=dev))
    if args.suite == "ld_banded":
        emit(bench_ld_banded(device=dev))
    if args.suite == "dgemm_exact":
        for p in args.panels:
            if p in PANELS:
                emit(bench_dgemm_exact(p, ncol=args.ncol, device=dev))
    if args.suite == "sparse_solve":
        emit(bench_sparse_solve(n=args.sparse_n, device=dev))
    if args.suite == "solve_refined":
        for p in args.panels:
            if p in PANELS:
                emit(bench_solve_refined(p, device=dev))
    if args.suite == "gwas":
        for p in args.panels:
            if p in PANELS:
                emit(bench_gwas(p, device=dev))
    if args.suite == "ssgblup":
        emit(bench_ssgblup(device=dev))
    if args.suite == "gblup_fullscale":
        emit(bench_gblup_fullscale(device=dev))
    if args.suite in ("scaling", "all"):
        emit(bench_scaling(device=dev))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

"""Drive the PyTorch/CUDA port once on one GPU, through its kernels.

    python3 chip_smoke.py

Builds the CUDA kernels of ``miraculix_tpu_torch/csrc`` and

1. holds each kernel against its plain torch version on the ``many_indiv``
   panel (65,536 SNPs x 16,384 animals), 'n' and 't', at the shapes the
   main paths launch: the tall dgemm kernel in its split mode with and
   without the fused center vector and in its bf16 and f32 modes (max error
   <= 1e-5 of max |plain|), the wide dgemm kernel in its four RHS instances
   (fast split, f32, bf16, bf16 hi||lo; error <= 4e-6 of each output's sum
   of |terms|), each against a plain version that rounds
   B the same way, and the integer crossproduct (exactly equal).  Each
   dgemm check also reads a control, the plain product at the other grade
   (bf16(B) against B), which must exceed the limit under the same metric.
   Each kernel is timed beside its plain version, one PyTorch library call
   on the pre-decoded panel, and its bound on the card;
2. runs the main GBLUP path at that size from the launch counters' zero:
   simulate -> write .bed -> ``from_bed`` on the GPU -> ``grm`` (diagonal
   checked against ``grm_diag``) -> simulated phenotypes -> ``gblup`` (CG
   converged, g_hat correlated with the true breeding values);
3. runs the main GWAS path on the same panel from the counters' zero:
   ``gwas_linear`` (checked against float64 regressions on 256 SNPs),
   ``gwas_logistic``, ``gwas_mixed`` (65 CG columns: the wide kernel) and
   ``gwas_mixed_loco`` over 4 chromosomes, each with finite statistics and
   the simulated QTL enriched >= 10x in median chi2;
4. runs the bf16/f32 tiers from the counters' zero: ``grm_cg_solve`` at
   both tiers, wide and tall, and ``packed_matmul`` at 32 columns;
5. checks the GPU pipeline against the port's CPU path on a small panel
   (GBLUP, GRM and the four scans).

Earlier lines report per-phase seconds, errors, launch counts, the card's
name and power limit, and one JSON object of kernel results; the last line
is ``{"ok": true, "device": {...}}``.  Any failed check exits nonzero and
prints no result line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

N_SNPS, N_INDIV = 65536, 16384   # miraculix_tpu/benchmark.py "many_indiv"
SEED = 0
KERNEL_RTOL = 1e-5    # tall kernel vs plain, relative to max |plain|
# wide kernel vs plain, relative to each output's sum of |terms|: on the
# H100 the sound instances read <= 4.2e-7 and the other-grade controls
# >= 5.3e-5 at 'n' (65,536 terms), so the limit sits ~10x from each
WIDE_RTOL = 4e-6
DIAG_RTOL = 1e-4      # grm() diagonal vs grm_diag(scale=True)
MIN_BV_CORR = 0.7     # corr(g_hat, true BV), in-sample, h2 = 0.5
SMALL_RTOL = 1e-3     # GPU vs CPU path on the small panel
LINEAR_RTOL = 1e-4    # gwas_linear vs f64 regressions, relative to max |x|
QTL_ENRICH = 10.0     # median chi2 over the QTL / median over all SNPs
GWAS_TOL, GWAS_MAXITER = 1e-2, 300   # absolute CG residual norm (|rhs| ~ 1e2)
N_QTL = 100           # gblup.simulate_phenotypes' default

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 and
# int8 tensor cores, and HBM; a kernel's bound is the larger of ops/peak
# and bytes/rate.
PEAK = {"bf16": 989e12, "int8": 1979e12}
HBM_RATE = 3.35e12

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
}
# the unit and passes that bound each kernel: one rule for the products,
# the bf16 tensor-core passes that the tier's grade needs (genotypes are
# exact in bf16; B takes one bf16 piece at the bf16 tier, hi + lo at the
# split tier, three pieces for its 24 bits at the f32 tier).  The split and
# f32 names are one kernel instance (B as given) at two tiers' bounds.
UNIT = {"tall_dgemm": ("bf16", 2), "tall_dgemm_cv": ("bf16", 2),
        "tall_dgemm_bf16": ("bf16", 1), "tall_dgemm_f32": ("bf16", 3),
        "wide_dgemm_split": ("bf16", 2), "wide_dgemm_hilo": ("bf16", 2),
        "wide_dgemm_bf16": ("bf16", 1), "wide_dgemm_f32": ("bf16", 3),
        "crossprod": ("int8", 1)}


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(name: str, macs: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for ``macs``
    multiply-adds and ``nbytes`` moved once."""
    unit, passes = UNIT[name]
    t_ops = 2.0 * macs * passes / PEAK[unit]
    t_bytes = nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def median_chi2_ratio(chi2, qtl) -> float:
    import numpy as np

    return float(np.median(chi2[qtl]) / np.median(chi2))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    from miraculix_tpu_torch import _kernels, gblup
    from miraculix_tpu_torch import (from_bed, from_dense, grm, grm_cg_solve,
                                     grm_diag, gwas_linear, gwas_logistic,
                                     gwas_mixed, gwas_mixed_loco,
                                     packed_crossprod, packed_matmul)
    from miraculix_tpu_torch.io import bed
    from miraculix_tpu_torch.ops.common import decode_planar16
    from miraculix_tpu_torch.ops.dgemm import (packed_matmul_plain,
                                               packed_matmul_tall,
                                               packed_matmul_tall_plain)
    from miraculix_tpu_torch.ops.grm import packed_crossprod_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # plain products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and bool(smi.stdout.strip()),
          "nvidia-smi did not report the card")
    log(smi.stdout.strip().splitlines()[0])   # name, power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

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

    t0 = time.perf_counter()
    lib = _kernels.build()
    log(f"phase build: {time.perf_counter() - t0:.3f} s -> {lib}")
    for ln in (lib.parent / "build.log").read_text().splitlines():
        if "Used" in ln or ("spill" in ln and not ln.strip().startswith("0")):
            log(f"  ptxas: {ln.strip()}")

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
        other grade) must read above the limit under the same metric."""
        tol = KERNEL_RTOL if scale is None else WIDE_RTOL

        def metric(x):
            diff = (x - want).abs()
            if scale is None:
                return float(diff.max()) / float(want.abs().max())
            zero = torch.zeros((), device=diff.device)
            return float(torch.where(scale > 0, diff / scale,
                                     torch.where(diff > 0, torch.inf,
                                                 zero)).max())
        err = float((got - want).abs().max())
        rel, crel = metric(got), metric(control)
        log(f"check {name} {label}: max_abs_err={err:.6g} rel={rel:.3g} "
            f"(limit {tol:g}; other-grade control {crel:.3g})")
        if not (bool(torch.isfinite(got).all()) and got.shape == want.shape
                and rel <= tol < crel):
            disagree.append(f"{name} {label}")
        record(name, err)

    def timings(name, label, kernel, plain, library, macs, nbytes, reps):
        ms = event_ms(kernel, reps)
        pms = event_ms(plain, 2)
        lms = event_ms(library, 3) if library is not None else None
        bms, by = bound(name, macs, nbytes)
        log(f"time {name} {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"library {'n/a' if lms is None else f'{lms:.4f} ms'}, "
            f"bound {bms:.4f} ms ({by})")
        return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": lms}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "panel.bed")
        t0 = time.perf_counter()
        bed.write_bed(path, geno)
        log(f"phase write_bed (host): {time.perf_counter() - t0:.3f} s")

        # -- 1. each kernel against its plain version ----------------------
        gm, secs = sync_time(lambda: from_bed(path, device=dev))
        log(f"phase from_bed(device=cuda) (host pack + upload): {secs:.3f} s")
        rng = np.random.default_rng(SEED)

        def randn(rows, n):
            return torch.as_tensor(rng.standard_normal((rows, n)),
                                   dtype=torch.float32, device=dev)

        # tall schedule: zq_t for 'n' (contract = SNPs), zq_n for 't'
        orient = {"n": (gm.zq_t, N_SNPS), "t": (gm.zq_n, N_INDIV)}
        for trans in ("n", "t"):
            zq, contract = orient[trans]
            dec = decode_planar16(zq[:contract], torch.float32)  # library's
            ones = torch.ones(contract, device=dev)
            cvs = {"n": 2.0 * gm.freq, "t": ones}
            for ncol in (32, 1, 128):
                cases = []
                if ncol <= 64:   # the split mode's widths (the fast tier)
                    cases += [("tall_dgemm_cv", "centered", cvs[trans],
                               "split"),
                              ("tall_dgemm", "uncentered", None, "split")]
                if trans == "n" or ncol == 32:
                    cases += [("tall_dgemm_bf16", "", None, "bf16"),
                              ("tall_dgemm_f32", "", None, "f32")]
                for name, label, cv, mode in cases:
                    b = randn(contract, ncol)
                    tag = f"{trans} {label} ncol={ncol}".replace("  ", " ")
                    got = packed_matmul_tall(zq, b, cv, mode=mode)
                    want = packed_matmul_tall_plain(zq, b, cv, mode=mode)
                    control = packed_matmul_tall_plain(
                        zq, b, mode="f32" if mode == "bf16" else "bf16")
                    if cv is None:
                        compare(name, tag + " c", got, want, control)
                    else:
                        compare(name, tag + " c", got[0], want[0], control)
                        # v = cv.b; its control rounds B to bf16
                        compare(name, tag + " v", got[1], want[1],
                                (cvs[trans] @ b.to(torch.bfloat16)
                                 .to(torch.float32)))
                    del got, want, control
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
            ("wide_dgemm_split", "t", 65, dict()),
            ("wide_dgemm_f32", "t", 130, dict(split=False)),
            ("wide_dgemm_bf16", "t", 130, dict(single_bf16=True)),
        ]
        for trans in ("n", "t"):
            zq, cols = wide_orient[trans]
            dec = decode_planar16(zq, torch.float32)[:, :cols]  # library's
            for name, tr, ncol, opts in wide_cases:
                if tr != trans:
                    continue
                b = randn(cols, ncol)
                tag = f"{trans} ncol={ncol}"
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
                rhs = name.rsplit("_", 1)[1]
                if rhs == "f32" or rhs == "split":
                    lib_fn = (lambda d=dec, bw=b: d @ bw)
                else:
                    dbf = dec.to(torch.bfloat16)
                    bw = b.to(torch.bfloat16)
                    if rhs == "hilo":
                        lo = (b - bw.to(torch.float32)).to(torch.bfloat16)
                        bw = torch.cat([bw, lo], dim=1)
                    lib_fn = (lambda d=dbf, bw=bw: d @ bw)
                t = timings(name, tag, lambda: packed_matmul(zq, b, **opts),
                            lambda: packed_matmul_plain(zq, b, **opts),
                            lib_fn, zq.shape[0] * cols * ncol,
                            4 * (zq.numel() + cols * ncol
                                 + zq.shape[0] * ncol), 3 if ncol > 128
                            else 10)
                if "ms" not in results[name]:
                    record(name, 0.0, t)
                lib_fn = None
            del dec
            torch.cuda.empty_cache()

        check(not disagree, f"kernels disagree with their plain versions "
              f"(or a control reads within the limit): {disagree}")
        got = packed_crossprod(gm.zq_n)
        want = packed_crossprod_plain(gm.zq_n)
        equal = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        log(f"check crossprod {tuple(got.shape)}: equal={equal} "
            f"max_abs_err={err}")
        check(equal, "crossprod differs from the plain f64 product")
        del got, want
        torch.cuda.empty_cache()
        d8 = decode_planar16(gm.zq_n, torch.int8)
        rows, kw = gm.zq_n.shape
        t = timings("crossprod", f"rows={rows}",
                    lambda: packed_crossprod(gm.zq_n),
                    lambda: packed_crossprod_plain(gm.zq_n),
                    lambda: torch._int_mm(d8, d8.T),
                    rows * (rows + 1) / 2 * 16 * kw,
                    4 * (gm.zq_n.numel() + rows * rows), 3)
        record("crossprod", 0.0, t)
        del d8, gm
        torch.cuda.empty_cache()

        # -- 2. the main GBLUP path, counted -------------------------------
        launches = {k: 0 for k in _kernels.LAUNCHES}

        def take_counts(phase):
            counts = dict(_kernels.LAUNCHES)
            log(f"launches on the main {phase} path: "
                f"{ {k: v for k, v in counts.items() if v} }")
            for k, v in counts.items():
                launches[k] += v
            return counts

        _kernels.reset_launch_counts()
        gm, secs = sync_time(lambda: from_bed(path))   # the default device
        check(gm.device.type == "cuda", "from_bed did not default to the card")
    log(f"phase main from_bed: {secs:.3f} s")
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

    # -- 3. the main GWAS path, counted ------------------------------------
    qtl = np.random.default_rng(SEED).choice(N_SNPS, size=N_QTL,
                                             replace=False)
    grng = np.random.default_rng(SEED + 2)
    cov = grng.standard_normal((N_INDIV, 3))
    yb = (y > np.median(y)).astype(np.float64)
    chrom = np.repeat(np.arange(4), N_SNPS // 4)
    _kernels.reset_launch_counts()
    scans = {}
    per_scan = {}
    for name, fn in (
            ("gwas_linear", lambda: gwas_linear(gm, y, covariates=cov)),
            ("gwas_logistic", lambda: gwas_logistic(gm, yb, covariates=cov)),
            ("gwas_mixed", lambda: gwas_mixed(
                gm, y, covariates=cov, n_gamma_snps=64, tol=GWAS_TOL,
                maxiter=GWAS_MAXITER)),
            ("gwas_mixed_loco", lambda: gwas_mixed_loco(
                gm, y, chrom, covariates=cov, n_gamma_snps=32, tol=GWAS_TOL,
                maxiter=GWAS_MAXITER))):
        before = dict(_kernels.LAUNCHES)
        scans[name], secs = sync_time(fn)
        per_scan[name] = {k: v - before[k] for k, v in
                          _kernels.LAUNCHES.items() if v - before[k]}
        r = scans[name]
        extra = ""
        if hasattr(r, "gamma"):
            extra = (f" gamma={r.gamma:.6g} cg_iterations={r.cg_iterations}"
                     f" residual_norm={np.array2string(r.residual_norm)}")
        log(f"phase main {name}: {secs:.3f} s{extra} launches="
            f"{per_scan[name]}")
    take_counts("gwas")
    check(per_scan["gwas_mixed"].get("wide_dgemm_split", 0) > 0,
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
    del gm, geno, c32, b32
    torch.cuda.empty_cache()
    missing = [k for k in SOURCES if launches[k] == 0]
    check(not missing, f"never launched on a main path: {missing}")

    # -- 5. GPU vs CPU path on a small panel -----------------------------
    small = bed.simulate_genotypes(600, 5000, seed=SEED + 1)
    ys, _ = gblup.simulate_phenotypes(small, h2=0.5, seed=SEED + 1)
    ysb = (ys > np.median(ys)).astype(np.float64)
    covs = np.random.default_rng(SEED + 4).standard_normal((600, 3))
    chroms = np.repeat(np.arange(4), 1250)
    fits = {}
    for d in ("cpu", dev):
        gs = from_dense(small, device=d)
        fits[str(d)] = {
            "fitted": gblup.gblup(gs, ys, h2=0.5, n_pcs=3, tol=1e-5).fitted,
            "grm": grm(gs).cpu().numpy(),
            "linear": gwas_linear(gs, ys, covariates=covs).t,
            "logistic": gwas_logistic(gs, ysb, covariates=covs).t,
            "mixed": gwas_mixed(gs, ys, covariates=covs, tol=1e-4).chi2,
            "loco": gwas_mixed_loco(gs, ys, chroms, covariates=covs,
                                    tol=1e-4).chi2}
    fc, fg = fits["cpu"], fits[str(dev)]
    err_grm = float(np.abs(fg["grm"] - fc["grm"]).max())
    rels = {k: float(np.abs(fg[k] - fc[k]).max() / np.abs(fc[k]).max())
            for k in fc if k != "grm"}
    log(f"check small panel GPU vs CPU: grm max_abs={err_grm:.3g} "
        + " ".join(f"{k} rel={v:.3g}" for k, v in rels.items()))
    check(err_grm <= 1e-5 and all(v <= SMALL_RTOL for v in rels.values()),
          "GPU pipeline disagrees with the CPU path on the small panel")

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k],
                **{f: results[k].get(f) for f in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for k, (src, rep) in SOURCES.items()]
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

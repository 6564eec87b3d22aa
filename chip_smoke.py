"""Drive the PyTorch/CUDA port once on one GPU, through its kernels.

    python3 chip_smoke.py

Builds the CUDA kernels of ``miraculix_tpu_torch/csrc`` and

1. holds each kernel against its plain torch version on the ``many_indiv``
   panel (65,536 SNPs x 16,384 animals), 'n' and 't', at the shapes the
   main paths launch: the tall dgemm kernel in its split mode with and
   without the fused center vector and in its bf16 and f32 modes (max error
   <= 1e-5 of max |plain|), the wide dgemm kernel in its four RHS instances
   (fast split, f32, bf16, bf16 hi||lo; error <= 4e-6 of each output's sum
   of |terms|), each against a plain version that rounds B the same way,
   the integer crossproduct (exactly equal), the
   rectangular crossproduct at an LD row block and a ``grm_blocked`` tile
   and the masked-grid crossproduct on the whole square (exactly equal, the
   latter to K3 too), and the weighted crossproduct at the GCTA GRM's
   weights (error <= 4e-6 of each output).  Each dgemm and weighted check
   also reads a control, the plain product at the other grade (bf16(B)
   against B, bf16(w) against w), which must exceed the limit under the
   same metric.  Each kernel is timed beside its plain version, one PyTorch
   library call on the pre-decoded panel, and its bound on the card;
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
5. runs the LD family from the counters' zero on the panel with 8,192
   planted adjacent duplicate pairs: ``ld_windowed``, ``ld_score`` and
   ``ld_prune`` over 4 chromosomes at window 512, ``ld`` and ``ld_blocked``
   on the first chromosome (prune drops exactly one SNP of each pair; the
   scores, the band and the blocked matrix agree with ``ld``);
6. runs the GRM family at 16,384 animals from the counters' zero:
   ``grm_blocked`` against ``grm``, the masked-grid crossproduct against
   K3, ``grm_yang`` against its float64 definition on 256 rows;
7. checks the GPU pipeline against the port's CPU path on small panels
   (GBLUP, GRM, the four scans; the LD and GRM families on a panel with 2%
   missing genotypes).

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
LD_WINDOW, LD_R2 = 512, 0.2   # plink --indep-pairwise 512 ... 0.2
LD_BLOCK = 4096               # ld_windowed's row block: [4096, 4608] products

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
    "crossprod_rect": ("miraculix_tpu_torch/csrc/crossprod.cu",
                       "miraculix_tpu/ops/grm.py:71"),
    "crossprod_tri": ("miraculix_tpu_torch/csrc/crossprod.cu",
                      "miraculix_tpu/ops/grm.py:85"),
    "crossprod_weighted": ("miraculix_tpu_torch/csrc/crossprod_weighted.cu",
                           "miraculix_tpu/ops/grm.py:450"),
}
# the unit and passes that bound each kernel: one rule for the products,
# the bf16 tensor-core passes that the tier's grade needs (genotypes are
# exact in bf16; B takes one bf16 piece at the bf16 tier, hi + lo at the
# split tier, three pieces for its 24 bits at the f32 tier).  The split and
# f32 names are one kernel instance (B as given) at two tiers' bounds.  The
# integer crossproducts are one int8 pass; the weighted one is f32 grade.
UNIT = {"tall_dgemm": ("bf16", 2), "tall_dgemm_cv": ("bf16", 2),
        "tall_dgemm_bf16": ("bf16", 1), "tall_dgemm_f32": ("bf16", 3),
        "wide_dgemm_split": ("bf16", 2), "wide_dgemm_hilo": ("bf16", 2),
        "wide_dgemm_bf16": ("bf16", 1), "wide_dgemm_f32": ("bf16", 3),
        "crossprod": ("int8", 1), "crossprod_rect": ("int8", 1),
        "crossprod_tri": ("int8", 1), "crossprod_weighted": ("bf16", 3)}


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
    from miraculix_tpu_torch import (dominance_grm, from_bed, from_dense, grm,
                                     grm_blocked, grm_cg_solve, grm_diag,
                                     grm_yang, gwas_linear, gwas_logistic,
                                     gwas_mixed, gwas_mixed_loco, ld,
                                     ld_blocked, ld_prune, ld_score,
                                     ld_windowed, packed_crossprod,
                                     packed_crossprod_rect, packed_matmul,
                                     pairwise_nonmissing, subset_snps)
    from miraculix_tpu_torch.io import bed
    from miraculix_tpu_torch.ops.common import decode_planar16
    from miraculix_tpu_torch.ops.dgemm import (packed_matmul_plain,
                                               packed_matmul_tall,
                                               packed_matmul_tall_plain)
    from miraculix_tpu_torch.ops.grm import (_ld_prune_greedy,
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

        # B9 at grm_yang's weights: 1 / (2pq m); every term is >= 0, so the
        # sum of |terms| of each output is the output itself
        f64 = gm.freq.double()
        pq2 = 2.0 * f64 * (1.0 - f64)
        wy = torch.where(pq2 > 1e-12, 1.0 / (pq2 * float((pq2 > 1e-12).sum())),
                         torch.zeros_like(pq2)).float()
        got = packed_crossprod_weighted(zn, wy)
        want = packed_crossprod_weighted_plain(zn, wy)
        control = packed_crossprod_weighted_plain(
            zn, wy.to(torch.bfloat16).to(torch.float32))
        compare("crossprod_weighted", f"rows={rows}", got, want, control,
                scale=want)
        del got, want, control
        torch.cuda.empty_cache()
        dec = decode_planar16(zn, torch.float32)
        dw = dec * torch.cat([wy, torch.zeros(16 * kw - N_SNPS, device=dev)])
        record("crossprod_weighted", 0.0, timings(
            "crossprod_weighted", f"rows={rows}",
            lambda: packed_crossprod_weighted(zn, wy),
            lambda: packed_crossprod_weighted_plain(zn, wy),
            lambda: dw @ dec.T, tri_macs,
            4 * (zn.numel() + 16 * kw + rows * rows), 2))
        del dec, dw, gm, zn
        torch.cuda.empty_cache()
        check(not disagree, f"kernels disagree with their plain versions "
              f"(or a control reads within the limit): {disagree}")

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
    per_fn = {}   # function -> its launches on a main path

    def counted(name, fn):
        before = dict(_kernels.LAUNCHES)
        out, secs = sync_time(fn)
        per_fn[name] = {k: v - before[k] for k, v in
                        _kernels.LAUNCHES.items() if v - before[k]}
        log(f"phase main {name}: {secs:.3f} s launches={per_fn[name]}")
        return out

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
    keep = counted("ld_prune", lambda: ld_prune(
        gl, window=LD_WINDOW, r2_threshold=LD_R2, chrom=chrom))
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
    t0_scan = time.perf_counter()
    keep_scan = _ld_prune_greedy(offend, np.minimum(f, 1.0 - f), N_SNPS,
                                 LD_WINDOW)
    log(f"phase host greedy prune scan ({N_SNPS} SNPs, window {LD_WINDOW}): "
        f"{time.perf_counter() - t0_scan:.3f} s")
    check(bool(np.array_equal(keep_scan, keep)),
          "ld_prune differs from the greedy scan of ld_windowed's band")
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
    del gy, gd, lhs, want, gm, geno
    torch.cuda.empty_cache()
    missing = [k for k in SOURCES if launches[k] == 0]
    check(not missing, f"never launched on a main path: {missing}")

    # -- 7. GPU vs CPU path on small panels -------------------------------
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

    # the LD and GRM families on a panel with 2% missing genotypes and a
    # duplicate of every 50th SNP, tracked (the corrected LD paths) and not
    sm = bed.simulate_genotypes(600, 5000, seed=SEED + 5, missing_rate=0.02)
    sm[:, 1::50] = sm[:, 0::50]
    t0 = time.perf_counter()
    fam = {}
    for d in ("cpu", dev):
        tr = from_dense(sm, keep_missing_info=True, device=d)
        un = from_dense(sm, device=d)
        fam[str(d)] = {
            "ld_windowed corrected": ld_windowed(tr, 64,
                                                 correct_missing=True),
            "ld_windowed uncorrected": ld_windowed(tr, 64,
                                                   correct_missing=False),
            "ld_score corrected": ld_score(tr, 64),
            "ld_score": ld_score(un, 64, chrom=chroms),
            "ld_prune corrected": ld_prune(tr, 64),
            "ld_prune": ld_prune(un, 64, chrom=chroms),
            "pairwise_nonmissing": pairwise_nonmissing(tr).cpu().numpy(),
            "grm_yang": grm_yang(un).cpu().numpy(),
            "dominance_grm": dominance_grm(tr).cpu().numpy(),
            "grm_blocked": grm_blocked(sm, row_block=512, device=d),
            "ld_blocked": ld_blocked(tr, row_block=1024)}
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
    check(all(equal.values()) and all(v <= SMALL_RTOL for v in rels.values())
          and pruned >= 100,
          "LD/GRM families disagree between the GPU and the CPU paths")

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

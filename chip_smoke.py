"""Drive the PyTorch/CUDA port once on one GPU, through its kernels.

    python3 chip_smoke.py

Builds the CUDA kernels of ``miraculix_tpu_torch/csrc`` and

1. holds each kernel against its plain torch version on the ``many_indiv``
   panel (65,536 SNPs x 16,384 animals): the tall dgemm kernel with and
   without the fused center vector (relative max error <= 1e-5 against the
   f32 plain product), and the integer crossproduct (exactly equal);
2. runs the main path at that size from the launch counters' zero:
   simulate -> write .bed -> ``from_bed`` on the GPU -> ``grm`` (diagonal
   checked against ``grm_diag``) -> simulated phenotypes -> ``gblup`` (CG
   converged, g_hat correlated with the true breeding values);
3. checks the GPU pipeline against the port's CPU path on a small panel.

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
TALL_RTOL = 1e-5      # kernel vs plain f32 product, relative to max |plain|
DIAG_RTOL = 1e-4      # grm() diagonal vs grm_diag(scale=True)
MIN_BV_CORR = 0.7     # corr(g_hat, true BV), in-sample, h2 = 0.5
SMALL_RTOL = 1e-3     # GPU vs CPU GBLUP on the small panel


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    from miraculix_tpu_torch import _kernels, gblup
    from miraculix_tpu_torch import (from_bed, from_dense, grm, grm_diag,
                                     packed_crossprod)
    from miraculix_tpu_torch.io import bed
    from miraculix_tpu_torch.ops.dgemm import (packed_matmul_tall,
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
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "panel.bed")
        t0 = time.perf_counter()
        bed.write_bed(path, geno)
        log(f"phase write_bed (host): {time.perf_counter() - t0:.3f} s")

        # -- 1. each kernel against its plain version ----------------------
        gm, secs = sync_time(lambda: from_bed(path, device=dev))
        log(f"phase from_bed(device=cuda) (host pack + upload): {secs:.3f} s")
        results = {}

        def record(name, err, ms=None, plain_ms=None):
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if ms is not None:
                r["ms"], r["plain_ms"] = ms, plain_ms

        rng = np.random.default_rng(SEED)
        f2 = 2.0 * gm.freq
        for ncol in (32, 1):
            cases = [("n", "centered", gm.zq_t, N_SNPS, f2),
                     ("t", "centered", gm.zq_n, N_INDIV,
                      torch.ones(N_INDIV, device=dev)),
                     ("n", "uncentered", gm.zq_t, N_SNPS, None)]
            for trans, label, zq, contract, cv in cases:
                b = torch.as_tensor(rng.standard_normal((contract, ncol)),
                                    dtype=torch.float32, device=dev)
                got = packed_matmul_tall(zq, b, center_vec=cv)
                want = packed_matmul_tall_plain(zq, b, center_vec=cv)
                pairs = [("c", got, want)] if cv is None else \
                    [("c", got[0], want[0]), ("v", got[1], want[1])]
                name = "tall_dgemm" if cv is None else "tall_dgemm_cv"
                for part, x, y in pairs:
                    err = float((x - y).abs().max())
                    rel = err / float(y.abs().max())
                    log(f"check {name} {trans} {label} ncol={ncol} {part}: "
                        f"max_abs_err={err:.6g} rel={rel:.3g}")
                    check(bool(torch.isfinite(x).all()) and rel <= TALL_RTOL,
                          f"{name} {trans} {label} ncol={ncol} {part}")
                    record(name, err)
                reps = 20 if ncol == 1 else 10
                ms = event_ms(lambda: packed_matmul_tall(zq, b, cv), reps)
                pms = event_ms(lambda: packed_matmul_tall_plain(zq, b, cv), 3)
                log(f"time {name} {trans} {label} ncol={ncol}: kernel "
                    f"{ms:.4f} ms, plain {pms:.4f} ms")
                if ncol == 32 and trans == "n":
                    record(name, 0.0, ms, pms)
                del got, want, b
        torch.cuda.empty_cache()

        got = packed_crossprod(gm.zq_n)
        want = packed_crossprod_plain(gm.zq_n)
        equal = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        log(f"check crossprod {tuple(got.shape)}: equal={equal} "
            f"max_abs_err={err}")
        check(equal, "crossprod differs from the plain f64 product")
        del got, want
        torch.cuda.empty_cache()
        ms = event_ms(lambda: packed_crossprod(gm.zq_n), 3)
        pms = event_ms(lambda: packed_crossprod_plain(gm.zq_n), 1)
        log(f"time crossprod: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        record("crossprod", err, ms, pms)
        torch.cuda.empty_cache()
        del gm

        # -- 2. the main path, counted ------------------------------------
        _kernels.reset_launch_counts()
        gm, secs = sync_time(lambda: from_bed(path, device=dev))
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
    y, bv = gblup.simulate_phenotypes(geno, h2=0.5, seed=SEED)
    log(f"phase simulate_phenotypes (host): {time.perf_counter() - t0:.3f} s")
    res, secs = sync_time(lambda: gblup.gblup(gm, y, h2=0.5, n_pcs=10))
    corr = float(np.corrcoef(res.g_hat, bv)[0, 1])
    log(f"phase main gblup: {secs:.3f} s cg_iterations={res.cg_iterations} "
        f"converged={res.converged} corr(g_hat, bv)={corr:.4f}")
    counts = dict(_kernels.LAUNCHES)
    log(f"launches on the main path: {counts}")
    check(res.converged, "GBLUP CG did not converge")
    check(res.g_hat.shape == (N_INDIV,) and bool(np.isfinite(res.fitted).all()),
          "GBLUP output malformed")
    check(corr >= MIN_BV_CORR, f"corr(g_hat, bv) {corr:.4f} < {MIN_BV_CORR}")
    check(all(v > 0 for v in counts.values()),
          "a kernel of the main path was never launched")
    del gm, geno

    # -- 3. GPU vs CPU path on a small panel -----------------------------
    small = bed.simulate_genotypes(600, 5000, seed=SEED + 1)
    ys, _ = gblup.simulate_phenotypes(small, h2=0.5, seed=SEED + 1)
    fits = {}
    for d in ("cpu", dev):
        gs = from_dense(small, device=d)
        fits[str(d)] = (gblup.gblup(gs, ys, h2=0.5, n_pcs=3, tol=1e-5).fitted,
                        grm(gs).cpu().numpy())
    (fc, gc), (fg, gg) = fits["cpu"], fits[str(dev)]
    rel_fit = float(np.abs(fg - fc).max() / np.abs(fc).max())
    err_grm = float(np.abs(gg - gc).max())
    log(f"check small panel GPU vs CPU: fitted rel={rel_fit:.3g} "
        f"grm max_abs={err_grm:.3g}")
    check(rel_fit <= SMALL_RTOL and err_grm <= 1e-5,
          "GPU pipeline disagrees with the CPU path on the small panel")

    sources = {"tall_dgemm": ("miraculix_tpu_torch/csrc/tall_dgemm.cu",
                              "miraculix_tpu/ops/dgemm.py:146"),
               "tall_dgemm_cv": ("miraculix_tpu_torch/csrc/tall_dgemm.cu",
                                 "miraculix_tpu/ops/dgemm.py:219"),
               "crossprod": ("miraculix_tpu_torch/csrc/crossprod.cu",
                             "miraculix_tpu/ops/grm.py:148,175")}
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[k], **results[k]}
               for k, (src, rep) in sources.items()]
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

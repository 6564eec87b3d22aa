"""Time the variance-component paths of miraculix_tpu_torch.gblup on one GPU,
split into CG, exact GRM diagonals, G products outside the CG, and host
float64 glue.

    python tools/torch_reml_profile.py [--reps 3]

Simulates the many_indiv panel (65,536 SNPs x 16,384 animals, seed 0) and
the four traits of ``chip_smoke.py`` (its ``more_traits``: h2 = 0.5;
traits 1 and 2 genetically correlated 0.5), packs the panel on the card
with ``from_dense``, and calls
``estimate_h2_he``, ``estimate_h2_reml`` (with and without 3 covariates),
``cross_validate`` (k = 5), ``estimate_bivar_reml``, ``estimate_multi_reml``
(4 traits), ``multi_trait_gblup`` (2 traits, 10% of trait 2 missing) and
``gblup_from_grm`` once to warm them, then ``--reps`` times each.  Each
call prints its seconds (host clock around a synchronize) split into the
seconds inside the CG solves (``gblup.cg`` and ``gblup.grm_cg_solve``)
less the exact GRM diagonals they compute (``grm_diag``, printed apart
with the count of its calls), inside G products outside a CG
(``gblup.grm_matvec``: the traces' probe blocks, G_s P y, the BLUP
products, with their host<->device copies), and the rest: the numpy
float64 glue (projections, traces, the AI matrix and steps, HE sums, the
Kronecker pages), with the CG iteration count and the seconds a CG
iteration.  The timers synchronize at each boundary.  One more call of
each runs under ``torch.profiler`` without the timers: the device's busy
time (the union of its kernels' intervals) against the call's wall time,
and the device time of its largest entries.  ``PYTHONPATH`` set to another
tree's root (one that has this script's ``chip_smoke.more_traits``) A/Bs
two trees.
"""
from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import time

# the repo root after PYTHONPATH's entries, so that PYTHONPATH picks the tree
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SNPS, N_INDIV, SEED = 65536, 16384, 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_reml_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import N_QTL, more_traits
    from miraculix_tpu_torch import _kernels, from_dense, gblup, grm
    from miraculix_tpu_torch.io import bed
    # the module (the package's attribute ``cg`` is the function)
    cg_module = importlib.import_module("miraculix_tpu_torch.solve.cg")

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    reps = ap.parse_args().reps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), f"| package {_kernels.__file__}", flush=True)
    dev = torch.device("cuda", 0)
    _kernels.build()
    geno = bed.simulate_genotypes(N_INDIV, N_SNPS, seed=SEED)
    gm = from_dense(geno, device=dev)
    y, bv = gblup.simulate_phenotypes(geno, h2=0.5, n_qtl=N_QTL, seed=SEED)
    _, y2, y3, y4, gone = more_traits(geno, bv, gblup.simulate_phenotypes)
    del geno
    ys4 = np.stack([y, y2, y3, y4], axis=1)
    ymt = ys4[:, :2].copy()
    ymt[gone, 1] = np.nan
    cov = np.random.default_rng(SEED + 2).standard_normal((N_INDIV, 3))
    g_s = grm(gm, scale=True)
    su = np.array([[0.5, 0.25], [0.25, 0.5]]) * np.outer(
        [y.std(), y2.std()], [y.std(), y2.std()])
    se = np.array([[0.5, 0.0], [0.0, 0.5]]) * np.outer(
        [y.std(), y2.std()], [y.std(), y2.std()])
    calls = {
        "estimate_h2_he": lambda: gblup.estimate_h2_he(gm, y),
        "estimate_h2_reml": lambda: gblup.estimate_h2_reml(gm, y),
        "estimate_h2_reml covariates": lambda: gblup.estimate_h2_reml(
            gm, y, covariates=cov),
        "cross_validate k=5": lambda: gblup.cross_validate(gm, y, k=5),
        "estimate_bivar_reml": lambda: gblup.estimate_bivar_reml(gm, y, y2),
        "estimate_multi_reml t=4": lambda: gblup.estimate_multi_reml(gm,
                                                                     ys4),
        "multi_trait_gblup t=2": lambda: gblup.multi_trait_gblup(gm, ymt, su,
                                                                 se),
        "gblup_from_grm": lambda: gblup.gblup_from_grm(g_s, y),
    }
    for fn in calls.values():             # warm: first-call costs
        fn()

    acc = {"cg": 0.0, "mv": 0.0, "iters": 0, "depth": 0, "diag": 0.0,
           "diag_in": 0.0, "diags": 0}
    originals = {k: getattr(gblup, k) for k in ("cg", "grm_cg_solve",
                                                "grm_matvec")}
    diag_fn = cg_module.grm_diag

    def timed_diag(*args, **kwargs):
        """grm_diag, timed wherever it is called (inside grm_cg_solve's
        preconditioner, or from the gblup layer)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = diag_fn(*args, **kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        acc["diag"] += dt
        acc["diags"] += 1
        if acc["depth"] > 0:
            acc["diag_in"] += dt
        return out

    def timed(name, key):
        fn = originals[name]

        def wrapper(*args, **kwargs):
            outer = acc["depth"] == 0
            acc["depth"] += 1
            if outer:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if outer:
                    torch.cuda.synchronize()
                    acc[key] += time.perf_counter() - t0
                if key == "cg":
                    acc["iters"] += int(out.iterations)
                return out
            finally:
                acc["depth"] -= 1
        return wrapper

    def profiled(label, fn):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, -np.inf
        for s, e in spans:          # union of the kernels' intervals, in us
            if e > end:
                busy += e - max(s, end)
                end = e
        print(f"profiled {label}: wall {wall:.4f} s, device busy "
              f"{busy / 1e6:.4f} s over {len(spans)} device events, idle "
              f"share {1 - busy / 1e6 / wall:.3f}", flush=True)
        for ev in sorted(prof.key_averages(),
                         key=lambda e: -e.device_time_total)[:5]:
            if ev.device_time_total > 0:
                print(f"  device {ev.device_time_total / 1e3:9.3f} ms "
                      f"x{ev.count:<5d} {ev.key[:70]}")

    for label, fn in calls.items():
        gblup.cg = timed("cg", "cg")
        gblup.grm_cg_solve = timed("grm_cg_solve", "cg")
        gblup.grm_matvec = timed("grm_matvec", "mv")
        gblup.grm_diag = cg_module.grm_diag = timed_diag
        try:
            for i in range(reps):
                acc.update(cg=0.0, mv=0.0, iters=0, depth=0, diag=0.0,
                           diag_in=0.0, diags=0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                cg_s = acc["cg"] - acc["diag_in"]
                glue = secs - acc["cg"] - acc["mv"] - (acc["diag"]
                                                       - acc["diag_in"])
                per = (f"{1e3 * cg_s / acc['iters']:.3f} ms"
                       if acc["iters"] else "n/a")
                print(f"{label} rep {i}: {secs:.4f} s = CG {cg_s:.4f} s "
                      f"({acc['iters']} iterations, {per} each) + grm_diag "
                      f"{acc['diag']:.4f} s ({acc['diags']} calls) + G "
                      f"products outside the CG {acc['mv']:.4f} s + host "
                      f"glue {glue:.4f} s", flush=True)
        finally:
            for k, v in originals.items():
                setattr(gblup, k, v)
            gblup.grm_diag = cg_module.grm_diag = diag_fn
        profiled(label, fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())

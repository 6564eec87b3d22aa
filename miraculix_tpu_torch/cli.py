"""Standalone driver CLI, torch twin of ``miraculix_tpu.cli`` (the
reference's src/miraculix/main.cc:401-816 "Wageningen/run" driver, plus the
``gcta --reml`` and ``plink --indep-pairwise`` roles): simulate panels,
validate codings against the OneByte oracle, time the core ops, and run
the GBLUP, GWAS, REML and single-step pipelines on .bed filesets.

    python -m miraculix_tpu_torch.cli simulate --snps 50000 --indiv 10000 out.bed
    python -m miraculix_tpu_torch.cli validate --snps 2000 --indiv 300
    python -m miraculix_tpu_torch.cli bench --snps 65536 --indiv 4096 --ncol 32
    python -m miraculix_tpu_torch.cli qc panel.bed -o clean.bed --maf 0.01
    python -m miraculix_tpu_torch.cli grm panel.bed -o grm.npy [--blocked]
                                  [--method yang] [--dominance] [--gcta-out g]
    python -m miraculix_tpu_torch.cli ld panel.bed -o ld.npy [--window 512]
    python -m miraculix_tpu_torch.cli gwas panel.bed [--logistic | --mixed [--loco]]
    python -m miraculix_tpu_torch.cli ingest panel.bed -o panel.npz  # or x.vcf.gz
    python -m miraculix_tpu_torch.cli reml panel.bed [--method he]
    python -m miraculix_tpu_torch.cli gblup panel.bed --h2 0.5 [--estimate-h2]
    python -m miraculix_tpu_torch.cli pedigree ped.txt -o inbreeding.tsv
    python -m miraculix_tpu_torch.cli ssgblup geno.bed --pedigree ped.txt
    python -m miraculix_tpu_torch.cli info

The subcommands, flags, defaults, printed lines, output files and exit
messages are the reference's.  One option is the port's own: ``--device``
(default ``cuda``), given before the subcommand, is where the panels go and
compute; on a host with no CUDA device the CLI exits unless it is given
``--device cpu``.  ``bench`` times its two products with the benchmark suite's
timers: CUDA events (a host clock on the CPU), the median of interleaved
differences between runs of one call and of ``iters + 1`` calls.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .geno import resolve_device


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _host(t) -> np.ndarray:
    """A result as numpy, from a tensor on any device or an array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def cmd_info(args) -> int:
    from .utils.logging import print_compile_info

    print_compile_info()
    return 0


def cmd_simulate(args) -> int:
    from .io import bed, codec

    if args.stream_chunk > 0:
        # arbitrary-size panels: stream SNP chunks to disk, never holding
        # the dense matrix (reference `plink --simulate` role for the
        # large/many_snps panels)
        bed.simulate_bed(args.out, n_indiv=args.indiv, n_snps=args.snps,
                         seed=args.seed, chunk_snps=args.stream_chunk)
        print(f"wrote {args.out}: {args.indiv} x {args.snps} (streamed)")
        return 0
    geno = bed.simulate_genotypes(args.indiv, args.snps, seed=args.seed,
                                  missing_rate=args.missing_rate)
    bed.write_bed(args.out, geno)
    bed.write_freq(args.out[:-4] + ".freq", codec.allele_freq(geno))
    print(f"wrote {args.out}: {args.indiv} x {args.snps}")
    return 0


def cmd_validate(args) -> int:
    """Differential validation: random panel in OneByte oracle coding,
    transform through every coding, compare dgemm / crossprod results
    elementwise (main.cc:583-760 cmp modes)."""
    from . import dgemm, from_dense, grm
    from .formats import Coding, CodedMatrix, encode, transform
    from .io import bed
    from .ops import ref_impl

    rng = np.random.default_rng(args.seed)
    geno = bed.simulate_genotypes(args.indiv, args.snps, seed=args.seed)
    oracle = CodedMatrix(encode(geno, Coding.ONE_BYTE), Coding.ONE_BYTE,
                         args.snps, args.indiv)
    failures = 0
    for coding in (Coding.TWO_BIT, Coding.PLINK, Coding.FIVE_CODES,
                   Coding.PLANAR16):
        dense = transform(oracle, coding).dense()
        ok = np.array_equal(dense, geno)
        print(f"coding {coding.value:<12s} round-trip: {'ok' if ok else 'FAIL'}")
        failures += not ok

    gm = from_dense(geno, device=args.device)
    freq = _host(gm.freq).astype(np.float64)
    b = rng.standard_normal((args.snps, args.ncol))
    got = _host(dgemm(gm, b, trans="n", center=True))
    want = ref_impl.dgemm_oracle(geno, b, freq)
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"dgemm 'n' vs OneByte oracle: rel-err {err:.2e} "
          f"{'ok' if err < 1e-4 else 'FAIL'}")
    failures += err >= 1e-4

    gg = _host(grm(gm)).astype(np.float64)
    gw = ref_impl.grm_oracle(geno, freq)
    gerr = np.abs(gg - gw).max()
    print(f"GRM vs oracle: abs-err {gerr:.2e} {'ok' if gerr < 1e-4 else 'FAIL'}")
    failures += gerr >= 1e-4
    return 1 if failures else 0


def cmd_bench(args) -> int:
    """Time the core ops (benchmark.f90 / main.cc timing loops): the packed
    dgemm at ``--ncol`` columns and, with ``--grm``, the integer GRM
    crossproduct, through the suite's differenced timers
    (``benchmark._timed_scan_b`` / ``_timed_scan_zq``)."""
    from .benchmark import _timed_scan_b, _timed_scan_zq
    from .io import bed, codec
    from .ops.dgemm import packed_matmul
    from .ops.grm import packed_crossprod
    from .utils.logging import PhaseTimer

    dev = args.device
    t = PhaseTimer(verbose=True)
    with t.phase("simulate"):
        geno = bed.simulate_genotypes(args.indiv, args.snps, seed=args.seed)
    with t.phase("pack (host)"):
        zq = codec.pack_planar16(geno, row_mult=256)
    with t.phase("h2d"):
        zqd = torch.from_numpy(zq.view(np.int32)).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    rng = np.random.default_rng(args.seed)
    b = torch.as_tensor(rng.standard_normal((args.snps, args.ncol)),
                        dtype=torch.float32, device=dev)

    per = _timed_scan_b(lambda z, bb: packed_matmul(z, bb), zqd, b, iters=8)
    ops = args.snps * args.indiv * args.ncol / per
    print(f"dgemm:  {per * 1e3:8.2f} ms  {ops / 1e12:6.2f} T geno-col-ops/s")

    if args.grm:
        per = _timed_scan_zq(lambda z: packed_crossprod(z), zqd, iters=2)
        flops = 2.0 * args.indiv ** 2 * args.snps
        print(f"GRM:    {per * 1e3:8.2f} ms  {flops / per / 1e12:6.1f} TFLOP/s")
    print(t.report())
    return 0


def cmd_grm(args) -> int:
    """GRM of a .bed fileset to .npy (the Julia grm() entry,
    src/bindings/Julia/crossproduct.jl:83-110, as a command)."""
    from . import from_bed, grm
    from .ops.grm import grm_blocked

    dev = args.device
    if args.pair_denom and (args.blocked or args.dominance):
        raise SystemExit("--pair-denom applies to the in-core "
                         "vanraden/yang paths only")
    if args.dominance:
        from .ops.grm import dominance_grm

        if args.blocked:
            raise SystemExit("--dominance has no blocked path yet")
        if args.method == "yang":
            raise SystemExit("--dominance and --method yang are mutually "
                             "exclusive (pick one GRM definition)")
        out = _host(dominance_grm(from_bed(args.bed, device=dev)))
    elif args.method == "yang":
        from .ops.grm import grm_yang

        if args.blocked:
            raise SystemExit("--method yang has no blocked path yet")
        gm = from_bed(args.bed, keep_missing_info=True, device=dev)
        out = _host(grm_yang(gm, pair_denominator=args.pair_denom))
    elif args.blocked:
        gm = None
        out = grm_blocked(args.bed, row_block=args.row_block, device=dev)
    else:
        gm = from_bed(args.bed, keep_missing_info=args.pair_denom, device=dev)
        out = _host(grm(gm, pair_denominator=args.pair_denom))
    if args.gcta_out:
        from .io.bed import read_bim, read_fam_ids
        from .io.grm_io import write_gcta_grm

        ids = read_fam_ids(args.bed)
        if len(ids) != out.shape[0]:
            raise SystemExit(f".fam has {len(ids)} ids but the GRM is "
                             f"{out.shape[0]}^2 — refusing to write a "
                             "desynchronized GCTA fileset")
        if args.pair_denom and gm is not None:
            # .grm.N.bin contract: "the number of SNPs used per pair" —
            # a pair-denominator GRM must ship each pair's co-called
            # count, not the constant .bim total
            from .ops.grm import pairwise_nonmissing

            n_snps = _host(pairwise_nonmissing(gm))
        else:
            n_snps = len(read_bim(args.bed))
        write_gcta_grm(args.gcta_out, out, n_snps, ids=ids)
        print(f"wrote {args.gcta_out}.grm.bin/.grm.N.bin/.grm.id "
              f"(GCTA format, {out.shape[0]} ids)")
    np.save(args.out, out)
    print(f"wrote {args.out}: {out.shape[0]}^2 GRM")
    return 0


def cmd_ld(args) -> int:
    from . import from_bed, ld, ld_score, ld_windowed
    from .io.bed import read_bim

    if args.score and args.prune_r2 is not None:
        raise SystemExit("--score and --prune-r2 are mutually exclusive "
                         "ld modes; pass one")
    if (args.score or args.prune_r2 is not None) and args.squared:
        raise SystemExit("--squared applies to the matrix/banded output "
                         "only; drop it with --score/--prune-r2")
    g = from_bed(args.bed, device=args.device)
    if args.prune_r2 is not None:
        from . import ld_prune

        bim = read_bim(args.bed)
        keep = ld_prune(g, window=args.window or 512,
                        r2_threshold=args.prune_r2,
                        chrom=np.array([row[0] for row in bim]))
        ids = [row[1] for row in bim]
        base = args.out or args.bed[:-4]
        if base.endswith(".npy"):
            base = base[:-4]
        with open(base + ".prune.in", "w") as fh:
            fh.writelines(f"{sid}\n" for sid, k in zip(ids, keep) if k)
        with open(base + ".prune.out", "w") as fh:
            fh.writelines(f"{sid}\n" for sid, k in zip(ids, keep) if not k)
        print(f"wrote {base}.prune.in ({int(keep.sum())} kept) / "
              f".prune.out ({int((~keep).sum())} dropped); window "
              f"{args.window or 512}, r^2 > {args.prune_r2}")
        return 0
    if args.score:
        bim = read_bim(args.bed)
        sc = ld_score(g, window=args.window or 512,
                      adjusted=not args.no_adjust,
                      chrom=np.array([row[0] for row in bim]))
        ids = [row[1] for row in bim]
        out = args.out or "ldscore.tsv"
        with open(out, "w") as fh:
            fh.write("snp\tldscore\n")
            for sid, s in zip(ids, sc):
                fh.write(f"{sid}\t{s:.6g}\n")
        print(f"wrote {out}: {len(sc)} LD scores (window "
              f"{args.window or 512}, "
              f"{'adjusted' if not args.no_adjust else 'raw'} r^2)")
        return 0
    path = args.out or "ld.npy"
    if args.window:
        out = ld_windowed(g, window=args.window, squared=args.squared)
        np.save(path, out)
        print(f"wrote {path}: {out.shape[0]} x {args.window} banded LD "
              f"{'r^2' if args.squared else 'r'} (partner = snp+1+d)")
        return 0
    out = _host(ld(g, squared=args.squared))
    np.save(path, out)
    print(f"wrote {path}: {out.shape[0]}^2 LD "
          f"{'r^2' if args.squared else 'r'}")
    return 0


def cmd_ingest(args) -> int:
    """Pack a .bed fileset once and checkpoint it (skip decode+pack on
    reload — geno.save/load).  A .vcf/.vcf.gz input is converted to a
    sibling .bed fileset first (biallelic GT records)."""
    from . import from_bed
    from .geno import save

    bed_path = args.bed
    if bed_path.endswith((".vcf", ".vcf.gz")):
        from .io.vcf import vcf_to_bed

        stem = bed_path[:-7] if bed_path.endswith(".vcf.gz") \
            else bed_path[:-4]
        n, s = vcf_to_bed(bed_path, stem + ".bed")
        print(f"converted {bed_path} -> {stem}.bed "
              f"({n} samples x {s} biallelic SNPs)")
        bed_path = stem + ".bed"
    g = from_bed(bed_path, device=args.device)
    save(args.out, g)
    print(f"wrote {args.out}: {g!r}")
    return 0


def cmd_gwas(args) -> int:
    """Per-SNP association scan; phenotype = 6th .fam column when present,
    else simulated (gblup-style)."""
    from . import from_bed
    from .gblup import simulate_phenotypes
    from .gwas import gwas_linear
    from .streamed import StreamedGeno

    if args.stream_chunk > 0 and args.mesh > 0:
        raise SystemExit("--stream-chunk and --mesh are alternative "
                         "scaling modes (out-of-core vs multi-chip); "
                         "pick one")
    if args.stream_chunk > 0:
        g = StreamedGeno.from_bed(args.bed, chunk_snps=args.stream_chunk,
                                  device=args.device)
    elif args.mesh > 0:
        from .parallel.sharded import mesh_on, shard_genotypes_from_bed

        g = shard_genotypes_from_bed(args.bed,
                                     mesh_on(args.mesh, args.device))
    else:
        g = from_bed(args.bed, device=args.device)
    y = None
    try:
        vals = []
        with open(args.bed[:-4] + ".fam") as fh:
            for line in fh:
                if not line.strip():
                    continue  # blank lines are not individuals
                parts = line.split()
                vals.append(float(parts[5]) if len(parts) > 5 else np.nan)
        y = np.asarray(vals)
        if (y == -9).any() and not np.all(y == -9):
            # PLINK missing-phenotype code: regressing against -9.0 emits
            # silently-wrong statistics (cmd_reml rejects it the same way)
            raise SystemExit(f"{int((y == -9).sum())} individuals have "
                             "missing phenotype (-9); subset the panel "
                             "first (e.g. qc --mind or plink --prune)")
        if np.isnan(y).any() or np.all(y == y[0]) or np.all(y == -9):
            y = None
    except (OSError, ValueError):
        y = None
    if y is None:
        if args.stream_chunk > 0 or args.mesh > 0:
            raise SystemExit(
                "--stream-chunk/--mesh panels need real .fam phenotypes: "
                "the simulated-phenotype fallback would densify the full "
                "panel these scaling modes exist to avoid")
        from .io import bed as bedio

        dense, _ = bedio.read_bed_genotypes(args.bed)
        y, _ = simulate_phenotypes(dense, h2=0.5)
        print("(.fam has no phenotypes — simulated, h2=0.5)")
    if args.loco and not args.mixed:
        raise SystemExit("--loco requires --mixed (it modifies the "
                         "mixed-model GRM, not the linear/logistic scans)")
    if args.loco and args.stream_chunk > 0:
        raise SystemExit("--loco needs the panel on device (per-chromosome "
                         "packed subsets); drop --stream-chunk or run "
                         "gwas_mixed per pre-split chromosome panel")
    from .io.bed import read_bim

    bim = read_bim(args.bed)
    snp_id = [row[1] for row in bim]
    chrom_of = [row[0] for row in bim]
    pos_of = [row[3] for row in bim]

    if args.logistic:
        from .gwas import gwas_logistic

        yb = np.asarray(y)
        uniq = np.unique(yb)
        if not np.isin(uniq, (0.0, 1.0)).all():
            # PLINK convention: 1=control, 2=case
            if set(uniq) <= {1.0, 2.0}:
                yb = yb - 1.0
            else:
                raise SystemExit("--logistic needs a 0/1 (or plink 1/2) "
                                 "phenotype")
        res = gwas_logistic(g, yb)
        with open(args.out, "w") as fh:
            fh.write("chr\tsnp\tbp\tbeta\tse\tz\tp\n")
            for i in range(len(res.beta)):
                fh.write(f"{chrom_of[i]}\t{snp_id[i]}\t{pos_of[i]}\t"
                         f"{res.beta[i]:.6g}\t{res.se[i]:.6g}\t"
                         f"{res.t[i]:.6g}\t{res.p[i]:.6g}\n")
        top = np.argsort(res.p)[:5]
        print(f"wrote {args.out}: {len(res.beta)} SNPs (logistic score); "
              f"top hits {list(top)}")
        return 0
    if args.mixed:
        from .gwas import gwas_mixed, gwas_mixed_loco

        if args.loco:
            res = gwas_mixed_loco(g, y, np.array(chrom_of), h2=args.h2)
        else:
            res = gwas_mixed(g, y, h2=args.h2)
        with open(args.out, "w") as fh:
            fh.write("chr\tsnp\tbp\tbeta\tchi2\tp\n")
            for i in range(len(res.beta)):
                fh.write(f"{chrom_of[i]}\t{snp_id[i]}\t{pos_of[i]}\t"
                         f"{res.beta[i]:.6g}\t{res.chi2[i]:.6g}\t"
                         f"{res.p[i]:.6g}\n")
        top = np.argsort(res.p)[:5]
        print(f"wrote {args.out}: {len(res.beta)} SNPs, GRAMMAR-gamma "
              f"{res.gamma:.3f}{' (LOCO)' if args.loco else ''}; "
              f"top hits {list(top)}")
        return 0
    res = gwas_linear(g, y)
    with open(args.out, "w") as fh:
        fh.write("chr\tsnp\tbp\tbeta\tse\tt\tp\n")
        for i in range(len(res.beta)):
            fh.write(f"{chrom_of[i]}\t{snp_id[i]}\t{pos_of[i]}\t"
                     f"{res.beta[i]:.6g}\t{res.se[i]:.6g}\t"
                     f"{res.t[i]:.6g}\t{res.p[i]:.6g}\n")
    top = np.argsort(res.p)[:5]
    print(f"wrote {args.out}: {len(res.beta)} SNPs, df={res.df}; "
          f"top hits {list(top)} (p {[f'{res.p[i]:.2g}' for i in top]})")
    return 0


def cmd_gblup(args) -> int:
    from .gblup import run_gblup

    return run_gblup(args.bed, h2=args.h2, pcs=args.pcs, solver=args.solver,
                     h2_method=args.h2_method, maxiter=args.maxiter,
                     stream_chunk=args.stream_chunk, tol=args.tol,
                     estimate_h2=args.estimate_h2,
                     effects_out=args.effects_out, device=args.device)


def cmd_score(args) -> int:
    """Score a panel with exported marker effects (plink --score role /
    the 'indirect predictions' deployment loop): g_hat = (Z - 2 f_train)
    alpha, centering with the TRAINING frequencies from the effects file
    (gblup --effects-out), one packed 'n' pass."""
    from . import from_bed
    from .gblup import predict

    header = None
    snp_ids, alleles, alpha, freq = [], [], [], []
    with open(args.effects) as fh:
        for ln in fh:
            parts = ln.split()
            if header is None:
                header = parts
                if parts[:1] == ["snp"]:
                    continue            # header row from gblup --effects-out
            snp_ids.append(parts[0])
            alleles.append(parts[1])
            alpha.append(float(parts[2]))
            freq.append(float(parts[3]))
    alpha = np.asarray(alpha)
    freq = np.asarray(freq)

    from .io.bed import read_bim, read_fam_ids

    bim = read_bim(args.bed)
    if len(bim) != len(alpha):
        raise SystemExit(f"effects file has {len(alpha)} SNPs but the panel "
                         f"has {len(bim)} — panels must share the SNP set")
    # dosage counts A2 copies (codec: 0b00 hom-A1 -> 0), so the effect
    # allele written by gblup --effects-out is the .bim 6th column (A2)
    mism = sum(1 for row, sid, eff in zip(bim, snp_ids, alleles)
               if row[1] != sid or row[5] != eff)
    if mism and not args.force:
        raise SystemExit(f"{mism} SNP id/allele mismatches vs the .bim — "
                         "the panels are not variant-aligned "
                         "(--force to score anyway)")

    g = from_bed(args.bed, device=args.device)
    scores = predict(g, alpha, freq)
    ids = read_fam_ids(args.bed)
    if len(ids) != len(scores):
        raise SystemExit(f".fam has {len(ids)} ids but the panel has "
                         f"{len(scores)} individuals")
    with open(args.out, "w") as fh:
        fh.write("fid\tiid\tscore\n")
        for (fid, iid), s in zip(ids, scores):
            fh.write(f"{fid}\t{iid}\t{s:.6g}\n")
    print(f"wrote {args.out}: {len(scores)} scores "
          f"({len(alpha)} markers)")
    return 0


def cmd_pedigree(args) -> int:
    """Pedigree report: Meuwissen-Luo inbreeding + A-inverse stats from a
    pedigree file (the INBUPGF90-style preprocessing step)."""
    from .pedigree import a_inverse, inbreeding, read_pedigree

    sire, dam, labels = read_pedigree(args.pedigree)
    n = len(labels)
    f = np.zeros(n) if args.no_inbreeding else inbreeding(sire, dam)
    r, c, v = a_inverse(sire, dam, f=f)
    with open(args.out, "w") as fh:
        fh.write("animal\tsire\tdam\tF\n")
        for i, lab in enumerate(labels):
            s_lab = labels[sire[i] - 1] if sire[i] else "0"
            d_lab = labels[dam[i] - 1] if dam[i] else "0"
            fh.write(f"{lab}\t{s_lab}\t{d_lab}\t{f[i]:.6f}\n")
    both = int(((sire > 0) & (dam > 0)).sum())
    print(f"wrote {args.out}: {n} animals ({both} with both parents), "
          f"mean F = {f.mean():.4f}, max F = {f.max():.4f}, "
          f"A-inverse nnz = {len(v)}")
    return 0


def cmd_qc(args) -> int:
    """Standard panel filters (plink --maf/--geno/--mind/--hwe roles),
    streamed over the .bed bytes."""
    from .qc import qc_filter

    keep_s, keep_i = qc_filter(args.bed, args.out, maf=args.maf,
                               geno=args.geno, mind=args.mind,
                               hwe=args.hwe)
    print(f"wrote {args.out}: kept {int(keep_s.sum())}/{len(keep_s)} SNPs, "
          f"{int(keep_i.sum())}/{len(keep_i)} individuals "
          f"(maf>={args.maf}, geno<={args.geno}, mind<={args.mind}"
          f"{f', hwe>={args.hwe}' if args.hwe > 0 else ''})")
    if args.rel_cutoff is not None:
        from . import from_bed, grm
        from .io.bed import read_fam_ids
        from .qc import rel_cutoff

        gmat = _host(grm(from_bed(args.out, device=args.device)))
        keep = rel_cutoff(gmat, cutoff=args.rel_cutoff)
        ids = read_fam_ids(args.out)
        base = args.out[:-4]
        with open(base + ".rel.id", "w") as fh:
            fh.writelines(f"{f}\t{i}\n"
                          for (f, i), k in zip(ids, keep) if k)
        print(f"wrote {base}.rel.id: {int(keep.sum())}/{len(keep)} pass "
              f"--rel-cutoff {args.rel_cutoff}")
    return 0


def cmd_reml(args) -> int:
    """Variance components / SNP heritability from a .bed fileset with
    phenotypes in the .fam 6th column — the gcta --reml role."""
    from . import from_bed
    from .gblup import (estimate_bivar_reml, estimate_h2_he,
                        estimate_h2_reml, estimate_multi_reml)
    from .streamed import StreamedGeno

    if args.stream_chunk > 0:
        g = StreamedGeno.from_bed(args.bed, chunk_snps=args.stream_chunk,
                                  device=args.device)
    else:
        g = from_bed(args.bed, device=args.device)
    if not args.multi:
        # --multi takes every trait from its own file; skip the .fam
        # phenotype column entirely there (it may be absent/non-numeric)
        with open(args.bed[:-4] + ".fam") as fh:
            y = np.array([ln.split()[5] for ln in fh if ln.strip()],
                         np.float64)
        if (y == -9).any():
            raise SystemExit(f"{int((y == -9).sum())} individuals have "
                             "missing phenotype (-9); subset the panel "
                             "first")
    if args.multi:
        from .io.bed import read_fam_ids

        with open(args.multi) as fh:
            rows = [ln.split() for ln in fh if ln.strip()]
        if rows and rows[0] and not _is_number(rows[0][-1]):
            rows = rows[1:]
        if not rows or len(rows[0]) < 4:
            raise SystemExit("--multi needs 'FID IID y1 y2 [y3 ...]' rows "
                             "(>= 2 traits)")
        if any(len(r) != len(rows[0]) for r in rows):
            raise SystemExit("--multi file is ragged")
        try:
            by_id = {(r[0], r[1]): [float(v) for v in r[2:]] for r in rows}
        except ValueError as e:
            raise SystemExit(f"--multi file has a non-numeric value: {e}")
        ids = read_fam_ids(args.bed)
        missing = [i for i in ids if i not in by_id]
        if missing:
            raise SystemExit(f"--multi file lacks {len(missing)} of the "
                             "panel's FID/IID pairs")
        ys = np.array([by_id[i] for i in ids])
        if (ys == -9).any():
            raise SystemExit("missing phenotype (-9) in --multi traits; "
                             "subset the panel first")
        sg_m, se_m, det = estimate_multi_reml(g, ys, n_probes=args.probes,
                                              verbose=args.verbose)
        t = det["n_traits"]
        print(f"{t}-trait REML (standardized scale)")
        print("trait\th2\tSE")
        for k in range(t):
            print(f"{k + 1}\t{det['h2'][k]:.4f}\t{det['se_h2'][k]:.4f}")
        print("pair\trG\tSE")
        for a in range(t):
            for b in range(a + 1, t):
                print(f"{a + 1},{b + 1}\t{det['rg'][a, b]:.4f}\t"
                      f"{det['se_rg'][a, b]:.4f}")
        print(f"(multivariate AI-REML: {det['iterations']} iterations, "
              f"converged={det['converged']}, {det['cg_iterations']} CG "
              f"iterations, {det['n_probes']} trace probes)")
        return 0
    if args.bivar:
        # second trait: one value per .fam row, or "FID IID value" rows
        from .io.bed import read_fam_ids

        with open(args.bivar) as fh:
            rows = [ln.split() for ln in fh if ln.strip()]
        if rows and rows[0] and not _is_number(rows[0][-1]):
            rows = rows[1:]          # header line
        if not rows:
            raise SystemExit("--bivar file has no data rows")
        if len(rows[0]) == 2:
            raise SystemExit("--bivar rows have 2 columns — ambiguous "
                             "(a numeric ID would silently be read as the "
                             "phenotype): use ONE value per .fam row, or "
                             "keyed 'FID IID value' rows")
        keyed = len(rows[0]) >= 3
        if any(len(r) != len(rows[0]) for r in rows):
            raise SystemExit("--bivar file is ragged (rows with differing "
                             "column counts)")
        try:
            if keyed:
                by_id = {(r[0], r[1]): float(r[2]) for r in rows}
            else:
                y2 = np.array([float(r[0]) for r in rows])
        except ValueError as e:
            raise SystemExit(f"--bivar file has a non-numeric phenotype "
                             f"value: {e}")
        if keyed:
            ids = read_fam_ids(args.bed)
            missing = [i for i in ids if i not in by_id]
            if missing:
                raise SystemExit(f"--bivar file lacks {len(missing)} of the "
                                 "panel's FID/IID pairs")
            y2 = np.array([by_id[i] for i in ids])
        elif len(y2) != len(y):
            raise SystemExit(f"--bivar file has {len(y2)} values but "
                             f"the panel has {len(y)} individuals")
        if (y2 == -9).any():
            raise SystemExit(f"{int((y2 == -9).sum())} individuals have "
                             "missing phenotype (-9) in the --bivar trait; "
                             "subset the panel first")
        rg, det = estimate_bivar_reml(g, y, y2, n_probes=args.probes,
                                      verbose=args.verbose)
        print("Source\tEstimate\tSE")
        print(f"rG\t{rg:.4f}\t{det['se_rg']:.4f}")
        print(f"h2 (trait 1)\t{det['h2_1']:.4f}\t{det['se_h2_1']:.4f}")
        print(f"h2 (trait 2)\t{det['h2_2']:.4f}\t{det['se_h2_2']:.4f}")
        print(f"components (standardized): Sg=[{det['g11']:.4f}, "
              f"{det['g12']:.4f}; ., {det['g22']:.4f}]  "
              f"Se=[{det['e11']:.4f}, {det['e12']:.4f}; ., "
              f"{det['e22']:.4f}]")
        print(f"(bivariate AI-REML: {det['iterations']} iterations, "
              f"converged={det['converged']}, {det['cg_iterations']} CG "
              f"iterations, {det['n_probes']} trace probes)")
        return 0
    if args.method == "he":
        h2, det = estimate_h2_he(g, y)
        print(f"HE h2 = {h2:.4f}")
        print(f"details: {det}")
        return 0
    h2, det = estimate_h2_reml(g, y, n_probes=args.probes,
                               verbose=args.verbose)
    vy = y.var()
    print("Source\tVariance\tSE-ish")
    print(f"V(G)\t{det['vg']:.6g}")
    print(f"V(e)\t{det['ve']:.6g}")
    print(f"Vp\t{vy:.6g}")
    print(f"V(G)/Vp\t{h2:.4f}\t{det['se_h2']:.4f}")
    print(f"(AI-REML: {det['iterations']} iterations, converged="
          f"{det['converged']}, {det['cg_iterations']} CG iterations, "
          f"{det['n_probes']} trace probes)")
    return 0


def cmd_pca(args) -> int:
    """Top-k GRM eigenpairs (gcta --pca / plink --pca role): Halko
    randomized range finder on the implicit operator Z_c(Z_cᵀ·) — G is
    never formed (reference PCA: examples/gblup/calculate_gblup.jl:152-158).
    Writes GCTA-style PREFIX.eigenvec (FID IID PC1..PCk) and
    PREFIX.eigenval (one eigenvalue of the VanRaden-scaled GRM per line).
    """
    from . import from_bed
    from .gblup import randomized_grm_pca
    from .io.bed import read_fam_ids

    if args.stream_chunk > 0:
        from .streamed import StreamedGeno

        g = StreamedGeno.from_bed(args.bed, chunk_snps=args.stream_chunk,
                                  device=args.device)
    else:
        g = from_bed(args.bed, device=args.device)
    w, v = randomized_grm_pca(g, k=args.k, oversample=args.oversample,
                              power_iters=args.power_iters, seed=args.seed)
    # randomized_grm_pca eigendecomposes the UNSCALED centered GRM
    # Z_c Z_cᵀ; GCTA reports eigenvalues of the sigma2-normalized matrix.
    w = w / float(g.sigma2)
    ids = read_fam_ids(args.bed)
    if len(ids) != v.shape[0]:
        raise SystemExit(f".fam has {len(ids)} ids but the panel has "
                         f"{v.shape[0]} individuals")
    with open(args.out + ".eigenval", "w") as fh:
        fh.writelines(f"{x:.6g}\n" for x in w)
    with open(args.out + ".eigenvec", "w") as fh:
        for (fid, iid), row in zip(ids, v):
            fh.write(" ".join([fid, iid] + [f"{x:.6g}" for x in row]) + "\n")
    print(f"wrote {args.out}.eigenvec/.eigenval (top {args.k} PCs, "
          f"{v.shape[0]} individuals)")
    return 0


def cmd_ssgblup(args) -> int:
    from .ssgblup import run_ssgblup

    return run_ssgblup(args.bed, args.pedigree, pheno_path=args.pheno,
                       out=args.out, h2=args.h2, blend=args.blend,
                       tau=args.tau, omega=args.omega, tol=args.tol,
                       no_inbreeding=args.no_inbreeding,
                       estimate_h2=args.estimate_h2,
                       stream_chunk=args.stream_chunk, device=args.device)


COMMANDS = {
    "info": cmd_info,
    "simulate": cmd_simulate,
    "validate": cmd_validate,
    "bench": cmd_bench,
    "grm": cmd_grm,
    "ld": cmd_ld,
    "gwas": cmd_gwas,
    "ingest": cmd_ingest,
    "gblup": cmd_gblup,
    "pedigree": cmd_pedigree,
    "qc": cmd_qc,
    "reml": cmd_reml,
    "ssgblup": cmd_ssgblup,
    "pca": cmd_pca,
    "score": cmd_score,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="miraculix_tpu_torch",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="where the panels go and compute (default: the CUDA "
                        "card; 'cpu' runs the plain versions of the kernels "
                        "on the host)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info")

    s = sub.add_parser("simulate")
    s.add_argument("out")
    s.add_argument("--snps", type=int, default=10000)
    s.add_argument("--indiv", type=int, default=1000)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--missing-rate", type=float, default=0.0)
    s.add_argument("--stream-chunk", type=int, default=0,
                   help="write in SNP chunks of this size (panels beyond "
                        "host RAM); missing-rate is ignored when streaming")

    v = sub.add_parser("validate")
    v.add_argument("--snps", type=int, default=2000)
    v.add_argument("--indiv", type=int, default=300)
    v.add_argument("--ncol", type=int, default=8)
    v.add_argument("--seed", type=int, default=0)

    b = sub.add_parser("bench")
    b.add_argument("--snps", type=int, default=65536)
    b.add_argument("--indiv", type=int, default=4096)
    b.add_argument("--ncol", type=int, default=32)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--grm", action="store_true")

    gr = sub.add_parser("grm")
    gr.add_argument("bed")
    gr.add_argument("-o", "--out", default="grm.npy")
    gr.add_argument("--blocked", action="store_true",
                    help="out-of-core (GRM larger than device memory)")
    gr.add_argument("--row-block", type=int, default=8192)
    gr.add_argument("--gcta-out", default=None, metavar="PREFIX",
                    help="also write PREFIX.grm.bin/.grm.N.bin/.grm.id "
                         "(GCTA binary GRM, consumed by gcta --reml etc.)")
    gr.add_argument("--method", choices=["vanraden", "yang"],
                    default="vanraden",
                    help="GRM definition: VanRaden (global normalization, "
                         "int8 crossprod path) or Yang/GCTA (per-SNP "
                         "standardization, weighted-crossprod path)")
    gr.add_argument("--pair-denom", action="store_true",
                    help="per-pair missingness denominators (gcta "
                         "--make-grm / plink --make-rel semantics): each "
                         "pair divides by its own co-called SNP count "
                         "(yang) or co-called Σ2pq (vanraden)")
    gr.add_argument("--dominance", action="store_true",
                    help="Su (2012) genotypic dominance relationship "
                         "matrix instead of the additive GRM")

    w = sub.add_parser("gwas")
    w.add_argument("bed")
    w.add_argument("-o", "--out", default="gwas.tsv")
    w.add_argument("--stream-chunk", type=int, default=0,
                   help="stream the panel in SNP chunks of this size")
    w.add_argument("--logistic", action="store_true",
                   help="case-control logistic score test (0/1 or plink "
                        "1/2 phenotype)")
    w.add_argument("--mixed", action="store_true",
                   help="GRAMMAR-gamma mixed-model scan (structure-"
                        "corrected; needs the panel in memory)")
    w.add_argument("--loco", action="store_true",
                   help="with --mixed: leave-one-chromosome-out GRM "
                        "(chromosomes from the .bim; proximal-"
                        "contamination guard)")
    w.add_argument("--h2", type=float, default=0.5)
    w.add_argument("--mesh", type=int, default=0,
                   help="shard the panel over this many devices and run "
                        "the scan distributed (linear/mixed/logistic/LOCO "
                        "all ride the sharded operators; 0 = single device)")

    l = sub.add_parser("ld")  # noqa: E741
    l.add_argument("--window", type=int, default=0,
                   help="banded LD within a SNP window (LD-pruning shape); "
                        "0 = full matrix")
    l.add_argument("--squared", action="store_true", help="emit r^2")
    l.add_argument("--score", action="store_true",
                   help="per-SNP LD scores (gcta --ld-score role; TSV "
                        "output, uses --window or 512)")
    l.add_argument("--prune-r2", type=float, default=None, metavar="R2",
                   help="greedy pairwise LD pruning (plink --indep-pairwise"
                        " role): write .prune.in/.prune.out SNP-id lists "
                        "(uses --window or 512)")
    l.add_argument("--no-adjust", action="store_true",
                   help="--score: raw r^2 instead of GCTA's adjusted "
                        "r^2 - (1-r^2)/(n-2)")
    l.add_argument("bed")
    l.add_argument("-o", "--out", default=None,
                   help="output path (default ld.npy, or ldscore.tsv "
                        "with --score)")

    ing = sub.add_parser("ingest")
    ing.add_argument("bed")
    ing.add_argument("-o", "--out", default="panel.npz")

    g = sub.add_parser("gblup")
    g.add_argument("bed")
    g.add_argument("--h2", type=float, default=0.5)
    g.add_argument("--pcs", type=int, default=10)
    g.add_argument("--solver", choices=["cg", "refined", "dense"],
                   default="cg")
    g.add_argument("--estimate-h2", action="store_true",
                   help="estimate h2 from the data instead of using --h2")
    g.add_argument("--h2-method", choices=["he", "reml"], default="he",
                   help="--estimate-h2 estimator: 'he' (Haseman-Elston "
                        "regression, two matvec batches) or 'reml' "
                        "(stochastic AI-REML, GCTA --reml role)")
    g.add_argument("--stream-chunk", type=int, default=0,
                   help="SNP chunk size for the out-of-core StreamedGeno "
                        "path (0 = in-memory GenoMatrix)")
    g.add_argument("--tol", type=float, default=1e-4,
                   help="CG convergence tolerance")
    g.add_argument("--maxiter", type=int, default=2000,
                   help="CG iteration cap (bound the wall time of "
                        "host-streamed out-of-core solves)")
    g.add_argument("--effects-out", default=None, metavar="FILE",
                   help="also backsolve per-SNP marker effects and write "
                        "them (snp, allele, effect, freq_train TSV) for "
                        "indirect prediction via `score`")

    pd = sub.add_parser("pedigree", help="inbreeding + A-inverse report "
                        "from a pedigree file")
    pd.add_argument("pedigree")
    pd.add_argument("-o", "--out", default="inbreeding.tsv")
    pd.add_argument("--no-inbreeding", action="store_true",
                    help="skip Meuwissen-Luo F (very large deep pedigrees)")

    qcp = sub.add_parser("qc", help="filter a panel (plink --maf/--geno/"
                         "--mind/--hwe roles), streamed")
    qcp.add_argument("bed")
    qcp.add_argument("-o", "--out", default="qc.bed")
    qcp.add_argument("--maf", type=float, default=0.0,
                     help="drop SNPs with minor-allele freq < MAF")
    qcp.add_argument("--geno", type=float, default=1.0,
                     help="drop SNPs with missing rate > GENO")
    qcp.add_argument("--mind", type=float, default=1.0,
                     help="drop individuals with missing rate > MIND")
    qcp.add_argument("--hwe", type=float, default=0.0,
                     help="drop SNPs with HWE chi2 p < HWE")
    qcp.add_argument("--rel-cutoff", type=float, default=None, metavar="R",
                     help="after filtering, greedily select an unrelated "
                          "subset (plink --rel-cutoff role): write "
                          "OUT.rel.id with the kept FID/IID pairs")

    rm = sub.add_parser("reml", help="variance components / h2 from .fam "
                        "phenotypes (gcta --reml role)")
    rm.add_argument("bed")
    rm.add_argument("--method", choices=["reml", "he"], default="reml")
    rm.add_argument("--probes", type=int, default=16,
                    help="Hutchinson trace probes per AI step")
    rm.add_argument("--stream-chunk", type=int, default=0)
    rm.add_argument("--bivar", default=None, metavar="PHENO2",
                    help="bivariate REML (gcta --reml-bivar role): genetic "
                         "correlation between the .fam phenotype and a "
                         "second trait file ('FID IID value' rows, or one "
                         "value per .fam line)")
    rm.add_argument("--multi", default=None, metavar="PHENOS",
                    help="multivariate REML over >= 2 traits from a "
                         "'FID IID y1 y2 ...' file (beyond gcta, which "
                         "stops at --reml-bivar)")
    rm.add_argument("-v", "--verbose", action="store_true")

    ss = sub.add_parser("ssgblup", help="single-step GBLUP: pedigree + "
                        "partial genotyping, matrix-free H^-1 MME")
    ss.add_argument("bed", help="PLINK fileset of the GENOTYPED animals "
                    "(.fam IID = pedigree label)")
    ss.add_argument("--pedigree", required=True,
                    help="animal sire dam per line (0/NA = unknown)")
    ss.add_argument("--pheno", default=None,
                    help="two-column file: animal label, value (any "
                         "pedigree animal); default = .fam phenotypes")
    ss.add_argument("-o", "--out", default="ebv.tsv")
    ss.add_argument("--h2", type=float, default=0.5)
    ss.add_argument("--blend", type=float, default=0.05,
                    help="identity fraction mixed into G")
    ss.add_argument("--tau", type=float, default=1.0)
    ss.add_argument("--omega", type=float, default=1.0)
    ss.add_argument("--tol", type=float, default=1e-5)
    ss.add_argument("--no-inbreeding", action="store_true",
                    help="classical A^-1 rules (skip Meuwissen-Luo F; "
                         "faster init on very large pedigrees)")
    ss.add_argument("--estimate-h2", action="store_true",
                    help="estimate the variance ratio by single-step "
                         "AI-REML before solving (replaces --h2)")
    ss.add_argument("--stream-chunk", type=int, default=0,
                    help="ingest the panel out-of-core in SNP chunks of "
                         "this size (panels beyond one card's memory)")

    sc = sub.add_parser("score", help="score a panel with exported marker "
                        "effects (plink --score role; centering uses the "
                        "training frequencies from the effects file)")
    sc.add_argument("bed")
    sc.add_argument("effects", help="TSV from gblup --effects-out")
    sc.add_argument("-o", "--out", default="scores.tsv")
    sc.add_argument("--force", action="store_true",
                    help="score even when SNP ids/alleles mismatch the .bim")

    pc = sub.add_parser("pca", help="top-k GRM principal components "
                        "(gcta --pca role; G applied implicitly, never "
                        "formed)")
    pc.add_argument("bed")
    pc.add_argument("-o", "--out", default="pca", metavar="PREFIX",
                    help="writes PREFIX.eigenvec + PREFIX.eigenval")
    pc.add_argument("-k", type=int, default=10, help="number of PCs")
    pc.add_argument("--oversample", type=int, default=8)
    pc.add_argument("--power-iters", type=int, default=2)
    pc.add_argument("--seed", type=int, default=0)
    pc.add_argument("--stream-chunk", type=int, default=0,
                    help="SNP chunk size for the out-of-core StreamedGeno "
                         "path (0 = in-memory)")

    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

"""One process of the multi-process drive of the parallel layer.

Each invocation is one process of an N-process ``torch.distributed`` group
(``MX_MP_DPP`` shards a process, default 4: CPU shards under gloo, or with
``MX_MP_BACKEND=nccl`` shards on the process's own card).  The checklist
crosses every process boundary one process cannot:

1. ``parallel.init_distributed``: the bootstrap, through a FileStore;
2. ``shard_genotypes_from_bed`` with read instrumentation: this process
   read only the SNP ranges of its own shards, and its words equal
   ``shard_genotypes`` of the dense panel;
3. ``sharded_dgemm`` both ways: 'n' (replicated) directly, 't'
   (row-sharded across processes) through ``host_global``, against the
   float64 oracle;
4. ``sharded_grm`` (and its row-scattered form) and the preconditioned
   ``sharded_cg_solve`` against the oracle, the solution's bytes equal on
   every process (an all_gather of its hash);
5. ``save_sharded`` / ``load_sharded``: the gather is collective, rank 0
   writes, and the reloaded panel computes the same product;
6. the 2D layer: ``shard_genotypes_2d_from_bed``, ``sharded_dgemm_2d``,
   ``sharded_grm_2d`` and ``sharded_cg_solve_2d`` across the same
   processes (lines of both axes may span processes);
7. failure injection: with ``MX_MP_FAIL_PID`` set, that process exits
   with code 3 after its ingestion; the survivors' next collective times
   out (``MX_MP_TIMEOUT`` seconds) and they end with an error.

    python -m miraculix_tpu_torch.parallel._mp_worker PID NPROC STORE WORKDIR

The parent writes WORKDIR/panel.bed and WORKDIR/oracle.npz first
(``mp_check.run_cluster`` does both).
"""
import hashlib
import os
import sys


def main():
    pid, nproc, store, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    dpp = int(os.environ.get("MX_MP_DPP", "4"))
    fail_pid = int(os.environ.get("MX_MP_FAIL_PID", "-1"))
    timeout_s = float(os.environ.get("MX_MP_TIMEOUT", "60"))
    backend = os.environ.get("MX_MP_BACKEND", "gloo")

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from miraculix_tpu_torch import parallel
    from miraculix_tpu_torch.io import bed as bedio

    # -- 1. bootstrap -----------------------------------------------------
    dev = (torch.device("cuda", pid % torch.cuda.device_count())
           if backend == "nccl" else torch.device("cpu"))
    got = parallel.init_distributed(
        num_processes=nproc, process_id=pid, backend=backend,
        init_method=f"file://{store}", timeout_s=timeout_s,
        device_id=dev if backend == "nccl" else None)
    assert got == pid == dist.get_rank() and dist.get_world_size() == nproc
    mesh = parallel.make_mesh(devices=[dev] * dpp)
    assert mesh.size == dpp * nproc and mesh.rank == pid

    bed_path = os.path.join(workdir, "panel.bed")
    oracle = np.load(os.path.join(workdir, "oracle.npz"))

    # -- 2. ingestion of this process's SNP ranges only -------------------
    reads = []
    orig_read = bedio.read_bed_slice_payload

    def instrumented(path, s0, s1):
        reads.append((s0, s1))
        return orig_read(path, s0, s1)

    bedio.read_bed_slice_payload = instrumented
    try:
        sg = parallel.shard_genotypes_from_bed(bed_path, mesh)
    finally:
        bedio.read_bed_slice_payload = orig_read
    own = {j * sg.spd for j in range(dpp * pid, dpp * (pid + 1))}
    got = {s0 for s0, _ in reads}
    assert got == own, (f"process {pid} read SNP ranges {sorted(got)}, "
                        f"its own are {sorted(own)}")
    dense = parallel.shard_genotypes(oracle["geno"], mesh)
    if backend == "nccl":
        from miraculix_tpu_torch import _kernels

        _kernels.reset_launch_counts()
    same = all(torch.equal(a, b) for a, b in zip(sg.zq_n + sg.zq_t + sg.freq,
                                                  dense.zq_n + dense.zq_t
                                                  + dense.freq))
    assert same, "from_bed shards differ from shard_genotypes"
    print(f"[{pid}] ingestion reads confined to own ranges: "
          f"{sorted(got)}; words equal to the dense packing", flush=True)

    if pid == fail_pid:
        # the survivors now wait on a peer that never arrives: their next
        # collective must time out with an error, not hang
        print(f"[{pid}] MP_FAIL_INJECTED: exiting before the checks",
              flush=True)
        os._exit(3)

    def close(got, want, what, tol=2e-4):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
        assert err < tol, f"{what}: rel err {err:.3g}"

    # -- 3. dgemm both ways ----------------------------------------------
    c_n = parallel.sharded_dgemm(sg, oracle["b_n"], trans="n")
    close(parallel.host_global(c_n), oracle["c_n"], "dgemm n")
    c_t = parallel.sharded_dgemm(sg, oracle["b_t"], trans="t")
    assert isinstance(c_t, parallel.RowSharded)
    close(parallel.host_global(c_t), oracle["c_t"], "dgemm t")
    print(f"[{pid}] sharded_dgemm n+t match oracle", flush=True)

    # -- 4. GRM + preconditioned CG ----------------------------------------
    n = sg.indiv
    close(parallel.host_global(parallel.sharded_grm(sg)), oracle["grm"],
          "grm")
    scat = parallel.host_global(parallel.sharded_grm(sg, scatter=True))
    close(scat[:n, :n], oracle["grm"], "grm scatter")
    assert np.abs(scat[n:]).max() == 0.0 and np.abs(scat[:, n:]).max() == 0
    lam, rhs = float(oracle["lam"]), oracle["rhs"]
    res = parallel.sharded_cg_solve(sg, rhs, lam=lam, tol=1e-6, maxiter=400,
                                    precondition=True)
    x = parallel.host_global(res.x)
    rel = (np.linalg.norm(oracle["g_unscaled"] @ x + lam * x - rhs)
           / np.linalg.norm(rhs))
    assert rel < 1e-4, f"CG residual {rel}"
    digest = torch.tensor(list(hashlib.sha256(x.tobytes()).digest()),
                          dtype=torch.int32, device=dev)
    every = [torch.empty_like(digest) for _ in range(nproc)]
    dist.all_gather(every, digest)
    assert all(torch.equal(d, digest) for d in every), \
        "CG solutions differ between processes"
    print(f"[{pid}] sharded_cg_solve residual {rel:.2e} in "
          f"{res.iterations} iters, bytes equal on all {nproc} processes",
          flush=True)

    # -- 5. checkpoint round trip -------------------------------------------
    ckpt = os.path.join(workdir, "ckpt.npz")
    parallel.save_sharded(ckpt, sg)
    sg_re = parallel.load_sharded(ckpt, mesh)
    c_re = parallel.sharded_dgemm(sg_re, oracle["b_n"], trans="n")
    assert torch.equal(c_re, c_n), "reloaded panel computes another product"
    print(f"[{pid}] save/load_sharded round trip ok", flush=True)

    # -- 6. the 2D layer -----------------------------------------------------
    mesh2 = parallel.make_mesh_2d(devices=[dev] * dpp)
    sg2 = parallel.shard_genotypes_2d_from_bed(bed_path, mesh2)
    dense2 = parallel.shard_genotypes_2d(oracle["geno"], mesh2)
    assert all(torch.equal(a, b) for a, b in zip(sg2.zq_n + sg2.zq_t,
                                                  dense2.zq_n + dense2.zq_t))
    c2 = parallel.sharded_dgemm_2d(sg2, parallel.pad_snp_vec(sg2,
                                                             oracle["b_n"]))
    close(parallel.host_global(c2)[:n], oracle["c_n"], "2D dgemm n")
    ct2 = parallel.sharded_dgemm_2d(
        sg2, parallel.pad_indiv_vec(sg2, oracle["b_t"]), trans="t")
    close(parallel.host_global(ct2)[: sg.snps], oracle["c_t"], "2D dgemm t")
    g2 = parallel.host_global(parallel.sharded_grm_2d(sg2))
    close(g2[:n, :n], oracle["grm"], "2D grm")
    res2 = parallel.sharded_cg_solve_2d(sg2, rhs, lam=lam, tol=1e-6,
                                        maxiter=400, precondition=True)
    x2 = parallel.host_global(res2.x)[:n]
    rel2 = (np.linalg.norm(oracle["g_unscaled"] @ x2 + lam * x2 - rhs)
            / np.linalg.norm(rhs))
    assert rel2 < 1e-4, f"2D CG residual {rel2}"
    print(f"[{pid}] 2D {mesh2.shape} dgemm + grm + CG ok (residual "
          f"{rel2:.2e}, {res2.iterations} iters)", flush=True)

    if backend == "nccl":
        plain = dict(_kernels.PLAIN_CALLS)
        assert not plain, f"plain versions ran on the card: {plain}"
        print(f"[{pid}] kernel launches "
              f"{ {k: v for k, v in _kernels.LAUNCHES.items() if v} }; "
              f"collectives {dict(parallel.COLLECTIVES)}", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    print(f"[{pid}] MP_DRIVE_OK", flush=True)


if __name__ == "__main__":
    main()

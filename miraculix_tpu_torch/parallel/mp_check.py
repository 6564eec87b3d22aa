"""Launcher of the multi-process drive (see ``_mp_worker.py``).

``run_cluster(n)`` writes a small .bed panel and its float64 oracle
results, then spawns ``n`` OS processes that form one ``torch.distributed``
group (gloo, CPU shards, one torch thread each) through a FileStore in a
temporary directory, and run the whole checklist: range-confined .bed
ingestion, sharded dgemm / GRM / CG against the oracle, the checkpoint
round trip and the 2D layer.  It crosses the process boundaries a single
process cannot (shard numbering across processes, subgroups of lines that
span processes, gathers of row-sharded results, rank-0 writes).

    python -m miraculix_tpu_torch.parallel.mp_check [n_processes]
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def write_oracle(workdir: str, indiv: int = 48, snps: int = 700,
                 seed: int = 7) -> None:
    """Write <workdir>/panel.bed and <workdir>/oracle.npz: the dense
    float64 results every worker holds its distributed outputs to."""
    import numpy as np

    from ..io import bed as bedio
    from ..io import codec

    g = bedio.simulate_genotypes(indiv, snps, seed=seed)
    bedio.write_bed(os.path.join(workdir, "panel.bed"), g)
    f = codec.allele_freq(g)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    rng = np.random.default_rng(seed + 1)
    b_n = rng.standard_normal((snps, 2)).astype(np.float32)
    b_t = rng.standard_normal((indiv, 2)).astype(np.float32)
    gu = zc @ zc.T
    np.savez(os.path.join(workdir, "oracle.npz"),
             geno=g, b_n=b_n, b_t=b_t,
             c_n=zc @ b_n.astype(np.float64),
             c_t=zc.T @ b_t.astype(np.float64),
             grm=gu / (2.0 * np.sum(f * (1.0 - f))), g_unscaled=gu,
             lam=np.float64(50.0),
             rhs=rng.standard_normal(indiv).astype(np.float32))


def run_cluster(num_processes: int = 2, timeout: float = 900.0,
                indiv: int = 48, snps: int = 700, devices_per_proc: int = 4,
                fail_process: int = None, *,
                collective_timeout: float = 60.0,
                backend: str = "gloo") -> list:
    """Spawn the N-process drive; raise with every worker's log on any
    failure.  Returns each process's output (each ends in MP_DRIVE_OK).

    ``devices_per_proc``: shards a process, on the CPU (``backend``
    "gloo") or, with "nccl", all on the process's own card (process i on
    card i modulo the cards).  ``fail_process``: that
    worker exits with code 3 after its ingestion, before the drive's
    first check; every survivor must then end with a nonzero code (its
    next collective times out after ``collective_timeout`` seconds)
    instead of hanging or reporting success, and the logs are returned."""
    with tempfile.TemporaryDirectory() as workdir:
        write_oracle(workdir, indiv=indiv, snps=snps)
        env = dict(os.environ, MX_MP_DPP=str(devices_per_proc),
                   MX_MP_TIMEOUT=str(collective_timeout),
                   MX_MP_BACKEND=backend, OMP_NUM_THREADS="1")
        if fail_process is not None:
            env["MX_MP_FAIL_PID"] = str(fail_process)
        store = os.path.join(workdir, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "miraculix_tpu_torch.parallel._mp_worker",
             str(i), str(num_processes), store, workdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=_REPO_ROOT) for i in range(num_processes)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out.decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            got = "\n---\n".join(outs)
            raise RuntimeError(
                f"mp drive timed out after {timeout}s; partial logs:\n{got}")
        logs = "\n".join(
            f"--- process {i} (rc={procs[i].returncode}) ---\n{outs[i]}"
            for i in range(num_processes))
        if fail_process is not None:
            assert procs[fail_process].returncode == 3, logs
            assert "MP_FAIL_INJECTED" in outs[fail_process], logs
            ok = [i for i in range(num_processes) if i != fail_process
                  and (procs[i].returncode == 0 or "MP_DRIVE_OK" in outs[i])]
            assert not ok, (f"survivors {ok} reported success despite a "
                            f"dead peer:\n{logs}")
            return outs
        bad = [i for i, (p, out) in enumerate(zip(procs, outs))
               if p.returncode != 0 or "MP_DRIVE_OK" not in out]
        if bad:
            raise RuntimeError(f"mp drive failed in process(es) {bad}:\n{logs}")
        return outs


if __name__ == "__main__":
    for line in run_cluster(int(sys.argv[1]) if len(sys.argv) > 1 else 2):
        print(line)

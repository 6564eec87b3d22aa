"""The port's parallel layer across real processes: ``mp_check.run_cluster``
spawns workers that form one ``torch.distributed`` group (gloo, CPU shards,
one torch thread each, a FileStore in a temporary directory) and run the
checklist of ``miraculix_tpu_torch/parallel/_mp_worker.py`` against a
dense float64 oracle (the reference's tests/test_multiprocess.py
counterpart): range-confined .bed ingestion, sharded dgemm both ways, the
GRM and the preconditioned CG (bytes equal on every process), the
checkpoint round trip and the 2D layer.  Every worker prints its lines and
ends in MP_DRIVE_OK.
"""
import pytest

pytest.importorskip("torch")


def _assert_drive(outs, n):
    assert len(outs) == n
    for i, out in enumerate(outs):
        assert "MP_DRIVE_OK" in out, f"process {i}:\n{out}"
        assert "ingestion reads confined to own ranges" in out
        assert f"bytes equal on all {n} processes" in out
        assert "save/load_sharded round trip ok" in out
        assert "dgemm + grm + CG ok" in out


def test_two_process_cluster_full_drive():
    """2 processes x 4 local shards: a 2 x 4 mesh whose "i" lines each
    span both processes."""
    from miraculix_tpu_torch.parallel import mp_check

    outs = mp_check.run_cluster(num_processes=2, timeout=300)
    _assert_drive(outs, 2)
    assert "2D {'i': 2, 'k': 4}" in outs[0]


def test_four_process_uneven_panel():
    """4 processes x 1 shard on an 8,300-SNP panel: partial shards, one
    empty shard, and a 2 x 2 mesh whose lines of both axes cross
    processes."""
    from miraculix_tpu_torch.parallel import mp_check

    outs = mp_check.run_cluster(num_processes=4, timeout=300, snps=8300,
                                devices_per_proc=1)
    _assert_drive(outs, 4)
    assert "reads confined to own ranges: [12288]" in outs[3]  # empty shard
    assert "2D {'i': 2, 'k': 2}" in outs[0]


def test_failure_injection_no_hang():
    """One worker exits with code 3 after its ingestion: the survivor's
    next collective fails (a closed peer or the 20 s collective timeout)
    and it ends with a nonzero code, neither hanging nor reporting
    success."""
    from miraculix_tpu_torch.parallel import mp_check

    outs = mp_check.run_cluster(num_processes=2, timeout=120,
                                fail_process=1, collective_timeout=20)
    assert "MP_FAIL_INJECTED" in outs[1]
    assert "MP_DRIVE_OK" not in outs[0]

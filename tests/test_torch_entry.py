"""The port's driver entry points against the reference's
``__graft_entry__``: ``entry(device="cpu")`` gives the reference entry's
result within 1e-5 of max (the reference on the suite's JAX CPU backend,
Pallas in interpret mode), and ``dryrun_multichip(4, device="cpu")`` runs
to its end on four CPU shards.  The two-process drive that
``dryrun_multichip`` adds at 8 shards is tested by
test_torch_multiprocess.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import __graft_entry__ as ref_entry  # noqa: E402

from miraculix_tpu_torch import entry as pt_entry  # noqa: E402


@pytest.fixture()
def no_card():
    """These tests check a host without a CUDA device (decided here, in
    the test, so every worker collects the same tests)."""
    if torch.cuda.is_available():
        pytest.skip("checks the host without a CUDA device")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_entry_matches_reference():
    fn, args = pt_entry.entry(device="cpu")
    gm, b = args
    assert (gm.indiv, gm.snps, b.shape, gm.device.type) == (
        512, 4096, (4096, 8), "cpu")
    got = fn(*args)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    rfn, rargs = ref_entry.entry()
    want = np.asarray(rfn(*rargs), np.float64)
    got = got.numpy().astype(np.float64)
    assert got.shape == want.shape == (512, 8)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(b, rargs[1])


def test_entry_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_entry.dryrun_multichip(4)


def test_dryrun_multichip_runs_on_cpu_shards():
    pt_entry.dryrun_multichip(4, device="cpu")

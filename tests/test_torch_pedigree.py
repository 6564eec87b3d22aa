"""The pedigree algebra against miraculix_tpu.pedigree and dense oracles.

The host functions (validation, Henderson's A^-1 with and without F, the
tabular A, the simulator, the reader and the Python Meuwissen-Luo) must
equal the reference bit for bit; ``inbreeding`` runs the port's native
codec and agrees with the Python oracle within 1e-12, counted in
``native.CALLS``; ``SparseCOO.matvec`` ('n' and 't', 1-D and 2-D) is within
1e-6 of the reference relative to max, ``diag`` and ``to_dense`` equal.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import pedigree as ref  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import pedigree as ped  # noqa: E402
from miraculix_tpu_torch.io import native  # noqa: E402

CPU = "cpu"
MRODE = (np.array([0, 0, 1, 1, 4, 5]), np.array([0, 0, 2, 0, 3, 2]))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pedigrees():
    """name -> (sire, dam): Mrode's textbook example and simulated ones
    (with and without unknown parents, inbred)."""
    return {"mrode": MRODE,
            "sim300": ref.simulate_pedigree(300, n_founders=30, seed=2,
                                            unknown_rate=0.15),
            "sim300_known": ref.simulate_pedigree(300, n_founders=30, seed=2,
                                                  unknown_rate=0.0),
            "sim400": ref.simulate_pedigree(400, n_founders=25, seed=5)}


@pytest.mark.parametrize("args", [
    dict(n=300, n_founders=30, seed=2, unknown_rate=0.15),
    dict(n=1000, n_founders=10, seed=7),
    dict(n=5, n_founders=5, seed=0),
], ids=["300", "1000", "founders_only"])
def test_simulate_pedigree_equals_reference(args):
    for got, want in zip(ped.simulate_pedigree(**args),
                         ref.simulate_pedigree(**args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["mrode", "sim300", "sim300_known",
                                  "sim400"])
@pytest.mark.parametrize("with_f", [False, True], ids=["F", "no_F"])
def test_a_inverse_equals_reference(pedigrees, name, with_f):
    sire, dam = pedigrees[name]
    f = np.zeros(len(sire)) if with_f else None
    for got, want in zip(ped.a_inverse(sire, dam, f=f),
                         ref.a_inverse(sire, dam, f=f)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["mrode", "sim300", "sim400"])
def test_a_matrix_and_python_inbreeding_equal_reference(pedigrees, name):
    sire, dam = pedigrees[name]
    np.testing.assert_array_equal(ped.a_matrix(sire, dam),
                                  ref.a_matrix(sire, dam))
    np.testing.assert_array_equal(ped._inbreeding_py(sire, dam),
                                  ref._inbreeding_py(sire, dam))


def test_native_inbreeding_is_counted_and_matches_the_oracle():
    sire, dam = ped.simulate_pedigree(3000, n_founders=60, seed=12,
                                      unknown_rate=0.08)
    if native.get_lib() is None:
        pytest.skip("native codec unavailable (no g++)")
    native.reset_call_counts()
    f = ped.inbreeding(sire, dam)
    assert native.CALLS["inbreeding"] == 1
    np.testing.assert_allclose(f, ref._inbreeding_py(sire, dam), atol=1e-12)
    assert f.max() > 0.01
    with native.disabled():
        np.testing.assert_array_equal(ped.inbreeding(sire, dam),
                                      ped._inbreeding_py(sire, dam))
    assert native.CALLS["inbreeding"] == 1


def test_mrode_textbook_pedigree():
    """Mrode's 6-animal example (Linear Models for the Prediction of Animal
    Breeding Values, ch. 2): known A entries, F = diag(A) - 1, and the
    sparse A^-1 is inv(A)."""
    sire, dam = MRODE
    a = ped.a_matrix(sire, dam)
    assert abs(a[4, 4] - 1.125) < 1e-12
    assert abs(a[0, 2] - 0.5) < 1e-12
    assert abs(a[2, 4] - 0.625) < 1e-12
    assert abs(a[4, 5] - 0.6875) < 1e-12
    np.testing.assert_allclose(ped.inbreeding(sire, dam), np.diag(a) - 1,
                               atol=1e-12)
    r, c, v = ped.a_inverse(sire, dam)
    ainv = np.zeros_like(a)
    np.add.at(ainv, (r, c), v)
    np.testing.assert_allclose(ainv, np.linalg.inv(a), atol=1e-10)


@pytest.mark.parametrize("name", ["sim300", "sim300_known"])
def test_henderson_inverts_tabular(pedigrees, name):
    sire, dam = pedigrees[name]
    a = ped.a_matrix(sire, dam)
    r, c, v = ped.a_inverse(sire, dam)
    ainv = np.zeros_like(a)
    np.add.at(ainv, (r, c), v)
    np.testing.assert_allclose(ainv @ a, np.eye(len(sire)), atol=1e-9)


def test_inbreeding_matches_tabular_diag(pedigrees):
    sire, dam = pedigrees["sim400"]
    f = ped.inbreeding(sire, dam)
    np.testing.assert_allclose(f, np.diag(ped.a_matrix(sire, dam)) - 1,
                               atol=1e-12)
    assert f.max() > 0.01


@pytest.mark.parametrize("sire,dam", [
    (np.array([2, 0]), np.array([0, 0])),          # a younger parent
    (np.array([0, 3]), np.array([0, 0])),          # out of range
    (np.array([0, 0]), np.array([0, -1])),         # negative
    (np.array([0, 0, 1]), np.array([0, 0])),       # lengths differ
    (np.zeros((2, 2), int), np.zeros((2, 2), int)),  # not 1-D
], ids=["younger", "range", "negative", "lengths", "2d"])
def test_check_pedigree_errors_equal_reference(sire, dam):
    with pytest.raises(ValueError) as want:
        ref.check_pedigree(sire, dam)
    with pytest.raises(ValueError) as got:
        ped.check_pedigree(sire, dam)
    assert str(got.value) == str(want.value)


PEDIGREE_FILES = {
    "labels": ("# toy pedigree\n"
               "calf1  bullA  cowB\n"   # parents defined below / implicitly
               "calf2  bullA  NA\n"
               "cowB   .      0\n"
               "calf3  calf1  cowB\n"),
    "founders_added": "x p q\ny p -\nz x y\n",
    "cycle": "a b 0\nb a 0\n",
    "conflict": "a 0 0\nb a 0\nb 0 0\n",
    "short_line": "a 0\n",
}


@pytest.mark.parametrize("name", sorted(PEDIGREE_FILES))
def test_read_pedigree_equals_reference(tmp_path, name):
    path = tmp_path / "ped.txt"
    path.write_text(PEDIGREE_FILES[name])
    try:
        want = ref.read_pedigree(str(path))
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            ped.read_pedigree(str(path))
        assert str(got.value) == str(exc)
        return
    sire, dam, labels = ped.read_pedigree(str(path))
    np.testing.assert_array_equal(sire, want[0])
    np.testing.assert_array_equal(dam, want[1])
    assert labels == want[2]
    ped.check_pedigree(sire, dam)


def test_read_pedigree_recodes_to_the_hand_coded_a(tmp_path):
    path = tmp_path / "ped.txt"
    path.write_text(PEDIGREE_FILES["labels"])
    sire, dam, labels = ped.read_pedigree(str(path))
    assert len(labels) == 5   # bullA added as an implicit founder
    code = {lab: i + 1 for i, lab in enumerate(labels)}
    a_hand = ped.a_matrix(np.array([0, 0, 1, 1, 3]), np.array([0, 0, 2, 0, 2]))
    perm = np.array([code[x] - 1 for x in
                     ["bullA", "cowB", "calf1", "calf2", "calf3"]])
    np.testing.assert_allclose(ped.a_matrix(sire, dam)[np.ix_(perm, perm)],
                               a_hand, atol=1e-12)


@pytest.fixture(scope="module")
def coo_pair():
    """(reference, port) SparseCOO of A^-1 of a 256-animal pedigree, and of
    a rectangular slice of its entries; the input block."""
    sire, dam = ref.simulate_pedigree(256, n_founders=20, seed=7)
    r, c, v = ref.a_inverse(sire, dam)
    x = np.random.default_rng(0).standard_normal((256, 4)).astype(np.float32)
    return {"square": (ref.SparseCOO(r, c, v, (256, 256)),
                       ped.SparseCOO(r, c, v, (256, 256), device=CPU)),
            "slice": (ref.SparseCOO(r[:100], c[:100], v[:100], (256, 256)),
                      ped.SparseCOO(r[:100], c[:100], v[:100], (256, 256),
                                    device=CPU))}, x


@pytest.mark.parametrize("which", ["square", "slice"])
@pytest.mark.parametrize("trans", ["n", "t"])
@pytest.mark.parametrize("ncol", [0, 4], ids=["1d", "2d"])
def test_sparse_coo_matvec_matches_reference(coo_pair, which, trans, ncol):
    pair, x = coo_pair
    r_op, p_op = pair[which]
    xv = x[:, 0] if ncol == 0 else x
    want = np.asarray(r_op.matvec(xv, trans=trans), np.float64)
    got = p_op.matvec(xv, trans=trans)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-6
    dense = p_op.to_dense()
    oracle = (dense if trans == "n" else dense.T) @ xv.astype(np.float64)
    assert np.abs(got.numpy() - oracle).max() / np.abs(oracle).max() < 1e-5


def test_sparse_coo_diag_and_dense_equal_reference(coo_pair):
    pair, _ = coo_pair
    r_op, p_op = pair["square"]
    np.testing.assert_array_equal(p_op.diag().numpy(), np.asarray(r_op.diag()))
    for which in ("square", "slice"):
        r_op, p_op = pair[which]
        np.testing.assert_array_equal(p_op.to_dense(), r_op.to_dense())
    assert p_op.nnz == r_op.nnz and p_op.shape == r_op.shape
    with pytest.raises(ValueError, match="non-square"):
        ped.SparseCOO([0], [1], [1.0], (2, 3), device=CPU).diag()


def test_sparse_coo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ped.SparseCOO([0], [0], [1.0], (1, 1))


def test_every_public_function_of_the_reference():
    """Every public function and class of the reference's pedigree module,
    with its parameters (names and kinds; defaults too, but for the dtype's
    framework); ``SparseCOO`` adds ``device`` last.  The package exports
    what the reference's exports."""
    public = {k: v for k, v in vars(ref).items()
              if not k.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == ref.__name__}
    assert {"SparseCOO", "a_inverse", "a_matrix", "inbreeding",
            "check_pedigree", "read_pedigree", "simulate_pedigree"} <= set(
                public)
    for name, ref_fn in public.items():
        want = inspect.signature(ref_fn).parameters
        got = inspect.signature(getattr(ped, name)).parameters
        assert list(got)[:len(want)] == list(want), name
        for k, p in want.items():
            assert got[k].kind == p.kind, (name, k)
            if k != "dtype":
                assert got[k].default == p.default, (name, k)
        assert list(got)[len(want):] == (["device"] if name == "SparseCOO"
                                         else []), name
    for name in ("SparseCOO", "a_inverse", "a_matrix", "inbreeding"):
        assert getattr(mt, name) is getattr(ped, name)

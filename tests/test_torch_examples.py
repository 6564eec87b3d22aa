"""Run every example of the port at the reference's test sizes, in a
subprocess on the CPU: ``python -m miraculix_tpu_torch.examples.<name>
--device cpu`` with the argv flags and ``MX_EX_*`` knobs of
tests/test_examples.py.  Each script's own checks must pass (they print
residuals and accuracies and exit nonzero on failure), and where those
checks are loose (``COMPARED``) the reference's script runs on the same argv
and knobs on the JAX CPU backend and every number both print is held to it:
counts exactly, CG iteration counts within 2, residuals within 10% at equal
iteration counts, top GWAS hits as a set, and every other number within one
unit of its last printed digit.  The port's examples must be the
reference's, name for name, and none of them may run on the CPU unasked.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "miraculix_tpu_torch", "examples")
REF_EXAMPLES = os.path.join(REPO, "examples")


@pytest.fixture()
def no_card():
    """These tests check a host without a CUDA device (decided here, in
    the test, so every worker collects the same tests)."""
    if torch.cuda.is_available():
        pytest.skip("checks the host without a CUDA device")

# tests/test_examples.py's table, with --device cpu added to each case
_CASES = {
    "exact_f64_solves.py": (["--snps", "1024", "--indiv", "256",
                             "--device", "cpu"], {}),
    "gblup_pipeline.py": (["--snps", "1536", "--indiv", "200",
                           "--pcs", "3", "--device", "cpu"], {}),
    "grm_solve_cg.py": (["--snps", "1536", "--indiv", "200",
                         "--device", "cpu"], {}),
    "mixblup_sparse_solve.py": (["3000", "--device", "cpu"], {}),
    "ssgblup_pipeline.py": (["--device", "cpu"],
                            {"MX_EX_ANIM": "160", "MX_EX_GENO": "50",
                             "MX_EX_SNPS": "512"}),
    "full_pipeline.py": (["--device", "cpu"],
                         {"MX_EX_N": "150", "MX_EX_NEW": "40",
                          "MX_EX_SNPS": "1536"}),
}


def _scripts(path):
    return sorted(f for f in os.listdir(path)
                  if f.endswith(".py") and f != "__init__.py")


def test_every_example_has_a_case():
    assert _scripts(EXAMPLES) == sorted(_CASES), (
        "miraculix_tpu_torch/examples/ and the smoke-test table drifted "
        "apart")
    assert _scripts(REF_EXAMPLES) == sorted(_CASES), (
        "the port's examples are not the reference's")


def _run(script, argv, env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **env_extra)
    return subprocess.run(
        [sys.executable, "-m",
         f"miraculix_tpu_torch.examples.{script[:-3]}", *argv],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)


def _run_reference(script, argv, env_extra):
    """The reference's script as tests/test_examples.py runs it."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               **env_extra)
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    proc = subprocess.run(
        [sys.executable, os.path.join(REF_EXAMPLES, script), *argv],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


# the examples whose own checks are loose (finite output, correlation > 0,
# CG converged): held number by number to the reference's printed output.
# exact_f64_solves and mixblup_sparse_solve check against float64 numpy.
COMPARED = ("full_pipeline.py", "gblup_pipeline.py", "grm_solve_cg.py",
            "ssgblup_pipeline.py")

_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _lines(out):
    """The printed lines, without wall-clock seconds and temporary paths."""
    return [re.sub(r"\d+\.\d+s\b", "<s>", ln) for ln in out.splitlines()
            if ln.strip() and not ln.startswith("pipeline artifacts in")]


def _agree(a, b, iterations):
    """Two printed numbers agree: integers exactly (CG iteration counts
    within 2), scientific ones within 10%, fixed-point ones within one unit
    of their last digit (rounding alone can part them by that much)."""
    fa, fb = float(a), float(b)
    if "e" in a + b:
        return abs(fa - fb) <= 0.1 * max(abs(fa), abs(fb))
    if "." not in a + b:
        return abs(fa - fb) <= (2 if iterations else 0)
    dec = max(len(t.split(".")[1]) for t in (a, b) if "." in t)
    return abs(fa - fb) <= 10.0 ** -dec + 1e-12


def _top_hits(ln):
    """A line cut before "top hits", and those hits as a set (near-tied
    p-values may swap order)."""
    if "top hits" not in ln:
        return ln, None
    head, tail = ln.split("top hits")
    return head, set(re.findall(r"\((\d+)\)", tail))


def _hold_to_reference(out, ref):
    """Line for line, the same words around the numbers, and the numbers
    held as ``_agree`` says."""
    got, want = _lines(out), _lines(ref)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        (g, hits_g), (w, hits_w) = _top_hits(g), _top_hits(w)
        assert hits_g == hits_w, (g, w)
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        ng, nw = _NUM.findall(g), _NUM.findall(w)
        iterations = "iterations" in g
        # a residual is comparable only at equal iteration counts
        same_counts = all(a == b for a, b in zip(ng, nw)
                          if not re.search(r"[.e]", a + b))
        for a, b in zip(ng, nw):
            if "e" in a + b and not same_counts:
                continue
            assert _agree(a, b, iterations), (
                f"port {a} vs reference {b} in\n  {g}\n  {w}")


@pytest.mark.parametrize("script", sorted(_CASES))
def test_example_runs(script):
    argv, env_extra = _CASES[script]
    proc = _run(script, argv, env_extra)
    assert proc.returncode == 0, (
        f"{script} failed (rc={proc.returncode})\n"
        f"stdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}")
    assert "FAIL" not in proc.stdout
    if script in COMPARED:
        _hold_to_reference(proc.stdout,
                           _run_reference(script, argv[:-2], env_extra))


def test_gblup_pipeline_on_a_mesh():
    """gblup_pipeline.py --mesh 4: the panel in 4 CPU shards, every printed
    number held to the single-device run (which test_example_runs holds to
    the reference's)."""
    argv, env_extra = _CASES["gblup_pipeline.py"]
    proc = _run("gblup_pipeline.py", argv + ["--mesh", "4"], env_extra)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "cor(estimated BV, true BV)" in proc.stdout
    _hold_to_reference(proc.stdout,
                       _run("gblup_pipeline.py", argv, env_extra).stdout)


@pytest.mark.parametrize("script", sorted(_CASES))
def test_example_refuses_the_cpu_unasked(script, no_card):
    """Without --device cpu on a host with no CUDA device: a nonzero exit
    naming --device cpu, before any work."""
    import importlib

    argv, _ = _CASES[script]
    assert argv[-2:] == ["--device", "cpu"]
    mod = importlib.import_module(
        f"miraculix_tpu_torch.examples.{script[:-3]}")
    with pytest.raises(SystemExit, match="--device cpu") as exc:
        mod.main(argv[:-2])
    assert exc.value.code != 0
    if script == "exact_f64_solves.py":      # one of them as a process
        proc = _run(script, argv[:-2], {})
        assert proc.returncode != 0 and "--device cpu" in proc.stderr

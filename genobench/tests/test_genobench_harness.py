"""The harness as a program: pieces found by name, the import rule, no
result without a card, and no result without the port."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import toy

ROOT = toy.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "miraculix_tpu")


def python(code: str, path: list, env=None, cwd=None):
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(path)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          cwd=cwd or ROOT, timeout=600)


def test_new_pieces_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric added as files, and a
    cell added to BENCHMARK.json, run with no edit to an existing file."""
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "genobench"), root / "genobench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (root / "genobench" / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "source": "test", "snps": 3000, "indiv": 300,
        "chips": 1, "reduced": [],
        "allele_freq": {"law": "uniform", "low": 0.1, "high": 0.4}}))
    (root / "genobench" / "traffic" / "tiny_grm.json").write_text(
        json.dumps({"job": "grm", "proj_cols": 2,
                    "limits": {"grm": 1e-5, "grm_proj": 1e-4}}))
    (root / "genobench" / "metrics" / "jobs.count.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "genobench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.tiny_grm", "config": "tiny",
                               "traffic": "tiny_grm", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "jobs.count", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "job_s",
                               "workloads": ["tiny.tiny_grm"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = python("""
        import json, torch
        from genobench import harness
        bench = harness.benchmark()
        assert harness.HERE.parent.name == "tree", harness.HERE
        _, conf, mix = harness.cell(bench, "tiny.tiny_grm")
        for traced in (False, True):
            res, _ = harness.drive(bench, "tiny.tiny_grm", conf, mix, 5,
                                   0.2, traced, torch.device("cpu"))
            print(json.dumps(res))
        """, [str(root), ROOT], cwd=str(root))
    assert out.returncode == 0, out.stderr
    untraced, traced = (json.loads(line) for line in
                        out.stdout.strip().splitlines()[-2:])
    assert untraced["correct"] and traced["correct"]
    assert traced["metrics"]["jobs.count"]["value"] == traced["attempted"]
    assert "jobs.count" not in untraced["metrics"]


def test_no_jax_and_a_plain_reference():
    """What a run loads holds no module named jax, jaxlib, flax or
    miraculix_tpu (top-level names compared whole), and the reference
    loads nothing of the port."""
    out = python("""
        import sys, torch
        from genobench.tests import toy
        for name in toy.cells():
            toy.drive(name, seconds=0.1, traced=name.endswith("grm"))
        import genobench.calibrate, genobench.run
        print(sorted({m.split(".")[0] for m in sys.modules}))
        """, [ROOT])
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "miraculix_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
    out = python("""
        import sys, torch
        from genobench import genotypes
        from genobench.reference import grm, gwas, solve, zpass
        spec = genotypes.Spec(500, 200, 3, 0.05, 0.5, torch.device("cpu"))
        grm.full(spec)
        print(sorted({m.split(".")[0] for m in sys.modules}))
        """, [ROOT])
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN + ("miraculix_tpu_torch",)), loaded


def test_run_refuses_without_a_card():
    """No CUDA card: exit non-zero and no result line (never the CPU)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "genobench/run.py", "--workload", "many_snps.grm",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_needs_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files:
    exit non-zero and no result."""
    shutil.copytree(os.path.join(ROOT, "genobench"), tmp_path / "genobench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "genobench/run.py", "--workload", "small.gblup",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "miraculix_tpu_torch" in out.stderr

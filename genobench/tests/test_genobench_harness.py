"""The harness as a program: pieces found by name, the import rule, no
result without a card, and no result without the port."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

import toy

ROOT = toy.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "miraculix_tpu")


def python(code: str, path: list, env=None, cwd=None):
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(path)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          cwd=cwd or ROOT, timeout=600)


AINV_KIND = '''\
"""A^-1 v on the pedigree of the configuration's ``pedigree`` block,
through the port's ``pedigree.a_inverse`` and ``SparseCOO``; checked
against the dense A of the tabular method in float64 (``ainv``: the
largest |A x - v| over the largest |v|)."""
import numpy as np
import torch


def pedigree(block, seed):
    rng = np.random.default_rng(seed)
    n, f = block["animals"], block["founders"]
    sire, dam = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for i in range(f, n):
        s, d = rng.integers(max(0, i - 3 * f), i, size=2) + 1
        sire[i], dam[i] = s, (d if d != s else 0)
    return sire, dam


def a_dense(sire, dam):
    n = len(sire)
    a = np.zeros((n + 1, n + 1))
    s, d = np.concatenate([[0], sire]), np.concatenate([[0], dam])
    for i in range(1, n + 1):
        a[i, 1:i] = a[1:i, i] = 0.5 * (a[1:i, s[i]] + a[1:i, d[i]])
        a[i, i] = 1.0 + 0.5 * a[s[i], d[i]]
    return torch.as_tensor(a[1:, 1:])


class Job:
    def __init__(self, spec, traffic, seed, config, device):
        from miraculix_tpu_torch import pedigree as port

        self.port, self.limits, self.device = port, traffic["limits"], device
        self.sire, self.dam = pedigree(config["pedigree"], seed)
        self.v = torch.as_tensor(np.random.default_rng(seed + 1)
                                 .standard_normal(len(self.sire)))
        self.kept = []

    def prepare(self, i):
        pass

    def run(self, i):
        r, c, v = self.port.a_inverse(self.sire, self.dam)
        n = len(self.sire)
        return self.port.SparseCOO(r, c, v, (n, n), device=self.device
                                   ).matvec(self.v)

    def record(self, i, out):
        self.kept.append(out.cpu().double())
        return {"ok": True}

    def release(self):
        pass

    def _compare(self, answers):
        a = a_dense(self.sire, self.dam)
        gap = max(float((a @ x - self.v).abs().max() / self.v.abs().max())
                  for x in answers)
        return [("ainv", gap, self.limits["ainv"])]

    def check(self):
        return self._compare(self.kept)

    def control(self, jobs):
        x = torch.linalg.solve(a_dense(self.sire, self.dam), self.v)
        return self._compare([x.to(torch.bfloat16).double()] * jobs)
'''

AINV_FAULTS = '''\
"""Faults an ``ainv`` job can have."""


def dropped_sire(fn, mix):
    def broken(sire, dam, *a, **kw):
        sire = sire.copy()
        sire[-1] = 0
        return fn(sire, dam, *a, **kw)
    return broken


FAULTS = [("altered", ("pedigree", "a_inverse", dropped_sire))]
'''

PANEL = {"snps": 3000, "indiv": 300,
         "allele_freq": {"law": "uniform", "low": 0.1, "high": 0.4}}
PEDIGREE = {"pedigree": {"animals": 200000, "founders": 2000}}


def copied_tree(tmp_path):
    """The benchmark's files in a git repository of their own, committed."""
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "genobench"), root / "genobench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t"]
    for args in (["init", "-q"], ["add", "-A"], ["commit", "-qm", "tree"]):
        subprocess.run(git + args, cwd=root, check=True, capture_output=True)
    return root


def add_cell(root, config: dict, traffic: str, mix: dict, per_layer=()):
    """A configuration file, a mix file and a cell added to BENCHMARK.json."""
    name = config["name"]
    (root / "genobench" / "configs" / f"{name}.json").write_text(
        json.dumps(dict(config, source="test", chips=1, reduced=[])))
    (root / "genobench" / "traffic" / f"{traffic}.json").write_text(
        json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"genobench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": f"{name}.{traffic}", "config": name,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    bench["per_layer"] += list(per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return f"{name}.{traffic}"


@pytest.mark.parametrize("case", ["mix", "kind", "panel_less"])
def test_new_pieces_are_found_by_name(tmp_path, case):
    """Pieces added as files, and a cell added to BENCHMARK.json, run with
    no edit to an existing file.  ``mix``: a configuration, a mix of an
    existing kind and a metric, driven plain and traced.  ``kind``: a job
    kind that reads a block of its configuration beside the panel (a
    pedigree, shrunk whole by its toy size), with its toy size and its
    faults: the copy's own tests drive it, sound and faulty.  ``panel_less``:
    the same kind on a configuration without a panel."""
    root = copied_tree(tmp_path)
    if case == "mix":
        cell = add_cell(root, dict(PANEL, name="tiny"), "tiny_grm",
                        {"job": "grm", "proj_cols": 2,
                         "limits": {"grm": 1e-5, "grm_proj": 1e-4}},
                        [{"name": "jobs.count", "unit": "jobs",
                          "better": "higher", "source": "host_clock",
                          "layer": "test", "moves": "job_s",
                          "workloads": ["tiny.tiny_grm"]}])
        (root / "genobench" / "metrics" / "jobs.count.py").write_text(
            "def read(run):\n    return float(len(run.jobs))\n")
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
        assert traced["metrics"]["jobs.count"]["value"] == \
            traced["attempted"]
        assert "jobs.count" not in untraced["metrics"]
    else:
        conf = dict(PEDIGREE, name="toyped")
        if case == "kind":
            conf.update(PANEL)
        cell = add_cell(root, conf, "ainv",
                        {"job": "ainv", "limits": {"ainv": 1e-4}})
        tests = root / "genobench" / "tests"
        (root / "genobench" / "jobs" / "ainv.py").write_text(AINV_KIND)
        (tests / "faults" / "ainv.py").write_text(AINV_FAULTS)
        (tests / "sizes" / "toyped.json").write_text(json.dumps(
            {"pedigree": {"animals": 240, "founders": 24}}))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root),
                                                           ROOT]))
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-rA",
             "-p", "no:cacheprovider", "-p", "no:randomly",
             "genobench/tests/test_genobench_jobs.py", "-k",
             f"{cell} or every"], capture_output=True, text=True,
            env=env, cwd=root, timeout=600)
        assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
        passed = [line.split("::")[1] for line in out.stdout.splitlines()
                  if line.startswith("PASSED")]
        want = [f"test_sound_run_is_correct[{cell}]",
                f"test_control_fails_and_program_passes[{cell}]",
                f"test_fault_is_not_correct[{cell}-altered-",
                "test_every_configuration_has_toy_sizes",
                "test_every_cell_has_faults"]
        assert len(passed) == len(want) and all(
            any(p.startswith(w) for p in passed) for w in want), \
            out.stdout[-4000:]
    status = subprocess.run(["git", "status", "--porcelain",
                             "--untracked-files=all"], cwd=root,
                            capture_output=True, text=True, check=True)
    changed = {line[3:]: line[:2] for line in status.stdout.splitlines()}
    assert {p for p, how in changed.items() if how != "??"} == \
        {"BENCHMARK.json"}, changed
    assert all(p.startswith("genobench/") for p, how in changed.items()
               if how == "??"), changed


def test_no_jax_and_a_plain_reference():
    """What a run loads holds no module named jax, jaxlib, flax or
    miraculix_tpu (top-level names compared whole), and the reference
    (every module of ``genobench/reference/``) loads nothing of the
    port."""
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
        import importlib, pkgutil, sys, torch
        from genobench import genotypes, reference
        for mod in pkgutil.iter_modules(reference.__path__):
            importlib.import_module(f"genobench.reference.{mod.name}")
        from genobench.reference import grm
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

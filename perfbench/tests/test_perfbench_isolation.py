"""What the harness may load and where it may run."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import harness

ROOT = harness.ROOT
PERFBENCH = ROOT / "perfbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (PERFBENCH / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"convofusion_tpu_torch", "convofusion_tpu", "jax",
                           "jaxlib", "flax"}, path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "convofusion_tpu_torch_x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    """A whole tiny run of every cell in a fresh process, then its
    sys.modules."""
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
from perfbench import harness
from perfbench.tests import tiny
for w in harness.manifest()["workloads"]:
    harness.run(tiny.context(w["name"], {str(tmp_path)!r}))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "convofusion_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "cf_sample_b32",
         "--seed", "5", "--seconds", "1", *extra], cwd=cwd,
        capture_output=True, text=True, env=env, timeout=600)


def test_no_card_fails_and_prints_no_result():
    res = _run(ROOT)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "CUDA device" in res.stderr


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert "{" not in res.stdout

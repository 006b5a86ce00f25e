"""What the benchmark loads and refuses: no module of JAX or of the JAX
package ``repro`` (top-level names compared whole), no run without a
card, no run without the program."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness

ROOT = harness.ROOT


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.serving", "repro", "repro.core",
            "jaxlib.xla_client", "jax_stub", "flax", "reprox", "numpy"]
    assert harness.forbidden_modules(mods) == [
        "flax", "jaxlib.xla_client", "repro", "repro.core"]


def test_a_rehearsed_run_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "from portbench.tests._cpu import rehearse\n"
        "from portbench import harness\n"
        "r = rehearse('sc2.code.routed', seconds=0.5)\n"
        "assert r['run'].record.tokens > 0\n"
        "print(harness.forbidden_modules(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli(root, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sc2.code.routed",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _cli(ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_cli_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _imports(path):
    import ast
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module


BENCH_FILES = sorted((ROOT / "portbench").rglob("*.py"))


@pytest.mark.parametrize("path", BENCH_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_the_benchmark(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench" / "reference").glob("*.py")) + [
        ROOT / "portbench" / "yardstick.py",
        ROOT / "portbench" / "traffic.py"],
    ids=lambda p: p.name)
def test_yardstick_and_reference_import_nothing_of_the_program(path):
    assert not [m for m in _imports(path) if m.startswith("repro_torch")]

"""A later change adds a cell, a traffic mix, a configuration's limits and
a per-layer metric by adding files and BENCHMARK.json entries only: the
harness finds each by its name."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def test_new_cell_mix_and_metric_found_by_name(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "portbench"
    mix = json.loads((pb / "traffic" / "code.routed.json").read_text())
    mix.update(why="short distinct prompts", arrival_gap_s=60.0)
    (pb / "traffic" / "code.short.json").write_text(json.dumps(mix))
    (pb / "limits" / "sc2.short.routed.json").write_text(json.dumps(
        {"logit_gap": {"limit": 1.0}}))
    (pb / "metrics" / "tokens_per_stream.py").write_text(
        "def read(run):\n"
        "    n = len(run.record.streams)\n"
        "    return run.record.tokens / n if n else None\n")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sc2.code.routed" in m.get("workloads", ()):
            m["workloads"].append("sc2.short.routed")
    bench["workloads"].append({"name": "sc2.short.routed",
                               "config": "starcoder2-7b",
                               "traffic": "code.short", "chips": 1,
                               "why": "short prompts"})
    bench["per_layer"].append({"name": "tokens_per_stream",
                               "unit": "tokens", "better": "higher",
                               "source": "program_counter",
                               "layer": "window loop", "moves":
                               "tokens_per_s",
                               "workloads": ["sc2.short.routed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json\n"
        "from portbench import harness\n"
        "from portbench.tests._cpu import rehearse\n"
        "r = rehearse('sc2.short.routed', seconds=0.5,\n"
        "             bench=harness.benchmark())\n"
        "print(json.dumps(sorted(r['metrics'])))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"tokens_per_stream", "tokens_per_s", "route_ms"} <= set(names)
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"

"""CPU rehearsals of the benchmark's cells at a tiny width, for the tests:
the same harness, entries, traffic generator, metrics and comparison as a
run on the card, with the port's plain paths on the CPU."""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch

from portbench import harness

#: a tiny decoder of each family (the cells' own layer structure is cut)
TINY = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=512)
TINY_MOE = dict(TINY, num_experts=8, experts_per_token=2, d_ff=32)
DEPLOYMENT = {"deployment": {"layers_per_stage": 1,
                             "replicas": {"honeypot": 2, "turtle": 2,
                                          "golden": 2}}}
SHORT = {"total_tokens": {"dist": "loguniform", "lo": 48, "hi": 160,
                          "minus_output": True},
         "output_tokens": {"dist": "uniform", "lo": 4, "hi": 10},
         "check_tokens": 24}


def step_clock(step: float = 1e-3):
    """A clock that advances ``step`` seconds at every reading."""
    count = itertools.count()
    return lambda: next(count) * step


def rehearse(workload: str, seed: int = 3, seconds: float = 1.5,
             faults: tuple = (), control: bool = False,
             bench: Optional[Dict] = None) -> Dict:
    """One run of ``workload`` on the CPU, its window read on a step clock
    (1 ms a reading), so that the window holds the same work on a loaded
    machine; returns the run, its non-device metrics and its
    comparison."""
    torch.set_num_threads(1)
    bench = bench or harness.benchmark()
    cell = harness.find_cell(bench, workload)
    moe = "qwen" in cell["config"]
    run = harness.prepare(bench, workload, seed, seconds, False, "cpu",
                          0.0, overrides=TINY_MOE if moe else TINY,
                          config_patch=DEPLOYMENT, mix_patch=SHORT,
                          faults=faults, clock=step_clock())
    harness.run_cell(run)
    specs = [m for m in harness.metric_names(bench, workload, False)
             + harness.metric_names(bench, workload, True)
             if m["source"] != "device_trace"]
    metrics = harness.read_metrics(run, specs)
    compared = harness.compare(run, control=control)
    failed = harness.failed_streams(run)
    line = harness.result_line(
        run, metrics, compared, failed,
        {"platform": "cpu-rehearsal", "kind": "cpu", "count": 1,
         "memory_peak_bytes": 0}, 0.0)
    return {"run": run, "metrics": metrics, "compared": compared,
            "line": line}

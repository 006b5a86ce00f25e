"""Each cell's entry rehearsed on the CPU at a tiny width: the window,
its counters, the last line's keys, the comparison, and the planted
faults the comparison must catch."""
from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests._cpu import rehearse

ROUTED = ("sc2.code.routed", "qwen3moe.chat.routed")


@pytest.mark.parametrize("workload", ROUTED)
def test_routed_entry_counts_windows_forwards_tokens(workload):
    r = rehearse(workload)
    rec, line = r["run"].record, r["line"]
    assert rec.route_calls > 0 and rec.forwards > 0
    assert rec.tokens > 0 and rec.attempted >= len(rec.streams) > 0
    assert any(s.finished for s in rec.streams)
    # every stage forward of every emitted token, prefill chunks on top
    assert rec.forwards >= 4 * rec.tokens
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    limits = harness.load_json(harness.HERE / "limits"
                               / f"{workload}.json")
    assert set(line["compared"]) == {"route_mismatch", "failed"} | \
        set(limits)
    for name in ("tokens_per_s", "itl_ms.p95", "setup_s", "mfu",
                 "route_ms", "forwards_per_token", "warm_hit_rate",
                 "completion_share"):
        assert name in r["metrics"], name
    assert r["metrics"]["forwards_per_token"]["value"] >= 4
    assert len(rec.in_flight) == rec.route_calls
    assert 0 < line["run"]["in_flight_mean"] <= rec.attempted
    assert sum(line["run"]["tokens_by_quarter"]) == rec.tokens


def test_engine_entry_counts_batches_and_tokens():
    r = rehearse("sc2.code.engine")
    rec, line = r["run"].record, r["line"]
    assert rec.attempted % 8 == 0 and rec.attempted >= 8
    assert rec.tokens > 0 and rec.route_calls == 0
    done = [s for s in rec.streams if s.finished]
    assert done and all(len(s.output) == s.max_new_tokens for s in done)
    assert line["correct"] is True
    assert set(line["compared"]) == {"logit_gap", "failed"}
    assert "logit_err" not in line["run"]["readings"]   # no logits here
    assert {"tokens_per_s", "itl_ms.p95", "setup_s",
            "mfu"} <= set(r["metrics"])


@pytest.mark.parametrize("workload,fault", [
    ("sc2.code.routed", "identity_stage"),
    ("sc2.code.routed", "alter_token"),
    ("sc2.code.routed", "alter_plan"),
    ("qwen3moe.chat.routed", "alter_token"),
    ("sc2.code.engine", "stuck_decode"),
    ("sc2.code.engine", "alter_token"),
])
def test_planted_fault_is_not_correct(workload, fault):
    r = rehearse(workload, faults=(fault,))
    assert r["line"]["correct"] is False, r["compared"]


def test_traced_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for CPU runs")
    bench = harness.benchmark()
    run = harness.prepare(bench, "sc2.code.routed", 1, 1.0, True, "cpu",
                          0.0)
    with pytest.raises(RuntimeError, match="needs the card"):
        harness.run_cell(run)

"""The schedule-only rehearsal that sets each routed mix's arrival gap:
it runs each routed cell's simulation at the cell's layer count and
counts the streams in flight, and a longer gap keeps fewer in flight."""
from __future__ import annotations

import pytest

from portbench import rehearse

COST_MS = (3.3, 6e-3, 1.5e-7)


@pytest.mark.parametrize("workload", ["sc2.code.routed",
                                      "qwen3moe.chat.routed"])
def test_rehearsal_counts_streams_in_flight(workload):
    gap = rehearse.traffic.load(
        rehearse.harness.find_cell(rehearse.harness.benchmark(),
                                   workload)["traffic"])["arrival_gap_s"]
    near = rehearse.rehearse(workload, gap, COST_MS, 20.0, seed=11)
    far = rehearse.rehearse(workload, 4 * gap, COST_MS, 20.0, seed=11)
    assert near["admitted"] >= 2 and near["tokens_per_s"] > 0
    assert 1.0 < near["in_flight"] <= near["admitted"]
    assert far["in_flight"] < near["in_flight"]


def test_rehearsal_refuses_an_engine_cell():
    with pytest.raises(ValueError, match="not a routed cell"):
        rehearse.rehearse("sc2.code.engine", 1.0, COST_MS, 1.0, seed=1)

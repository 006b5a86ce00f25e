"""BENCHMARK.json against the benchmark's contract, and every name it
holds against the files that carry it."""
from __future__ import annotations

import json
import re

from portbench import harness, traffic

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_name_has_its_file():
    b = _bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cfg_file = ROOT / configs[w["config"]]["file"]
        config = json.loads(cfg_file.read_text())
        assert config["source"] == configs[w["config"]]["source"]
        assert sorted(config["reduced"]) == \
            sorted(configs[w["config"]]["reduced"])
        mix = traffic.load(w["traffic"])
        assert (harness.HERE / "entries" / f"{mix['entry']}.py").exists()
        limits = harness.load_json(harness.HERE / "limits"
                                   / f"{w['name']}.json")
        assert limits and set(limits) <= {"logit_gap", "logit_err",
                                          "greedy_excess"}
        assert all(v["limit"] >= 0 for v in limits.values())
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_every_cell_reports_its_metrics():
    b = _bench()
    for w in b["workloads"]:
        traced = harness.metric_names(b, w["name"], True)
        plain = harness.metric_names(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in plain}
        assert len(plain) >= 2 and traced

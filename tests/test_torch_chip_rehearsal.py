"""The CPU rehearsal of ``chip_smoke.py`` phase 17 (``edge_control``).

The phase's hedge and worker-drill counts come from the simulation, which
draws nothing that depends on the model's width, so the phase runs here
at the full depth of 36 layers and a tiny width, on the kernels' plain
versions: its gates (tokens per stream, hedges fired against
``EDGE_HEDGES_FIRED``, the honest control-plane run, the composed digest
against the in-process twin, f32 kernel-vs-plain parity, the trace export
and TTFT identity, the worker drill's tokens against
``EDGE_CHAOS_TOKENS``, no worker left) must pass as they stand. Only the
kernel-launch gates are replaced: the CPU launches no kernel, so K3 is
counted as one launch per layer of every stage forward the phase ran.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rehearsal", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase17_rehearsal(monkeypatch, capsys):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    seen = {}

    def check_served(cfg, srv, done, counts, forwards):
        assert all(r.metrics.tokens == cs.NEW_TOKENS for r in done)
        seen["windows"] = srv.router.stats.windows

    orig = cs.check_edge_counts

    def check_edge_counts(cfg, srv, done, counts, forwards, tally):
        per_stage = cfg.num_layers // srv.partition.n_stages
        orig(cfg, srv, done, dict(counts, flash_attention=forwards
                                  * per_stage), forwards, tally)
        seen["tally"] = dict(tally)

    monkeypatch.setattr(cs, "check_served", check_served)
    monkeypatch.setattr(cs, "check_edge_counts", check_edge_counts)
    cfg = dataclasses.replace(get_config("gpt2-large").reduced(
        num_layers=36, d_model=32, d_ff=64, num_heads=2, num_kv_heads=1,
        head_dim=16), attn_impl="flash")
    params = init_params(cfg, torch.Generator().manual_seed(cs.SEED), "cpu")
    cs.phase_edge_control(cfg, params, 0.0)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            rows.update(json.loads(line))
    served = rows["hedged_serving"]
    assert served["hedges_fired"] == cs.EDGE_HEDGES_FIRED
    assert (served["windows"], served["dp_windows"]) == (34, 34)
    assert seen["tally"] == {"primary": served["primary_forwards"],
                             "hedge": served["hedge_forwards"]}
    assert served["health"]["rpc_timeouts"] == 0
    assert served["worker_start_method"] == "spawn"
    assert rows["trace_export"]["schema_errors"] == 0
    chaos = rows["worker_chaos"]
    assert tuple(chaos["tokens_per_stream"]) == cs.EDGE_CHAOS_TOKENS
    assert chaos["health"]["worker_restarts"] == 1
    assert rows["edge_control_step_ms"] and cs.shard_workers() == []

"""The lower-precision control fails each cell's limit: the reference in
float8 put in the program's place in the harness's own comparison, on a
perfect program's served tokens (the float32 reference's own greedy
decode), at a size a test run holds; the perfect program passes it."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import decoder

SIZE = dict(num_layers=8, num_heads=8, num_kv_heads=2, vocab_size=4096)
FAMILY = {"starcoder2-7b": dict(SIZE, d_model=512, head_dim=64, d_ff=2048),
          "qwen3-moe-30b-a3b": dict(SIZE, d_model=256, head_dim=32,
                                    d_ff=128, num_experts=16,
                                    experts_per_token=4)}
PROMPT, SERVED = 32, 64


def _cells():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return [(w["name"], w["config"]) for w in bench["workloads"]]


@pytest.mark.parametrize("workload,config", _cells())
def test_float8_control_fails_the_limit(workload, config):
    from repro_torch.configs import get_config
    torch.set_num_threads(1)           # beside the suite's other workers
    limits = harness.load_json(harness.HERE / "limits"
                               / f"{workload}.json")
    cfg = get_config(config).reduced(**FAMILY[config])
    W = weights.make_params(cfg, 1, "cpu", decoder.layout)
    g = torch.Generator().manual_seed(0)
    per_step = workload.endswith(".routed")
    streams = []
    for _ in range(4):
        seq = torch.randint(0, cfg.vocab_size, (PROMPT,), generator=g)
        for _ in range(SERVED):        # greedy: one full forward a token
            nxt = decoder.forward_logits(cfg, W, seq, [len(seq) - 1])
            seq = torch.cat([seq, nxt.argmax(-1)])
        streams.append(harness.Stream(
            seq[:PROMPT].numpy().astype(np.int32), SERVED,
            output=seq[PROMPT:].tolist(), finished=True))
    for s in streams:                  # the perfect program's own logits
        prompt = torch.as_tensor(s.prompt.astype(np.int64))
        s.logits = list(decoder.served_logits(cfg, W, prompt, s.output,
                                              per_step))
    exact = harness.readings(decoder, cfg, W, streams, per_step, "cpu")
    assert max(exact["logit_gap"]) == 0.0 and max(exact["logit_err"]) < 1e-5
    assert max(exact["greedy_excess"]) <= 0.0
    bench = harness.benchmark()
    run = harness.prepare(bench, workload, 5, 1.0, False, "cpu", 0.0,
                          mix_patch={"check_tokens": len(streams) * SERVED})
    run.cfg, run.params = cfg, W
    run.record.streams = streams
    run.record.check["per_step_capacity"] = per_step
    assert harness.is_correct(harness.compare(run)), run.record.check
    control = harness.compare(run, control=True)
    assert run.record.check["control"] == "fp8"
    assert run.record.check["checked_tokens"] == len(streams) * SERVED
    # the control fails one of the cell's numbers at least, and with it
    # the comparison that decides ``correct``
    assert not harness.is_correct(control), control
    assert any(control[name]["value"] > lim["limit"]
               for name, lim in limits.items()), control

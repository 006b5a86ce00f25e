"""The plain references: the K-best chains against an enumeration of
every chain, the plan comparison, and the MoE capacity grouping of the
decoder reference against one forward per position."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench import weights
from portbench.reference import decoder, kbest
from portbench.tests._cpu import TINY_MOE


def _table(rng, stages=3, per_stage=4):
    n = stages * per_stage
    return {"layer_start": np.repeat(np.arange(stages), per_stage) * 2,
            "layer_end": np.repeat(np.arange(1, stages + 1), per_stage) * 2,
            "trust": rng.uniform(0.9, 1.0, n),
            "latency_ms": rng.uniform(1.0, 300.0, n),
            "alive": rng.uniform(size=n) > 0.1}


def _enumerate(t, tau, timeout):
    cost = t["latency_ms"] + (1 - t["trust"]) * timeout
    ok = t["alive"] & (t["trust"] >= tau)
    stages = sorted(set(t["layer_start"].tolist()))
    rows = [[r for r in np.nonzero(ok & (t["layer_start"] == s))[0]]
            for s in stages]
    return sorted((float(sum(cost[list(c)])), tuple(int(r) for r in c))
                  for c in itertools.product(*rows))


def test_kbest_equals_enumeration():
    rng = np.random.default_rng(0)
    for _ in range(20):
        t = _table(rng)
        ref = _enumerate(t, 0.95, 25_000.0)[:4]
        got = kbest.kbest(t, 6, 0.95, 25_000.0, 4)
        assert [c for c, _ in got] == [c for c, _ in ref]


def test_plan_mismatch_accepts_the_plan_and_catches_an_altered_one():
    rng = np.random.default_rng(1)
    t = _table(rng)
    ref = kbest.kbest(t, 6, 0.95, 25_000.0, 4)
    chains = [list(c) for _, c in ref]
    costs = [np.float32(c).item() for c, _ in ref]
    assert not kbest.plan_mismatch(t, 6, 0.95, 25_000.0, 4, chains, costs)
    worse = costs[:1] + [c + 1.0 for c in costs[1:]]
    assert kbest.plan_mismatch(t, 6, 0.95, 25_000.0, 4, chains, worse)
    assert kbest.plan_mismatch(t, 6, 0.95, 25_000.0, 4, chains[1:],
                               costs[1:])


def test_moe_per_step_capacity_is_one_forward_per_position():
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-30b-a3b").reduced(**TINY_MOE)
    W = weights.make_params(cfg, 5, "cpu", decoder.layout)
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (90,), generator=g)
    out = torch.randint(0, cfg.vocab_size, (40,), generator=g).tolist()
    got = decoder.served_logits(cfg, W, prompt, out, per_step_capacity=True)
    seq = torch.cat([prompt, torch.tensor(out)])
    for j in (0, 13, 39):
        one = decoder.forward_logits(cfg, W, seq, [89 + j])
        assert torch.allclose(got[j], one[0], atol=1e-5, rtol=1e-5)
    # the capacity changes across these prefixes, so a single forward over
    # the whole sequence is a different computation
    caps = {decoder.moe_capacity(cfg, 90 + j) for j in range(40)}
    assert len(caps) > 1

"""Schedule-only rehearsal of a routed cell on the CPU: how many streams a
mix's ``arrival_gap_s`` keeps in flight.

    python3 portbench/rehearse.py --workload sc2.code.routed \
        --cost-ms 3.3,6e-3,1.5e-7 --gaps 1200,1800,2400 [--horizon 45]

The routed mixes arrive open-loop in the simulation's clock, so the
number of streams in flight is the simulation's: the same on the card as
here. The rehearsal serves the cell's mix through ``run_queue`` with the
cell's layer count, stages and replicas at a tiny width, the stage
compute replaced by a stub that charges a cost model's time to a proxy
clock (``a + b*S + c*S^2`` ms per stage forward over S tokens). Nothing
in the simulation depends on the width; the proxy clock only weights the
count of streams in flight (admitted, not finished, at each routing
window) by the time each routing window would take, and ends the
rehearsal after ``--horizon`` proxy seconds. For each gap it prints the
time-weighted mean in flight over the seeds and the proxy's tokens/s.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Sequence

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, traffic, weights  # noqa: E402

#: the width the stub's server is built at (nothing simulated reads it)
TINY = dict(d_model=16, num_heads=2, num_kv_heads=1, head_dim=8, d_ff=16,
            vocab_size=64)


class _Horizon(Exception):
    pass


def rehearse(workload: str, gap_s: float, cost_ms: Sequence[float],
             horizon_s: float, seed: int, cycles: int = 8) -> Dict:
    """One rehearsal of ``workload`` with arrivals ``gap_s`` apart."""
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.serving.api import SubmitSpec
    from repro_torch.serving.gtrac_serve import GTRACPipelineServer

    bench = harness.benchmark()
    cell = harness.find_cell(bench, workload)
    path = harness.HERE / "configs" / f"{cell['config']}.json"
    config = harness.load_json(path)
    model = harness.model_module(config, path)
    mix = dict(traffic.load(cell["traffic"]), arrival_gap_s=float(gap_s))
    if mix["entry"] != "routed":
        raise ValueError(f"{workload} is not a routed cell")
    base = harness.model_config(config)
    tiny = dict(TINY, num_layers=base.num_layers)
    if base.family == "moe":
        tiny.update(num_experts=4, experts_per_token=2)
    cfg = base.reduced(**tiny)
    dep = config["deployment"]
    server = GTRACPipelineServer(
        cfg, weights.make_params(cfg, 0, "cpu", model.layout),
        layers_per_stage=int(dep["layers_per_stage"]),
        replicas=dict(dep["replicas"]),
        gcfg=GTRACConfig(**config.get("gtrac", {})),
        seed=int(mix["sim_seed"]), device="cpu")
    a, b, c = cost_ms
    clock = [0.0]
    logits = torch.zeros(1, 1, cfg.vocab_size)
    last = len(server.stage_fns) - 1

    def stub(i):
        def stage(payload):
            S = payload[0].shape[1]
            clock[0] += (a + b * S + c * S * S) / 1e3
            return (payload[0], logits if i == last else None)
        return stage

    server.stage_fns = [stub(i) for i in range(len(server.stage_fns))]
    admitted = {}
    next0 = server.admission.next_window

    def next_window(capacity=None, now=None):
        got = next0(capacity=capacity, now=now)
        admitted.update((r.request_id, r) for r in got)
        return got

    server.admission.next_window = next_window
    samples = []
    tokens = [0]
    emit0 = server._emit_token

    def emit(req, tok, t_emit):
        emit0(req, tok, t_emit)
        tokens[0] += 1

    server._emit_token = emit
    route0 = server.router.route_window

    def route_window(table):
        samples.append((clock[0], sum(not r.done
                                      for r in admitted.values())))
        if clock[0] > horizon_s:
            raise _Horizon
        return route0(table)

    server.router.route_window = route_window
    n = 0
    for k in range(cycles):
        for it in traffic.routed_cycle(mix, seed, k, cfg.vocab_size, n):
            server.submit(SubmitSpec(prompt=it.prompt,
                                     max_new_tokens=it.max_new_tokens,
                                     arrival_time=it.arrival_s))
            n += 1
    try:
        server.run_queue()
    except _Horizon:
        pass
    finally:
        server.close()
    t = np.array([s[0] for s in samples] + [clock[0]])
    live = np.array([s[1] for s in samples], dtype=float)
    w = np.diff(t)
    return {"in_flight": float((w * live).sum() / max(w.sum(), 1e-12)),
            "tokens_per_s": tokens[0] / max(clock[0], 1e-12),
            "admitted": len(admitted),
            "finished": sum(r.done for r in admitted.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--cost-ms", required=True,
                    help="a,b,c: ms per stage forward of S tokens is "
                         "a + b*S + c*S^2")
    ap.add_argument("--gaps", required=True,
                    help="arrival gaps in simulated s, comma separated")
    ap.add_argument("--horizon", type=float, default=45.0)
    ap.add_argument("--seeds", default="11,12,13")
    args = ap.parse_args(argv)
    cost = [float(x) for x in args.cost_ms.split(",")]
    seeds = [int(x) for x in args.seeds.split(",")]
    for gap in (float(g) for g in args.gaps.split(",")):
        rows = [rehearse(args.workload, gap, cost, args.horizon, s)
                for s in seeds]
        print(f"gap {gap:g} in_flight "
              f"{np.mean([r['in_flight'] for r in rows]):.2f} "
              f"tokens_per_s {np.mean([r['tokens_per_s'] for r in rows]):.2f}"
              f" admitted {[r['admitted'] for r in rows]} "
              f"finished {[r['finished'] for r in rows]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

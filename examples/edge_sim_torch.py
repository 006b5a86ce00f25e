"""The port's version of ``examples/edge_sim.py``, on ``repro_torch``.

Reproduce paper Fig. 3 (SSR) + Fig. 7 (decision overhead) quickly on the
336-peer simulated testbed, then demo the gossip sync plane riding out a
partition: a seeker loses two of four anchor shards mid-serve, routes
conservatively on stale trust, gossip heals, and completion rates recover.
Ends with the epidemic relay demo: 32 seekers kept current by an anchor
that only ever pushes to 4 seeds per round — including a seeker that
cannot reach the anchor at all and converges through its neighbors.

The simulation parts are host code (numpy), as in the reference.

With ``--trace PATH`` it instead runs the compact traced-serving demo on
the device: a windowed gossip+relay serve with hedging, the process-backed
4-shard anchor (one spawned worker per shard) and end-to-end tracing
(repro_torch.obs) on, exports the span trace to PATH, schema-validates
it, prints the per-request critical-path report, and asserts the TTFT
decomposition identity (components sum to each request's measured TTFT).
Stage forwards run on ``--device`` (default: cuda; raises without it),
with random weights from the port's seeded ``init_params``.

    PYTHONPATH=src python examples/edge_sim_torch.py
    PYTHONPATH=src python examples/edge_sim_torch.py --trace /tmp/edge.jsonl
    PYTHONPATH=src python examples/edge_sim_torch.py --trace /tmp/edge.jsonl \
        --device cpu
"""
import sys
import time

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.routing import gtrac_route
from repro_torch.sim.testbed import build_paper_testbed, build_scaling_testbed
from repro_torch.sim.workload import run_workload
from repro_torch.sync.gossip import make_sync_plane


class GossipSeeker:
    """Adapter giving a sync-plane ``SeekerCache`` the classic seeker
    surface ``run_workload`` drives: ``maybe_sync`` runs gossip rounds on
    the configured cadence, ``view`` is the staleness-bounded routing
    table."""

    def __init__(self, seeker, sched, bed):
        self.seeker, self.sched, self.bed = seeker, sched, bed

    def maybe_sync(self, now):
        return self.sched.maybe_tick(now)

    def view(self):
        return self.seeker.routing_view(self.bed.now)


def main():
    print("=== SSR vs generation length (paper Fig. 3) ===")
    print(f"{'algo':8s}" + "".join(f"  L={l:<4d}" for l in (10, 20, 50)))
    for algo in ("gtrac", "sp", "mr", "naive", "larac"):
        row = f"{algo:8s}"
        for l_tok in (10, 20, 50):
            bed = build_paper_testbed(seed=42)
            run_workload(bed, algo, 15, l_tok=5, epsilon=0.10)   # converge
            s = run_workload(bed, algo, 30, l_tok, epsilon=0.10,
                             request_id_base=1000)
            row += f"  {s.ssr:5.2f} "
        print(row)

    print("\n=== routing decision time vs N (paper Fig. 7) ===")
    cfg = GTRACConfig()
    for n in (50, 200, 1000):
        bed = build_scaling_testbed(n, cfg=cfg)
        t = bed.anchor.snapshot(0.0)
        t0 = time.perf_counter()
        for _ in range(50):
            gtrac_route(t, bed.total_layers, cfg, tau=0.8)
        ms = (time.perf_counter() - t0) / 50 * 1e3
        print(f"N={n:5d}: gtrac {ms:.3f} ms/decision")
    print("\npaper claims: sub-ms at practical scales, <10 ms at N=1000.")

    print("\n=== gossip partition demo (the sync plane) ===")
    cfg = GTRACConfig(gossip_fanout=4, gossip_stale_margin=0.01,
                      gossip_stale_margin_max=0.3)
    bed = build_paper_testbed(cfg=cfg, seed=7, shards=4)
    _, (seeker,), sched = make_sync_plane(bed.anchor, cfg, now=bed.now)
    gs = GossipSeeker(seeker, sched, bed)
    lost = [0, 1]                       # two of four anchor shards

    def serve(n_requests, rid_base):
        s = run_workload(bed, "gtrac", n_requests, l_tok=8, seeker=gs,
                         request_id_base=rid_base)
        stale = int(seeker.staleness_rounds(bed.now).max())
        return s, stale

    run_workload(bed, "gtrac", 15, l_tok=5, seeker=gs)   # trust converges
    before, _ = serve(25, 1000)
    sched.partition(seeker, lost)
    during, stale = serve(25, 2000)
    sched.heal(seeker, lost)
    sched.full_sync(seeker, bed.now)    # anti-entropy reconciliation
    healed = sched.converged(seeker, bed.now)
    after, _ = serve(25, 3000)
    g = sched.stats
    print(f"phase     SSR    (completion over 25 requests)")
    print(f"before    {before.ssr:4.2f}   fully synced, 4/4 shards")
    print(f"during    {during.ssr:4.2f}   shards {lost} unreachable, "
          f"max staleness {stale} rounds — stale trust docked "
          f"{cfg.gossip_stale_margin}/round, routing conservative")
    print(f"after     {after.ssr:4.2f}   healed, anti-entropy "
          f"reconverged={healed}")
    print(f"gossip totals: {g.rounds} rounds, {g.deltas} deltas "
          f"({g.delta_bytes} B), {g.full_syncs} full syncs "
          f"({g.full_bytes} B), {g.hb_refreshes} hb refreshes "
          f"({g.hb_bytes} B)")

    print("\n=== epidemic relay demo: 32 seekers, anchor fanout 4 ===")
    cfg = GTRACConfig(gossip_fanout=4, relay_enabled=True, relay_fanout=4,
                      gossip_stale_margin=0.01)
    bed = build_paper_testbed(cfg=cfg, seed=7, shards=4)
    _, seekers, sched = make_sync_plane(bed.anchor, cfg, n_seekers=32,
                                        now=bed.now)
    gs = GossipSeeker(seekers[0], sched, bed)
    run_workload(bed, "gtrac", 15, l_tok=5, seeker=gs)   # trust converges
    sched.partition(seekers[0])      # seeker 0 loses the anchor ENTIRELY
    s = run_workload(bed, "gtrac", 25, l_tok=8, seeker=gs,
                     request_id_base=5000)
    stale = int(seekers[0].staleness_rounds(bed.now).max())
    for _ in range(7):      # quiet rounds: the epidemic drains the tail
        bed.advance(cfg.gossip_period_s)
        sched.tick(bed.now)
    behind = sum(not sched.converged(sk, bed.now, check_table=False)
                 for sk in seekers)
    g, rs = sched.stats, sched.relay.stats
    print(f"seeker 0 partitioned from the anchor, relay-fed by 31 "
          f"neighbors:")
    print(f"  SSR {s.ssr:4.2f} over 25 requests, max staleness "
          f"{stale} rounds")
    print(f"  anchor: {g.pushes} seed pushes over {g.rounds} rounds "
          f"({g.anchor_bytes()} B total — O(fanout), not O(32 seekers))")
    print(f"  relay: {rs.msgs} msgs ({rs.msg_bytes} B), "
          f"{rs.deltas_applied} deltas applied, {rs.anchor_repairs} "
          f"anchor / {rs.peer_full_syncs} neighbor gap repairs")
    print(f"  7 quiet rounds after the last churn: {behind}/32 seekers "
          f"behind (bound: ceil(log2 32)+2 = 7)")


def trace_demo(path, device=None):
    """Traced windowed serve: gossip + relay + hedging + the process-backed
    4-shard anchor + end-to-end tracing, then export, schema-validate,
    report, and check the TTFT identity."""
    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.export import export_jsonl, validate_jsonl
    from repro_torch.obs.report import format_report, ttft_breakdown
    from repro_torch.serving.api import SubmitSpec
    from repro_torch.serving.gtrac_serve import GTRACPipelineServer

    print("=== traced windowed serving demo (repro_torch.obs) ===")
    device = resolve_device(device)
    cfg = get_config("gpt2-large").reduced(num_layers=4, vocab_size=128,
                                           remat=False)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(7),
                         device)
    gcfg = GTRACConfig(trace_enabled=True, gossip_enabled=True,
                       relay_enabled=True, gossip_seekers=4,
                       disaggregate=True, prefill_chunk_tokens=4,
                       hedge_enabled=True, control_plane="procs",
                       anchor_shards=4)
    srv = GTRACPipelineServer(cfg, params, layers_per_stage=2, gcfg=gcfg,
                              seed=3, device=device)
    try:
        for i in range(4):
            srv.submit(SubmitSpec(prompt=np.arange(1, 9 + 4 * i),
                                  max_new_tokens=4, arrival_time=0.01 * i))
        done = srv.run_queue()
        h = srv._cp.health
        print(f"served {len(done)} streams, "
              f"{sum(r.metrics.tokens for r in done)} tokens on {device}, "
              f"{sum(r.metrics.hedges_fired for r in done)} hedges fired, "
              f"4 shard workers: {h.rpc_timeouts} rpc timeouts, "
              f"{h.degraded_windows} degraded windows")
        export_jsonl(srv.trace, path)
    finally:
        srv.close()
    n, errors = validate_jsonl(path)
    assert not errors, errors[:5]
    print(f"trace: {n} spans -> {path} (schema OK)")
    for row in ttft_breakdown(srv.trace):
        if row["complete"]:
            assert abs(row["ttft_sum_ms"] - row["measured_ttft_ms"]) < 1e-6, \
                row   # the decomposition must tile TTFT exactly
    print("TTFT decomposition identity holds for every completed stream")
    print(format_report(srv.trace))


if __name__ == "__main__":
    if "--trace" in sys.argv:
        dev = (sys.argv[sys.argv.index("--device") + 1]
               if "--device" in sys.argv else None)
        trace_demo(sys.argv[sys.argv.index("--trace") + 1], device=dev)
    else:
        main()

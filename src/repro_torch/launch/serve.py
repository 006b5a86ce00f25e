"""Serving launcher: the KV-cache engine or the G-TRAC trust-routed
pipeline, on PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-large \
        --windowed --attn-impl flash
    PYTHONPATH=src python -m repro_torch.launch.serve --algorithm sp
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --arch tinyllama-1.1b
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --windowed --disaggregate
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --arch qwen3-moe-30b-a3b --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \
        --windowed --attn-impl flash

Port of ``repro.launch.serve``. ``--mode gtrac`` (the default): the
window-batched router (``--windowed``, optionally ``--disaggregate``;
G-TRAC only) or per-token ``generate`` under any ``--algorithm``.
``--mode engine``: the plain KV-cache ``ServingEngine`` (with
``--attn-impl flash``, a dense or MoE model's prefill through kernel K3
and every decode step through kernel K4), which also serves RWKV6
(rwkv6-1.6b: every prefill's WKV scan through kernel K5, decode as plain
recurrence) and Zamba2 (zamba2-2.7b: every Mamba2 prefill's SSD scan
through kernel K6, its shared attention block through K3 and K4 at head
dim 80). The pipeline server serves the decoder-only transformers, dense,
MoE and vlm (learned positions, RoPE or, for qwen2-vl-7b, text-only
M-RoPE), whose layers the reference's stage functions run; it refuses the
ssm and hybrid families. Both modes refuse the audio family
(whisper-large-v3): the reference's stage functions read
``params["layers"]``, which Whisper does not have, and its engine
prefills with tokens only, while Whisper's prefill needs frames.
Parameters are made in the config's ``param_dtype`` (f32 for every
shipped config; neither this CLI nor the reference's has a flag for it,
so the largest configs, granite-34b, qwen3-moe and phi3.5-moe, fit one
80 GB card only through ``dataclasses.replace`` in a script, as
``chip_smoke.py`` does). Runs on ``cuda`` unless
``--device cpu``. Weights are random, made from ``--seed`` with the
family's ``init`` (the reference's distributions), so the tokens are
meaningless; the routing, trust, repair and model compute are
the real thing. ``--shards`` shards the anchor, ``--gossip`` routes from a
gossip-synced seeker cache and ``--relay`` adds the seeker→seeker relay
plane; ``--control-plane procs`` runs every anchor shard in its own worker
process behind the RPC control plane (``--cp-timeout``, ``--cp-retries``,
``--cp-backoff``), ``--hedged`` fires a backup hop (a real stage forward)
when a primary is slow, and ``--trace PATH`` writes the span trace
(``--trace-format jsonl`` or ``chrome``) and prints the critical-path
report.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import GTRACConfig
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.gtrac_serve import GTRACPipelineServer, latency_summary
from repro_torch.sim.workload import serving_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-large")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny test config with 4 layers")
    ap.add_argument("--mode", default="gtrac", choices=["engine", "gtrac"],
                    help="engine: the plain KV-cache engine; gtrac: the "
                         "trust-routed pipeline server")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--attn-impl", default="flash", choices=["xla", "flash"],
                    help="flash: the CUDA kernels (attention; RWKV6's "
                         "WKV scan; Mamba2's SSD scan); xla: plain PyTorch")
    ap.add_argument("--algorithm", default="gtrac",
                    choices=["gtrac", "sp", "mr", "naive", "larac"])
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--layers-per-stage", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--windowed", action="store_true",
                    help="serve all requests concurrently via the "
                         "window-batched router (one batched DP per "
                         "token window) instead of per-token routing")
    ap.add_argument("--disaggregate", action="store_true",
                    help="windowed serving: long prompts prefill in "
                         "dedicated chunked windows feeding the decode "
                         "pool (requires --windowed)")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="T",
                    help="prefill chunk size in tokens (default: "
                         "GTRACConfig.prefill_chunk_tokens)")
    ap.add_argument("--kv-reuse-bonus", type=float, default=None,
                    metavar="B",
                    help="edge-cost discount on peers holding a stream's "
                         "warm KV, 0..1 (default: GTRACConfig)")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="short (interactive) prompt length")
    ap.add_argument("--long-prompt-len", type=int, default=96,
                    help="long prompt length for the prefill-heavy tail")
    ap.add_argument("--long-fraction", type=float, default=0.0,
                    help="fraction of requests carrying a long prompt")
    ap.add_argument("--burst-every", type=float, default=0.0, metavar="S",
                    help="windowed serving: arrivals in bursts spaced S "
                         "sim-seconds apart (0 = all queued up front)")
    ap.add_argument("--burst-size", type=int, default=4,
                    help="requests per arrival burst (with --burst-every)")
    ap.add_argument("--shards", type=int, default=1,
                    help="anchor registry shards (1 = monolithic; >1 "
                         "partitions peers across S AnchorRegistry shards "
                         "by stable peer-id hash with composed snapshots)")
    ap.add_argument("--shard-by", default="peer", choices=["peer", "layer"],
                    help="shard placement key: peer-id hash or layer-slot "
                         "affinity")
    ap.add_argument("--control-plane", default="inproc",
                    choices=["inproc", "procs"],
                    help="anchor shard backend: in-process registries, or "
                         "one worker PROCESS per shard behind the RPC "
                         "control plane (repro_torch.control_plane) — "
                         "deadlines, bounded retries, degraded-shard "
                         "serving")
    ap.add_argument("--cp-timeout", type=float, default=None, metavar="S",
                    help="per-attempt composer->worker RPC deadline in "
                         "seconds (default: GTRACConfig.cp_rpc_timeout_s)")
    ap.add_argument("--cp-retries", type=int, default=None, metavar="N",
                    help="RPC retries after the first deadline expiry "
                         "(default: GTRACConfig.cp_rpc_retries)")
    ap.add_argument("--cp-backoff", type=float, default=None, metavar="S",
                    help="base backoff before the first retry; doubles "
                         "per attempt (default: "
                         "GTRACConfig.cp_backoff_base_s)")
    ap.add_argument("--hedged", action="store_true",
                    help="hedged window serving: fire a backup hop when a "
                         "primary exceeds its latency-quantile trigger")
    ap.add_argument("--gossip", action="store_true",
                    help="route from a gossip-synced seeker cache "
                         "(repro_torch.sync): anchors push per-shard version "
                         "vectors, the seeker pulls delta-encoded dirty "
                         "shards, and routing prices staleness instead of "
                         "reading in-process snapshots")
    ap.add_argument("--gossip-period", type=float, default=None,
                    metavar="S",
                    help="gossip round period in seconds "
                         "(default: T_gossip from GTRACConfig)")
    ap.add_argument("--gossip-fanout", type=int, default=2,
                    help="max dirty shards a seeker pulls per round "
                         "(the rest defer — bandwidth cap)")
    ap.add_argument("--gossip-stale-margin", type=float, default=0.0,
                    metavar="M",
                    help="trust docked per stale gossip round (an "
                         "inflated trust floor for shards the seeker "
                         "cannot confirm; 0 disables)")
    ap.add_argument("--gossip-stale-decay", type=float, default=0.0,
                    metavar="R",
                    help="seeker-side trust discount toward init_trust, "
                         "per second of shard staleness (0 disables)")
    ap.add_argument("--relay", action="store_true",
                    help="epidemic seeker->seeker relay (requires "
                         "--gossip): the anchor pushes only to "
                         "--gossip-fanout seed seekers per round and "
                         "the seekers relay delta chains to each other "
                         "— anchor cost O(fanout), convergence "
                         "O(log N) rounds")
    ap.add_argument("--relay-seekers", type=int, default=8, metavar="N",
                    help="seeker caches in the relay plane (routing "
                         "reads seeker 0; the rest carry the epidemic)")
    ap.add_argument("--relay-fanout", type=int, default=2,
                    help="neighbors each seeker pushes to per relay "
                         "round (seeded k-regular random sampling)")
    ap.add_argument("--relay-history", type=int, default=8,
                    help="per-shard delta chain depth a seeker retains "
                         "for forwarding (behind it: anti-entropy)")
    ap.add_argument("--relay-seed", type=int, default=0,
                    help="relay topology RNG seed (deterministic "
                         "per-round neighbor sampling)")
    ap.add_argument("--relay-blind", action="store_true",
                    help="disable the digest handshake: push whole "
                         "delta-chain messages to every neighbor "
                         "instead of summary/pull (the pre-handshake "
                         "wire protocol — more duplicate bytes)")
    ap.add_argument("--relay-no-verify", action="store_true",
                    help="disable digest verification, quarantine and "
                         "hb plausibility checks on relayed payloads "
                         "(trust every neighbor — the pre-hardening "
                         "behavior)")
    ap.add_argument("--relay-quarantine-rounds", type=int, default=None,
                    metavar="R",
                    help="relay rounds a convicted lying sender stays "
                         "quarantined per receiver (default: "
                         "GTRACConfig.relay_quarantine_rounds)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="gtrac mode: enable end-to-end tracing "
                         "(repro_torch.obs), write the span trace to PATH "
                         "and print the per-request critical-path report")
    ap.add_argument("--trace-format", default="jsonl",
                    choices=["jsonl", "chrome"],
                    help="trace file format: JSONL span records, or a "
                         "Chrome trace-event file for chrome://tracing "
                         "/ Perfetto (default: jsonl)")
    args = ap.parse_args(argv)
    if args.windowed and args.algorithm != "gtrac":
        ap.error("--windowed routes via the gtrac batch router; "
                 "--algorithm %s is only available per-token" % args.algorithm)
    if args.hedged and not args.windowed:
        ap.error("--hedged is a window-serving feature (run_queue); "
                 "add --windowed — the per-token generate() path does "
                 "not hedge")
    if args.disaggregate and not args.windowed:
        ap.error("--disaggregate splits the window-batched serving loop "
                 "(run_queue); add --windowed")
    if args.algorithm != "gtrac" and args.gossip:
        ap.error("--gossip serves from the trust-aware seeker cache; "
                 "--algorithm %s does not consume it" % args.algorithm)
    if args.relay and not args.gossip:
        ap.error("--relay rides on the gossip sync plane; add --gossip")

    cfg = get_config(args.arch)
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: neither serving path runs an encoder-decoder: "
            "the pipeline server's stage functions run params['layers'], "
            "which Whisper does not have, and the engine prefills with "
            "tokens only while Whisper's prefill needs frames (as in the "
            "reference); serve it through models.api.build_model's "
            "prefill(tokens=..., frames=...) and decode_step")
    if args.mode == "gtrac" and cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the trust-routed pipeline server serves the "
            f"dense, moe and vlm families only (family {cfg.family!r}); "
            "serve it with --mode engine")
    if args.reduced:
        cfg = cfg.reduced(num_layers=4)
    cfg = dataclasses.replace(cfg, remat=False, attn_impl=args.attn_impl)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = build_model(cfg).init(gen, device)
    rng = np.random.default_rng(args.seed)

    if args.mode == "engine":
        eng = ServingEngine(cfg, params, device=device)
        for _ in range(args.requests):
            prompt = rng.integers(1, cfg.vocab_size, size=args.prompt_len)
            eng.submit(SubmitSpec(prompt=prompt,
                                  max_new_tokens=args.tokens))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run_batch()
        _sync(device)
        wall = time.perf_counter() - t0
        for r in done:
            print(f"req {r.request_id}: {r.prompt.tolist()} -> {r.output}")
        tokens = sum(len(r.output) for r in done)
        print(f"device {device}: {tokens} tokens in {wall:.3f} s wall "
              f"({tokens / max(wall, 1e-9):.1f} tokens/s), "
              f"{eng.prefills} prefills, {eng.decode_steps} decode steps, "
              f"kernel launches {ops.launch_counts()}")
        return

    kw = {}
    if args.gossip_period is not None:
        kw["gossip_period_s"] = args.gossip_period
    if args.relay_quarantine_rounds is not None:
        kw["relay_quarantine_rounds"] = args.relay_quarantine_rounds
    if args.cp_timeout is not None:
        kw["cp_rpc_timeout_s"] = args.cp_timeout
    if args.cp_retries is not None:
        kw["cp_rpc_retries"] = args.cp_retries
    if args.cp_backoff is not None:
        kw["cp_backoff_base_s"] = args.cp_backoff
    if args.prefill_chunk is not None:
        kw["prefill_chunk_tokens"] = args.prefill_chunk
    if args.kv_reuse_bonus is not None:
        kw["kv_reuse_bonus"] = args.kv_reuse_bonus
    gcfg = GTRACConfig(anchor_shards=args.shards, shard_by=args.shard_by,
                       control_plane=args.control_plane,
                       disaggregate=args.disaggregate,
                       hedge_enabled=args.hedged,
                       gossip_enabled=args.gossip,
                       gossip_fanout=args.gossip_fanout,
                       gossip_stale_margin=args.gossip_stale_margin,
                       gossip_stale_decay=args.gossip_stale_decay,
                       relay_enabled=args.relay,
                       relay_fanout=args.relay_fanout,
                       relay_history=args.relay_history,
                       relay_seed=args.relay_seed,
                       relay_handshake=not args.relay_blind,
                       relay_verify=not args.relay_no_verify,
                       gossip_seekers=(args.relay_seekers if args.relay
                                       else 1),
                       trace_enabled=args.trace is not None,
                       **kw)
    srv = GTRACPipelineServer(cfg, params,
                              layers_per_stage=args.layers_per_stage,
                              algorithm=args.algorithm, seed=args.seed,
                              gcfg=gcfg, device=device)
    try:
        _serve(srv, args, cfg, rng, device)
        _report_control_plane(srv)
        _dump_trace(srv, args)
    finally:
        srv.close()


def _serve(srv, args, cfg, rng, device) -> None:
    """Serve the workload (``run_queue`` with ``--windowed``, else
    ``generate`` per request) and print the reference's summary lines
    beside the device's tokens per second and kernel launches."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if args.windowed:
        for spec in serving_workload(
                rng, args.requests, vocab_size=cfg.vocab_size,
                short_len=args.prompt_len, long_len=args.long_prompt_len,
                long_fraction=args.long_fraction,
                max_new_tokens=args.tokens,
                burst_every_s=args.burst_every,
                burst_size=args.burst_size):
            srv.submit(spec)
        done = srv.run_queue()
        _sync(device)
        wall = time.perf_counter() - t0
        ok = 0
        for r in done:
            met = r.metrics
            ok += met.tokens == args.tokens
            print(f"req {r.request_id}: {met.tokens}/{args.tokens} tokens, "
                  f"{met.repairs} repairs, {met.failures} failures "
                  f"-> {r.output}")
        s = srv.router.stats
        hedges = sum(r.metrics.hedges_fired for r in done)
        print(f"SSR: {ok}/{args.requests}  windows: {s.windows}  "
              f"batched DP calls: {s.device_calls} "
              f"(vs {s.requests} per-token solves)  "
              f"anchor shards: {args.shards}  hedges fired: {hedges}")
        ls = latency_summary(done)
        chunks = sum(r.metrics.prefill_chunks for r in done)
        print(f"ttft p50/p99: {ls['ttft_p50_ms']:.0f}/"
              f"{ls['ttft_p99_ms']:.0f} ms  "
              f"itl p50/p99: {ls['itl_p50_ms']:.0f}/"
              f"{ls['itl_p99_ms']:.0f} ms (sim clock)  "
              f"kv warm-hit rate: {ls['warm_hit_rate']:.2f}  "
              f"prefill chunks: {chunks} "
              f"({'disaggregated' if args.disaggregate else 'inline'})")
        print(f"completion: {ls['completed']}/{ls['requests']} requests "
              f"emitted ({ls['incomplete']} incomplete, rate "
              f"{ls['completion_rate']:.2f})")
        tokens = sum(r.metrics.tokens for r in done)
        if srv.gossip is not None:
            g = srv.gossip.stats
            stale = max((r.metrics.stale_rounds_max for r in done),
                        default=0)
            print(f"gossip: {g.rounds} rounds, {g.deltas} deltas "
                  f"({g.delta_bytes} B), {g.full_syncs} full syncs "
                  f"({g.full_bytes} B), max staleness {stale} rounds")
            if srv.gossip.relay is not None:
                rs = srv.gossip.relay.stats
                print(f"relay: {args.relay_seekers} seekers, "
                      f"{rs.msgs} msgs ({rs.msg_bytes} B), "
                      f"{rs.summaries} summaries ({rs.summary_bytes} B), "
                      f"{rs.deltas_applied} deltas applied, "
                      f"{rs.duplicates} duplicates, "
                      f"{rs.gaps} gaps ({rs.anchor_repairs} anchor / "
                      f"{rs.peer_full_syncs} peer repairs), "
                      f"anchor bytes {g.anchor_bytes()} B")
                print(f"relay hardening: {rs.digest_mismatches} digest "
                      f"mismatches, {rs.rejected_chains} rejected "
                      f"chains, {rs.quarantines} quarantines "
                      f"({rs.quarantine_drops} drops), "
                      f"{rs.hb_rejected} hb rejections")
    else:
        ok = tokens = 0
        for rid in range(args.requests):
            prompt = rng.integers(1, cfg.vocab_size, size=args.prompt_len)
            out, met = srv.generate(prompt, max_new_tokens=args.tokens,
                                    request_id=rid)
            ok += met.tokens == args.tokens
            tokens += met.tokens
            print(f"req {rid}: {met.tokens}/{args.tokens} tokens, "
                  f"{met.repairs} repairs, {met.failures} failures "
                  f"-> {out.tolist()}")
        _sync(device)
        wall = time.perf_counter() - t0
        print(f"SSR: {ok}/{args.requests} ({args.algorithm})")
    print(f"device {device}: {tokens} tokens in {wall:.3f} s wall "
          f"({tokens / max(wall, 1e-9):.1f} tokens/s), kernel launches "
          f"{ops.launch_counts()}")


def _dump_trace(srv, args) -> None:
    """Export the run's span buffer and print the critical-path report
    (tracing runs only when --trace was passed)."""
    if getattr(srv, "trace", None) is None or not args.trace:
        return
    from repro_torch.obs.export import export_chrome, export_jsonl
    from repro_torch.obs.report import format_report
    if args.trace_format == "chrome":
        export_chrome(srv.trace, args.trace)
    else:
        export_jsonl(srv.trace, args.trace)
    print(f"trace: {len(srv.trace)} spans -> {args.trace} "
          f"({args.trace_format}, {srv.trace.dropped} evicted)")
    print(format_report(srv.trace))


def _report_control_plane(srv) -> None:
    """End-of-run health report for the process-backed control plane."""
    cp = getattr(srv, "_cp", None)
    if cp is None:
        return
    h = cp.health
    print(f"control plane: {cp.n_shards} worker procs, "
          f"{h.rpc_retries} rpc retries, {h.rpc_timeouts} timeouts, "
          f"{h.degraded_windows} degraded windows, "
          f"{h.worker_restarts} worker restarts, "
          f"{h.dropped_writes} dropped writes, "
          f"{h.full_resyncs} full resyncs")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()

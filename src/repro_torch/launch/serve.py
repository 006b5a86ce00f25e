"""Serving launcher: the G-TRAC trust-routed pipeline on PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-large \
        --windowed --attn-impl flash
    PYTHONPATH=src python -m repro_torch.launch.serve --algorithm sp

Port of ``repro.launch.serve`` for the ``gtrac`` mode: the window-batched
router (``--windowed``, optionally ``--disaggregate``; G-TRAC only) or
per-token ``generate`` under any ``--algorithm``. Runs on ``cuda`` unless
``--device cpu``. Weights
are random, made from ``--seed`` with ``init_params`` (the reference's
distributions), so the tokens are meaningless; the routing, trust, repair
and stage compute are the real thing. The reference's plain engine mode,
sharded / process-backed anchors, gossip and relay planes, hedging and
trace export join the port in later slices.
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
from repro_torch.models.transformer import init_params
from repro_torch.serving.gtrac_serve import GTRACPipelineServer, latency_summary
from repro_torch.sim.workload import serving_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-large")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny test config with 4 layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--attn-impl", default="flash", choices=["xla", "flash"],
                    help="flash: the CUDA flash-attention kernel; xla: "
                         "plain PyTorch attention")
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
    args = ap.parse_args(argv)
    if args.windowed and args.algorithm != "gtrac":
        ap.error("--windowed routes via the gtrac batch router; "
                 "--algorithm %s is only available per-token" % args.algorithm)
    if args.disaggregate and not args.windowed:
        ap.error("--disaggregate splits the window-batched serving loop "
                 "(run_queue); add --windowed")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=4)
    cfg = dataclasses.replace(cfg, remat=False, attn_impl=args.attn_impl)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    rng = np.random.default_rng(args.seed)

    kw = {}
    if args.prefill_chunk is not None:
        kw["prefill_chunk_tokens"] = args.prefill_chunk
    if args.kv_reuse_bonus is not None:
        kw["kv_reuse_bonus"] = args.kv_reuse_bonus
    gcfg = GTRACConfig(disaggregate=args.disaggregate, **kw)
    srv = GTRACPipelineServer(cfg, params,
                              layers_per_stage=args.layers_per_stage,
                              algorithm=args.algorithm, seed=args.seed,
                              gcfg=gcfg, device=device)
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
        print(f"SSR: {ok}/{args.requests}  windows: {s.windows}  "
              f"batched DP calls: {s.device_calls} "
              f"(vs {s.requests} per-token solves)")
        ls = latency_summary(done)
        chunks = sum(r.metrics.prefill_chunks for r in done)
        print(f"ttft p50/p99: {ls['ttft_p50_ms']:.0f}/"
              f"{ls['ttft_p99_ms']:.0f} ms  "
              f"itl p50/p99: {ls['itl_p50_ms']:.0f}/"
              f"{ls['itl_p99_ms']:.0f} ms (sim clock)  "
              f"kv warm-hit rate: {ls['warm_hit_rate']:.2f}  "
              f"prefill chunks: {chunks} "
              f"({'disaggregated' if args.disaggregate else 'inline'})")
        tokens = sum(r.metrics.tokens for r in done)
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()

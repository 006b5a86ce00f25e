"""END-TO-END DRIVER on PyTorch: serve a small model with batched requests
through the port's full G-TRAC stack, comparing routing policies under
adversarial peers (the port's version of ``examples/serve_gtrac.py``).

The model is layer-sharded across simulated edge peers (honeypot / turtle
/ golden profiles), every token's chain is routed from the seeker's cached
view, hops execute REAL stage forwards on the device (attention through
the port's CUDA kernel with ``--attn-impl flash``), failures trigger
Bounded One-Shot Repair, and the Anchor learns trust from execution
reports. Weights are random, from the port's seeded ``init_params``.

    PYTHONPATH=src python examples/serve_gtrac_torch.py [--requests 12]
    PYTHONPATH=src python examples/serve_gtrac_torch.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.transformer import init_params
from repro_torch.serving.gtrac_serve import GTRACPipelineServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--layers-per-stage", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--attn-impl", default="flash", choices=["xla", "flash"],
                    help="flash: attention through the CUDA kernel; xla: "
                         "plain PyTorch")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config("gpt2-large").reduced(num_layers=8, vocab_size=512,
                                           remat=False)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    rng = np.random.default_rng(args.seed)
    replicas = {"honeypot": 3, "turtle": 2, "golden": 2}

    print(f"model: {cfg.num_layers} layers, "
          f"{cfg.num_layers // args.layers_per_stage} pipeline stages, "
          f"peers/stage: {sum(replicas.values())} {replicas}, "
          f"device {device}")
    print(f"{'policy':8s} {'SSR':>6s} {'tok/s-lat':>10s} {'repairs':>8s} "
          f"{'failures':>9s}")

    for algo in ("gtrac", "sp", "mr"):
        srv = GTRACPipelineServer(cfg, params,
                                  layers_per_stage=args.layers_per_stage,
                                  replicas=replicas, algorithm=algo,
                                  seed=args.seed, device=device)
        ok = repairs = failures = 0
        lats = []
        for rid in range(args.requests):
            prompt = rng.integers(1, cfg.vocab_size, size=8)
            out, met = srv.generate(prompt, max_new_tokens=args.tokens,
                                    request_id=rid)
            ok += met.tokens == args.tokens
            repairs += met.repairs
            failures += met.failures
            lats.extend(met.token_latency_ms)
        lat_s = np.mean(lats) / 1e3 if lats else float("nan")
        print(f"{algo:8s} {ok/args.requests:6.2f} {lat_s:9.2f}s "
              f"{repairs:8d} {failures:9d}")

    print("\nexpected: gtrac matches mr's reliability at the lowest latency;"
          "\nsp keeps picking honeypots — at this small scale the one-shot"
          "\nrepair often rescues it, but at ~3x the per-token latency and"
          "\nan order of magnitude more repairs.")


if __name__ == "__main__":
    main()

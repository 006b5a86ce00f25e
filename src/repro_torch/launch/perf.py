"""§Perf hillclimb: baseline + named optimization variants for the
three selected cells, each run through the dry-run on the single-pod mesh.

Port of ``repro.launch.perf``: ``CELLS`` copied verbatim, each variant run
through the port's ``launch/dryrun.run_cell`` (the step on ``meta`` as
rank 0 of a 256-rank process group that exchanges nothing).

    PYTHONPATH=src python -m repro_torch.launch.perf --cell A --out perf.jsonl
    PYTHONPATH=src python -m repro_torch.launch.perf --all --out perf.jsonl

Cells:
  A  smollm-360m  prefill_32k   15 heads won't TP-shard 16-way (replicated
                                score traffic)
  B  granite-34b  decode_32k    token-by-token pipelined serving (MQA: the
                                cache shards its sequence)
  C  starcoder2-7b train_4k     remat + full-logit CE
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.dryrun import run_cell

# cell -> (arch, shape, [(variant_name, overrides, serving_layout), ...])
# The FIRST variant is the paper-faithful baseline (exactly the sweep cell).
CELLS = {
    "A": ("smollm-360m", "prefill_32k", [
        ("baseline", {}, False),
        # H1: pad heads 15->16 / kv 5->8 (+6.7% attn flops, q%kv==0) so
        #     scores/activations TP-shard 16-way instead of replicating
        ("pad_heads16", {"num_heads": 16, "num_kv_heads": 8}, False),
        # H2: additionally serve-resident weights (no FSDP gathers)
        ("pad_heads16+serve_layout", {"num_heads": 16, "num_kv_heads": 8},
         True),
    ]),
    "B": ("granite-34b", "decode_32k", [
        ("baseline", {}, False),
        # H1: serving layout — weights TP-resident, zero gathers per token
        ("serve_layout", {}, True),
        # H2: + bf16 logits (halve the (B,1,V) logit traffic)
        ("serve_layout+bf16_logits", {"logits_dtype": "bfloat16"}, True),
        # H3 (partial): masked (shard-local) cache write — helps memory but
        #     the gather persisted: it comes from the ATTENTION einsum
        #     resharding (head-sharded q × seq-sharded cache)
        ("serve_layout+masked_write", {"decode_masked_write": True}, True),
        # H4: + flash-decoding layout — replicate the (tiny) q heads, keep
        #     scores sequence-sharded; GSPMD then emits the lse-combine
        #     psums instead of gathering the 23.6 GB cache
        ("serve_layout+masked+seqshard",
         {"decode_masked_write": True, "decode_seq_shard": True}, True),
    ]),
    "C": ("starcoder2-7b", "train_4k", [
        ("baseline", {}, False),
        # H1 (REFUTED): chunked CE — same bytes accessed, peak-only effect;
        #     and without per-chunk remat even the peak win evaporates
        ("chunked_ce", {"ce_impl": "chunked", "ce_chunk": 2048}, False),
        # H2: pad heads 36->48 (+33% attn flops = ~+5% total): score/prob
        #     traffic TP-shards 16-way instead of replicating
        ("pad_heads48", {"num_heads": 48}, False),
        # H3: + flash-style chunk remat + remat'd chunked CE
        ("pad_heads48+chunk_remat",
         {"num_heads": 48, "attn_chunk_remat": True,
          "ce_impl": "chunked", "ce_chunk": 2048}, False),
    ]),
}


def run_variant(arch, shape, name, overrides, serving_layout, **kw):
    """One variant of a cell through ``run_cell`` on the single mesh."""
    return run_cell(arch, shape, "single", overrides=dict(overrides),
                    serving_layout=serving_layout, tag=name, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS), default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="perf.jsonl")
    args = ap.parse_args(argv)

    cells = list(CELLS) if args.all else [args.cell]
    for c in cells:
        arch, shape, variants = CELLS[c]
        for name, ov, serve in variants:
            if args.variant and name != args.variant:
                continue
            rec = run_variant(arch, shape, f"{c}/{name}", ov, serve)
            with open(args.out, "a") as f:
                f.write(json.dumps({k: v for k, v in rec.items()
                                    if k != "traceback"}) + "\n")


if __name__ == "__main__":
    main()

"""Quickstart on PyTorch: train a tiny LM, checkpoint it, restore it, then
serve it through the G-TRAC trust-routed pipeline (the port's version of
``examples/quickstart.py``).

The train step is plain PyTorch (``attn_impl="xla"``: the CUDA kernels
have no gradient, as the reference's Pallas kernels have none); serving
runs the stage forwards with ``--attn-impl`` (flash: attention through the
port's CUDA kernel). The checkpoint is written in the reference's format.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.models.api import build_model
from repro_torch.serving.gtrac_serve import GTRACPipelineServer
from repro_torch.trainer import optimizer as opt
from repro_torch.trainer.checkpoint import CheckpointManager
from repro_torch.trainer.train_loop import make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--attn-impl", default="flash", choices=["xla", "flash"],
                    help="attention when serving (training runs xla)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart"))
    args = ap.parse_args()
    device = resolve_device(args.device)

    # 1. a tiny GPT-2-family model (the paper's arch family, reduced)
    cfg = get_config("gpt2-large").reduced(num_layers=4, vocab_size=256,
                                           remat=False)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)

    # 2. train a few steps on the synthetic packed LM stream
    tcfg = TrainConfig(warmup_steps=2, total_steps=20)
    step = make_train_step(model, tcfg)
    data = SyntheticLMStream(DataConfig(cfg.vocab_size, seq_len=64,
                                        global_batch=8))
    opt_state = opt.init(params)
    for i, batch in enumerate(data.batches(0, 20)):
        params, opt_state, m = step(params, opt_state,
                                    {k: torch.as_tensor(v, device=device)
                                     for k, v in batch.items()})
        if (i + 1) % 5 == 0:
            print(f"step {i+1:3d} loss {float(m['loss']):.3f}")

    # 3. checkpoint + restore round trip
    ck = CheckpointManager(args.ckpt_dir, keep=2)
    ck.save(20, {"params": params}, async_write=True)
    params = ck.restore({"params": params})["params"]
    print("checkpointed + restored at step", ck.latest_step())

    # 4. serve through the trust-aware routed pipeline (2 layers/peer,
    #    adversarial peer mix): real stage compute, simulated failures
    srv = GTRACPipelineServer(dataclasses.replace(cfg,
                                                  attn_impl=args.attn_impl),
                              params, layers_per_stage=2,
                              replicas={"honeypot": 2, "golden": 2,
                                        "turtle": 1},
                              algorithm="gtrac", seed=0, device=device)
    for rid in range(3):
        out, met = srv.generate(np.arange(1, 9), max_new_tokens=8,
                                request_id=rid)
        print(f"request {rid}: tokens={out.tolist()} repairs={met.repairs} "
              f"failures={met.failures}")
    print("OK")


if __name__ == "__main__":
    main()

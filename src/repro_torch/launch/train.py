"""Training launcher with checkpoint/restart, on PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --steps 50 --seq 128 --batch 8 --ckpt-dir ckpt --resume

Port of ``repro.launch.train``: the same flags and log lines, plus
``--device`` (``cuda`` unless ``--device cpu``). The step runs eagerly
through ``trainer.train_loop.make_train_step`` (plain PyTorch, no
hand-written kernel: the kernels have no gradient, so the config keeps
``attn_impl="xla"``); checkpoints are written in the reference's format
(``trainer/checkpoint.py``), so either package resumes from the other's.
Weights are random, made from ``--seed`` with the family's ``init``.
``--mesh single|multi`` builds the production mesh (``launch/mesh.py``,
one rank per device of the default process group) and sets the
activation policy, as the reference does; with fewer ranks than the mesh
needs it raises the reference's device-count error, so on one card it
always raises. The mesh is built before the parameters, so the error
comes first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.distributed import sharding as sh
from repro_torch.models.api import build_model
from repro_torch.trainer import optimizer as opt
from repro_torch.trainer.checkpoint import CheckpointManager
from repro_torch.trainer.train_loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="none", choices=["none", "single",
                                                       "multi"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                    device_type=device.type)
        sh.set_activation_policy(mesh)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat=False)
    model = build_model(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       microbatches=args.microbatches,
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir)
    data = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed))
    ckpt = CheckpointManager(args.ckpt_dir, keep=tcfg.keep_checkpoints)

    params = model.init(torch.Generator(device=device).manual_seed(args.seed),
                        device)
    opt_state = opt.init(params)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore({"params": params, "opt_state": opt_state})
        params, opt_state = state["params"], state["opt_state"]
        start_step = ckpt.latest_step()
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(model, tcfg)
    t0 = time.time()
    metrics = None
    for i, batch in enumerate(data.batches(start_step, args.steps -
                                           start_step)):
        step_i = start_step + i + 1
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step_i % args.log_every == 0 or step_i == args.steps:
            print(f"step {step_i:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/max(1,i+1):.2f}s/step)", flush=True)
        if step_i % tcfg.checkpoint_every == 0 or step_i == args.steps:
            ckpt.save(step_i, {"params": params, "opt_state": opt_state},
                      async_write=True)
    ckpt.wait()
    sh.set_activation_policy(None)
    print(f"done: {args.steps} steps, final loss "
          f"{float(metrics['loss']):.4f}")
    return params


if __name__ == "__main__":
    main()

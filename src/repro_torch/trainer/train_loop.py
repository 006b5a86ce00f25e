"""Training step construction: microbatched grad accumulation, AdamW, and
the failure-aware outer loop.

Port of ``repro.trainer.train_loop``. ``make_train_step(model, tcfg)``
returns ``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
the loss and its gradients by ``torch.autograd`` over the port's parameter
leaves, microbatches accumulated into an f32 zeros tree and divided by
their count, the learning rate ``lr_fn(step + 1)`` and the functional
AdamW ``update``. The step runs eagerly. It goes through no hand-written
kernel: the kernels have no gradient (``kernels/ops.py`` refuses a tensor
that requires one), as the reference's Pallas kernels have none, so
training runs ``attn_impl="xla"``. The same step runs sharded when its
inputs are DTensors (``distributed/sharding.py``: ``distribute_params``
and ``policy_call``). The reference's int8-compressed gradient all-reduce
(``distributed/collectives.make_compressed_grad_allreduce``) is read by
neither train loop: ``TrainConfig.grad_compression`` is not wired in,
as in the reference.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.api import Model
from repro_torch.trainer import optimizer as opt
from repro_torch.trainer.optimizer import tree_leaves, tree_map
from repro_torch.trainer.schedule import warmup_cosine


def _split_microbatches(batch, n: int):
    """Each batch tensor (B, ...) -> (n, B // n, ...); M-RoPE positions
    (3, B, S) -> (n, 3, B // n, S)."""
    out = {}
    for k, v in batch.items():
        if k == "positions" and v.dim() == 3:
            out[k] = v.reshape(3, n, v.shape[1] // n,
                               v.shape[2]).transpose(0, 1)
        else:
            out[k] = v.reshape(n, v.shape[0] // n, *v.shape[1:])
    return out


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient with
    respect to every leaf of ``params`` (zeros where the loss does not
    reach a leaf, as ``jax.grad`` gives), in the leaves' dtypes. The
    parameters are not modified and need not require grad."""
    leaves = tree_leaves(params)
    req = [p.detach().requires_grad_() for p in leaves]
    it = iter(req)
    with torch.enable_grad():
        loss = loss_fn(tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model: Model, tcfg: TrainConfig,
                    unroll_accum: bool = False) -> Callable:
    """The train step for ``model`` under ``tcfg``. ``unroll_accum``
    unrolls the reference's microbatch scan for its dry-run's cost
    analysis; the eager loop here is unrolled either way, so it is accepted
    and changes nothing."""
    lr_fn = warmup_cosine(tcfg)
    n_micro = tcfg.microbatches

    def step(params, opt_state, batch) \
            -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        if n_micro <= 1:
            loss, grads = value_and_grad(model.loss_fn, params, batch)
        else:
            mbs = _split_microbatches(batch, n_micro)
            dev = tree_leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in range(n_micro):
                mb = {k: v[i] for k, v in mbs.items()}
                l, g = value_and_grad(model.loss_fn, params, mb)
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
                del g
            loss = loss / n_micro
            grads = tree_map(lambda g: g / n_micro, grads)

        lr = lr_fn(opt_state["step"] + 1)
        params, opt_state, om = opt.update(params, grads, opt_state, tcfg,
                                           lr)
        metrics = {"loss": loss, "lr": lr, **om}
        return params, opt_state, metrics

    return step


# ---------------------------------------------------------------------------
# Failure-aware outer loop (host-side fault tolerance)
# ---------------------------------------------------------------------------


class ResilientTrainer:
    """Host loop: checkpoint cadence and crash recovery.

    On a failure (an exception from the step, or an injected fault) the
    trainer hands it to ``on_failure``, which returns the state to resume
    from (typically the latest checkpoint), and goes on with the next
    batch. The reference also re-meshes onto the surviving devices
    (``distributed/elastic.py``); the port runs on one card.
    """

    def __init__(self, model: Model, tcfg: TrainConfig, step_fn,
                 checkpoint_mgr=None):
        self.model = model
        self.tcfg = tcfg
        self.step_fn = step_fn
        self.ckpt = checkpoint_mgr
        self.step_times = []

    def run(self, params, opt_state, batches, on_failure=None,
            start_step: int = 0):
        step_i = start_step
        for batch in batches:
            t0 = time.perf_counter()
            try:
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
            except Exception as e:  # device loss / injected fault
                if on_failure is None:
                    raise
                params, opt_state = on_failure(e, step_i)
                continue
            self.step_times.append(time.perf_counter() - t0)
            step_i += 1
            if self.ckpt and step_i % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step_i, {"params": params,
                                        "opt_state": opt_state},
                               async_write=True)
        return params, opt_state, step_i

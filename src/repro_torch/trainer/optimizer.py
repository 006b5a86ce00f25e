"""AdamW over the port's parameter trees.

Port of ``repro.trainer.optimizer`` (without its ZeRO-1 sharding of the
moments, which follows the reference's TPU mesh: on one card every moment
is whole). Moments are f32, the step counter an int32 0-d tensor; weight
decay is decoupled, bias correction exact (``1 - b ** step`` in f32).

Trees are nested dicts and lists of tensors, as the models build them: a
list holds one dict per layer where the reference stacks the layers along a
leading axis (``transformer._STACKED``). The reference decays every leaf of
rank >= 2, so a per-layer norm scale or bias, which it holds as (L, d), is
decayed; the port holds the same leaf as (d,) inside a list. The rank rule
is therefore read in the reference's layout: a leaf inside a list counts one
dimension more (``reference_rank``). Zamba2's single ``shared`` block is not
stacked in either package, so its norms are decayed in neither.

``update`` is functional: it returns new trees and leaves its inputs
untouched, as the reference's is (``ResilientTrainer`` and the restart
test rely on it).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import TrainConfig

OptState = Dict[str, Any]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over a tree of dicts and lists; every
    tree in ``rest`` has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def reference_rank(tree, stacked: int = 0):
    """A tree of ints: each leaf's rank in the reference's layout, where a
    list of per-layer dicts is one leading axis."""
    if isinstance(tree, dict):
        return {k: reference_rank(v, stacked) for k, v in tree.items()}
    if isinstance(tree, list):
        return [reference_rank(v, stacked + 1) for v in tree]
    return tree.dim() + stacked


def init(params) -> OptState:
    def zeros(p):   # zeros_like: a DTensor leaf keeps its placements
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        p)
    leaf = tree_leaves(params)[0]
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def update(params, grads, state: OptState, cfg: TrainConfig,
           lr: torch.Tensor) -> Tuple[Any, OptState, Dict[str, Any]]:
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, mu, nu, rank):
        g32 = g.float()
        mu = b1 * mu + (1 - b1) * g32
        nu = b2 * nu + (1 - b2) * torch.square(g32)
        mhat = mu / c1
        nhat = nu / c2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if rank >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"],
                   reference_rank(params))
    new_state = {"mu": tree_map(lambda o: o[1], out),
                 "nu": tree_map(lambda o: o[2], out), "step": step}
    return tree_map(lambda o: o[0], out), new_state, {"grad_norm": gnorm}

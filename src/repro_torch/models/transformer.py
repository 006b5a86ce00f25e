"""Decoder-only transformer LM (the dense family: GPT-2 Large here).

Port of ``repro.models.transformer`` for the serving path: ``block_forward``
and ``forward_hidden`` over a parameter dict whose ``"layers"`` entry is a
list of per-layer dicts (the reference stacks them along a leading layer
axis for ``jax.lax.scan``; PyTorch runs eagerly, so the layers are a plain
loop). Two ways to get parameters:

* ``params_from_jax(tree)`` — the reference's parameter pytree, converted
  to numpy by the caller, becomes torch tensors with the layer stack
  unstacked along its leading axis. Layouts are unchanged.
* ``init_params(cfg, generator, device)`` — seeded random weights with the
  reference's distributions (normal × 0.02 for dense and embedding
  matrices, unit/zero norms), made directly on the device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (Params, apply_norm, dense_init,
                                       embed_tokens, init_norm, pdtype)
from repro_torch.models.mlp import apply_mlp, init_mlp


def require_dense(cfg: ModelConfig) -> None:
    """Raise for model families this slice of the port does not serve."""
    if cfg.family != "dense" or cfg.pos_type not in ("learned", "none"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / pos_type "
            f"{cfg.pos_type!r} join the port with their model slices "
            "(RoPE, MoE, SSM, audio); this slice serves dense models with "
            "learned positions (GPT-2)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_block(cfg: ModelConfig, generator: torch.Generator,
               device) -> Params:
    return {
        "attn": attn.init_attention(cfg, generator, device),
        "norm1": init_norm(cfg, device),
        "norm2": init_norm(cfg, device),
        "ffn": init_mlp(cfg, generator, device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights from ``generator`` on ``device``: the reference's
    ``init`` distributions, not its draws."""
    require_dense(cfg)
    emb: Params = {"tok": dense_init((cfg.vocab_size, cfg.d_model),
                                     generator, device, pdtype(cfg))}
    if cfg.pos_type == "learned":
        emb["pos"] = dense_init((cfg.max_position, cfg.d_model), generator,
                                device, pdtype(cfg))
    if not cfg.tie_embeddings:
        emb["head"] = dense_init((cfg.vocab_size, cfg.d_model), generator,
                                 device, pdtype(cfg))
    return {
        "embed": emb,
        "layers": [init_block(cfg, generator, device)
                   for _ in range(cfg.num_layers)],
        "final_norm": init_norm(cfg, device),
    }


def _to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)   # copies


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Params:
    """The reference's parameter pytree (leaves as numpy arrays) -> this
    package's parameter dict on ``device``.

    ``tree["layers"]`` is stacked along a leading layer axis in the
    reference; it becomes a list with one dict per layer. Every other leaf
    keeps its shape, layout and dtype."""
    layers = tree["layers"]
    first = layers
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n = int(np.asarray(first).shape[0])
    out = {k: _to_torch(v, device) for k, v in tree.items() if k != "layers"}
    stacked = _to_torch(layers, device)
    out["layers"] = [_unstack(stacked, i) for i in range(n)]
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def block_forward(cfg: ModelConfig, p: Params, x):
    """Full-sequence (prefill) block. Returns (x, (k, v))."""
    h = apply_norm(cfg, p["norm1"], x)
    q, k, v = attn.qkv_proj(cfg, p["attn"], h)
    o = attn.attend(cfg, q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn.out_proj(cfg, p["attn"], o)
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["ffn"], h), (k, v)


def forward_hidden(cfg: ModelConfig, params: Params, tokens):
    """tokens (B,S) -> final-normed hidden (B,S,d) through every layer."""
    require_dense(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)
    for lp in params["layers"]:
        x, _ = block_forward(cfg, lp, x)
    return apply_norm(cfg, params["final_norm"], x)

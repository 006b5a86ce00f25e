"""Decoder-only transformer LM: the dense family (GPT-2 Large, TinyLlama,
SmolLM, StarCoder2, Granite), the MoE family (qwen3-moe, phi3.5-moe) and
the vlm family (Qwen2-VL: M-RoPE, and stub patch embeddings prepended to
the token embeddings, ``prefix_embeds``).

Port of ``repro.models.transformer``: ``block_forward`` and
``forward_hidden`` (the pipeline server's stage compute), the KV-cache
engine's ``make_cache``, ``prefill``, ``block_decode`` and ``decode_step``,
and the training loss ``loss_fn``, over a parameter dict whose ``"layers"`` entry is a list
of per-layer dicts (the reference stacks them along a leading layer axis
for ``jax.lax.scan``; PyTorch runs eagerly, so the layers are a plain
loop). A layer's feed-forward is the MLP (``models/mlp.py``) or, for the
``moe`` family, the expert layer (``models/moe.py``). The cache keeps the
reference's layout: ``k`` and ``v`` of shape (L, B, capacity, Hkv, D),
layer-major so that each layer's slice is a contiguous (B, capacity, Hkv,
D) tensor for kernel K4, and ``index``, the number of filled positions,
kept on the host as an int. Two ways to get parameters:

* ``params_from_jax(tree)`` — the reference's parameter pytree, converted
  to numpy by the caller, becomes torch tensors with the layer stack
  unstacked along its leading axis. Layouts are unchanged.
* ``init_params(cfg, generator, device)`` — seeded random weights with the
  reference's distributions (normal × 0.02 for dense and embedding
  matrices, unit/zero norms), made directly on the device, every leaf in
  ``cfg.param_dtype``.

``params_to_numpy(tree)`` is ``params_from_jax``'s inverse: the layer lists
restacked along a leading axis, every leaf a numpy array (the checkpoints'
layout, which is the reference's).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (Params, adtype, apply_norm,
                                       chunked_cross_entropy,
                                       cross_entropy_loss, embed_tokens,
                                       init_embeddings, init_norm,
                                       logits_head, remat)
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.rope import apply_rotary, positional_angles


#: families and position types the decoder serves
_FAMILIES = ("dense", "moe", "vlm")
_POS_TYPES = ("learned", "none", "rope", "mrope")


def require_decoder(cfg: ModelConfig) -> None:
    """Raise for configs this module does not serve. It serves the dense,
    MoE and vlm families with learned positions, none, RoPE or M-RoPE;
    RWKV6, Zamba2 and Whisper have modules of their own."""
    if cfg.family not in _FAMILIES or cfg.pos_type not in _POS_TYPES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / pos_type "
            f"{cfg.pos_type!r} is not served by the decoder-only "
            "transformer (dense, moe and vlm with learned, none, rope or "
            "mrope positions)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_block(cfg: ModelConfig, generator: torch.Generator,
               device) -> Params:
    return {
        "attn": attn.init_attention(cfg, generator, device),
        "norm1": init_norm(cfg, device),
        "norm2": init_norm(cfg, device),
        "ffn": (moe_mod.init_moe(cfg, generator, device)
                if cfg.family == "moe" else init_mlp(cfg, generator, device)),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights from ``generator`` on ``device``: the reference's
    ``init`` distributions, not its draws, every leaf in
    ``cfg.param_dtype``. Each matrix is drawn in f32 and cast on its own,
    so the largest transient is one f32 matrix."""
    require_decoder(cfg)
    return {
        "embed": init_embeddings(cfg, generator, device),
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


def _depth(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(np.asarray(tree).shape[0])


#: the subtrees the reference stacks along a leading layer axis: the
#: dense / RWKV6 ``layers``, Zamba2's ``mamba`` blocks and Whisper's
#: ``encoder`` and ``decoder`` blocks
_STACKED = ("layers", "mamba", "encoder", "decoder")


def params_from_jax(tree: Dict[str, Any], device=None) -> Params:
    """The reference's parameter pytree (leaves as numpy arrays) -> this
    package's parameter dict on ``device`` (``cuda`` unless the caller
    passes another; ``resolve_device``). Serves every family the port
    serves: the dense, MoE and vlm transformer and RWKV6 (``embed`` /
    ``layers`` / ``final_norm``; an MoE layer's ``ffn`` holds the router
    and the (E, d, f) / (E, f, d) expert stacks), Zamba2 (``embed`` /
    ``mamba`` / ``shared`` / ``final_norm``) and Whisper (``embed`` /
    ``enc_pos`` / ``encoder`` / ``decoder`` / ``enc_norm`` /
    ``final_norm``).

    ``layers``, ``mamba``, ``encoder`` and ``decoder`` are stacked along a
    leading layer axis in the reference; each becomes a list with one
    dict per layer. Every other subtree (Zamba2's single ``shared`` block
    among them) and every leaf keep their shape, layout and dtype."""
    device = resolve_device(device)
    out = {}
    for name, sub in tree.items():
        sub_t = _to_torch(sub, device)
        if name in _STACKED:
            sub_t = [_unstack(sub_t, i) for i in range(_depth(sub))]
        out[name] = sub_t
    return out


def _stack(layers: list) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device -> a numpy array. bf16 (numpy has no such
    type) becomes raw 2-byte ``|V2`` values, which is what
    ``np.asarray`` of a JAX bf16 array stores in a ``.npz``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def leaf_from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``leaf_to_numpy``'s inverse: ``a`` as a tensor of ``like``'s dtype
    on ``like``'s device (``|V2`` values read as bf16 bits first)."""
    a = a if a.flags.c_contiguous else a.copy()
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def params_to_numpy(tree: Any) -> Any:
    """This package's parameter (or moment) tree -> the reference's layout
    as numpy arrays: ``params_from_jax``'s inverse. Each list of per-layer
    dicts (``layers``, ``mamba``, ``encoder``, ``decoder``) is stacked
    along a leading layer axis; every leaf keeps its shape and dtype (bf16
    as ``|V2``, ``leaf_to_numpy``)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return params_to_numpy(_stack(tree))
    return leaf_to_numpy(tree)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn(cfg: ModelConfig, p: Params, x):
    """The layer's feed-forward: (y, aux), aux the MoE load-balance loss
    (a 0-d f32 tensor) and 0.0 for the dense MLP."""
    if cfg.family == "moe":
        return moe_mod.apply_moe(cfg, p, x, return_aux=True)
    return apply_mlp(cfg, p, x), 0.0


def block_forward(cfg: ModelConfig, p: Params, x, angles=None):
    """Full-sequence (prefill) block. Returns (x, (k, v, aux))."""
    h = apply_norm(cfg, p["norm1"], x)
    q, k, v = attn.qkv_proj(cfg, p["attn"], h)
    if angles is not None:
        q = apply_rotary(q, angles)
        k = apply_rotary(k, angles)
    o = attn.attend(cfg, q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn.out_proj(cfg, p["attn"], o)
    h = apply_norm(cfg, p["norm2"], x)
    y, aux = _ffn(cfg, p["ffn"], h)
    return x + y, (k, v, aux)


def block_decode(cfg: ModelConfig, p: Params, x, angles, cache_k, cache_v,
                 index: int, kv_len: torch.Tensor):
    """One-token block. x (B,1,d); caches (B,Smax,Hkv,D), written in place
    at the host int ``index``. ``kv_len`` — (B,) int32 tensor on the
    device equal to ``index + 1``, built once per step for every layer.
    Returns (x, cache_k, cache_v)."""
    h = apply_norm(cfg, p["norm1"], x)
    q, k, v = attn.qkv_proj(cfg, p["attn"], h)
    if angles is not None:
        q = apply_rotary(q, angles)
        k = apply_rotary(k, angles)
    cache_k, cache_v = attn.cache_update(cache_k, cache_v, k, v, index,
                                         masked=cfg.decode_masked_write)
    o = attn.decode_attend(cfg, q, cache_k, cache_v, kv_len,
                           window=cfg.sliding_window)
    x = x + attn.out_proj(cfg, p["attn"], o)
    h = apply_norm(cfg, p["norm2"], x)
    y, _ = _ffn(cfg, p["ffn"], h)
    return x + y, cache_k, cache_v


def _angles(cfg: ModelConfig, positions):
    if cfg.pos_type in ("rope", "mrope"):
        return positional_angles(cfg, positions)
    return None


def forward_hidden(cfg: ModelConfig, params: Params, tokens, positions=None,
                   prefix_embeds=None, collect_kv: bool = False,
                   return_aux: bool = False):
    """tokens (B,S) -> final-normed hidden (B,S_total,d) through every
    layer.

    ``prefix_embeds`` (B, Sv, d): modality-stub embeddings (Qwen2-VL's
    patch embeddings) prepended to the token embeddings, so S_total =
    Sv + S. ``positions`` (B, S_total) feed learned positions, RoPE and
    text-only M-RoPE, (3, B, S_total) the three M-RoPE streams (default
    0..S_total-1). With ``collect_kv`` the result is (hidden, (k, v)),
    k, v stacked per layer: (L, B, S_total, Hkv, D). With ``return_aux``
    the MoE load-balance loss, the mean over layers (0.0 for a dense
    layer), is appended: (hidden, aux) or (hidden, (k, v), aux). Under
    ``cfg.remat`` each layer is rematerialised in backward, as the
    reference's ``jax.checkpoint`` of its layer body."""
    require_decoder(cfg)
    learned = cfg.pos_type == "learned" and positions is not None and \
        positions.dim() == 2
    x = embed_tokens(cfg, params["embed"], tokens,
                     positions if learned else None)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    if positions is None and cfg.pos_type in ("rope", "mrope"):
        positions = torch.arange(S, device=tokens.device)[None, :].expand(
            B, S)
    angles = _angles(cfg, positions)
    ks, vs, auxs = [], [], []
    for lp in params["layers"]:
        x, (k, v, aux) = remat(
            cfg.remat, lambda x, lp: block_forward(cfg, lp, x, angles), x,
            lp)
        auxs.append(aux)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = apply_norm(cfg, params["final_norm"], x)
    out = (x,)
    if collect_kv:
        out += ((torch.stack(ks), torch.stack(vs)),)
    if return_aux:
        out += (torch.stack(auxs).mean() if cfg.family == "moe" else 0.0,)
    return out[0] if len(out) == 1 else out


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """batch: tokens (B,S), labels (B,S) [, mask, positions,
    vision_embeds] -> the mean token cross-entropy (f32, 0-d), plus
    ``moe_aux_weight`` x the load-balance loss for the MoE family. With
    ``vision_embeds`` (B, Sv, d) the loss covers the text region only."""
    tokens = batch["tokens"]
    prefix = batch.get("vision_embeds")
    x, aux = forward_hidden(cfg, params, tokens,
                            positions=batch.get("positions"),
                            prefix_embeds=prefix, return_aux=True)
    if prefix is not None:  # loss only over the text region
        x = x[:, prefix.shape[1]:, :]
    labels = batch["labels"]
    mask = batch.get("mask")
    if cfg.ce_impl == "chunked":
        loss = chunked_cross_entropy(cfg, params["embed"], x, labels,
                                     chunk=cfg.ce_chunk, mask=mask)
    else:
        logits = logits_head(cfg, params["embed"], x)
        loss = cross_entropy_loss(logits, labels, mask)
    if cfg.family == "moe":
        loss = loss + cfg.moe_aux_weight * aux
    return loss


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def make_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
               device=None):
    """An empty cache on ``device`` (``cuda`` unless the caller passes
    another): zero K/V of (L, batch, capacity, Hkv, D) in the activation
    dtype (or ``dtype``), index 0."""
    dtype = dtype or adtype(cfg)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def prefill(cfg: ModelConfig, params: Params, tokens, positions=None,
            prefix_embeds=None, capacity: Optional[int] = None):
    """Process the prompt (B, S) behind an optional ``prefix_embeds``
    (B, Sv, d); returns (last-token logits (B,1,V), cache) with K/V of
    all S_total = Sv + S positions, zero-padded to ``capacity`` (default
    S_total), and index S_total."""
    x, (k, v) = forward_hidden(cfg, params, tokens, positions=positions,
                               prefix_embeds=prefix_embeds, collect_kv=True)
    L, B, S = k.shape[:3]
    capacity = max(capacity or S, S)
    if capacity == S:   # the stacked K/V are the cache: no copy
        cache = {"k": k, "v": v, "index": S}
    else:
        cache = make_cache(cfg, B, capacity, dtype=k.dtype, device=k.device)
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
        cache["index"] = S
    logits = logits_head(cfg, params["embed"], x[:, -1:, :])
    return logits, cache


def decode_step(cfg: ModelConfig, params: Params, token, cache,
                positions=None):
    """token (B,1) int; cache from prefill/make_cache. One serve step:
    returns (logits (B,1,V), cache) with the new K/V written in place and
    the index advanced. The index is a host int, so no step reads a device
    scalar back. Rotary configs take the token's position from ``index``
    unless ``positions`` ((B, 1), or (3, B, 1) for M-RoPE: Qwen2-VL's
    continued positions after an image prefix) are given."""
    require_decoder(cfg)
    index = int(cache["index"])
    B = token.shape[0]
    dev = token.device
    x = embed_tokens(cfg, params["embed"], token,
                     positions=torch.full((B, 1), index, device=dev)
                     if cfg.pos_type == "learned" else None)
    if cfg.pos_type in ("rope", "mrope") and positions is None:
        positions = torch.full((B, 1), index, dtype=torch.int32, device=dev)
    angles = _angles(cfg, positions)
    kv_len = torch.full((B,), index + 1, dtype=torch.int32, device=dev)
    for l, lp in enumerate(params["layers"]):
        x, _, _ = block_decode(cfg, lp, x, angles, cache["k"][l],
                               cache["v"][l], index, kv_len)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = logits_head(cfg, params["embed"], x)
    cache["index"] = index + 1
    return logits, cache

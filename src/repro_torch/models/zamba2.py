"""Zamba2 — Mamba2 backbone with a SHARED attention+MLP block applied every
``cfg.attn_every`` mamba blocks.

Port of ``repro.models.zamba2`` for the serving path. The shared block has
ONE weight copy (a defining Zamba trait: attention weights amortised
across the depth); each of the ``n_groups = num_layers / attn_every``
applications keeps its own KV cache. The released checkpoints add
per-invocation LoRA deltas on the shared block; the reference omits them,
and so does the port.

Prefill runs each Mamba2 block's chunked SSD scan through kernel K6 and
each shared block's causal attention through kernel K3 when
``cfg.attn_impl == "flash"`` (their plain versions on CPU tensors, and with
``"xla"``); decode runs the plain one-token recurrence in the Mamba2
blocks and kernel K4 in each shared block. The reference scans over groups
and over each group's blocks; here both are plain loops over
``params["mamba"]``, a list of per-layer dicts.

The cache keeps the reference's layout: ``k`` and ``v`` (g, B, capacity,
Hkv, D) in the activation dtype, group-major so each group's slice is a
contiguous (B, capacity, Hkv, D) tensor for K4; ``conv`` (L, B, W-1,
conv channels) in the activation dtype; ``ssm`` (L, B, H, N, P) in f32;
and ``index``, the number of filled positions, kept on the host as an int.
Prefill writes into a cache it allocates once and decode updates it in
place. The training loss ``loss_fn`` runs ``forward_hidden`` without a
cache, each group (its Mamba2 blocks and the shared block) rematerialised
in backward under ``cfg.remat``, as the reference's ``jax.checkpoint`` of
its group body; training takes the plain chunked SSD form under
``attn_impl="xla"`` (kernel K6 has no gradient, as the reference's Pallas
kernel has none). Inside an activation policy (``distributed/sharding.py``)
a prefill builds its cache as DTensors in the ``cache_pspecs`` layout
(``sharding.cache_zeros``), which the reference's sharded prefill gives
its cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import cache_zeros
from repro_torch.models import attention as attn, mamba2 as m2
from repro_torch.models.common import (Params, adtype, apply_norm,
                                       chunked_cross_entropy,
                                       cross_entropy_loss, embed_tokens,
                                       init_embeddings, init_norm,
                                       logits_head, remat)
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.rope import apply_rotary, positional_angles


def n_groups(cfg: ModelConfig) -> int:
    if cfg.attn_every < 1 or cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} is not a "
                         f"multiple of attn_every={cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights from ``generator`` on ``device``: the reference's
    ``init`` distributions (``mamba2.init_mamba2`` per block, one shared
    attention + MLP block), not its draws."""
    n_groups(cfg)
    return {
        "embed": init_embeddings(cfg, generator, device),
        "mamba": [{"mixer": m2.init_mamba2(cfg, generator, device),
                   "norm": init_norm(cfg, device)}
                  for _ in range(cfg.num_layers)],
        "shared": {"attn": attn.init_attention(cfg, generator, device),
                   "mlp": init_mlp(cfg, generator, device),
                   "norm1": init_norm(cfg, device),
                   "norm2": init_norm(cfg, device)},
        "final_norm": init_norm(cfg, device),
    }


# ---------------------------------------------------------------------------
# Shared attention block
# ---------------------------------------------------------------------------


def shared_forward(cfg: ModelConfig, sp: Params, x, angles):
    """Full-sequence shared block. Returns (x, (k, v))."""
    h = apply_norm(cfg, sp["norm1"], x)
    q, k, v = attn.qkv_proj(cfg, sp["attn"], h)
    if angles is not None:
        q, k = apply_rotary(q, angles), apply_rotary(k, angles)
    o = attn.attend(cfg, q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn.out_proj(cfg, sp["attn"], o)
    h = apply_norm(cfg, sp["norm2"], x)
    return x + apply_mlp(cfg, sp["mlp"], h), (k, v)


def shared_decode(cfg: ModelConfig, sp: Params, x, angles, cache_k,
                  cache_v, index: int, kv_len: torch.Tensor):
    """One-token shared block against this application's caches
    (B, capacity, Hkv, D), written in place at the host int ``index``;
    ``kv_len`` = index + 1 per row, built once per step. Returns
    (x, cache_k, cache_v)."""
    h = apply_norm(cfg, sp["norm1"], x)
    q, k, v = attn.qkv_proj(cfg, sp["attn"], h)
    if angles is not None:
        q, k = apply_rotary(q, angles), apply_rotary(k, angles)
    cache_k, cache_v = attn.cache_update(cache_k, cache_v, k, v, index,
                                         masked=cfg.decode_masked_write)
    o = attn.decode_attend(cfg, q, cache_k, cache_v, kv_len,
                           window=cfg.sliding_window)
    x = x + attn.out_proj(cfg, sp["attn"], o)
    h = apply_norm(cfg, sp["norm2"], x)
    return x + apply_mlp(cfg, sp["mlp"], h), cache_k, cache_v


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def make_cache(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> Params:
    """An empty cache on ``device`` (``cuda`` unless the caller passes
    another): zero K/V of (g, batch, capacity, Hkv, D) and conv tails of
    (L, batch, W-1, conv channels) in the activation dtype, zero SSM states
    of (L, batch, H, N, P) in f32, index 0."""
    d_in, H, P, N = m2.dims(cfg)
    dtype = adtype(cfg)
    device = resolve_device(device)
    kv = (n_groups(cfg), batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "conv": torch.zeros((cfg.num_layers, batch, cfg.ssm_conv_width - 1,
                             d_in + 2 * N), dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.num_layers, batch, H, N, P),
                           dtype=torch.float32, device=device),
        "index": 0,
    }


def forward_hidden(cfg: ModelConfig, params: Params, tokens, positions=None,
                   cache: Optional[Params] = None):
    """tokens (B,S) -> final-normed hidden (B,S,d) through every block.

    With ``cache`` (``make_cache``'s layout, capacity >= S) each block's
    conv tail and SSM state, and each group's K/V in rows 0..S-1, are
    written into it in place. Without it, under ``cfg.remat``, each group
    is rematerialised in backward."""
    E = cfg.attn_every
    B, S = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(
            B, S)
    angles = positional_angles(cfg, positions)
    sp = params["shared"]

    def group(x, g: int):
        for l in range(g * E, (g + 1) * E):
            lp = params["mamba"][l]
            h = apply_norm(cfg, lp["norm"], x)
            out, (conv, ssm) = m2.mamba2_forward(cfg, lp["mixer"], h)
            x = x + out
            if cache is not None:
                cache["conv"][l] = conv
                cache["ssm"][l] = ssm
        x, (k, v) = shared_forward(cfg, sp, x, angles)
        if cache is not None:
            cache["k"][g, :, :S] = k
            cache["v"][g, :, :S] = v
        return x

    for g in range(n_groups(cfg)):
        x = remat(cfg.remat and cache is None, group, x, g)
    return apply_norm(cfg, params["final_norm"], x)


def loss_fn(cfg: ModelConfig, params: Params, batch):
    """batch: tokens (B,S), labels (B,S) [, mask] -> mean token
    cross-entropy (f32, 0-d)."""
    x = forward_hidden(cfg, params, batch["tokens"])
    if cfg.ce_impl == "chunked":
        return chunked_cross_entropy(cfg, params["embed"], x,
                                     batch["labels"], chunk=cfg.ce_chunk,
                                     mask=batch.get("mask"))
    logits = logits_head(cfg, params["embed"], x)
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


def prefill(cfg: ModelConfig, params: Params, tokens,
            capacity: Optional[int] = None):
    """Process the prompt (B, S); returns (last-token logits (B,1,V),
    cache) with K/V zero-padded to ``capacity`` (default S)."""
    B, S = tokens.shape
    cache = cache_zeros(cfg, lambda dev: make_cache(
        cfg, B, max(capacity or S, S), device=dev), tokens)
    x = forward_hidden(cfg, params, tokens, cache=cache)
    cache["index"] = S
    return logits_head(cfg, params["embed"], x[:, -1:, :]), cache


def decode_step(cfg: ModelConfig, params: Params, token, cache):
    """token (B,1) int; cache from prefill/make_cache. One serve step:
    returns (logits (B,1,V), cache) with every block's conv tail and SSM
    state and every group's new K/V row written in place, and the index
    (a host int) advanced. No step reads a device scalar back."""
    E = cfg.attn_every
    index = int(cache["index"])
    B = token.shape[0]
    dev = token.device
    x = embed_tokens(cfg, params["embed"], token)
    angles = positional_angles(
        cfg, torch.full((B, 1), index, dtype=torch.int32, device=dev))
    kv_len = torch.full((B,), index + 1, dtype=torch.int32, device=dev)
    sp = params["shared"]
    for g in range(n_groups(cfg)):
        for l in range(g * E, (g + 1) * E):
            lp = params["mamba"][l]
            h = apply_norm(cfg, lp["norm"], x)
            out, (conv, ssm) = m2.mamba2_step(
                cfg, lp["mixer"], h,
                (cache["conv"][l].to(x.dtype), cache["ssm"][l]))
            x = x + out
            cache["conv"][l] = conv
            cache["ssm"][l] = ssm
        x, _, _ = shared_decode(cfg, sp, x, angles, cache["k"][g],
                                cache["v"][g], index, kv_len)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = logits_head(cfg, params["embed"], x)
    cache["index"] = index + 1
    return logits, cache

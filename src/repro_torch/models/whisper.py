"""Whisper-large-v3 backbone: transformer encoder–decoder.

Port of ``repro.models.whisper`` for the serving surface. The conv/mel
audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d) plus learned positions
(``enc_pos``). The decoder is a causal transformer with cross-attention
over the encoder output. Layers are plain lists of per-layer dicts (the
reference stacks them for ``jax.lax.scan``; PyTorch runs eagerly).

Attention routes as in the reference (``attention.attend``): with
``attn_impl="flash"`` the encoder's self-attention is kernel K3 with
``causal=False`` (Sq = Sk = S_enc), the decoder's self-attention K3
causal, cross-attention K3 with ``causal=False`` and Sq = prompt length,
Sk = S_enc; in a decode step the self-attention over the cache is kernel
K4 (``decode_attend``) and the one-token cross-attention K3 again (Sq = 1,
Sk = S_enc: the reference calls ``attend`` there, not ``decode_attend``).

The serving cache holds ``sk`` / ``sv`` (L, B, capacity, H, D), the
decoder's self-attention K/V, written in place at every step, and ``ck``
/ ``cv`` (L, B, S_enc, H, D), the cross-attention K/V of the encoder
output, written once at prefill; ``index`` is a host int.

The training loss ``loss_fn`` encodes the frames and runs the decoder over
the tokens; under ``cfg.remat`` each encoder and decoder layer is
rematerialised in backward, as the reference's ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import reshape
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.models.common import (Params, adtype, apply_norm,
                                       chunked_cross_entropy,
                                       cross_entropy_loss, dense_init,
                                       embed_tokens, init_embeddings,
                                       init_norm, logits_head, pdtype, remat)
from repro_torch.models.mlp import apply_mlp, init_mlp


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_enc_block(cfg: ModelConfig, generator: torch.Generator,
                   device) -> Params:
    return {"attn": attn.init_attention(cfg, generator, device),
            "mlp": init_mlp(cfg, generator, device),
            "norm1": init_norm(cfg, device), "norm2": init_norm(cfg, device)}


def init_dec_block(cfg: ModelConfig, generator: torch.Generator,
                   device) -> Params:
    return {"self": attn.init_attention(cfg, generator, device),
            "cross": attn.init_attention(cfg, generator, device),
            "mlp": init_mlp(cfg, generator, device),
            "norm1": init_norm(cfg, device), "norm2": init_norm(cfg, device),
            "norm3": init_norm(cfg, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights from ``generator`` on ``device``: the reference's
    ``init`` tree and distributions (normal × 0.02 for the dense,
    embedding and ``enc_pos`` (max_position, d) matrices, unit/zero
    norms), not its draws, every leaf in ``cfg.param_dtype``."""
    return {
        "embed": init_embeddings(cfg, generator, device),
        "enc_pos": dense_init((cfg.max_position, cfg.d_model), generator,
                              device, pdtype(cfg)),
        "encoder": [init_enc_block(cfg, generator, device)
                    for _ in range(cfg.enc_layers)],
        "decoder": [init_dec_block(cfg, generator, device)
                    for _ in range(cfg.num_layers)],
        "enc_norm": init_norm(cfg, device),
        "final_norm": init_norm(cfg, device),
    }


#: the reference's Whisper pytree -> this module's parameter dict: the
#: ``encoder`` and ``decoder`` stacks become lists of per-layer dicts
params_from_jax = transformer.params_from_jax


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _cross_q(cfg: ModelConfig, p: Params, h):
    B, S = h.shape[:2]
    return reshape(h @ p["wq"].to(h.dtype), B, S, cfg.num_heads,
                   cfg.head_dim)


def _cross_kv(cfg: ModelConfig, p: Params, enc_out):
    B, S = enc_out.shape[:2]
    dt = enc_out.dtype
    ck = reshape(enc_out @ p["wk"].to(dt), B, S, cfg.num_kv_heads,
                 cfg.head_dim)
    cv = reshape(enc_out @ p["wv"].to(dt), B, S, cfg.num_kv_heads,
                 cfg.head_dim)
    return ck, cv


def enc_block(cfg: ModelConfig, p: Params, x):
    h = apply_norm(cfg, p["norm1"], x)
    q, k, v = attn.qkv_proj(cfg, p["attn"], h)
    o = attn.attend(cfg, q, k, v, causal=False)
    x = x + attn.out_proj(cfg, p["attn"], o)
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h)


def dec_block(cfg: ModelConfig, p: Params, x, enc_out):
    """Full-sequence decoder block. Returns (x, (k, v, ck, cv)): the
    self-attention K/V and the cross-attention K/V of ``enc_out``."""
    h = apply_norm(cfg, p["norm1"], x)
    q, k, v = attn.qkv_proj(cfg, p["self"], h)
    o = attn.attend(cfg, q, k, v, causal=True)
    x = x + attn.out_proj(cfg, p["self"], o)
    h = apply_norm(cfg, p["norm2"], x)
    q = _cross_q(cfg, p["cross"], h)
    ck, cv = _cross_kv(cfg, p["cross"], enc_out)
    o = attn.attend(cfg, q, ck, cv, causal=False)
    x = x + attn.out_proj(cfg, p["cross"], o)
    h = apply_norm(cfg, p["norm3"], x)
    return x + apply_mlp(cfg, p["mlp"], h), (k, v, ck, cv)


def dec_block_step(cfg: ModelConfig, p: Params, x, sk, sv, ck, cv,
                   index: int, kv_len: torch.Tensor):
    """One-token decoder block: the self cache (sk, sv) of (B, capacity,
    H, D) written in place at the host int ``index``, K4 over its first
    ``kv_len`` (= index + 1, a (B,) int32 tensor) rows, then the
    cross-attention over (ck, cv) through ``attend``. Returns (x, sk,
    sv)."""
    h = apply_norm(cfg, p["norm1"], x)
    q, k, v = attn.qkv_proj(cfg, p["self"], h)
    sk, sv = attn.cache_update(sk, sv, k, v, index,
                               masked=cfg.decode_masked_write)
    o = attn.decode_attend(cfg, q, sk, sv, kv_len)
    x = x + attn.out_proj(cfg, p["self"], o)
    h = apply_norm(cfg, p["norm2"], x)
    q = _cross_q(cfg, p["cross"], h)
    o = attn.attend(cfg, q, ck, cv, causal=False)
    x = x + attn.out_proj(cfg, p["cross"], o)
    h = apply_norm(cfg, p["norm3"], x)
    return x + apply_mlp(cfg, p["mlp"], h), sk, sv


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, params: Params, frames):
    """frames (B, S_enc, d) stub embeddings -> encoder output (B, S_enc,
    d) in the activation dtype."""
    S = frames.shape[1]
    x = frames.to(adtype(cfg)) + params["enc_pos"][:S][None].to(adtype(cfg))
    for lp in params["encoder"]:
        x = remat(cfg.remat, lambda x, lp: enc_block(cfg, lp, x), x, lp)
    return apply_norm(cfg, params["enc_norm"], x)


def decode_hidden(cfg: ModelConfig, params: Params, tokens, enc_out,
                  collect_kv: bool = False):
    """tokens (B, S) over ``enc_out`` -> (final-normed hidden (B, S, d),
    kv): with ``collect_kv`` kv is (sk, sv, ck, cv), each stacked per
    layer, (L, B, S or S_enc, H, D); else None."""
    x = embed_tokens(cfg, params["embed"], tokens)
    kvs = []
    for lp in params["decoder"]:
        x, kv = remat(cfg.remat, lambda x, lp: dec_block(cfg, lp, x, enc_out),
                      x, lp)
        if collect_kv:
            kvs.append(kv)
    x = apply_norm(cfg, params["final_norm"], x)
    if not collect_kv:
        return x, None
    return x, tuple(torch.stack(t) for t in zip(*kvs))


def loss_fn(cfg: ModelConfig, params: Params, batch):
    """batch: frames (B,S_enc,d), tokens (B,S), labels (B,S) [, mask] ->
    mean token cross-entropy (f32, 0-d)."""
    enc_out = encode(cfg, params, batch["frames"])
    x, _ = decode_hidden(cfg, params, batch["tokens"], enc_out)
    if cfg.ce_impl == "chunked":
        return chunked_cross_entropy(cfg, params["embed"], x,
                                     batch["labels"], chunk=cfg.ce_chunk,
                                     mask=batch.get("mask"))
    logits = logits_head(cfg, params["embed"], x)
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


def make_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
               device=None):
    """An empty cache on ``device`` (``cuda`` unless the caller passes
    another), in the activation dtype (or ``dtype``): sk, sv, ck, cv,
    each (L, batch, capacity, H, D), and index 0 — the reference's
    ``models/api.make_cache`` layout, which ``cache_bytes`` counts. A
    ``prefill``'s cache holds ck, cv at S_enc rows instead."""
    dtype = dtype or adtype(cfg)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads,
             cfg.head_dim)
    cache = {name: torch.zeros(shape, dtype=dtype, device=device)
             for name in ("sk", "sv", "ck", "cv")}
    cache["index"] = 0
    return cache


def prefill(cfg: ModelConfig, params: Params, tokens, frames=None,
            capacity: Optional[int] = None, **_):
    """Encode the stub frames (B, S_enc, d) and run the decoder over the
    prompt (B, S). Returns (last-token logits (B, 1, V), cache) with the
    self K/V zero-padded to ``capacity`` (default S) and index S."""
    assert frames is not None, "whisper prefill needs stub frame embeddings"
    enc_out = encode(cfg, params, frames)
    x, (sk, sv, ck, cv) = decode_hidden(cfg, params, tokens, enc_out,
                                        collect_kv=True)
    L, B, S = sk.shape[:3]
    capacity = max(capacity or S, S)
    cache = {"ck": ck, "cv": cv, "index": S}
    for name, t in (("sk", sk), ("sv", sv)):
        cache[name] = t.new_zeros((L, B, capacity) + tuple(t.shape[3:]))
        cache[name][:, :, :S] = t
    logits = logits_head(cfg, params["embed"], x[:, -1:, :])
    return logits, cache


def decode_step(cfg: ModelConfig, params: Params, token, cache, **_):
    """token (B, 1) int; cache from ``prefill``. One serve step: returns
    (logits (B, 1, V), cache) with the new self K/V written in place at
    the host int index and the index advanced; the cross K/V are read
    only."""
    index = int(cache["index"])
    B = token.shape[0]
    dev = token.device
    x = embed_tokens(cfg, params["embed"], token,
                     positions=torch.full((B, 1), index, device=dev))
    kv_len = torch.full((B,), index + 1, dtype=torch.int32, device=dev)
    for l, lp in enumerate(params["decoder"]):
        x, _, _ = dec_block_step(cfg, lp, x, cache["sk"][l], cache["sv"][l],
                                 cache["ck"][l], cache["cv"][l], index,
                                 kv_len)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = logits_head(cfg, params["embed"], x)
    cache["index"] = index + 1
    return logits, cache

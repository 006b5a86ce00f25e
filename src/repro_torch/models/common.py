"""Shared model building blocks: dtypes, norms, embeddings, logits head.

Port of ``repro.models.common``: the blocks every family shares, the
training losses (``cross_entropy_loss``, ``chunked_cross_entropy``) and
``remat``, the counterpart of the reference's ``jax.checkpoint``.
Parameters are nested dicts of torch tensors in the reference's layouts:
dense weights are ``(in, out)`` and are cast to the activation dtype at each
matmul, exactly as the reference does, so parameters converted from the
reference need no transposes. Norm statistics are taken in f32.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain, pin,
                                               reduce_partial, take_rows)

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def adtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.activation_dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def strict_fp32_matmul() -> None:
    """Keep f32 matmuls and convolutions in full f32 on the card (no TF32),
    so f32 runs are comparable with the reference and with each other.
    PyTorch's own defaults already keep f32 matmuls exact; the cuDNN flag
    defaults to TF32 and is set too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


def rmsnorm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def layernorm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    out = x * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dt)


def apply_norm(cfg: ModelConfig, p: Params, x):
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, p["weight"], cfg.norm_eps)
    return layernorm(x, p["weight"], p.get("bias"), cfg.norm_eps)


def init_norm(cfg: ModelConfig, device, d: int | None = None) -> Params:
    """Unit weight (and zero bias for LayerNorm), as the reference."""
    d = d or cfg.d_model
    p = {"weight": torch.ones((d,), dtype=pdtype(cfg), device=device)}
    if cfg.norm_type != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=pdtype(cfg), device=device)
    return p


def dense_init(shape, generator: torch.Generator, device,
               dtype=torch.float32, scale: float = 0.02):
    """``scale`` × standard normal, as the reference's ``dense_init``
    (the draws differ: the generator is torch's, not jax.random)."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Embeddings / logits
# ---------------------------------------------------------------------------


def init_embeddings(cfg: ModelConfig, generator: torch.Generator,
                    device) -> Params:
    """Token embedding, learned positions (when the config has them) and
    an untied head, each ``dense_init`` × 0.02, as the reference."""
    p: Params = {"tok": dense_init((cfg.vocab_size, cfg.d_model), generator,
                                   device, pdtype(cfg))}
    if cfg.pos_type == "learned":
        p["pos"] = dense_init((cfg.max_position, cfg.d_model), generator,
                              device, pdtype(cfg))
    if not cfg.tie_embeddings:
        p["head"] = dense_init((cfg.vocab_size, cfg.d_model), generator,
                               device, pdtype(cfg))
    return p


def embed_tokens(cfg: ModelConfig, p: Params, tokens, positions=None):
    """tokens (B, S) int -> (B, S, d) activations (learned positions added
    when the config has them; rows looked up by ``sharding.take_rows``,
    plain indexing outside an activation policy)."""
    x = take_rows(p["tok"], tokens).to(adtype(cfg))
    if cfg.pos_type == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[-1],
                                     device=tokens.device)[None, :]
        x = x + take_rows(p["pos"], positions).to(adtype(cfg))
    return constrain(x, "batch", "seq", "embed")


def logits_head(cfg: ModelConfig, p: Params, x):
    """x (..., d) -> (..., V) logits in ``cfg.logits_dtype`` (tied head:
    the token embedding matrix)."""
    w = p["tok"] if cfg.tie_embeddings else p["head"]
    # a tied table's two gradients (the lookup's and this product's, a
    # partial sum where the vocab is not sharded) meet in its own layout
    out = torch.matmul(x, pin(w).to(x.dtype).t())
    if out.dim() == 3:
        out = constrain(out, "batch", "seq", "vocab")
    return out.to(_DTYPES[cfg.logits_dtype])



# ---------------------------------------------------------------------------
# Training: losses, rematerialisation
# ---------------------------------------------------------------------------


def remat(enabled: bool, fn: Callable, *args):
    """``fn(*args)``, rematerialised in backward when ``enabled`` and
    autograd is recording: the counterpart of the reference's
    ``jax.checkpoint`` (``torch.utils.checkpoint``, non-reentrant, so
    ``fn`` may close over the parameters)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _nll(logits, labels):
    """Per-token negative log-likelihood in f32: logsumexp - gold logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = reduce_partial(torch.gather(logits, -1,
                                       labels[..., None].long()))[..., 0]
    return lse - gold


def cross_entropy_loss(logits, labels, mask=None):
    """Token-level CE; logits (..., V) any float dtype, labels (...) int.
    With ``mask`` a masked mean over max(sum(mask), 1) tokens."""
    nll = _nll(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def chunked_cross_entropy(cfg: ModelConfig, emb_params: Params, x, labels,
                          chunk: int = 512, mask=None):
    """CE over sequence chunks without materialising (B, S, V) logits, as
    the reference: each chunk's logits, logsumexp and masked sum, with the
    chunk body rematerialised in backward (without it autograd keeps every
    chunk's logits and the memory win is gone). The reference scans or
    unrolls the chunks (``cfg.scan_layers``); an eager loop is both."""
    B, S, D = x.shape
    n = S // chunk
    assert n * chunk == S, f"seq {S} not divisible by ce chunk {chunk}"
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)

    def body(xc, yc, mc):
        nll = _nll(logits_head(cfg, emb_params, xc), yc)
        return torch.sum(nll * mc), torch.sum(mc)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c = remat(True, body, x[:, sl], labels[:, sl], mask[:, sl].float())
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)

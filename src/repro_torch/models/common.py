"""Shared model building blocks: dtypes, norms, embeddings, logits head.

Port of ``repro.models.common`` for the dense decoder of this slice.
Parameters are nested dicts of torch tensors in the reference's layouts:
dense weights are ``(in, out)`` and are cast to the activation dtype at each
matmul, exactly as the reference does, so parameters converted from the
reference need no transposes. Norm statistics are taken in f32.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig

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


def embed_tokens(cfg: ModelConfig, p: Params, tokens, positions=None):
    """tokens (B, S) int -> (B, S, d) activations (learned positions added
    when the config has them)."""
    x = p["tok"][tokens].to(adtype(cfg))
    if cfg.pos_type == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[-1],
                                     device=tokens.device)[None, :]
        x = x + p["pos"][positions].to(adtype(cfg))
    return x


def logits_head(cfg: ModelConfig, p: Params, x):
    """x (..., d) -> (..., V) logits in ``cfg.logits_dtype`` (tied head:
    the token embedding matrix)."""
    w = p["tok"] if cfg.tie_embeddings else p["head"]
    out = torch.matmul(x, w.to(x.dtype).t())
    return out.to(_DTYPES[cfg.logits_dtype])


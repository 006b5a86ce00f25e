"""Unified model API: ``build_model(cfg)`` and ``make_cache``.

Port of ``repro.models.api`` for the serving surface of the families the
port serves so far:

    model.init(generator, device)            -> params
    model.prefill(params, tokens=..., capacity=...) -> (logits, cache)
    model.decode_step(params, token, cache)  -> (logits, cache)
    model.make_cache(batch, capacity, device) -> empty cache

The dense family (``dense``: GPT-2 Large, TinyLlama) is served by
``models/transformer.py``. The other families raise
``NotImplementedError`` naming the slice they wait for: ``moe`` and
``vlm`` (their model slices), ``ssm`` (RWKV6, with kernel K5), ``hybrid``
(Mamba2/Zamba2, with kernel K6) and ``audio`` (Whisper). The training
hooks (``loss_fn``, the dry-run input specs) wait for the trainer slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

#: family -> the slice of the port that brings it
_WAITING = {
    "moe": "the MoE slice (models/moe.py: phi3.5-moe, qwen3-moe)",
    "vlm": "the vlm slice (M-RoPE, qwen2-vl)",
    "ssm": "the RWKV6 slice (models/rwkv6.py with kernel K5, wkv6_chunked)",
    "hybrid": "the Mamba2/Zamba2 slice (kernel K6, ssd_chunked)",
    "audio": "the Whisper slice (models/whisper.py)",
}


def _require_served(cfg: ModelConfig) -> None:
    if cfg.family in _WAITING:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} joins "
                                  f"the port with {_WAITING[cfg.family]}")
    transformer.require_dense(cfg, rope=True)


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable


def make_cache(cfg: ModelConfig, batch: int, capacity: int, device="cpu"):
    """An empty serving cache for ``cfg`` (the dense layout: k, v of
    (L, batch, capacity, Hkv, D) in the activation dtype, index 0)."""
    _require_served(cfg)
    return transformer.make_cache(cfg, batch, capacity, device=device)


def build_model(cfg: ModelConfig) -> Model:
    _require_served(cfg)
    return Model(
        cfg=cfg,
        init=lambda generator, device: transformer.init_params(
            cfg, generator, device),
        prefill=lambda params, **kw: transformer.prefill(cfg, params, **kw),
        decode_step=lambda params, token, cache: transformer.decode_step(
            cfg, params, token, cache),
        make_cache=lambda batch, capacity, device="cpu": make_cache(
            cfg, batch, capacity, device=device),
    )

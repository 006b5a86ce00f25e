"""Unified model API: ``build_model(cfg)`` and ``make_cache``.

Port of ``repro.models.api`` for the serving surface of the families the
port serves so far:

    model.init(generator, device)            -> params
    model.prefill(params, tokens=..., capacity=...) -> (logits, cache)
    model.decode_step(params, token, cache)  -> (logits, cache)
    model.make_cache(batch, capacity, device) -> empty cache

The dense family (``dense``: GPT-2 Large, TinyLlama, SmolLM, StarCoder2,
Granite) and the MoE family (``moe``: qwen3-moe, phi3.5-moe) are served by
``models/transformer.py``, the ``ssm`` family (RWKV6) by
``models/rwkv6.py``, the ``hybrid`` family (Zamba2: Mamba2 blocks and a
shared attention block) by ``models/zamba2.py``. The other families raise
``NotImplementedError`` naming the slice they wait for: ``vlm`` (M-RoPE)
and ``audio`` (Whisper). The training hooks (``loss_fn``, the dry-run
input specs) wait for the trainer slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6, transformer, zamba2

_FAMILY_MODULES = {"dense": transformer, "moe": transformer, "ssm": rwkv6,
                   "hybrid": zamba2}


def _module(cfg: ModelConfig):
    """The module serving ``cfg``'s family; raises for the others (vlm and
    audio name the slice they wait for: ``transformer.WAITING``)."""
    mod = _FAMILY_MODULES.get(cfg.family, transformer)
    if mod is transformer:
        transformer.require_decoder(cfg)
    return mod


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable


def make_cache(cfg: ModelConfig, batch: int, capacity: int, device=None):
    """An empty serving cache for ``cfg`` on ``device`` (``cuda`` unless
    the caller passes another). Dense and MoE: k, v of (L, batch,
    capacity, Hkv, D) in the activation dtype and index 0. RWKV6: its zero
    recurrent state (``rwkv6.make_state``, independent of ``capacity``)
    and index 0, as the reference (``rwkv6.make_cache``). Zamba2: k, v of
    (groups, batch, capacity, Hkv, D), the conv tails and the f32 SSM
    states (``zamba2.make_cache``) and index 0. Each family's
    ``make_cache`` resolves the device."""
    return _module(cfg).make_cache(cfg, batch, capacity, device=device)


def build_model(cfg: ModelConfig) -> Model:
    mod = _module(cfg)
    return Model(
        cfg=cfg,
        init=lambda generator, device: mod.init_params(cfg, generator,
                                                       device),
        prefill=lambda params, **kw: mod.prefill(cfg, params, **kw),
        decode_step=lambda params, token, cache: mod.decode_step(
            cfg, params, token, cache),
        make_cache=lambda batch, capacity, device=None: make_cache(
            cfg, batch, capacity, device=device),
    )

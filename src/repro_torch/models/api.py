"""Unified model API: ``build_model(cfg)`` and ``make_cache``.

Port of ``repro.models.api`` for every family:

    model.init(generator, device)            -> params
    model.loss_fn(params, batch)             -> 0-d f32 loss (train step)
    model.prefill(params, tokens=..., capacity=..., **inputs)
                                             -> (logits, cache)
    model.decode_step(params, token, cache)  -> (logits, cache)
    model.make_cache(batch, capacity, device) -> empty cache
    model.input_specs(shape)                 -> the inputs of the step
                                                ``shape.kind`` names, as
                                                tensors on ``meta``

The dense family (``dense``: GPT-2 Large, TinyLlama, SmolLM, StarCoder2,
Granite), the MoE family (``moe``: qwen3-moe, phi3.5-moe) and the vlm
family (``vlm``: Qwen2-VL, whose prefill also takes ``prefix_embeds``
(B, Sv, d) stub patch embeddings and (3, B, S_total) M-RoPE
``positions``) are served by ``models/transformer.py``; the ``audio``
family (Whisper, whose prefill takes ``frames`` (B, S_enc, d) stub frame
embeddings) by ``models/whisper.py``; the ``ssm`` family (RWKV6) by
``models/rwkv6.py``; the ``hybrid`` family (Zamba2: Mamba2 blocks and a
shared attention block) by ``models/zamba2.py``. As in the reference,
``decode_step`` forwards no ``positions``: after an image prefix a vlm
decode step takes its position from the cache's index (the module's
``transformer.decode_step(..., positions=)`` takes continued M-RoPE
positions).

``input_specs`` is the dry-run contract of the reference: where it returns
``jax.ShapeDtypeStruct``s the port returns tensors on the ``meta`` device,
the same shapes and dtypes with no allocation. Modality-stub rule:
audio / vlm specs hold precomputed frame / patch embeddings (vlm: ``sv =
min(1024, S // 4)`` patch positions ahead of the text), never raw audio or
pixels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import rwkv6, transformer, whisper, zamba2
from repro_torch.models.common import adtype

_FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                   "vlm": transformer, "audio": whisper, "ssm": rwkv6,
                   "hybrid": zamba2}


def _module(cfg: ModelConfig):
    """The module serving ``cfg``'s family; an unknown family (or a
    position type the transformer does not serve) raises
    ``NotImplementedError`` (``transformer.require_decoder``), and so does
    a decoder stack with Mamba2 layers, whose KV-cache path would need an
    SSM cache that the port does not have (``transformer.require_kv_cache``:
    Granite-4.0-H is served through the pipeline server only)."""
    mod = _FAMILY_MODULES.get(cfg.family, transformer)
    if mod is transformer:
        transformer.require_decoder(cfg)
        transformer.require_kv_cache(cfg)
    return mod


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable

    # ------------------------------------------------------------------
    def train_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """The batch ``loss_fn`` takes, on ``meta``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if cfg.family == "audio":
            return {"frames": _spec((B, S, cfg.d_model), adtype(cfg)),
                    "tokens": _spec((B, S), i32),
                    "labels": _spec((B, S), i32)}
        if cfg.family == "vlm":
            sv = min(1024, S // 4)
            st = S - sv
            return {"tokens": _spec((B, st), i32),
                    "vision_embeds": _spec((B, sv, cfg.d_model),
                                           adtype(cfg)),
                    "positions": _spec((3, B, S), i32),
                    "labels": _spec((B, st), i32)}
        return {"tokens": _spec((B, S), i32), "labels": _spec((B, S), i32)}

    def prefill_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """The keyword inputs ``prefill`` takes, on ``meta``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if cfg.family == "audio":
            return {"tokens": _spec((B, S), i32),
                    "frames": _spec((B, S, cfg.d_model), adtype(cfg))}
        if cfg.family == "vlm":
            sv = min(1024, S // 4)
            return {"tokens": _spec((B, S - sv), i32),
                    "prefix_embeds": _spec((B, sv, cfg.d_model),
                                           adtype(cfg)),
                    "positions": _spec((3, B, S), i32)}
        return {"tokens": _spec((B, S), i32)}

    def decode_specs(self, shape: ShapeConfig):
        """(token, cache) on ``meta``: one new token and the cache at
        capacity ``seq_len``. The cache's ``index``, a host int when
        serving, is a 0-d int32 tensor here, as the reference's."""
        B, S = shape.global_batch, shape.seq_len
        cache = make_cache(self.cfg, B, S, device="meta")
        cache["index"] = _spec((), torch.int32)
        return _spec((B, 1), torch.int32), cache

    def input_specs(self, shape: ShapeConfig):
        if shape.kind == "train":
            return self.train_specs(shape)
        if shape.kind == "prefill":
            return self.prefill_specs(shape)
        return self.decode_specs(shape)


def make_cache(cfg: ModelConfig, batch: int, capacity: int, device=None):
    """An empty serving cache for ``cfg`` on ``device`` (``cuda`` unless
    the caller passes another). Dense, MoE and vlm: k, v of (L, batch,
    capacity, Hkv, D) in the activation dtype and index 0. Whisper: sk,
    sv, ck, cv, each (L, batch, capacity, H, D), and index 0, as the
    reference's audio branch (a prefill's cache holds ck, cv at S_enc
    rows instead). RWKV6: its zero recurrent state (``rwkv6.make_state``,
    independent of ``capacity``) and index 0, as the reference
    (``rwkv6.make_cache``). Zamba2: k, v of (groups, batch, capacity, Hkv,
    D), the conv tails and the f32 SSM states (``zamba2.make_cache``) and
    index 0. Each family's ``make_cache`` resolves the device."""
    return _module(cfg).make_cache(cfg, batch, capacity, device=device)


def build_model(cfg: ModelConfig) -> Model:
    mod = _module(cfg)
    return Model(
        cfg=cfg,
        init=lambda generator, device: mod.init_params(cfg, generator,
                                                       device),
        loss_fn=lambda params, batch: mod.loss_fn(cfg, params, batch),
        prefill=lambda params, **kw: mod.prefill(cfg, params, **kw),
        decode_step=lambda params, token, cache: mod.decode_step(
            cfg, params, token, cache),
        make_cache=lambda batch, capacity, device=None: make_cache(
            cfg, batch, capacity, device=device),
    )

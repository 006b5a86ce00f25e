"""Config registry: ``get_config(name)`` / ``--arch <id>`` resolution.

Port of ``repro.configs``. The port serves the paper's own model,
gpt2-large, and every other decoder-only transformer of the reference
through both serving paths (the pipeline server and the KV-cache engine):
the dense tinyllama-1.1b, smollm-360m, starcoder2-7b and granite-34b and
the MoE qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b; through the KV-cache
engine also rwkv6-1.6b (attention-free, the WKV scan of kernel K5) and
zamba2-2.7b (Mamba2 blocks with the SSD scan of kernel K6, and one shared
attention block of head dim 80); qwen2-vl-7b (vlm: M-RoPE, a prefix of
stub patch embeddings) through both serving paths for text and through the
model API with an image prefix; and whisper-large-v3 (audio: encoder over
stub frame embeddings, decoder with cross-attention) through its model API.
``ALL_ARCHS`` is the reference's list, in the reference's order;
``ASSIGNED_ARCHS`` (all but the paper's GPT-2) and ``get_shape`` are the
reference's too (the dry-run's grid).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    GTRACConfig,
    MeshConfig,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    shape_applicable,
)

#: arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    # dense code LM: RoPE, LayerNorm, GELU MLP, GQA 36/4 at head dim 128
    "starcoder2-7b": "starcoder2_7b",
    # llama2-arch dense LM: RoPE, RMSNorm, SwiGLU, GQA 32/4
    "tinyllama-1.1b": "tinyllama_1_1b",
    # dense code LM: learned positions, MQA 48/1 at head dim 128, tied head
    "granite-34b": "granite_34b",
    # llama-arch small dense LM: RoPE, GQA 15/5, tied head
    "smollm-360m": "smollm_360m",
    # MoE: 16 experts, top-2, LayerNorm, GQA 32/8 at head dim 128
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    # fine-grained MoE: 128 experts, top-8, GQA 32/4
    "qwen3-moe-30b-a3b": "qwen3_moe",
    # attention-free RWKV6 "Finch": data-dependent decay, WKV scan (K5)
    "rwkv6-1.6b": "rwkv6_1_6b",
    # hybrid: 54 Mamba2 blocks (SSD scan, K6) + a shared attention block
    "zamba2-2.7b": "zamba2_2_7b",
    # encoder-decoder audio backbone: non-causal encoder, cross-attention
    "whisper-large-v3": "whisper_large_v3",
    # VLM decoder: M-RoPE over (t, h, w) streams, stub patch embeddings
    "qwen2-vl-7b": "qwen2_vl_7b",
    # the paper's own evaluation model (GPT-2 Large, 36 layers)
    "gpt2-large": "gpt2_large",
}

ASSIGNED_ARCHS: List[str] = [a for a in _ARCH_MODULES if a != "gpt2-large"]
ALL_ARCHS: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]

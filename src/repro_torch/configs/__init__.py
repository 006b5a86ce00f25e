"""Config registry: ``get_config(name)`` / ``--arch <id>`` resolution.

Port of ``repro.configs``. The port serves the paper's own model,
gpt2-large, and every other decoder-only transformer of the reference
through both serving paths (the pipeline server and the KV-cache engine):
the dense tinyllama-1.1b, smollm-360m, starcoder2-7b and granite-34b and
the MoE qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b; through the KV-cache
engine also rwkv6-1.6b (attention-free, the WKV scan of kernel K5) and
zamba2-2.7b (Mamba2 blocks with the SSD scan of kernel K6, and one shared
attention block of head dim 80). whisper-large-v3 (audio) and qwen2-vl-7b
(vlm, M-RoPE) join with their model families.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import GTRACConfig, ModelConfig  # noqa: F401

#: arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    # the paper's own evaluation model (GPT-2 Large, 36 layers)
    "gpt2-large": "gpt2_large",
    # llama2-arch dense LM: RoPE, RMSNorm, SwiGLU, GQA 32/4
    "tinyllama-1.1b": "tinyllama_1_1b",
    # llama-arch small dense LM: RoPE, GQA 15/5, tied head
    "smollm-360m": "smollm_360m",
    # dense code LM: RoPE, LayerNorm, GELU MLP, GQA 36/4 at head dim 128
    "starcoder2-7b": "starcoder2_7b",
    # dense code LM: learned positions, MQA 48/1 at head dim 128, tied head
    "granite-34b": "granite_34b",
    # fine-grained MoE: 128 experts, top-8, GQA 32/4
    "qwen3-moe-30b-a3b": "qwen3_moe",
    # MoE: 16 experts, top-2, LayerNorm, GQA 32/8 at head dim 128
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    # attention-free RWKV6 "Finch": data-dependent decay, WKV scan (K5)
    "rwkv6-1.6b": "rwkv6_1_6b",
    # hybrid: 54 Mamba2 blocks (SSD scan, K6) + a shared attention block
    "zamba2-2.7b": "zamba2_2_7b",
}

ALL_ARCHS: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG

"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts, top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]

Port of ``repro.configs.phi35_moe``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6_400,            # per-expert intermediate size
    vocab_size=32_064,
    num_experts=16,
    experts_per_token=2,
    pos_type="rope",
    rope_theta=10_000.0,
    norm_type="layernorm",
    act="silu",
)

"""Qwen3-30B-A3B — 128 experts, top-8, fine-grained MoE.
[hf:Qwen/Qwen3-30B-A3B; hf]

Port of ``repro.configs.qwen3_moe``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2_048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,           # 2048 / 32
    d_ff=768,              # per-expert intermediate size (fine-grained)
    vocab_size=151_936,
    num_experts=128,
    experts_per_token=8,
    pos_type="rope",
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="silu",
)

"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

Port of ``repro.configs.zamba2_2_7b``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,          # mamba2 blocks
    d_model=2_560,
    num_heads=32,           # shared attention block heads
    num_kv_heads=32,
    head_dim=80,
    d_ff=10_240,            # shared block MLP
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    attn_every=6,           # shared attn block applied every 6 mamba blocks
    pos_type="rope",
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    act="gelu",
)

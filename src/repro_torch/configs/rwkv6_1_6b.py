"""RWKV6 (Finch) 1.6B — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]

Port of ``repro.configs.rwkv6_1_6b``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2_048,
    num_heads=32,          # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=32,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=7_168,            # channel-mix hidden (3.5x)
    vocab_size=65_536,
    pos_type="none",
    norm_type="layernorm",
    act="silu",
)

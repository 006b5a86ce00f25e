"""Granite-34B-Code — llama-arch, MQA (kv=1). [arXiv:2405.04324; hf]

Port of ``repro.configs.granite_34b``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6_144,
    num_heads=48,
    num_kv_heads=1,   # multi-query attention
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    pos_type="learned",   # granite-34b-code uses learned absolute positions
    norm_type="layernorm",
    act="gelu",
    tie_embeddings=True,
)

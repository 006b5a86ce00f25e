"""StarCoder2-7B — dense GQA code LM. [arXiv:2402.19173; hf]

Port of ``repro.configs.starcoder2_7b``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4_608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_432,
    vocab_size=49_152,
    pos_type="rope",
    rope_theta=1_000_000.0,
    norm_type="layernorm",
    act="gelu",
)

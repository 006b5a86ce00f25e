"""TinyLlama-1.1B — llama2-arch small dense LM. [arXiv:2401.02385; hf]

Port of ``repro.configs.tinyllama_1_1b``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2_048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5_632,
    vocab_size=32_000,
    pos_type="rope",
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    act="silu",
)

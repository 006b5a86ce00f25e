"""GPT-2 Large (774M, 36 layers) — the paper's own evaluation model (§V-A).
[Radford et al. 2019]

Port of ``repro.configs.gpt2_large``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-large",
    family="dense",
    num_layers=36,
    d_model=1_280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5_120,
    vocab_size=50_257,
    pos_type="learned",
    norm_type="layernorm",
    act="gelu",
    tie_embeddings=True,
)

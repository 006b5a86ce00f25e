"""SmolLM-360M — llama-arch small dense LM. [hf:HuggingFaceTB/SmolLM-360M; hf]

Port of ``repro.configs.smollm_360m``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2_560,
    vocab_size=49_152,
    pos_type="rope",
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    act="silu",
    tie_embeddings=True,
)

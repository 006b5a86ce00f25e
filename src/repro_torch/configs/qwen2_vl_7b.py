"""Qwen2-VL-7B — VLM decoder backbone with M-RoPE; ViT frontend is a STUB
(input_specs feeds precomputed patch embeddings). [arXiv:2409.12191; hf]

Port of ``repro.configs.qwen2_vl_7b``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3_584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    pos_type="mrope",
    mrope_sections=(16, 24, 24),   # (temporal, height, width) rotary sections
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="silu",
)

"""Whisper-large-v3 — encoder-decoder audio backbone; conv/mel frontend is a
STUB (input_specs feeds precomputed frame embeddings). [arXiv:2212.04356]

Port of ``repro.configs.whisper_large_v3``, copied verbatim.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,          # decoder layers
    enc_layers=32,          # encoder layers
    is_encoder_decoder=True,
    d_model=1_280,
    num_heads=20,
    num_kv_heads=20,        # MHA
    head_dim=64,
    d_ff=5_120,
    vocab_size=51_866,
    pos_type="learned",
    norm_type="layernorm",
    act="gelu",
    tie_embeddings=True,
)

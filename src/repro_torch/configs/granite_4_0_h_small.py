"""Granite-4.0-H-Small — a Mamba2 / attention hybrid with 72 experts and a
shared expert (32B total, 9B active). [hf:ibm-granite/granite-4.0-h-small]

The published ``config.json`` (``granitemoehybrid``): 40 layers of d 4,096,
36 of them Mamba2 mixers (128 heads of 64 channels, d_state 128, one group,
conv 4 with a bias) and 4 NoPE GQA attention layers (32/8 at head dim 128)
at layers 5, 15, 25 and 35, each mixer followed by a feed-forward of 72
SwiGLU experts of 768, top-10 renormalised, plus one shared SwiGLU expert
of 1,536; RMSNorm (eps 1e-5); the embedding times 12, attention scores
times 1/128, each mixer's and feed-forward's output times 0.22 before its
residual add, the tied head's logits divided by 16; vocabulary 100,352.
The port's own config: the JAX package has none.
"""
from repro_torch.configs.base import ModelConfig

#: attention at layers 5, 15, 25 and 35, a Mamba2 mixer elsewhere
_LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                     for i in range(40))

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="moe",
    num_layers=40,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,               # per-expert intermediate size
    vocab_size=100_352,
    num_experts=72,
    experts_per_token=10,
    shared_expert_ff=1_536,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    layer_types=_LAYER_TYPES,
    pos_type="none",        # NoPE
    norm_type="rmsnorm",
    norm_eps=1e-5,
    act="silu",
    tie_embeddings=True,
    embedding_multiplier=12.0,
    attention_multiplier=1.0 / 128,
    residual_multiplier=0.22,
    logits_scaling=16.0,
)

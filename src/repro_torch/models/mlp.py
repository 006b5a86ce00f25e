"""Feed-forward blocks: SwiGLU (llama-style) and plain GELU MLP.

Port of ``repro.models.mlp``. GELU is the tanh approximation, as the
reference's ``jax.nn.gelu(approximate=True)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import Params, dense_init, pdtype


def init_mlp(cfg: ModelConfig, generator: torch.Generator, device,
             d_in=None, d_ff=None) -> Params:
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    p = {
        "wi": dense_init((d, f), generator, device, pdtype(cfg)),
        "wo": dense_init((f, d), generator, device, pdtype(cfg)),
    }
    if cfg.act == "silu":  # gated
        p["wg"] = dense_init((d, f), generator, device, pdtype(cfg))
    return p


def apply_mlp(cfg: ModelConfig, p: Params, x):
    dt = x.dtype
    h = constrain(x @ p["wi"].to(dt), "batch", "seq", "ff")
    if cfg.act == "silu":
        h = F.silu(h) * constrain(x @ p["wg"].to(dt), "batch", "seq", "ff")
    else:
        h = F.gelu(h, approximate="tanh")
    return constrain(h @ p["wo"].to(dt), "batch", "seq", "embed")

"""Rotary position embeddings (llama half-split RoPE).

Port of ``repro.models.rope`` for standard RoPE: ``rope_freqs``,
``rope_angles``, ``apply_rotary`` and ``positional_angles``, the same
arithmetic (angles in f32, rotation in f32, cast back to the input's
dtype). Qwen2-VL's M-RoPE (``mrope_angles``) joins the port with the vlm
slice and raises until then.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim/2,) inverse frequencies in float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions, head_dim: int, theta: float):
    """positions (...,) -> angles (..., head_dim/2) in float32."""
    inv = rope_freqs(head_dim, theta, device=positions.device)
    return positions.float()[..., None] * inv


def mrope_angles(positions3, head_dim: int, theta: float, sections):
    """Qwen2-VL multimodal RoPE: joins the port with the vlm slice."""
    raise NotImplementedError("M-RoPE (qwen2-vl) joins the port with the "
                              "vlm slice")


def apply_rotary(x, angles):
    """x (B, S, H, D), angles (B, S, D/2) -> rotated x (llama half-split)."""
    dt = x.dtype
    x = x.float()
    cos = torch.cos(angles)[:, :, None, :]  # (B, S, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def positional_angles(cfg: ModelConfig, positions):
    """Dispatch on ``cfg.pos_type``. ``positions`` is (B, S), or (3, B, S)
    whose temporal stream is used. Returns (B, S, head_dim/2) angles, or
    None for non-rotary configs; M-RoPE raises until the vlm slice."""
    if cfg.pos_type == "rope":
        if positions.dim() == 3:
            positions = positions[0]
        return rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.pos_type == "mrope":
        return mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    return None

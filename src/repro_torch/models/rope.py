"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

Port of ``repro.models.rope``: ``rope_freqs``, ``rope_angles``,
``mrope_angles``, ``apply_rotary`` and ``positional_angles``, the same
arithmetic (angles in f32, rotation in f32, cast back to the input's
dtype). M-RoPE (multimodal rotary) splits the rotary pairs into (temporal,
height, width) sections, each driven by its own position stream; for
text-only tokens the three streams carry the same position, and M-RoPE
gives plain RoPE's frequencies.
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
    """positions3 (3, B, S) -> angles (B, S, head_dim/2) in float32.

    ``sections`` = (t, h, w) counts of rotary *pairs* per stream; must
    satisfy t + h + w == head_dim // 2."""
    t, h, w = sections
    assert t + h + w == head_dim // 2, (sections, head_dim)
    inv = rope_freqs(head_dim, theta, device=positions3.device)
    ang = positions3.float()[..., None] * inv          # (3, B, S, hd/2)
    return torch.cat([ang[0, ..., :t], ang[1, ..., t:t + h],
                      ang[2, ..., t + h:]], dim=-1)


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
    """Dispatch on ``cfg.pos_type``. ``positions`` is (B, S) or (3, B, S):
    RoPE uses the temporal stream of a (3, B, S); M-RoPE copies a (B, S)
    to all three streams (text only). Returns (B, S, head_dim/2) angles,
    or None for non-rotary configs."""
    if cfg.pos_type == "rope":
        if positions.dim() == 3:
            positions = positions[0]
        return rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.pos_type == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand((3,) + positions.shape)
        return mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    return None

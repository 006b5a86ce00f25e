"""Learning-rate schedules.

Port of ``repro.trainer.schedule``: the same f32 arithmetic on torch
tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def warmup_cosine(cfg: TrainConfig):
    """``lr(step)`` -> 0-d f32 tensor: linear warm-up to
    ``cfg.learning_rate`` over ``cfg.warmup_steps``, then a cosine decay to
    0 at ``cfg.total_steps``. ``step`` is an int or an integer tensor; the
    result lies on its device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = cfg.learning_rate * step / max(1, cfg.warmup_steps)
        progress = torch.clamp((step - cfg.warmup_steps) /
                               max(1, cfg.total_steps - cfg.warmup_steps),
                               0, 1)
        cos = 0.5 * cfg.learning_rate * (1 + torch.cos(math.pi * progress))
        return torch.where(step < cfg.warmup_steps, warm, cos)

    return lr

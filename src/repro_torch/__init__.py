"""repro_torch — the PyTorch/CUDA port of the G-TRAC reproduction.

The JAX package ``repro`` is the reference; this package mirrors its
layout file for file and is held against it by ``tests/test_torch_*.py``.
It imports torch and numpy, never jax and never ``repro``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; on a CUDA tensor
every kernel wrapper launches its hand-written kernel or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``; a bare ``cuda`` resolves to the current CUDA device. Without
    CUDA and without an explicit device this raises — the port never
    quietly falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch runs on CUDA by default and no "
                               "CUDA device is available; pass device='cpu' "
                               "to run the plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:   # "cuda" -> "cuda:<current>"
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

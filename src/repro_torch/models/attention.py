"""GQA attention: projections and the core implementations.

Port of ``repro.models.attention`` for the dense decoder of this slice:

* ``direct`` — plain PyTorch (``attention_direct``): scores in f32, the
  reference's -1e30 mask bias, softmax in f32, probabilities cast to the
  activation dtype for the PV product. Used for ``attn_impl="xla"`` at
  every length (the reference's chunked online-softmax variant is the same
  function within rounding and joins the port later).
* ``flash`` — kernel K3 through ``kernels.ops.flash_attention``: the
  hand-written CUDA kernel for tensors on the card, its plain version on
  the CPU.

GQA is computed natively with grouped einsums — KV heads are never
materially repeated.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import Params, dense_init, pdtype


def init_attention(cfg: ModelConfig, generator: torch.Generator, device,
                   d_in=None) -> Params:
    d = d_in or cfg.d_model
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    return {
        "wq": dense_init((d, hq), generator, device, pdtype(cfg)),
        "wk": dense_init((d, hkv), generator, device, pdtype(cfg)),
        "wv": dense_init((d, hkv), generator, device, pdtype(cfg)),
        "wo": dense_init((hq, cfg.d_model), generator, device, pdtype(cfg)),
    }


def qkv_proj(cfg: ModelConfig, p: Params, x):
    """x (B, S, d) -> q (B,S,Hq,D), k,v (B,S,Hkv,D)."""
    B, S, _ = x.shape
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"].to(dt)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].to(dt)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def out_proj(cfg: ModelConfig, p: Params, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"].to(o.dtype)


def attention_direct(q, k, v, *, causal: bool, q_offset: int = 0,
                     kv_len=None, window: int = 0):
    """q (B,Sq,Hq,D); k,v (B,Sk,Hkv,D) -> (B,Sq,Hq,D).

    ``kv_len`` (scalar or (B,)) masks out key positions >= kv_len.
    ``window`` > 0 restricts attention to the trailing window.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    # 1/sqrt(D) rounded in f32, as the reference's f32 constant
    scale = torch.tensor(float(D), dtype=torch.float32).rsqrt().item()
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    bias = _mask_bias(mask)[None, None, None]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev)
        live = k_pos[None, :] < kv_len.reshape(-1, 1)        # (B or 1, Sk)
        bias = bias + _mask_bias(live)[:, None, None, None, :]
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, D)


def _mask_bias(mask):
    return torch.where(mask, 0.0, -1e30).to(torch.float32)


def attention_flash(q, k, v, *, causal: bool):
    """Kernel K3 (``kernels/flash_attention.py``) through its dispatch."""
    return ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal)


def attend(cfg: ModelConfig, q, k, v, *, causal: bool = True,
           q_offset: int = 0, kv_len=None, window: int = 0):
    """Dispatch on ``cfg.attn_impl``.

    ``flash`` takes full causal self-attention only. The reference's flash
    path silently ignores ``sliding_window``; here ``window > 0`` with
    ``attn_impl="flash"`` raises ``ValueError`` instead (no shipped config
    sets a window)."""
    if cfg.attn_impl == "flash" and kv_len is None:
        if window:
            raise ValueError("attn_impl='flash' does not implement "
                             f"sliding_window={window}; use attn_impl='xla'")
        return attention_flash(q, k, v, causal=causal)
    return attention_direct(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len, window=window)

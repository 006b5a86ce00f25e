"""The benchmark's yardstick: peaks, percentiles, operation counts and
the least-time bounds of the attention kernels.

Frozen copies, so that a change to the program cannot move them:

* ``percentiles`` from ``src/repro_torch/obs/metrics.py`` at commit
  0da9266 (``np.percentile`` per quantile, -1.0 for no samples);
* ``k3_bound_ms`` and ``k4_bound_ms`` from ``chip_smoke.py`` at commit
  0da9266 (bytes read and written once against the multiply-adds at the
  peak rate of the input type), with the causal pair count in closed form;
* the peaks of one NVIDIA H100 SXM (the data sheet's dense rates), as
  ``src/repro_torch/launch/roofline.py`` and ``chip_smoke.py`` hold them
  at commit 0da9266;
* ``token_flops``: ``launch/roofline.py``'s 2·N per token at commit
  0da9266 (N the parameters a token passes through, the routed experts
  only for an MoE layer), with attention over the token's prefix added.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

#: one H100 SXM: bf16 dense tensor-core rate, f32 FMA rate, HBM bandwidth
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

#: profiler names of kernel K3 (``kernels/flash_attention.py`` KERNELS)
#: and kernel K4 (``kernels/decode_attention.py``: split and combine)
K3_KERNELS = ("flash_bf16_wgmma_kernel", "flash_bf16_mma_kernel",
              "flash_f32_kernel")
K4_KERNELS = ("decode_split_kernel", "decode_split_mma_kernel",
              "decode_combine_kernel")


def percentiles(xs: Sequence[float],
                qs: Sequence[float]) -> Tuple[float, ...]:
    """``np.percentile`` over every sample in ``xs`` for each quantile in
    ``qs``; -1.0 for each when ``xs`` is empty."""
    arr = np.asarray(xs, np.float64)
    if arr.size == 0:
        return tuple(-1.0 for _ in qs)
    return tuple(float(np.percentile(arr, q)) for q in qs)


def _peak(itemsize: int) -> float:
    return BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S


def k3_bound_ms(B: int, S: int, Hq: int, Hkv: int, D: int, itemsize: int,
                causal: bool = True, Sk: int = 0) -> Tuple[float, str]:
    """Least time for one attention call on the card: q, k, v read once
    and the output written once, against the multiply-adds of QK^T and PV
    over the visible (query, key) pairs at the peak rate of the input
    type. Causal pairs are key <= query, both counted from 0."""
    Sk = Sk or S
    nbytes = itemsize * (2 * B * S * Hq * D + 2 * B * Sk * Hkv * D)
    if causal:
        m = min(S, Sk)
        pairs = m * (m + 1) // 2 + (S - m) * Sk
    else:
        pairs = S * Sk
    flops = 4 * B * Hq * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / _peak(itemsize) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k4_bound_ms(B: int, Hq: int, Hkv: int, D: int, kv_len: int,
                itemsize: int) -> Tuple[float, str]:
    """Least time for one decode-attention call: the live K and V rows
    (``kv_len`` of each of the ``B`` rows), q and kv_len read once and the
    output written once, against the multiply-adds of QK^T and PV over
    the live rows at the peak rate of the input type."""
    live = B * int(kv_len)
    nbytes = itemsize * (2 * live * Hkv * D + 2 * B * Hq * D) + 4 * B
    flops = 4 * Hq * D * live
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / _peak(itemsize) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def layer_matmul_params(cfg) -> int:
    """Weights one token multiplies in one layer: the attention
    projections and the feed-forward (for an MoE layer the router and the
    ``experts_per_token`` routed experts only)."""
    d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    attn = d * hq + 2 * d * hkv + hq * d
    mats = 3 if cfg.act == "silu" else 2
    if cfg.family == "moe":
        ffn = d * cfg.num_experts + cfg.experts_per_token * mats * d * cfg.d_ff
    else:
        ffn = mats * d * cfg.d_ff
    return attn + ffn


def token_flops(cfg, position: int, head: bool) -> float:
    """Operations one token at ``position`` (0-based) needs in a KV-cache
    deployment: 2 per weight it multiplies in every layer, attention over
    its ``position + 1`` visible keys (QK^T and PV, 2 each per key, head
    and channel), and the output head when its logits are read."""
    per_layer = 2 * layer_matmul_params(cfg) + \
        4 * cfg.num_heads * cfg.head_dim * (position + 1)
    out = cfg.num_layers * per_layer
    if head:
        out += 2 * cfg.d_model * cfg.vocab_size
    return float(out)


def span_flops(cfg, start: int, end: int, head_last: bool) -> float:
    """``token_flops`` summed over positions ``start .. end - 1``, the
    head counted for the last position only when ``head_last``: a prompt
    chunk in closed form."""
    n = end - start
    if n <= 0:
        return 0.0
    per_layer = 2 * layer_matmul_params(cfg) * n + \
        4 * cfg.num_heads * cfg.head_dim * ((end * (end + 1)
                                             - start * (start + 1)) // 2)
    out = cfg.num_layers * per_layer
    if head_last:
        out += 2 * cfg.d_model * cfg.vocab_size
    return float(out)

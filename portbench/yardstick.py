"""The benchmark's yardstick: peaks, percentiles and the least-time
bounds of the attention kernels.

Frozen copies, so that a change to the program cannot move them:

* ``percentiles`` from ``src/repro_torch/obs/metrics.py`` at commit
  0da9266 (``np.percentile`` per quantile, -1.0 for no samples);
* ``k3_bound_ms`` and ``k4_bound_ms`` from ``chip_smoke.py`` at commit
  0da9266 (bytes read and written once against the multiply-adds at the
  peak rate of the input type), with the causal pair count in closed form;
* the peaks of one NVIDIA H100 SXM (the data sheet's dense rates), as
  ``src/repro_torch/launch/roofline.py`` and ``chip_smoke.py`` hold them
  at commit 0da9266.

The operations a token needs depend on the architecture: each
configuration's model module counts them (``reference/<model>.py``
``token_flops``, ``span_flops``).
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


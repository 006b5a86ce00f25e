"""Kernel K6's least time on the card (the chunked Mamba2 SSD scan,
``src/repro_torch/kernels/ssd_chunk.py``): a frozen copy of
``chip_smoke.py``'s ``k6_bound_ms``, so that a change to the program
cannot move it, and the profiler names of K6's kernels."""
from __future__ import annotations

from typing import Tuple

from portbench.yardstick import FP32_FLOP_PER_S, HBM_BYTES_PER_S

#: a split 3xTF32 product (the scan's products): three passes at the TF32
#: peak of one H100 SXM (the data sheet's dense rate)
TF32X3_FLOP_PER_S = 495e12 / 3
#: profiler names of K6's kernels: the mma.sync pre-pass and scan, and the
#: Hopper pre-pass and scan of ``csrc/ssd_chunk.cu``
K6_KERNELS = ("ssd_prep_kernel", "ssd_scan_kernel", "ssd_gram_kernel",
              "ssd_wgmma_kernel")
#: tokens per chunk of the bound's count
CHUNK = 64


def k6_bound_ms(B: int, S: int, H: int, P: int,
                N: int) -> Tuple[float, str]:
    """Least time for one scan call: x read and y written once, dt, la,
    Bm, Cm, h0 read and the final state written once (f32), against the
    operations the function needs. Per token and head 2 N P for the state
    update and 2 N P for the inter-chunk output; per chunk of c tokens
    (64, the last one ragged) and head the lower triangle s <= t of the
    intra-chunk product, c (c + 1) / 2 entries of 2 P: those at the rate
    of the scan's split 3xTF32 products; and per chunk and batch row that
    triangle of C . B^T (shared by the heads), c (c + 1) / 2 entries of
    2 N, at the FP32 peak (the pre-pass's FMAs)."""
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * H + 2 * B * S * N
                  + 2 * B * H * N * P)
    tri = (S // CHUNK) * CHUNK * (CHUNK + 1) + (S % CHUNK) * (S % CHUNK + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (B * H * (4 * N * P * S + P * tri) / TF32X3_FLOP_PER_S
             + B * N * tri / FP32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")

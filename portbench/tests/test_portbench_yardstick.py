"""The yardstick's arithmetic against hand-worked numbers: percentiles
over every sample, the rate, the decoder module's operation counts at
StarCoder2's and Qwen3's widths, and the kernels' least-time bounds."""
from __future__ import annotations

import types

import numpy as np
import pytest

from portbench import harness, yardstick as y
from portbench.harness import Record, Stream
from portbench.reference import decoder as m


def _cfg(name):
    import json
    config = json.load(open(harness.HERE / "configs" / f"{name}.json"))
    return harness.model_config(config)


def test_percentiles_over_every_sample():
    xs = list(range(1, 101))
    assert y.percentiles(xs, (50, 95)) == (50.5, 95.05)
    assert y.percentiles([], (95,)) == (-1.0,)


def _run(streams, window_s):
    rec = Record(streams=streams)
    win = types.SimpleNamespace(length=window_s)
    return types.SimpleNamespace(record=rec, window=win)


def test_rate_and_gap_tail_take_every_token_and_gap():
    a = Stream(np.zeros(4, np.int32), 8, output=[1] * 5,
               emit_s=[0.0, 0.1, 0.2, 0.3, 0.4])
    b = Stream(np.zeros(4, np.int32), 8, output=[1] * 3,
               emit_s=[1.0, 2.0, 3.0])
    run = _run([a, b], 4.0)
    rate = harness.load_module("metrics", "tokens_per_s").read(run)
    assert rate == 8 / 4.0
    p95 = harness.load_module("metrics", "itl_ms.p95").read(run)
    gaps = [100.0] * 4 + [1000.0] * 2
    assert p95 == pytest.approx(np.percentile(gaps, 95))


def test_flops_at_starcoder2_widths():
    cfg = _cfg("starcoder2-7b")
    # attention 4608x4608 + 2 x 4608x512 + 4608x4608, MLP 2 x 4608x18432
    assert m.layer_matmul_params(cfg) == 47_185_920 + 169_869_312
    # position 99: 32 layers x (2 x 217,055,232 + 4 x 36 x 128 x 100)
    # plus the head 2 x 4608 x 49,152
    assert m.token_flops(cfg, 99, True) == \
        32 * (434_110_464 + 1_843_200) + 452_984_832
    assert m.span_flops(cfg, 10, 20, True) == pytest.approx(
        sum(m.token_flops(cfg, p, False) for p in range(10, 20))
        + 452_984_832)


def test_flops_at_qwen3_widths():
    cfg = _cfg("qwen3-moe-30b-a3b")
    # attention 2048x4096 + 2 x 2048x512 + 4096x2048, router 2048x128,
    # 8 routed experts of 3 x 2048x768
    assert m.layer_matmul_params(cfg) == \
        18_874_368 + 262_144 + 8 * 4_718_592
    assert m.token_flops(cfg, 0, False) == \
        48 * (2 * 56_885_248 + 4 * 32 * 128)


def test_k3_bound_at_starcoder2_shape():
    ms, by = y.k3_bound_ms(1, 2048, 36, 4, 128, 2)
    # bytes 2 x (2 x 2048x36x128 + 2 x 2048x4x128) = 41,943,040;
    # causal pairs 2048 x 2049 / 2 = 2,098,176, 4 x 36 x 128 each
    flops = 4 * 36 * 128 * 2_098_176
    assert by == "operations"
    assert ms == pytest.approx(flops / 989e12 * 1e3)
    assert ms > 41_943_040 / 3.35e12 * 1e3


def test_k4_bound_at_engine_decode_shape():
    ms, by = y.k4_bound_ms(8, 36, 4, 128, 3000, 2)
    nbytes = 2 * (2 * 8 * 3000 * 4 * 128 + 2 * 8 * 36 * 128) + 4 * 8
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)

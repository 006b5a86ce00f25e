"""Granite-4.0-H-Small in the benchmark: the model module
``reference/granite_hybrid.py`` against the program on the CPU (the routed
stage functions' logits, the Mamba2 scan), planted faults the comparison
must catch, the layout and layer counts at published widths, a reduced
cell through the harness, and the readers of ``k6_roofline`` and
``ssm_share``."""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from portbench import harness, weights
from portbench.k6 import k6_bound_ms
from portbench.reference import granite_hybrid as gh
from portbench.tests import _cpu

CELL = "granite4h.chat.routed"
#: both sides in f32 on the CPU differ only in the order of their sums
#: (the scan's 64- against 256-token chunks, the conv's and the
#: attention's order): measured <= 2e-6 of the reference's standard
#: deviation; every planted fault below moves the logits by >= 2.8e-3
TOL_SD = 1e-4
#: the benchmark's weights (0.02 x normal) at the reduced width of 128 leave
#: each branch's output small beside the embedding, since those outputs
#: grow with the width; four times that gives the reduced stack branches
#: of the published width's size, so that every term moves the logits
WEIGHT_SCALE = 4.0


def _config_file():
    return harness.load_json(harness.HERE / "configs"
                             / "granite-4.0-h-small.json")


def _reduced(**kw):
    """The reduced Granite (one period: 9 Mamba2 layers and the attention
    layer at 5) in f32, through the benchmark's configuration file."""
    cfg = harness.model_config(_config_file(), dict(
        dict(activation_dtype="float32", param_dtype="float32",
             attn_impl="xla", d_ff=64, num_experts=8), **kw))
    assert cfg.layer_types.count("attention") == 1
    return cfg


def _weights(cfg, seed=11, scale=WEIGHT_SCALE):
    """The benchmark's weights with every seeded leaf but ``A_log`` at
    ``scale`` times the cell's."""
    W = weights.make_params(cfg, seed, "cpu", gh.layout)
    for path, shape, fill, *kind in gh.layout(cfg):
        if isinstance(fill, str) or path[-1] == "A_log":
            continue
        node = W
        for key in path:
            node = node[int(key)] if isinstance(node, list) else node[key]
        node.mul_(scale)
    return W


def _program_logits(cfg, W, toks):
    """The last stage's logits of the routed stage functions (two stages
    of five layers) over ``toks`` (1, S)."""
    from repro_torch.distributed.pipeline import StagePartition
    from repro_torch.serving.gtrac_serve import make_stage_fns
    payload = (toks, None)
    for fn in make_stage_fns(cfg, W, StagePartition.uniform(10, 5)):
        payload = fn(payload)
    return payload[1][0, -1].double()


def _error_sd(cfg_program, cfg, W, toks, reads=(109, 149)):
    """The program's largest logit error at each read position (a forward
    of the prefix through it), in standard deviations of the reference's
    logits there."""
    out = []
    for r in reads:
        ref = gh.forward_logits(cfg, W, toks, [r]).double()[0]
        got = _program_logits(cfg_program, W, toks[None, :r + 1])
        out.append(float((got - ref).abs().max() / ref.std()))
    return max(out)


@pytest.fixture(scope="module")
def granite():
    torch.set_num_threads(2)
    cfg = _reduced()
    W = _weights(cfg)
    toks = torch.randint(0, cfg.vocab_size, (150,),
                         generator=torch.Generator().manual_seed(4))
    return cfg, W, toks


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_stage_logits_match_the_reference(granite, attn_impl):
    cfg, W, toks = granite
    got = _error_sd(dataclasses.replace(cfg, attn_impl=attn_impl), cfg, W,
                    toks)
    assert got <= TOL_SD


def _zero_state_at_64(x, dt, la, Bm, Cm, h0):
    from repro_torch.kernels.ssd_chunk import ssd_chunked_plain
    y1, h = ssd_chunked_plain(*(a[:, :64] for a in (x, dt, la, Bm, Cm)), h0)
    y2, h = ssd_chunked_plain(*(a[:, 64:] for a in (x, dt, la, Bm, Cm)),
                              torch.zeros_like(h))
    return torch.cat([y1, y2], 1), h


@pytest.mark.parametrize("fault,change", [
    ("embedding multiplier dropped", dict(embedding_multiplier=1.0)),
    ("attention multiplier dropped", dict(attention_multiplier=1.0)),
    ("1/sqrt(D) for 1/128", dict(attention_multiplier=None)),
    ("residual multiplier dropped", dict(residual_multiplier=1.0)),
    ("logits scaling dropped", dict(logits_scaling=1.0)),
    ("shared expert dropped", dict(shared_expert_ff=0)),
    ("rotary on the NoPE layers", dict(pos_type="rope")),
    ("scan state zeroed at a chunk boundary", {}),
])
def test_planted_fault_fails_the_comparison(granite, monkeypatch, fault,
                                            change):
    """Each fault, planted in the program alone, moves its logits past
    the tolerance the sound program keeps."""
    cfg, W, toks = granite
    if not change:
        from repro_torch.models import mamba2
        monkeypatch.setattr(mamba2, "ssd_chunked", _zero_state_at_64)
    got = _error_sd(dataclasses.replace(cfg, **change), cfg, W, toks)
    assert got > 10 * TOL_SD, fault


@pytest.mark.parametrize("S", [1, 63, 64, 65, 300, 513])
def test_program_scan_matches_the_reference_scan(S):
    """The port's plain chunked scan (64-token chunks, a zero state)
    against the reference's own (256-token chunks), heads of fast and
    slow decay, within 1e-5 of the output's scale."""
    from repro_torch.kernels.ssd_chunk import ssd_chunked_plain
    g = torch.Generator().manual_seed(S)
    H, P, N = 3, 8, 16
    x = torch.randn(1, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(1, S, H, generator=g))
    la = -torch.exp(3 * torch.randn(H, generator=g)) * dt
    Bm, Cm = (torch.nn.functional.silu(torch.randn(1, S, N, generator=g))
              for _ in range(2))
    y, _ = ssd_chunked_plain(x, dt, la, Bm, Cm, torch.zeros(1, H, N, P))
    want = gh.scan(x[0], dt[0], la[0], Bm[0], Cm[0])
    assert float((y[0] - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


def test_layout_holds_the_published_parameters_without_allocating():
    cfg = harness.model_config(_config_file())
    n = sum(math.prod(leaf[1]) for leaf in gh.layout(cfg))
    assert n == 32_207_337_984 == _config_file()["parameters"]
    # the seeded ones: every leaf but the attention layers' norm1, the final
    # norm, the gated norms, D and dt_bias
    const = sum(math.prod(leaf[1]) for leaf in gh.layout(cfg)
                if isinstance(leaf[2], str))
    assert weights.count(cfg, gh.layout) == n - const
    assert (cfg.layer_types.count("mamba"), cfg.num_layers) == (36, 40)


def test_every_stage_holds_one_attention_and_nine_mamba_layers():
    cfg = harness.model_config(_config_file())
    per = _config_file()["deployment"]["layers_per_stage"]
    for s in range(0, cfg.num_layers, per):
        assert gh.attention_layers(cfg, s, s + per) == 1
        assert gh.ssm_layers(cfg, s, s + per) == 9
    assert gh.attention_layers(cfg, 0, 40) == 4
    assert gh.ssm_layers(cfg, 0, 40) == 36


def test_operation_count_adds_up():
    cfg = harness.model_config(_config_file())
    for a, b in ((0, 1), (0, 2048), (100, 164), (5000, 6272)):
        for head in (False, True):
            want = sum(gh.token_flops(cfg, p, False) for p in range(a, b)) \
                + (2 * cfg.d_model * cfg.vocab_size if head else 0)
            assert gh.span_flops(cfg, a, b, head) == pytest.approx(
                want, rel=1e-12)
    # per token at the prefix's start: 2 per weight multiplied, the 8.8e9
    # active parameters less the embedding (4.1e8), with the scan's 4 N P
    # per head and the conv beside them
    assert 1.68e10 < gh.token_flops(cfg, 0, False) < 1.70e10


def test_k6_bound_is_chip_smokes():
    """The frozen copy at Granite's shapes: 4 bytes a value of x, y, dt,
    la, Bm, Cm and the two states; operations at the split 3xTF32 rate."""
    t, by = k6_bound_ms(1, 4096, 128, 64, 128)
    assert by == "operations" and 0.117 < t < 0.119
    t, by = k6_bound_ms(4, 2048, 80, 64, 64)        # Zamba2's, 4 x 2,048
    assert by == "bytes" and abs(t - 0.106) < 0.001


def _rehearse(faults=()):
    """The reduced cell through the harness on the CPU: one period in two
    stages, bf16 as the cell runs, with ``faults`` planted in the program's
    stage functions only."""
    torch.set_num_threads(2)
    from repro_torch.serving import gtrac_serve
    bench = harness.benchmark()
    over = dict(num_layers=10, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, d_ff=32, vocab_size=512, num_experts=8,
                experts_per_token=2, shared_expert_ff=64, ssm_state=16,
                ssm_head_dim=16)
    run = harness.prepare(
        bench, CELL, 5, 0.4, False, "cpu", 0.0, overrides=over,
        config_patch={"deployment": dict(
            _cpu.DEPLOYMENT["deployment"], layers_per_stage=5)},
        mix_patch=_cpu.SHORT, clock=_cpu.step_clock())
    head, embed = gtrac_serve.logits_head, gtrac_serve.embed_tokens
    try:
        if "logits scaling dropped" in faults:
            gtrac_serve.logits_head = \
                lambda cfg, p, x: head(cfg, p, x) * cfg.logits_scaling
        if "embedding multiplier dropped" in faults:
            gtrac_serve.embed_tokens = lambda cfg, p, t: \
                embed(cfg, p, t) / cfg.embedding_multiplier
        harness.run_cell(run)
    finally:
        gtrac_serve.logits_head, gtrac_serve.embed_tokens = head, embed
    compared = harness.compare(run)
    return run, compared


def test_reduced_cell_through_the_harness_is_correct():
    run, compared = _rehearse()
    rec = run.record
    assert rec.tokens > 0 and rec.check["checked_tokens"] > 0
    assert harness.is_correct(compared) and not rec.errors, compared
    assert set(compared) == {"route_mismatch", "failed"} | set(run.limits)
    # the K3 shape records count each stage's attention layers
    assert [gh.attention_layers(run.cfg, s, s + 5) for s in (0, 5)] == [0, 1]


@pytest.mark.parametrize("fault", ["logits scaling dropped",
                                   "embedding multiplier dropped"])
def test_reduced_cell_with_a_planted_fault_is_not_correct(fault):
    run, compared = _rehearse((fault,))
    assert not harness.is_correct(compared), compared


#: the control's stack: two periods at width 128, the seeded projections at
#: 8 times the cell's, so that float8 rounding carried through 20 layers
#: reaches the logit error it reaches at the published widths over 40
CONTROL_SIZE = dict(num_layers=20, d_model=128, num_heads=4, num_kv_heads=2,
                    head_dim=32, d_ff=64, vocab_size=512, num_experts=8,
                    experts_per_token=2, shared_expert_ff=128, ssm_state=16,
                    ssm_head_dim=16, activation_dtype="float32",
                    param_dtype="float32", attn_impl="xla")
CONTROL_SCALE = 8.0


def test_float8_control_fails_the_committed_limits():
    """``--control 1`` at a test size, through the harness's own
    comparison under the cell's committed limits: on a perfect program's
    served tokens (the float32 reference's own greedy decode, one full
    forward a token) the comparison reads correct; with the float8 control
    in the program's place it reads not correct, by ``logit_err``."""
    import numpy as np
    torch.set_num_threads(2)
    cfg = harness.model_config(_config_file(), CONTROL_SIZE)
    assert cfg.layer_types.count("attention") == 2
    W = _weights(cfg, 1, CONTROL_SCALE)
    g = torch.Generator().manual_seed(0)
    prompt, served, streams = 32, 24, []
    for _ in range(4):
        seq = torch.randint(0, cfg.vocab_size, (prompt,), generator=g)
        for _ in range(served):
            nxt = gh.forward_logits(cfg, W, seq, [len(seq) - 1])
            seq = torch.cat([seq, nxt.argmax(-1)])
        s = harness.Stream(seq[:prompt].numpy().astype(np.int32), served,
                           output=seq[prompt:].tolist(), finished=True)
        s.logits = list(gh.served_logits(cfg, W, seq[:prompt], s.output,
                                         True))
        streams.append(s)
    run = harness.prepare(harness.benchmark(), CELL, 5, 1.0, False, "cpu",
                          0.0, mix_patch={"check_tokens": 4 * served})
    assert run.model.__file__ == gh.__file__
    run.cfg, run.params = cfg, W
    run.record.streams = streams
    run.record.check["per_step_capacity"] = True
    exact = harness.compare(run)
    assert harness.is_correct(exact), exact
    assert exact["logit_err"]["value"] < 1e-5
    control = harness.compare(run, control=True)
    assert run.record.check["control"] == "fp8"
    assert run.record.check["checked_tokens"] == 4 * served
    assert not harness.is_correct(control), control
    assert control["logit_err"]["value"] > control["logit_err"]["limit"]
    print(control)


# ---------------------------------------------------------------------------
# The readers of k6_roofline and ssm_share
# ---------------------------------------------------------------------------


class _Event:
    def __init__(self, cuda, name, start, dur, corr=0, link=0):
        from torch.autograd import DeviceType
        self._dt = DeviceType.CUDA if cuda else DeviceType.CPU
        self._name, self._s, self._d = name, start, dur
        self._c, self._l = corr, link

    def device_type(self):
        return self._dt

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def is_user_annotation(self):
        return False


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda self: events})()})()


def _run_with(summary, events, config, cfg):
    sl = {"prof": _Prof(events), "wall_s": 1.0, "shapes": summary["shapes"]}
    prof = type("SP", (), {"summary": summary, "slices": [sl]})()
    return type("R", (), {"summary": summary, "profiler": prof,
                          "config": config, "cfg": cfg, "model": gh})()


def test_ssm_share_counts_the_kernels_launched_in_model_ssm():
    events = [_Event(False, "model.ssm", 100, 100),
              _Event(False, "cudaLaunchKernel", 120, 5, corr=1),
              _Event(False, "cudaLaunchKernel", 250, 5, corr=2),
              _Event(True, "ssd_scan_kernel", 300, 30, link=1),
              _Event(True, "gemm", 400, 70, link=2)]
    cfg = harness.model_config(_config_file())
    summary = {"shapes": [], "by_kernel": {}, "device_s": 1e-7}
    run = _run_with(summary, events, _config_file(), cfg)
    got = harness.load_module("metrics", "ssm_share").read(run)
    assert got == pytest.approx(30.0)
    # no model.ssm span (a program without one): nothing
    run = _run_with(summary, events[1:], _config_file(), cfg)
    assert harness.load_module("metrics", "ssm_share").read(run) is None


def test_k6_roofline_reads_every_forwards_mamba_layers():
    cfg = harness.model_config(_config_file())
    reader = harness.load_module("metrics", "k6_roofline")
    shapes = [("k3", 1, 4096, 1), ("k3", 1, 2048, 1)]
    dev_s = 0.02
    summary = {"shapes": shapes, "device_s": 1.0,
               "by_kernel": {"ssd_scan_kernel<64, 128, 32>": dev_s * 0.9,
                             "ssd_prep_kernel<128>": dev_s * 0.1,
                             "gemm": 0.5}}
    run = _run_with(summary, [], _config_file(), cfg)
    want = 9 * (k6_bound_ms(1, 4096, 128, 64, 128)[0]
                + k6_bound_ms(1, 2048, 128, 64, 128)[0]) / 1e3 / dev_s
    assert reader.read(run) == pytest.approx(100 * want)
    # stages that do not hold whole periods: nothing
    uneven = dict(_config_file(), deployment={"layers_per_stage": 8})
    assert reader.read(_run_with(summary, [], uneven, cfg)) is None
    # a model module without Mamba2 layers: nothing
    run = _run_with(summary, [], _config_file(), cfg)
    run.model = harness.load_module("reference", "decoder")
    assert reader.read(run) is None

"""The readers of the program's own spans and counters
(``issue_us_per_layer``, ``idle_in_model``, ``readback_share``,
``recompute_factor``) and the reductions under them, on synthetic event
lists with hand-computed answers, and every reader's None cases."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness, spans

US = 1000      # ns


def _reader(name):
    return harness.load_module("metrics", name).read


class _Event:
    def __init__(self, start, end, name, device=DeviceType.CPU,
                 annotation=False):
        self._s, self._d, self._n = start, end - start, name
        self._dev, self._ann = device, annotation

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._ann

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def name(self):
        return self._n


def _kernel(s, e, name="gemm"):
    return _Event(s * US, e * US, name, DeviceType.CUDA)


def _run(events, wall_s=1e-3):
    """A traced run whose chosen slice holds ``events`` (times in us)."""
    shapes = []
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))
    return SimpleNamespace(
        summary={"shapes": shapes, "wall_s": wall_s},
        profiler=SimpleNamespace(slices=[
            {"prof": None, "wall_s": 9.0, "shapes": []},
            {"prof": prof, "wall_s": wall_s, "shapes": shapes}]))


def _span(s, e, name):
    return _Event(s * US, e * US, name, annotation=True)


# Kernels busy 0-100, 130-200, 200-210 (touching), 215-300, 400-500 us:
# gaps 100-130 (30), 210-215 (5, under GAP_MIN_S = 20 us), 300-400 (100).
KERNELS = [_kernel(0, 100), _kernel(130, 200), _kernel(200, 210),
           _kernel(215, 300), _kernel(400, 500),
           _Event(90 * US, 450 * US, "gpu_user_annotation", DeviceType.CUDA,
                  annotation=True)]
# host: a stage (0-320) with two layers, a read-back after it (320-390)
# inside a loop window (0-600); an aten op; a harness range
HOST = [_span(0, 600, "loop.window"), _span(0, 320, "model.stage"),
        _span(10, 120, "model.attn"), _span(120, 180, "model.ffn"),
        _span(125, 140, "moe.route"), _span(180, 250, "model.attn"),
        _span(250, 320, "model.ffn"), _span(320, 390, "loop.readback"),
        _span(390, 392, "loop.emit"),
        _Event(330 * US, 380 * US, "aten::_local_scalar_dense"),
        _Event(0, 600 * US, "portbench.route_window", annotation=True)]


def test_merge_and_gaps_by_hand():
    busy = spans.merge([(k.start_ns(), k.start_ns() + k.duration_ns())
                        for k in KERNELS[:5]])
    assert busy == [(0, 100 * US), (130 * US, 210 * US),
                    (215 * US, 300 * US), (400 * US, 500 * US)]
    assert spans.idle_gaps(busy) == [(100 * US, 130 * US),
                                     (300 * US, 400 * US)]


def test_idle_within_by_hand():
    gaps = [(100 * US, 130 * US), (300 * US, 400 * US)]
    sp = [(h.start_ns(), h.start_ns() + h.duration_ns(), h.name())
          for h in HOST]
    # gap 1's midpoint (115) lies in model.stage and model.attn; gap 2's
    # (350) in loop.readback only
    assert spans.idle_within(gaps, sp, ("model.", "moe.")) == \
        (30 * US, 130 * US)
    assert spans.idle_within(gaps, sp, ("loop.readback",)) == \
        (100 * US, 130 * US)
    assert spans.idle_within(gaps, sp, ("engine.",)) == (0, 130 * US)
    assert spans.idle_within([], sp, ("model.",)) == (0, 0)


def test_issue_per_layer_less_nested_readbacks():
    sp = [(0, 300, "model.decode"), (10, 100, "model.attn"),
          (100, 150, "model.ffn"), (150, 200, "model.attn"),
          (200, 260, "engine.readback"),      # nested: left out
          (300, 350, "engine.readback"),      # after the call
          (400, 500, "model.attn")]           # in no model call
    assert spans.issue_ns_per_layer(sp) == (300 - 60) / 2
    assert spans.readback_ns(sp) == 110
    assert spans.issue_ns_per_layer([(0, 10, "model.stage")]) is None


def test_readers_on_a_synthetic_slice():
    run = _run(KERNELS + HOST, wall_s=1e-3)
    assert _reader("issue_us_per_layer")(run) == pytest.approx(320 / 2)
    assert _reader("idle_in_model")(run) == pytest.approx(100 * 30 / 130)
    assert _reader("readback_share")(run) == pytest.approx(100 * 70e-6 /
                                                           1e-3)
    r = spans.slice_ranges(run)
    assert [n for _, _, n in r.spans] == [      # by start, then end
        "model.stage", "loop.window", "model.attn", "model.ffn",
        "moe.route", "model.attn", "model.ffn", "loop.readback",
        "loop.emit"]
    assert spans.slice_ranges(run) is r          # read once a run


@pytest.mark.parametrize("name", ["issue_us_per_layer", "idle_in_model",
                                  "readback_share"])
def test_span_readers_none_cases(name):
    read = _reader(name)
    # untraced: no summary
    assert read(SimpleNamespace(summary=None,
                                profiler=SimpleNamespace(slices=[]))) is None
    # a program without wall spans (only the harness's ranges and ops)
    assert read(_run(KERNELS + HOST[-2:])) is None
    # no layer, no gap, no wall time
    assert read(_run([_kernel(0, 100), _span(0, 50, "loop.emit")],
                     wall_s=0.0)) is None


def test_recompute_factor_reads_the_program_counters(monkeypatch):
    from repro_torch.serving import gtrac_serve
    read = _reader("recompute_factor")
    stats = gtrac_serve.StageStats(forwards=4, positions=420, fresh=116)
    monkeypatch.setattr(gtrac_serve, "last_stage_stats", lambda: stats)
    assert read(None) == pytest.approx(420 / 116)
    assert spans.stage_counters() == {"forwards": 4, "positions": 420,
                                      "fresh": 116}
    monkeypatch.setattr(gtrac_serve, "last_stage_stats",
                        gtrac_serve.StageStats)
    assert read(None) is None                    # no hop ran
    monkeypatch.setattr(gtrac_serve, "last_stage_stats", lambda: None)
    assert read(None) is None                    # no server made
    monkeypatch.delattr(gtrac_serve, "last_stage_stats")
    assert read(None) is None                    # a program without them


def test_by_name_counts_total_and_self_time():
    sp = [(h.start_ns(), h.start_ns() + h.duration_ns(), h.name())
          for h in HOST if h.name().startswith(spans.PROGRAM)]
    got = {k: [c, t / US, own / US] for k, (c, t, own) in
           spans.by_name(sp).items()}
    # loop.window 600 holds model.stage 320, loop.readback 70, loop.emit 2;
    # model.stage holds 2 attn + 2 ffn (320 - 10); the first ffn holds
    # moe.route 15
    assert got == {"loop.window": [1, 600, 600 - 320 - 70 - 2],
                   "model.stage": [1, 320, 10],
                   "model.attn": [2, 110 + 70, 180],
                   "model.ffn": [2, 60 + 70, 130 - 15],
                   "moe.route": [1, 15, 15],
                   "loop.readback": [1, 70, 70], "loop.emit": [1, 2, 2]}


def test_label_gaps_by_innermost_span():
    sp = [(h.start_ns(), h.start_ns() + h.duration_ns(), h.name())
          for h in HOST if h.name().startswith(spans.PROGRAM)]
    gaps = [(100 * US, 130 * US), (300 * US, 400 * US),
            (700 * US, 720 * US)]
    # midpoints 115 (model.attn, inside model.stage and loop.window), 350
    # (loop.readback), 710 (after the window)
    assert spans.label_gaps(gaps, sp) == {"model.attn": 30 * US,
                                          "loop.readback": 100 * US,
                                          spans.NO_SPAN: 20 * US}
    # a span that starts where the one before ends is not inside it
    assert spans.label_gaps([(14, 16)], [(0, 10, "a"), (10, 20, "b")]) == \
        {"b": 2}
    assert spans.label_gaps([], sp) == {}

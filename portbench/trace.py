"""The traced run's profile: ``torch.profiler`` (CPU and CUDA activity)
over two stated steady slices of the measured window, reduced after the
window has closed to what the per-layer metrics read.

Each slice lasts ``slice_s`` (``SLICE_S``, or a sixth of the window when
that is shorter) and opens and closes at a boundary of the entry
(a routing window, a prefill, a decode step) with the device
synchronised. Slice A opens a third of the way into the window, slice B
``slice_s`` before its length and runs to the close. A is stopped inside
the window: the profiler's stop takes seconds (``stop_in_window_s``, which
``mfu`` leaves out of the window's time); B only after the window's close
has been stamped; the events of both are read after the close. The
metrics read A, or B where A recorded no device time (``torch.profiler``
returns an empty profile about once in 40): one retry within the run.
Two empty slices fail the run.

The reduction reads the profiler's raw events (no per-event Python
objects are built) and keeps, per slice: its wall seconds; the device's
busy seconds (the union of the kernel and memory-copy intervals; the
harness's own annotations excluded); device time per kernel name; the
device time of the kernels launched inside each host operator of
``OPS`` (found by the launching operator's start time); and the idle gaps
longer than ``GAP_MIN_S``, labelled by the innermost host operator, else
the innermost harness span, running at their midpoint.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional

SLICE_S = 6.0
GAP_MIN_S = 20e-6
#: host operators whose kernels' device time the summary keeps
OPS = ("aten::_to_copy", "aten::bmm")


class SliceProfiler:
    """Opens and closes the slices at the boundaries the entry reports
    (``tick``), by the window's wall clock."""

    def __init__(self, window_s: float, enabled: bool):
        self.enabled = enabled
        self.slice_s = min(SLICE_S, window_s / 6.0)
        self.starts = (window_s / 3.0, window_s - self.slice_s)
        self._prof = None
        self._t0 = 0.0
        self._wall0 = 0.0
        self.slices: List[Dict] = []     # {"prof", "wall_s", "shapes"}
        self.shapes: List[tuple] = []
        self.summary: Optional[Dict] = None
        self.stop_s: List[float] = []
        self.stop_in_window_s = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def warm(self) -> None:
        """One short profile in set-up, so that the profiler's own
        start-up is not paid inside the window."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        x = torch.ones(8, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            (x + 1).sum().item()

    def tick(self, now: float) -> None:
        """Called at each boundary inside the window with the seconds
        since it opened."""
        if not self.enabled:
            return
        if self._prof is None:
            if len(self.slices) < 2 and now >= self.starts[len(self.slices)]:
                self._start(now)
        elif len(self.slices) == 0 and now - self._t0 >= self.slice_s:
            self._stop()
            self.stop_in_window_s += self.stop_s[-1]

    def close(self) -> None:
        """After the window's close: stop an open slice and reduce."""
        if not self.enabled:
            return
        if self._prof is not None:
            self._stop()
        for sl in self.slices:
            s = summarize(sl["prof"], sl["wall_s"])
            s["shapes"] = sl["shapes"]
            if s["device_s"] > 0:
                self.summary = s
                return
        raise RuntimeError("torch.profiler recorded no device time in "
                           f"{len(self.slices)} slice(s) of the window")

    def _start(self, now: float) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.shapes = []
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = now
        self._wall0 = time.perf_counter()

    def _stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._wall0
        prof, self._prof = self._prof, None
        t = time.perf_counter()
        prof.stop()
        self.stop_s.append(time.perf_counter() - t)
        self.slices.append({"prof": prof, "wall_s": wall,
                            "shapes": self.shapes})


def summarize(prof, wall_s: float) -> Dict:
    """Reduce one profile to the slice's sums (see the module's doc)."""
    from torch.autograd import DeviceType
    kernels = []                 # (start_ns, end_ns, name, launching op)
    host = []                    # (start_ns, end_ns, name)
    op_start: Dict[int, int] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            s = e.start_ns()
            kernels.append((s, s + e.duration_ns(), e.name(),
                            e.linked_correlation_id()))
        else:
            s = e.start_ns()
            host.append((s, s + e.duration_ns(), e.name()))
            op_start[e.correlation_id()] = s
    within = {name: sorted((a, b) for a, b, n in host if n == name)
              for name in OPS}
    kernels.sort()
    by_kernel: Dict[str, float] = defaultdict(float)
    by_op: Dict[str, float] = defaultdict(float)
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    for s, e, name, link in kernels:
        d = (e - s) / 1e9
        by_kernel[name] += d
        t = op_start.get(link)
        if t is not None:
            for op, spans in within.items():
                i = bisect.bisect_right(spans, (t, float("inf"))) - 1
                if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                    by_op[op] += d
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            if (s - cur_e) / 1e9 >= GAP_MIN_S:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    spans = sorted(h for h in host if h[2].startswith("portbench."))
    ops = sorted(h for h in host if not h[2].startswith("portbench."))
    labelled: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        t = (a + b) / 2
        name = _innermost(ops, t, 256) or _innermost(spans, t, len(spans))
        labelled[name or "(outside the harness's spans)"] += (b - a) / 1e9
    return {"wall_s": wall_s, "busy_s": busy / 1e9,
            "device_s": sum(by_kernel.values()),
            "by_kernel": dict(by_kernel), "by_op": dict(by_op),
            "idle_by_host": dict(labelled)}


def _innermost(events, t: float, scan: int) -> Optional[str]:
    """The shortest of the (start, end, name) ``events`` (sorted by start)
    that contains ``t``, looking back ``scan`` events; None if none."""
    i = bisect.bisect_right(events, (t, float("inf"), ""))
    best, best_len = None, float("inf")
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        s, e, name = events[j]
        if e >= t and (e - s) < best_len:
            best, best_len = name, e - s
    return best

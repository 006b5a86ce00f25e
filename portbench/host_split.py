"""Where the host's time goes in one traced run of a cell, by the
program's own wall spans.

    python3 portbench/host_split.py <out.json> --workload <cell> \
        --seed <n> --seconds <s>

from the root of a checkout, on the card. It runs the cell as
``run.py ... --trace 1`` does (the result line is the last line of
standard output, as there) and writes to ``out.json``, for the traced
slice the metrics read: each program span's count, total and self
seconds (self: less the program's spans directly inside it); the
device's idle gaps by the innermost program span at their midpoint; and
the host's time in the CUDA runtime's kernel launches, all of it and the
part inside the model calls, where a full launch queue blocks the host.
Nothing is written for a program that opens no wall spans.
"""
from __future__ import annotations

import bisect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as bench_run  # noqa: E402

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def split(run):
    """The traced slice's host split (see the module's doc); None where
    the program opened no wall span."""
    from portbench import spans
    r = spans.slice_ranges(run)
    if r is None or not r.spans:
        return None
    calls = spans.merge([(s, e) for s, e, n in r.spans
                         if n in spans.MODEL_CALLS])
    starts = [s for s, _ in calls]
    launch = in_model = 0
    for e in spans.chosen_slice(run)["prof"].profiler.kineto_results.events():
        if e.name().startswith(LAUNCHES):
            s, d = e.start_ns(), e.duration_ns()
            launch += d
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s + d <= calls[i][1]:
                in_model += d
    gaps = spans.idle_gaps(r.busy)
    return {"cell": run.cell["name"], "seed": run.seed,
            "slice_wall_s": r.wall_s,
            "busy_s": sum(e - s for s, e in r.busy) / 1e9,
            "idle_gap_s": sum(b - a for a, b in gaps) / 1e9,
            "idle_by_span_s": {k: v / 1e9 for k, v in sorted(
                spans.label_gaps(gaps, r.spans).items(),
                key=lambda kv: -kv[1])},
            "spans_s": {k: [c, t / 1e9, own / 1e9] for k, (c, t, own) in
                        sorted(spans.by_name(r.spans).items())},
            "launch_s": launch / 1e9, "launch_in_model_s": in_model / 1e9}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_path, rest = Path(argv[0]), list(argv[1:])
    bench_run._environment()
    from portbench import harness
    found = {}
    read0 = harness.read_metrics

    def read_metrics(run, specs):
        if run.trace and "split" not in found:
            found["split"] = split(run)
        return read0(run, specs)

    harness.read_metrics = read_metrics
    code = bench_run.main(rest + ["--trace", "1"])
    if found.get("split") is not None:
        out_path.write_text(json.dumps(found["split"], indent=1))
    return code


if __name__ == "__main__":
    sys.exit(main())

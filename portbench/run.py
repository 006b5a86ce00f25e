"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is a ``workloads`` entry of
``BENCHMARK.json``; everything else is found by name under ``portbench/``
(see ``harness.py``). With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
profiled slice of the window. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``compared``,
each number compared with its limit); the last lines of standard error
repeat the numbers compared.

It needs as many CUDA devices as the cell asks for, and exits with 2 and
prints no result otherwise. It exits with 3 and prints no result when a
module of JAX or of the JAX package ``repro`` is loaded once the window
has closed. Build and kernel caches live at fixed paths inside the
checkout (``build/``). ``--control 1`` puts the lower-precision control
(the reference in float8) in the program's place in the comparison, on
the same served tokens, so that it reports ``correct`` false; the
benchmark's own runs leave it off.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no JAX pulled in by a
    library of the program."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from portbench import harness
    bench = harness.benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    import torch
    import repro_torch  # noqa: F401  (the program; counted as import)
    t_import = time.perf_counter()
    chips = int(cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.ones(1, device=device).sum().item()
    run = harness.prepare(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), device, T_START)
    run.record.setup_split.update(
        import_s=t_import - T_START,
        cuda_init_s=time.perf_counter() - t_import)
    result = harness.run_cell(run)
    rec = run.record
    specs = harness.metric_names(bench, args.workload, bool(args.trace))
    metrics = harness.read_metrics(run, specs)
    untraced_layers = None
    if not args.trace:
        # the per-layer metrics that need no trace, as the timed path reads
        # them: the traced run's profiler slows the window they come from
        untraced_layers = {k: v["value"] for k, v in harness.read_metrics(
            run, [m for m in harness.metric_names(bench, args.workload, True)
                  if m["source"] != "device_trace"]).items()}
    failed = harness.failed_streams(run)
    # the program's state is gone (the entry dropped it); the reference
    # runs after the peak was read
    torch.cuda.empty_cache()
    t = time.perf_counter()
    compared = harness.compare(run, control=bool(args.control))
    check_s = time.perf_counter() - t
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print("portbench: modules of JAX or the JAX package are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for err in rec.errors:
        print(err, file=sys.stderr)
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": chips,
                   "memory_peak_bytes": result["memory_peak_bytes"]}
    out = harness.result_line(run, metrics, compared, failed, device_info,
                              check_s, untraced_layers)
    print(json.dumps(out))
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

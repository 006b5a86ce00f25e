"""One run of one cell: the parts every entry shares.

``run_cell`` loads the cell's files by name (``BENCHMARK.json``'s
workload, then ``configs/<config>.json``, the model module
``reference/<model>.py`` the configuration file names, ``traffic/
<traffic>.json``, ``limits/<workload>.json`` and the entry ``entries/
<entry>.py`` the traffic file names), makes the weights from the seed in
the model module's layout, lets the entry set up, warm up and serve the
measured window, reads the peak memory, frees the program's state, runs
the comparison that decides ``correct`` against the model module's
reference, and reads the metrics the cell reports through
``metrics/<metric>.py``. The model module is all the harness knows of an
architecture: its layout, reference, operation count and attention
layers (``reference/decoder.py`` documents the interface).

The window is wall time: it opens when set-up ends and closes at the
first boundary the entry reports (a routing window, a decode step, a
batch) at or after ``seconds``; ``Window.boundary`` raises
``WindowClosed`` there, which ends the program's serving loop from
outside. Everything emitted before that boundary is in the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench import traffic as traffic_mod
from portbench import weights
from portbench.trace import SliceProfiler
from portbench.yardstick import percentiles

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class WindowClosed(Exception):
    """Raised at the first boundary at or after the window's length."""


class Window:
    """The measured window's wall clock and its boundaries. ``clock`` is
    ``time.perf_counter`` in every run; the CPU tests pass a clock that
    advances a fixed step a reading, so that their windows hold the same
    work however loaded the machine is."""

    def __init__(self, seconds: float, profiler: SliceProfiler,
                 clock: Callable[[], float] = time.perf_counter):
        self.seconds = float(seconds)
        self.profiler = profiler
        self.clock = clock
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None

    def open(self) -> None:
        self.t_open = self.clock()

    def now(self) -> float:
        return self.clock() - self.t_open

    def close_now(self) -> None:
        self.t_close = self.clock()

    @property
    def length(self) -> float:
        return self.t_close - self.t_open

    def boundary(self) -> None:
        now = self.now()
        if now >= self.seconds:
            self.close_now()
            raise WindowClosed
        self.profiler.tick(now)


@dataclass
class Stream:
    """One request as the window saw it."""
    prompt: np.ndarray
    max_new_tokens: int
    output: List[int] = field(default_factory=list)
    emit_s: List[float] = field(default_factory=list)
    finished: bool = False
    # the simulation failed it (peers, infeasible routes): not the program
    sim_failed: bool = False
    # prompt tokens processed in the window (chunks), and whether the
    # prompt's last position (the first token's logits) was reached
    prefill_tokens: int = 0
    warm_hits: int = 0
    cold_steps: int = 0
    # the program's logits each served token was taken from, where the
    # entry can reach them (the routed entry: the last stage's output)
    logits: List = field(default_factory=list)


@dataclass
class Record:
    """What the entry hands back from the window."""
    streams: List[Stream] = field(default_factory=list)
    attempted: int = 0
    errors: List[str] = field(default_factory=list)
    # counters and spans of the harness around the program's calls
    forwards: int = 0
    route_calls: int = 0
    route_s: float = 0.0
    # streams admitted and not finished, at each routing window
    in_flight: List[int] = field(default_factory=list)
    decode_steps: List[float] = field(default_factory=list)
    decode_flops: float = 0.0
    flops: float = 0.0
    # entry-specific material for the comparison (plans, capacities)
    check: Dict = field(default_factory=dict)
    setup_split: Dict[str, float] = field(default_factory=dict)

    @property
    def tokens(self) -> int:
        return sum(len(s.output) for s in self.streams)


@dataclass
class Run:
    """Everything an entry and a metric reader see of one run."""
    cell: Dict
    config: Dict
    mix: Dict
    limits: Dict
    cfg: object                  # the port's ModelConfig as run
    model: object                # reference/<model>.py of the config
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    window: Window
    profiler: SliceProfiler
    params: Dict = None
    record: Record = field(default_factory=Record)
    setup_s: float = 0.0
    # test hooks: faults planted under the timed path
    faults: tuple = ()

    @property
    def summary(self) -> Optional[Dict]:
        return self.profiler.summary


def load_json(path: Path) -> Dict:
    if not path.exists():
        raise FileNotFoundError(f"missing {path}")
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def model_config(config: Dict, overrides: Optional[Dict] = None):
    """The port's ModelConfig named by the configuration file, with the
    file's ``port_overrides`` (and a test's ``overrides``) applied."""
    from repro_torch.configs import get_config
    cfg = get_config(config["port_config"])
    kw = dict(config.get("port_overrides", {}))
    if overrides:
        cfg = cfg.reduced(**{**kw, **overrides})
        return cfg
    return dataclasses.replace(cfg, **kw)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_module(config: Dict, path: Path):
    """The model module ``reference/<model>.py`` that the configuration
    file at ``path`` names under ``"model"``."""
    if "model" not in config:
        raise ValueError(f"{path} names no model module: it needs "
                         "\"model\": \"<module>\", a file of "
                         "portbench/reference/")
    return load_module("reference", config["model"])


def prepare(bench: Dict, workload: str, seed: int, seconds: float,
            trace: bool, device, t_start: float,
            overrides: Optional[Dict] = None, faults: tuple = (),
            config_patch: Optional[Dict] = None,
            mix_patch: Optional[Dict] = None,
            clock: Callable[[], float] = time.perf_counter) -> Run:
    """The run's context. ``overrides`` (a reduced ModelConfig's fields),
    ``config_patch`` and ``mix_patch`` (keys replaced in the files),
    ``faults`` and ``clock`` serve the CPU tests only."""
    cell = find_cell(bench, workload)
    path = HERE / "configs" / f"{cell['config']}.json"
    config = load_json(path)
    config.update(config_patch or {})
    model = model_module(config, path)
    mix = traffic_mod.load(cell["traffic"])
    mix.update(mix_patch or {})
    limits = load_json(HERE / "limits" / f"{workload}.json")
    cfg = model_config(config, overrides)
    prof = SliceProfiler(seconds, enabled=trace)
    return Run(cell=cell, config=config, mix=mix, limits=limits, cfg=cfg,
               model=model, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=device, t_start=t_start,
               window=Window(seconds, prof, clock), profiler=prof,
               faults=faults)


def run_cell(run: Run) -> Dict:
    """Set up, warm up and serve the window; returns the result fields
    the run reports before the comparison (``memory_peak_bytes``)."""
    import torch
    if run.trace and torch.device(run.device).type != "cuda":
        raise RuntimeError("the traced run reads device metrics and needs "
                           "the card")
    entry = load_module("entries", run.mix["entry"])
    t = time.perf_counter()
    run.params = weights.make_params(run.cfg, run.seed, run.device,
                                     run.model.layout)
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    run.record.setup_split["weights_s"] = time.perf_counter() - t
    entry.serve(run)
    run.profiler.close()
    mem = 0
    if torch.device(run.device).type == "cuda":
        mem = int(torch.cuda.max_memory_allocated())
    return {"memory_peak_bytes": mem}


# ---------------------------------------------------------------------------
# The comparison that decides ``correct``
# ---------------------------------------------------------------------------


def sample_streams(streams: List[Stream], seed: int,
                   target_tokens: int) -> List[Stream]:
    """The streams the reference checks: drawn from the seed among those
    the window finished, the one with the most served tokens first, until
    ``target_tokens`` served tokens are in; where the finished ones fall
    short, the unfinished ones with the most served tokens follow."""
    done = [s for s in streams if s.finished and s.output]
    rest = sorted((s for s in streams if not s.finished and s.output),
                  key=lambda s: -len(s.output))
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    out: List[Stream] = []
    if done:
        first = max(range(len(done)), key=lambda i: len(done[i].output))
        order = [first] + [i for i in rng.permutation(len(done))
                           if i != first]
        pool = [done[i] for i in order] + rest
    else:
        pool = rest
    n = 0
    for s in pool:
        if n >= target_tokens:
            break
        out.append(s)
        n += len(s.output)
    return out


def readings(model, cfg, W, streams: List[Stream], per_step_capacity: bool,
             device, quant: Optional[str] = None) -> Dict[str, List[float]]:
    """Readings for every served token of ``streams``, each in units of
    the standard deviation of the reference's logits at its position
    (``model.served_logits``, the model module's reference).
    Without ``quant`` they read the program: its served tokens and, where
    the entry captured them, its logits. With ``quant`` the reference in
    that precision takes the program's place on the same prompts and
    served tokens: its logits, and at each position the token it puts
    first.

    * ``logit_gap``: how far the reference's logit of the token taken
      lies below the reference's best;
    * ``logit_err``: the largest difference over the vocabulary between
      the logits read and the reference's;
    * ``greedy_excess``: the gap less twice the error. A token taken
      greedily from logits within e of the reference's lies at most 2e
      below the reference's best, so this is never above 0 unless a token
      taken is not the one its logits give; computed in float64 from the
      float32 logits, where the bound holds exactly.
    """
    import torch
    out: Dict[str, List[float]] = {"logit_gap": [], "logit_err": [],
                                   "greedy_excess": []}
    for s in streams:
        prompt = torch.as_tensor(s.prompt.astype(np.int64), device=device)
        ref = model.served_logits(cfg, W, prompt, s.output,
                                  per_step_capacity).double()
        sd = ref.std(-1)
        if quant is None:
            chosen = torch.as_tensor(s.output, device=device)
            whole = len(s.logits) == len(s.output) and \
                all(x is not None for x in s.logits)
            other = (torch.cat([x.reshape(1, -1).float() for x in s.logits])
                     if whole else None)
        else:
            other = model.served_logits(cfg, W, prompt, s.output,
                                        per_step_capacity, quant=quant)
            chosen = other.argmax(-1)
        gap = ref.max(-1).values - \
            ref.gather(1, chosen[:, None].to(torch.int64))[:, 0]
        out["logit_gap"] += (gap / sd).tolist()
        if other is not None:
            err = (other.double() - ref).abs().amax(-1)
            out["logit_err"] += (err / sd).tolist()
            out["greedy_excess"] += ((gap - 2 * err) / sd).tolist()
        del ref, other
    return out


def compare(run: Run, control: bool = False) -> Dict:
    """The numbers compared, each with its limit: the plans against the
    plain K-best reference (routed cells), the served tokens' readings
    that the cell's limits file lists (``logit_gap``, ``logit_err``,
    ``greedy_excess``), and the streams the program failed. With
    ``control`` the float8 control takes the program's place in the
    readings (the reference with every matmul operand rounded to e4m3,
    on the same served tokens), so that a sound control run comes out not
    correct. Every reading, compared or not, is kept in
    ``record.check["readings"]``."""
    import torch
    rec = run.record
    out: Dict[str, Dict] = {}
    if "plans" in rec.check:
        from portbench.reference import kbest
        bad = 0
        g = rec.check["gtrac"]
        for table, rows in rec.check["plans"]:
            for tau, chains, costs in rows:
                bad += kbest.plan_mismatch(
                    table, run.cfg.num_layers, tau, g["timeout_ms"],
                    g["k_best"], chains, costs)
        out["route_mismatch"] = {"value": bad, "limit": 0}
    if torch.device(run.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sample = sample_streams(rec.streams, run.seed,
                            int(run.mix["check_tokens"]))
    per_step = bool(rec.check.get("per_step_capacity", False))
    got = readings(run.model, run.cfg, run.params, sample, per_step,
                   run.device, quant="fp8" if control else None)
    rec.check["checked_tokens"] = len(got["logit_gap"])
    if control:
        rec.check["control"] = "fp8"
    widest = {k: (max(v) if v else math.inf) for k, v in got.items()}
    rec.check["readings"] = {k: v for k, v in widest.items() if got[k]}
    for name, lim in run.limits.items():
        out[name] = {"value": widest[name], "limit": lim["limit"]}
    out["failed"] = {"value": failed_streams(run), "limit": 0}
    return out


def failed_streams(run: Run) -> int:
    """Streams the program failed: a token out of the vocabulary, or a
    finished stream short of its tokens that the simulation did not
    fail; plus every unfinished stream when the program raised."""
    V = run.cfg.vocab_size
    bad = 0
    for s in run.record.streams:
        if any(not 0 <= t < V for t in s.output):
            bad += 1
        elif s.finished and not s.sim_failed and \
                len(s.output) < s.max_new_tokens:
            bad += 1
    if run.record.errors:
        bad += sum(1 for s in run.record.streams if not s.finished)
    return bad


def is_correct(compared: Dict) -> bool:
    """Every number within its limit."""
    return all(c["value"] <= c["limit"] for c in compared.values())


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def metric_names(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's metrics: its end-to-end ones untraced, its per-layer
    ones traced (each listed for the cell, or for every cell when a
    metric lists none)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def read_metrics(run: Run, specs: List[Dict]) -> Dict[str, Dict]:
    out = {}
    for m in specs:
        value = load_module("metrics", m["name"]).read(run)
        if value is None:
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(summary: Optional[Dict]) -> Optional[Dict]:
    """The traced slice's top device operations and idle time by what the
    host was doing, at most 10 each, in seconds."""
    if not summary:
        return None
    top = sorted(summary["by_kernel"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(summary["idle_by_host"].items(),
                  key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v] for k, v in top],
            "idle_gaps": [[k[:160], v] for k, v in idle]}


def result_line(run: Run, metrics: Dict, compared: Dict, failed: int,
                device: Dict, check_s: float,
                untraced_layers: Optional[Dict] = None) -> Dict:
    """The result's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (with the traced slice's ``busy_s`` and
    ``window_s``), ``breakdown`` when traced, this run's own figures
    (``run``; in an untraced run also ``untraced_layers``, the per-layer
    metrics that need no trace, read from this run's counters), and last
    ``compared``."""
    rec = run.record
    out = {"correct": is_correct(compared) and not rec.errors
           and failed == 0,
           "attempted": int(rec.attempted), "failed": int(failed),
           "metrics": metrics, "device": dict(device)}
    if run.trace:
        s = run.summary
        out["device"]["busy_s"] = s["busy_s"]
        out["device"]["window_s"] = s["wall_s"]
        out["breakdown"] = breakdown(s)
    gaps = stream_gaps_ms(rec.streams)
    out["run"] = {"window_s": run.window.length, "tokens": rec.tokens,
                  "tokens_by_quarter": tokens_by_quarter(
                      rec.streams, run.window.length),
                  "itl_ms_p50": percentiles(gaps, (50,))[0],
                  "gaps": len(gaps),
                  "streams": len(rec.streams),
                  "in_flight_mean": (sum(rec.in_flight) / len(rec.in_flight)
                                     if rec.in_flight else None),
                  "check_s": check_s,
                  "control": rec.check.get("control"),
                  "checked_tokens": rec.check.get("checked_tokens", 0),
                  "readings": rec.check.get("readings", {}),
                  "setup_split_s": rec.setup_split,
                  "profiler_stop_s": run.profiler.stop_s,
                  "stop_in_window_s": run.profiler.stop_in_window_s}
    if untraced_layers is not None:
        out["run"]["untraced_layers"] = untraced_layers
    out["compared"] = compared
    return out


def tokens_by_quarter(streams: List[Stream], length: float) -> List[int]:
    """Tokens emitted in each quarter of the window: whether a run's rate
    holds through its window or drifts within it."""
    out = [0, 0, 0, 0]
    for s in streams:
        for t in s.emit_s:
            out[min(3, max(0, int(4 * t / length)))] += 1
    return out


def stream_gaps_ms(streams: List[Stream]) -> List[float]:
    out: List[float] = []
    for s in streams:
        e = s.emit_s
        out += [(b - a) * 1e3 for a, b in zip(e, e[1:])]
    return out


def span(run: Run, name: str):
    """A profiler range named ``name`` around a call into the program, in
    the traced run only: the idle gaps' labels read it."""
    if run.trace:
        import torch
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` (the JAX package), compared whole."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m for m in modules if m.split(".", 1)[0] in bad})

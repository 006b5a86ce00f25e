"""Multi-pod dry-run: run every (arch × shape × mesh) cell on ``meta``.

Port of ``repro.launch.dryrun``. For each cell this builds the production
mesh ((16,16) single-pod or (2,16,16) multi-pod) as the ranks of a process
group that exchanges nothing (the ``fake`` backend: 256 or 512 ranks in
one process, as the reference's placeholder CPU devices), constructs the
step (train step / prefill / serve step) with its inputs on the ``meta``
device (no allocation), places them as DTensors by
``distributed/sharding.py`` and runs the step once as rank 0, under the
activation policy and counting modes. Success proves the distribution
config is coherent: DTensor has a sharding rule for every op of the step.
What it counts feeds the roofline (``launch/roofline.py``):

* ``memory``: ``argument_size_in_bytes`` is the local shard bytes of the
  inputs (params, optimizer state, batch, cache); ``output_size_in_bytes``
  those of the outputs; ``temp_size_in_bytes`` the peak of the bytes
  live in storages made during the step; ``total_per_device`` the sum of
  argument and temp bytes.
* ``cost``: ``flops`` by ``torch.utils.flop_counter``'s formulas over
  the local (per-rank) aten ops, decomposed as ``FlopCounterMode`` does;
  ``bytes accessed`` the input plus output bytes of every local aten op
  that is not a view.
* ``collectives``: wire bytes by kind from the functional collectives
  DTensor issues (``torch.ops._c10d_functional.*``), each op's result
  bytes times the reference's ring factor. On a CPU mesh DTensor runs an
  all-to-all as an all-gather and a slice, so such a step records
  all-gathers where a CUDA mesh would record all-to-alls.

Where the port differs from the reference:

* Eager counting sees every layer. The reference compiles a scanned
  program for memory and an unrolled one (affine extrapolation in depth
  above 32 layers) for costs; the port runs the full-depth step once and
  records ``accounting: eager_full_depth``.
* ``FlopCounterMode`` counts only matmul-class operations (mm, bmm,
  addmm, convolutions, SDPA); XLA's cost analysis also counts elementwise
  work, so the port's FLOPs are lower for the same step.
* The cache's ``index`` is a host int in the port (the last slot of the
  cache) where the reference traces a 0-d array; no shape depends on it.

A cell that DTensor cannot run is recorded ``fail`` with its error, as the
reference records a cell that does not compile.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl

``--all`` runs as many cells at once as the host has cores, each in a
process of its own.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict

import torch

from repro_torch.configs import (ALL_ARCHS, ASSIGNED_ARCHS, SHAPES,
                                 get_config, get_shape, shape_applicable)
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.trainer import optimizer as opt
from repro_torch.trainer.train_loop import make_train_step


def opt_state_pspecs(params):
    """The optimizer state's specs: the moments as the parameters'
    training layout, the step count replicated."""
    return {"mu": sh.param_pspecs(params), "nu": sh.param_pspecs(params),
            "step": sh.P()}


def build_lowerable(arch: str, shape: ShapeConfig, mesh,
                    overrides: Dict[str, Any] = None,
                    serving_layout: bool = False):
    """Returns (fn, args): the step and its DTensor inputs on ``meta``.

    ``fn(*args)`` runs the train step (``make_train_step``), ``prefill``
    or ``decode_step`` through ``sharding.policy_call``: under
    ``activation_policy(mesh)``, every input a DTensor. ``scan_layers``
    is accepted among the overrides and changes nothing (the eager step is
    unrolled either way).
    """
    kw = dict(overrides or {})
    microbatches = int(kw.pop("__microbatches__", 1))
    cfg = dataclasses.replace(get_config(arch), **kw)
    model = build_model(cfg)
    params = model.init(None, "meta")
    p_spec = sh.param_pspecs(params, serving=serving_layout)

    def run(step):
        return lambda *args: sh.policy_call(mesh, step, *args)

    if shape.kind == "train":
        tcfg = TrainConfig(microbatches=microbatches)
        step = make_train_step(model, tcfg,
                               unroll_accum=not cfg.scan_layers)
        batch = model.input_specs(shape)
        args = (sh.distribute(mesh, params, p_spec),
                sh.distribute(mesh, opt.init(params),
                              opt_state_pspecs(params)),
                sh.distribute(mesh, batch, sh.batch_pspecs(mesh, batch)))
        return run(step), args

    if shape.kind == "prefill":
        inputs = model.input_specs(shape)

        def prefill_fn(params, inputs):
            return model.prefill(params, **inputs)

        args = (sh.distribute(mesh, params, p_spec),
                sh.distribute(mesh, inputs, sh.batch_pspecs(mesh, inputs)))
        return run(prefill_fn), args

    # decode / serve_step
    token, cache = model.input_specs(shape)
    cache["index"] = shape.seq_len - 1

    def serve_step(params, token, cache):
        return model.decode_step(params, token, cache)

    args = (sh.distribute(mesh, params, p_spec),
            sh.distribute(mesh, token,
                    sh.batch_pspecs(mesh, {"token": token})["token"]),
            sh.distribute(mesh, cache, sh.cache_pspecs(mesh, cfg, cache)))
    return run(serve_step), args


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(tree))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _counter():
    """A dispatch mode over the local (per-rank) ops of a step: FLOPs by
    ``FlopCounterMode``'s formulas and decomposition rule, bytes
    accessed, functional collectives, and the peak of live bytes."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    aten = torch.ops.aten
    meta_ops = {aten.is_contiguous.default,
                aten.is_contiguous.memory_format,
                aten.is_strides_like_format.default,
                aten.is_non_overlapping_and_dense.default,
                aten.size.default, aten.sym_size.default,
                aten.stride.default, aten.sym_stride.default,
                aten.storage_offset.default,
                aten.sym_storage_offset.default, aten.numel.default,
                aten.sym_numel.default, aten.dim.default,
                torch.ops.prim.layout.default}

    class Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.collectives = []          # (kind, result bytes)
            self.live = 0
            self.peak = 0
            self._refs = {}

        def _track(self, out):
            for t in _tensors(out):
                st = t.untyped_storage()
                key = id(st)
                if key in self._refs:
                    continue
                n = st.nbytes()

                def gone(_r, key=key, n=n):
                    self._refs.pop(key, None)
                    self.live -= n
                self._refs[key] = weakref.ref(st, gone)
                self.live += n
                self.peak = max(self.peak, self.live)

        def mark(self, tree):
            """Storages of ``tree`` (the arguments) are not temps."""
            for t in _tensors(tree):
                st = _local(t).untyped_storage()
                self._refs.setdefault(id(st), weakref.ref(st))

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in meta_ops:
                return NotImplemented
            if any(t is DTensor for t in types):
                return NotImplemented      # DTensor: see its local ops
            if any(t is not torch.Tensor for t in types):
                # DTensor's sharding propagation on fake tensors
                return func(*args, **kwargs)
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            packet = func._overloadpacket
            if func.namespace == "_c10d_functional":
                out = func(*args, **kwargs)
                kind = _COLLECTIVE_KINDS.get(packet.__name__)
                if kind is not None:
                    self.collectives.append(
                        (kind, sum(_nbytes(t) for t in _tensors(out))))
                self._track(out)
                return out
            if packet not in flop_registry and \
                    func is not torch.ops.prim.device.default:
                with self:
                    r = func.decompose(*args, **kwargs)
                    if r is not NotImplemented:
                        return r
            out = func(*args, **kwargs)
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if not func.is_view:
                self.bytes += sum(_nbytes(t) for t in _tensors(args)) + \
                    sum(_nbytes(t) for t in _tensors(kwargs)) + \
                    sum(_nbytes(t) for t in _tensors(out))
            self._track(out)
            return out

    return Mode()


def count_step(fn, args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the counting mode: the record's
    ``memory``, ``cost`` and the collective records."""
    mode = _counter()
    mode.mark(args)
    with mode:
        out = fn(*args)
    return {"memory": {"argument_size_in_bytes": local_bytes(args),
                       "output_size_in_bytes": local_bytes(out),
                       "temp_size_in_bytes": int(mode.peak),
                       "generated_code_size_in_bytes": 0},
            "cost": {"flops": float(mode.flops),
                     "bytes accessed": float(mode.bytes)},
            "collective_ops": list(mode.collectives)}


@contextlib.contextmanager
def greedy_redistribution():
    """DTensor plans a redistribution greedily, one mesh dimension at a
    time, whenever the placements are in default order; a strided or
    out-of-order shard (what a reshape of a dimension sharded over
    ("pod", "data") leaves) switches it to a shortest-path search over
    every placement state, run for each candidate strategy of an op. On
    the (2, 16, 16) mesh that search takes minutes per op (cell B: 485 s
    at full depth, 4.9 s greedy at one layer). Inside this context the
    greedy plan is tried first and the search runs only where greedy
    cannot plan; the cached plans are dropped on exit. A greedy plan that
    moves a strided shard straight to another shard (which the greedy
    planner writes but cannot run) is replaced by gathering whole and
    cutting. Without the internals this relies on (another torch
    version), plans are left alone."""
    try:
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor import _redistribute as R
        from torch.distributed.tensor._dtensor_spec import DTensorSpec
        orig = R._gen_transform_infos_non_cached
        planner = R.get_redistribute_planner
        cached = R._gen_transform_infos
    except (ImportError, AttributeError):
        yield
        return

    def strided_to_shard(info):
        a, b = (type(p).__name__ for p in info.src_dst_placements)
        return "Shard" in a and "Shard" in b and "Strided" in a + b

    def greedy_first(src, dst, use_graph_based_transform=None):
        try:
            greedy = planner(src.device_mesh, src.tensor_meta) \
                .generate_greedy_transform_infos
            infos = greedy(src, dst)
            # the greedy planner moves a strided shard to another shard in
            # one step, which it cannot run: gather whole, then cut
            if any(strided_to_shard(i) for i in infos):
                whole = DTensorSpec(src.mesh, (Replicate(),) * src.mesh.ndim,
                                    tensor_meta=src.tensor_meta)
                infos = greedy(src, whole) + greedy(whole, dst)
            return infos
        except Exception:
            return orig(src, dst, use_graph_based_transform)

    R._gen_transform_infos_non_cached = greedy_first
    cached.cache_clear()
    try:
        yield
    finally:
        R._gen_transform_infos_non_cached = orig
        cached.cache_clear()


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A default process group of ``world_size`` ranks, this process rank
    0, that exchanges nothing (the ``fake`` backend); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run needs its own process group; "
                           "destroy the current one first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_for(mesh_name: str, mesh_shape=None):
    """(world size, mesh factory): the production mesh for ``single`` /
    ``multi``, else a ``(shape, axes)`` test mesh."""
    if mesh_shape is None:
        multi = mesh_name == "multi"
        n = 512 if multi else 256
        return n, lambda: make_production_mesh(multi_pod=multi,
                                               device_type="cpu")
    shape, axes = mesh_shape
    n = 1
    for s in shape:
        n *= s

    def build():
        from repro_torch.launch.mesh import make_test_mesh
        return make_test_mesh(shape, axes, device_type="cpu")
    return n, build


def run_cell(arch: str, shape_name, mesh_name: str,
             verbose: bool = True, cost_pass: bool = None,
             overrides: Dict[str, Any] = None, serving_layout: bool = False,
             tag: str = "", mesh_shape=None) -> Dict[str, Any]:
    """One cell. ``shape_name`` names a shape of the grid (or is a
    ``ShapeConfig``); ``mesh_name`` is ``single`` or ``multi``, or any
    name with ``mesh_shape=(shape, axes)`` for a smaller mesh."""
    shape = shape_name if isinstance(shape_name, ShapeConfig) else \
        get_shape(shape_name)
    n_dev, build_mesh = _mesh_for(mesh_name, mesh_shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape.name,
                           "mesh": mesh_name, "num_devices": n_dev}
    if tag:
        rec["tag"] = tag
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    if serving_layout:
        rec["serving_layout"] = True
    if cost_pass is None:  # roofline table is single-pod per the spec
        cost_pass = mesh_name == "single"
    t0 = time.time()
    try:
        with fake_process_group(n_dev), greedy_redistribution():
            mesh = build_mesh()
            fn, args = build_lowerable(arch, shape, mesh,
                                       overrides=overrides,
                                       serving_layout=serving_layout)
            counts = count_step(fn, args)
            del fn, args
        rec["compile_scan_s"] = round(time.time() - t0, 2)
        mem = counts["memory"]
        mem["total_per_device"] = mem["argument_size_in_bytes"] + \
            mem["temp_size_in_bytes"]
        rec["memory"] = mem
        rec["status"] = "ok"
        if cost_pass:
            rec["accounting"] = "eager_full_depth"
            rec["cost"] = counts["cost"]
            wires = rl.collective_wire_bytes_from_ops(
                counts["collective_ops"])
            roof = rl.derive_from_parts(
                arch, shape, mesh_name, n_dev, counts["cost"]["flops"],
                counts["cost"]["bytes accessed"], wires,
                get_config(arch))
            rec["roofline"] = roof.as_dict()
            rec["collectives"] = wires
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)
    if verbose:
        msg = (f"[{rec['status']:4s}] {arch:26s} {shape.name:12s} "
               f"{mesh_name:6s} {rec['total_s']:7.1f}s")
        if rec["status"] == "ok" and "roofline" in rec:
            r = rec["roofline"]
            msg += (f" | dom={r['dominant']:10s} comp={r['compute_s']:.3e} "
                    f"mem={r['memory_s']:.3e} coll={r['collective_s']:.3e}")
        elif rec["status"] == "ok":
            mem = rec.get("memory", {}).get("total_per_device", 0)
            msg += f" | runs; mem={mem/1e9:.1f}GB/dev"
        else:
            msg += f" | {rec['error'][:120]}"
        print(msg, flush=True)
    return rec


def _run_cells(cells, jobs: int):
    """``run_cell`` of each (arch, shape, mesh) in ``cells``, records in
    the order they finish: ``jobs`` at once, each cell in a fresh spawned
    process (a cell is host work on ``meta``, one core's; its process
    group lives in its process), or one after another for ``jobs`` 1."""
    if jobs <= 1:
        for cell in cells:
            yield run_cell(*cell)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context(
            "spawn"), max_tasks_per_child=1) as ex:
        for fut in as_completed([ex.submit(run_cell, *c) for c in cells]):
            yield fut.result()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true",
                    help="run every applicable cell on both meshes")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--include-paper-model", action="store_true")
    ap.add_argument("--out", default=None, help="JSONL output (appended)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    args = ap.parse_args(argv)

    done = set()
    if args.out and args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") == "ok":
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    def emit(rec):
        if args.out:
            slim = {k: v for k, v in rec.items() if k != "traceback"}
            with open(args.out, "a") as f:
                f.write(json.dumps(slim) + "\n")

    if args.all:
        archs = ALL_ARCHS if args.include_paper_model else ASSIGNED_ARCHS
        meshes = args.meshes.split(",")
        cells = [(a, s.name, m) for a in archs for s in SHAPES.values()
                 if shape_applicable(get_config(a), s) for m in meshes]
        print(f"dry-run: {len(cells)} cells ({len(done)} already done)")
        todo = [c for c in cells if c not in done]
        n_fail = 0
        for rec in _run_cells(todo, os.cpu_count() or 1):
            emit(rec)
            n_fail += rec["status"] != "ok"
        print(f"dry-run complete; failures: {n_fail}")
        raise SystemExit(1 if n_fail else 0)

    rec = run_cell(args.arch, args.shape, args.mesh)
    emit(rec)
    if rec["status"] == "ok":
        print(json.dumps({k: rec[k] for k in ("memory", "cost", "roofline")
                          if k in rec}, indent=2))
    raise SystemExit(0 if rec["status"] == "ok" else 1)


if __name__ == "__main__":
    main()

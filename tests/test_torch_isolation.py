"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, and the port never quietly runs on
the CPU when it was not asked to."""
import ast
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
#: the modules of the hedging / control-plane / trace-export slice, each
#: imported alone in a fresh interpreter by ``test_module_imports_alone``
SLICE_MODULES = ("repro_torch.core.hedging", "repro_torch.control_plane",
                 "repro_torch.control_plane.rpc",
                 "repro_torch.control_plane.worker",
                 "repro_torch.control_plane.registry",
                 "repro_torch.obs.export", "repro_torch.obs.report")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module


def test_port_files_found():
    assert len(PORT_FILES) > 20
    assert (ROOT / "src" / "repro_torch" / "csrc" /
            "tropical_route.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_module_imports_alone(module):
    """Imported by itself in a fresh interpreter, the module loads and
    pulls in neither JAX nor the reference package, not even
    transitively (a spawned shard worker imports exactly this)."""
    code = ("import importlib, sys; importlib.import_module(%r); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)" % module)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_forbidden_detects_reference_imports():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.planner")
    assert _forbidden("repro") and not _forbidden("repro_torch.core")


def test_server_without_device_or_cuda_raises(monkeypatch):
    """No device and no CUDA: the server raises instead of running on the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.gtrac_serve import GTRACPipelineServer
    cfg = get_config("gpt2-large").reduced(num_layers=2, vocab_size=64,
                                           max_position=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GTRACPipelineServer(cfg, params, layers_per_stage=1)
    # asked explicitly, the CPU is fine
    GTRACPipelineServer(cfg, params, layers_per_stage=1, device="cpu")


def _shard_workers():
    return [p for p in mp.active_children()
            if p.name.startswith("anchor-shard-")]


def test_gtrac_surface_server_without_device_or_cuda_raises(monkeypatch):
    """Hedging, the process-backed 4-shard anchor and tracing together:
    with no device and no CUDA the server raises before it starts a shard
    worker; asked for the CPU it serves, and ``close`` stops its workers."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.control_plane import ProcessShardedRegistry
    from repro_torch.core.hedging import HedgedChainExecutor
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.api import SubmitSpec
    from repro_torch.serving.gtrac_serve import GTRACPipelineServer
    cfg = get_config("gpt2-large").reduced(num_layers=2, vocab_size=64,
                                           max_position=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gcfg = GTRACConfig(hedge_enabled=True, control_plane="procs",
                       anchor_shards=4, trace_enabled=True)
    before = len(_shard_workers())
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            GTRACPipelineServer(cfg, params, layers_per_stage=1, gcfg=gcfg)
        assert len(_shard_workers()) == before
    srv = GTRACPipelineServer(cfg, params, layers_per_stage=1, gcfg=gcfg,
                              device="cpu")
    try:
        assert isinstance(srv.bed.anchor, ProcessShardedRegistry)
        req = srv.submit(SubmitSpec(prompt=[1, 2, 3], max_new_tokens=2))
        assert isinstance(req.executor, HedgedChainExecutor)
        (done,) = srv.run_queue()
        assert done.metrics.tokens == 2 and len(srv.trace) > 0
        assert srv._cp.health.rpc_timeouts == 0
    finally:
        srv.close()
    for p in mp.active_children():
        p.join(timeout=10)
    assert len(_shard_workers()) == before


def test_serve_gtrac_surface_without_device_or_cuda_raises(monkeypatch,
                                                           tmp_path):
    """The serve CLI with the slice's flags raises without CUDA when no
    device is given."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--windowed", "--hedged", "--shards", "4",
                    "--control-plane", "procs", "--trace",
                    str(tmp_path / "t.jsonl"), "--tokens", "2",
                    "--requests", "1"])
    assert not (tmp_path / "t.jsonl").exists()


def test_routing_entry_points_without_device_or_cuda_raise(monkeypatch):
    """The batched routers default to the card: with no device and no CUDA
    they raise instead of routing on the CPU; asked explicitly, the CPU is
    fine. (The numpy backend is host code and takes no device.)"""
    import numpy as np

    from repro_torch.configs.base import GTRACConfig
    from repro_torch.core.planner import RoutePlanner
    from repro_torch.core.routing_torch import route_batched, route_batched_kbest
    from repro_torch.serving.batch_router import BatchRouter, plan_batched
    from repro_torch.sim.testbed import build_scaling_testbed
    cfg = GTRACConfig()
    table = build_scaling_testbed(30, cfg=cfg).anchor.snapshot(0.0)
    taus = np.array([0.0, 0.8])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda **d: route_batched(table, 36, cfg, taus, k_max=36, **d),
        lambda **d: route_batched_kbest(table, 36, cfg, taus, k_max=36,
                                        k_best=2, **d),
        lambda **d: plan_batched(table, 36, cfg, taus,
                                 planner=RoutePlanner(36), **d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")
    router = BatchRouter(planner=RoutePlanner(36), cfg=cfg, total_layers=36)
    router.submit(1, 0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        router.route_window(table)
    router.device = "cpu"
    router.submit(1, 0.5)
    assert router.route_window(table)[1].feasible
    plan_batched(table, 36, cfg, taus, planner=RoutePlanner(36),
                 backend="numpy")


def test_engine_without_device_or_cuda_raises(monkeypatch):
    """The KV-cache engine defaults to the card: with no device and no
    CUDA it raises instead of running on the CPU; asked explicitly, the
    CPU is fine."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("tinyllama-1.1b").reduced(vocab_size=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
    ServingEngine(cfg, params, device="cpu")


def test_serve_engine_mode_without_device_or_cuda_raises(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--mode", "engine", "--reduced", "--tokens", "2",
                    "--requests", "1"])


def test_make_cache_and_params_without_device_or_cuda_raise(monkeypatch):
    """The model API defaults to the card too: ``make_cache`` (the api's,
    ``Model.make_cache`` and the transformer's) and ``params_from_jax``
    with no device and no CUDA raise; asked explicitly, the CPU is
    fine."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import api, transformer
    from repro_torch.models.transformer import init_params, params_from_jax
    dense = get_config("tinyllama-1.1b").reduced(vocab_size=64)
    rwkv = get_config("rwkv6-1.6b").reduced(vocab_size=64)
    tree = {"embed": {"tok": np.zeros((64, 128), np.float32)},
            "layers": {"w": np.zeros((2, 3), np.float32)},
            "final_norm": {"weight": np.ones((128,), np.float32)}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda **d: api.make_cache(dense, 2, 5, **d),
        lambda **d: api.make_cache(rwkv, 2, 5, **d),
        lambda **d: api.build_model(dense).make_cache(2, 5, **d),
        lambda **d: api.build_model(rwkv).make_cache(2, 5, **d),
        lambda **d: transformer.make_cache(dense, 2, 5, **d),
        lambda **d: params_from_jax(tree, **d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        out = call(device="cpu")
        leaves = [out["embed"]["tok"]] if "embed" in out else \
            [t for t in out.values() if isinstance(t, torch.Tensor)]
        assert leaves and all(t.device.type == "cpu" for t in leaves)
    params = init_params(dense, torch.Generator().manual_seed(0), "cpu")
    assert params["embed"]["tok"].device.type == "cpu"

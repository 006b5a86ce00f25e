"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, and the port never quietly runs on
the CPU when it was not asked to."""
import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


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

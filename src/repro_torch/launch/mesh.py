"""Production mesh construction on ``torch.distributed``.

Port of ``repro.launch.mesh``. The port runs one process per device, so
the devices a mesh can use are the ranks of the default process group
(one when none is initialised). Importing this module touches no device
or process-group state: every mesh is built inside a function.

``device_type`` is ``cuda`` unless the caller asks for ``cpu``; the
process-group backend is NCCL on the card and gloo on the CPU
(``init_process_group``). ``launch/dryrun.py`` runs the production meshes
as ranks of a process group that exchanges nothing.
"""
from __future__ import annotations

from repro_torch.configs.base import MeshConfig


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def available_devices() -> int:
    """The ranks a mesh can use: the default group's size, else 1."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def init_process_group(device_type: str = "cuda", store=None, rank: int = 0,
                       world_size: int = 1) -> None:
    """The default process group for ``device_type``: NCCL on ``cuda``,
    gloo on ``cpu``. A one-rank group needs no network (an in-memory
    store)."""
    import torch.distributed as dist

    if store is None:
        store = dist.HashStore()
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def _mesh(shape, axes, device_type):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(_prod(shape)).reshape(tuple(shape))
    return DeviceMesh(device_type or "cuda", ranks,
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16,16) data×model single pod; (2,16,16) pod×data×model for 2
    pods. Raises below that many ranks; never falls back to a smaller
    mesh or another device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _prod(shape)
    have = available_devices()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — run via "
            "launch/dryrun.py (it runs a process group of that size that "
            "exchanges nothing)")
    return _mesh(shape, axes, device_type)


def make_mesh_from_config(cfg: MeshConfig, device_type=None):
    n = cfg.num_devices
    have = available_devices()
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return _mesh(cfg.shape, cfg.axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type=None):
    """Small mesh for multi-process distributed tests."""
    return _mesh(shape, axes, device_type)

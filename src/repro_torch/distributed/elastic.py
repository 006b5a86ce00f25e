"""Elastic scaling: re-mesh and reshard after device-group loss.

Port of ``repro.distributed.elastic``. Recovery path for training: when a
device group drops out, (1) build a smaller mesh from the surviving ranks
(shrink the leading ``data``-like axis — the TP degree is kept so weight
layouts stay valid), (2) reshard the last checkpoint's param trees onto
it, (3) resume. The serving path needs no special handling — G-TRAC's
trust/liveness layer routes around lost stage replicas.

The survivors' layout is a pure function of ranks (``surviving_layout``),
the reference's device-id array for device ids that equal ranks; the
``DeviceMesh`` is built over it, and every rank of the process group calls
``surviving_mesh`` (a lost rank that still runs is simply not in the new
mesh).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.sharding import distribute, param_pspecs


def surviving_layout(shape: Tuple[int, ...], lost_ranks: Sequence[int] = (),
                     ranks: Optional[Sequence[int]] = None) -> np.ndarray:
    """The rank array of the largest mesh with ``shape``'s trailing axes
    after losing ``lost_ranks``: axis 0 shrinks to the number of whole
    model groups among the survivors, which take their places in order."""
    ranks = list(ranks if ranks is not None else range(int(np.prod(shape))))
    lost = set(lost_ranks)
    survivors = [r for r in ranks if r not in lost]
    shape = list(shape)
    model_like = int(np.prod(shape[1:]))  # all but the first axis
    n_groups = len(survivors) // model_like
    if n_groups < 1:
        raise RuntimeError(
            f"cannot rebuild mesh: {len(survivors)} survivors < model "
            f"degree {model_like}")
    shape[0] = n_groups
    n_use = n_groups * model_like
    return np.array(survivors[:n_use]).reshape(shape)


def surviving_mesh(axes: Tuple[str, ...], shape: Tuple[int, ...],
                   lost_ranks: Sequence[int] = (), ranks=None,
                   device_type: Optional[str] = None):
    """A ``DeviceMesh`` with the same axis order over the survivors
    (``surviving_layout``); ``ranks`` defaults to the whole process group,
    ``device_type`` to ``cuda`` unless the caller asks for ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if ranks is None:
        ranks = range(dist.get_world_size())
    layout = surviving_layout(shape, lost_ranks, ranks)
    return DeviceMesh(device_type or "cuda", layout.tolist(),
                      mesh_dim_names=tuple(axes))


def reshard_params(params, new_mesh):
    """Place a (restored, whole) param tree onto ``new_mesh`` by the same
    logical rules (fitted to the new mesh's divisibility, which the
    reference's ``NamedSharding`` requires)."""
    return distribute(new_mesh, params, param_pspecs(params))


def remesh_and_restore(checkpoint_restore_fn, axes, shape,
                       lost_ranks: Sequence[int], device_type=None):
    """Full recovery: new mesh + resharded restore from checkpoint."""
    mesh = surviving_mesh(axes, shape, lost_ranks, device_type=device_type)
    state = checkpoint_restore_fn()
    params = reshard_params(state["params"], mesh)
    return mesh, {**state, "params": params}

"""Anchor registry factory.

Port of ``repro.core.sharding`` for the monolithic anchor only:
``make_registry`` returns the plain ``AnchorRegistry`` for ``shards <= 1``
on the in-process backend, as the reference does. The sharded registries
(``ShardedAnchorRegistry``, and ``ProcessShardedRegistry`` behind
``backend="procs"``) join the port with the sharding and control-plane
slice; asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.registry import AnchorRegistry


def make_registry(cfg: GTRACConfig, shards: int = 1,
                  shard_by: str = "peer",
                  backend: Optional[str] = None) -> AnchorRegistry:
    """Factory: the monolithic anchor for ``shards <= 1`` in process.

    ``backend`` defaults to ``cfg.control_plane``. ``"procs"`` and
    ``shards > 1`` raise ``NotImplementedError`` (a later slice of the
    port); any other backend name raises ``ValueError``, as in the
    reference."""
    if backend is None:
        backend = getattr(cfg, "control_plane", "inproc")
    if backend not in ("inproc", "procs"):
        raise ValueError(f"control_plane backend must be 'inproc' or "
                         f"'procs', got {backend!r}")
    if backend == "procs" or shards > 1:
        raise NotImplementedError(
            f"make_registry(shards={shards}, backend={backend!r}): sharded "
            "and process-backed anchors join repro_torch in a later slice "
            "of the port")
    return AnchorRegistry(cfg)

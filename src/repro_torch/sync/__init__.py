"""Gossip sync plane: delta-encoded trust dissemination from anchors to
edge seeker caches, with staleness-bounded routing under partitions.

The third plane of the system — data (serving), control (registries),
and now dissemination: ``delta`` is the wire format (per-shard columnar
diffs + full-snapshot fallback), ``seeker`` the edge-side shard mirrors
that materialize bit-identical route tables, ``gossip`` the round
scheduler (version-vector push, fanout-capped dirty-shard pull,
anti-entropy full sync after partition heal), and ``relay`` the
epidemic seeker→seeker plane that keeps the anchor's per-round push
cost O(fanout) while updates reach all N seekers in O(log N) rounds.

Port of ``repro.sync``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from repro_torch.sync.delta import (
    DeltaGapError,
    ShardDelta,
    apply_delta,
    copy_state,
    empty_state,
    full_delta,
    make_delta,
    slice_state,
    state_wire_bytes,
)
from repro_torch.sync.gossip import (
    GossipPublisher,
    GossipScheduler,
    GossipStats,
    make_sync_plane,
    registry_n_shards,
    registry_shard_state,
    registry_version_vector,
)
from repro_torch.sync.relay import (
    RelayMessage,
    RelayNode,
    RelayPlane,
    RelayStats,
    RelayTopology,
)
from repro_torch.sync.seeker import SeekerCache, SeekerSyncStats

__all__ = [
    "DeltaGapError", "ShardDelta", "apply_delta", "copy_state",
    "empty_state", "full_delta", "make_delta", "slice_state",
    "state_wire_bytes",
    "GossipPublisher", "GossipScheduler", "GossipStats",
    "make_sync_plane", "registry_n_shards", "registry_shard_state",
    "registry_version_vector",
    "RelayMessage", "RelayNode", "RelayPlane", "RelayStats",
    "RelayTopology",
    "SeekerCache", "SeekerSyncStats",
]

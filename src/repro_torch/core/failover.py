"""Anchor replication and failover.

The paper's Hybrid Trust Architecture places the global registry on ONE
stable anchor (§III-A) — a single point of failure at 1000+ node scale.
``ReplicatedAnchor`` runs a primary + N backups with asynchronous state
replication on the gossip cadence: every ``apply_report``/heartbeat goes to
the primary; backups pull snapshots in the background (the same staleness
model as seeker caches, so failover loses at most T_sync of trust updates —
which the trust protocol tolerates by design: updates are idempotent
increments and liveness re-establishes via heartbeats within T_hb).

Failover: when the primary misses ``primary_ttl`` of liveness probes, the
first live backup is promoted; seekers keep routing from their caches
throughout (the control plane is off the critical path — the paper's own
argument makes the failover invisible to in-flight inference).

Replication is array-copy, not ``copy.deepcopy``: the primary exports its
columnar ``RegistryState`` (shared zero-copy with its snapshot mirror) and
each backup adopts the column arrays in O(#columns); backups only pay the
O(P) record materialisation lazily, on first control-plane access after a
promotion.

With ``shards > 1`` the replica group runs ``ShardedAnchorRegistry``
replicas and replication is **per shard**: each tick ships only the shards
whose version advanced since the last sync (dirty-shard delta, tracked by
the primary's per-shard version vector), and ``restore_shard`` promotes a
backup's copy of ONE lost shard into the primary without copying the other
S-1 shards — the shard-granular recovery path the composed-snapshot
design exists for.

Port of ``repro.core.failover``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

from typing import List, Optional, Union

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.registry import AnchorRegistry
from repro_torch.core.sharding import ShardedAnchorRegistry, make_registry
from repro_torch.core.types import ExecReport, PeerTable

AnyAnchor = Union[AnchorRegistry, ShardedAnchorRegistry]


class ReplicatedAnchor:
    """Primary/backup anchor group with async snapshot replication."""

    def __init__(self, cfg: GTRACConfig, n_backups: int = 2,
                 sync_period_s: Optional[float] = None,
                 primary_ttl_s: Optional[float] = None,
                 shards: int = 1, shard_by: str = "peer"):
        self.cfg = cfg
        self.shards = int(shards)
        primary = make_registry(cfg, shards=shards, shard_by=shard_by)
        self.replicas: List[AnyAnchor] = [primary] + [
            self._make_backup(primary, cfg, shards, shard_by)
            for _ in range(n_backups)]
        self.primary_idx = 0
        self.alive = [True] * (1 + n_backups)
        self.sync_period_s = sync_period_s or cfg.gossip_period_s
        self.primary_ttl_s = primary_ttl_s or cfg.node_ttl_s
        self._last_sync = 0.0
        self._last_primary_seen = 0.0
        # per-BACKUP per-shard versions last *delivered by a full state
        # ship* (None = this backup never received that shard): a backup
        # that was dead during a dirty-shard ship must get a full re-ship
        # when it revives, and restore_shard must only adopt from a backup
        # that actually holds a copy
        self._shipped: dict = {}        # replica idx -> [version | None]*S
        self.failovers = 0

    @staticmethod
    def _make_backup(primary: AnyAnchor, cfg: GTRACConfig, shards: int,
                     shard_by: str) -> AnyAnchor:
        """Backups are always in-process (the ledger must survive a
        worker massacre, so it cannot live behind the same process
        boundary it insures), but they must speak the primary's
        replication surface: a process-backed primary replicates per
        shard even at S=1, which the monolithic registry cannot adopt."""
        backup = make_registry(cfg, shards=shards, shard_by=shard_by,
                               backend="inproc")
        if hasattr(primary, "export_shard_state") and \
                not hasattr(backup, "adopt_shard_state"):
            backup = ShardedAnchorRegistry(
                cfg, n_shards=getattr(primary, "n_shards", 1),
                shard_by=shard_by)
        return backup

    # -- the AnchorRegistry surface (delegated to the primary) ---------------

    @property
    def primary(self) -> AnyAnchor:
        return self.replicas[self.primary_idx]

    def register(self, *a, **kw):
        return self.primary.register(*a, **kw)

    def deregister(self, *a, **kw):
        return self.primary.deregister(*a, **kw)

    def heartbeat(self, peer_id: int, now: float) -> None:
        self.primary.heartbeat(peer_id, now)
        self._last_primary_seen = now

    def heartbeat_all(self, peer_ids, now: float) -> None:
        self.primary.heartbeat_all(peer_ids, now)
        self._last_primary_seen = now

    def apply_report(self, report: ExecReport) -> None:
        self.primary.apply_report(report)

    def snapshot(self, now: float) -> PeerTable:
        return self.primary.snapshot(now)

    def sweep(self, now: float, **kw) -> int:
        return self.primary.sweep(now, **kw)

    def reset_trust(self) -> None:
        self.primary.reset_trust()

    @property
    def peers(self):
        return self.primary.peers

    # -- replication & failover ------------------------------------------------

    def tick(self, now: float) -> None:
        """Background replication: backups adopt the primary's columnar
        state (a handful of array refs + one heartbeat-column copy) instead
        of deep-copying the entire peer-record map per backup.

        Sharded groups replicate per shard with a dirty-shard delta: the
        primary's per-shard version vector is compared against the versions
        last shipped, and clean shards — whose only traffic since the last
        ship was heartbeats (heartbeats never bump a shard's version) —
        ship just their liveness column instead of the full state, so a
        backup promoted later never sees stale heartbeats and TTL-expires
        live peers."""
        if now - self._last_sync < self.sync_period_s:
            return
        self._last_sync = now
        if not self.alive[self.primary_idx]:
            return
        primary = self.primary
        if hasattr(primary, "export_shard_state"):
            # sharded surface — in-process or process-backed composer
            vec = primary.version_vector
            states: dict = {}       # exported once per dirty shard
            hbs: dict = {}          # exported once per clean shard
            for i, rep in enumerate(self.replicas):
                if i == self.primary_idx:
                    continue
                if not self.alive[i]:
                    # a dead backup's state is gone; forget what it had so
                    # revival triggers a full re-ship of every shard
                    self._shipped.pop(i, None)
                    continue
                delivered = self._shipped.get(i) or \
                    [None] * primary.n_shards
                for s in range(primary.n_shards):
                    if s in primary.lost_shards:
                        continue    # never overwrite the last good copy
                    if delivered[s] == vec[s]:
                        # unchanged since this backup's last full ship:
                        # only heartbeats moved (they never bump versions)
                        if s not in hbs:
                            hbs[s] = primary.export_shard_heartbeats(s)
                        rep.adopt_shard_heartbeats(s, hbs[s])
                    else:
                        if s not in states:
                            states[s] = primary.export_shard_state(s)
                        rep.adopt_shard_state(s, states[s])
                        delivered[s] = vec[s]
                self._shipped[i] = delivered
            return
        state = primary.export_state()
        for i, rep in enumerate(self.replicas):
            if i != self.primary_idx and self.alive[i]:
                rep.adopt_state(state)

    def crash_primary(self) -> None:
        self.alive[self.primary_idx] = False

    def maybe_failover(self, now: float) -> bool:
        """Promote the first live backup if the primary is down/expired."""
        expired = (not self.alive[self.primary_idx]) or \
            (now - self._last_primary_seen > self.primary_ttl_s)
        if not expired:
            return False
        for i, ok in enumerate(self.alive):
            if ok and i != self.primary_idx:
                self.primary_idx = i
                self.failovers += 1
                self._shipped = {}     # new primary re-ships everything
                return True
        raise RuntimeError("no live anchor replica to promote")

    def restore_shard(self, shard: int) -> bool:
        """Shard-granular recovery: the primary lost ONE shard (e.g. a
        shard process crash simulated by ``lose_shard``); re-adopt that
        shard's columnar state from the live backup holding the freshest
        *delivered* copy (per the ship ledger — a backup that was dead or
        never ticked does not qualify, so an empty replica can never
        silently "restore" nothing). The primary's other S-1 shards —
        including any trust updates newer than the last replication tick —
        are untouched. Returns False if no live backup holds a copy (e.g.
        loss before the first replication tick, or right after a failover
        reset the ship ledger)."""
        primary = self.primary
        if not hasattr(primary, "adopt_shard_state"):
            raise ValueError("restore_shard requires a sharded anchor group")
        best = None
        best_v = None
        for i, rep in enumerate(self.replicas):
            if i == self.primary_idx or not self.alive[i]:
                continue
            delivered = self._shipped.get(i)
            v = delivered[shard] if delivered is not None else None
            if v is not None and (best_v is None or v > best_v):
                best, best_v = rep, v
        if best is None:
            return False
        primary.adopt_shard_state(shard, best.export_shard_state(shard))
        # adopt bumped the shard's version, so the next tick's per-backup
        # version compare re-ships the restored state everywhere
        return True

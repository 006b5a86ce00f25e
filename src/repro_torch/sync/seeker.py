"""Seeker-side shard mirrors: apply deltas, materialize route tables,
price staleness into routing.

``SeekerCache`` holds one columnar ``RegistryState`` mirror per anchor
shard, applied strictly in version order (duplicates are idempotent
no-ops; a base-version gap raises ``DeltaGapError`` and the gossip
scheduler anti-entropy full-syncs the shard). ``materialize(now)``
composes the mirrors into a ``PeerTable`` in global registration order —
the same stable seq argsort as ``ShardedAnchorRegistry.compose_snapshot``
— so a fully-synced cache routes **bit-identically** to an
anchor-composed snapshot (tests/test_sync.py parity suite).

The cache carries its own ``version`` / ``topo_version`` generations and
``source_id``, bumped once per rebuilt table / membership change, so
every downstream cache keyed on the registry snapshot contract —
``RoutePlanner.compile``/``plan_cached``, ``BatchRouter``'s window cache,
``CompiledGraph.device_state`` — consumes seeker tables unchanged.

Staleness-bounded routing: ``staleness(now)`` is the per-shard age in
seconds since the shard last synced (``staleness_rounds`` in gossip
rounds); ``routing_view(now)`` returns the materialized table with each
row's trust first discounted toward ``init_trust`` at
``gossip_stale_decay`` per second of its shard's staleness (the
seeker-side mirror of the anchor sweep's decay law) and then reduced by
``gossip_stale_margin`` per stale round (capped at
``gossip_stale_margin_max``) — an inflated trust floor in disguise, since
routing masks on ``trust >= tau``. A partitioned seeker therefore routes
conservatively on what it cannot confirm instead of trusting dead data;
with zero staleness (or both knobs off) the base table object itself is
returned, preserving bit-identical parity and every zero-copy fast path.

Port of ``repro.sync.seeker``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.digest import empty_digest, state_digest, xor_rows
from repro_torch.core.registry import _REGISTRY_IDS
from repro_torch.core.types import PeerTable, RegistryState
from repro_torch.sync.delta import (
    DeltaGapError,
    ShardDelta,
    apply_delta,
    copy_state,
    empty_state,
    slice_state,
)

APPLIED = "applied"
DUPLICATE = "duplicate"


@dataclass
class SeekerSyncStats:
    deltas_applied: int = 0
    full_syncs: int = 0
    duplicates: int = 0
    gaps: int = 0
    hb_refreshes: int = 0
    bytes_received: int = 0


@dataclass
class _Composed:
    """Cache of the last materialized composition."""

    table: PeerTable
    hb: np.ndarray          # (P,) composed last-heartbeat column
    row_shard: np.ndarray   # (P,) owning shard index per row


class SeekerCache:
    """Per-shard column mirrors + staleness-bounded routing views."""

    def __init__(self, cfg: GTRACConfig, n_shards: int, now: float = 0.0):
        self.cfg = cfg
        self.n_shards = int(n_shards)
        self.source_id = next(_REGISTRY_IDS)
        self._states: List[RegistryState] = [empty_state()
                                             for _ in range(self.n_shards)]
        self._versions: List[int] = [-1] * self.n_shards
        # per-shard mirror content digests (core/digest.py), maintained
        # INCREMENTALLY on delta application — O(changed rows), XOR out
        # dropped row hashes, XOR in upserted ones — and from scratch on
        # full-snapshot adoption. The relay plane verifies these against
        # anchor-attested digests at matching versions.
        self._digest_seed = int(cfg.sync_digest_seed)
        self._digests: List[int] = [empty_digest(self._digest_seed)
                                    for _ in range(self.n_shards)]
        self._synced_at = np.full(self.n_shards, float(now))
        # when each shard last received its WHOLE heartbeat column (full
        # sync or hb refresh) — deltas only carry changed rows' hb, so
        # this is the liveness-freshness clock the scheduler renews
        self._hb_at = np.full(self.n_shards, float(now))
        self._dirty = True
        self._topo_dirty = True
        self._gen = 0
        self._topo_gen = 0
        self._composed: Optional[_Composed] = None
        # staleness-adjusted routing tables get their own snapshot
        # identity: a separate source_id + generation stream, so planner /
        # router caches never confuse them with the base tables
        self._routing_source_id = next(_REGISTRY_IDS)
        self._routing: Optional[Tuple[Tuple, PeerTable]] = None
        self._rgen = 0
        self.stats = SeekerSyncStats()

    # -- sync protocol -------------------------------------------------------

    @property
    def version_vector(self) -> Tuple[int, ...]:
        """Mirrored per-shard anchor versions (−1 = never synced)."""
        return tuple(self._versions)

    def observe(self, version_vector: Sequence[int], now: float,
                reachable: Optional[Sequence[bool]] = None) -> List[int]:
        """Ingest an anchor's per-shard version-vector push. Shards
        already at the advertised version refresh their staleness clock
        (a clean round IS a successful sync); the rest are returned as
        the dirty set to pull. ``reachable`` masks partitioned shards —
        they neither refresh nor appear dirty (their staleness grows)."""
        dirty: List[int] = []
        for s, v in enumerate(version_vector):
            if reachable is not None and not reachable[s]:
                continue
            if v == self._versions[s]:
                # monotonic: a relayed observation may carry an OLDER
                # timestamp than a confirmation this seeker already has
                self._synced_at[s] = max(self._synced_at[s], now)
            else:
                dirty.append(s)
        return dirty

    def apply(self, delta: ShardDelta, now: float) -> str:
        """Apply one shard delta in version order.

        Returns ``"applied"`` or ``"duplicate"`` (idempotent: the delta's
        ``new_version`` is behind the mirror, or a replayed delta at the
        mirrored version). A full snapshot AT the mirrored version is
        applied, not rejected: its rows are identical by the version
        contract but its heartbeat column is fresher (liveness refreshes
        on full syncs). Raises ``DeltaGapError`` when a non-full delta's
        base version does not match the mirrored shard version —
        out-of-order application is never silently absorbed; the
        scheduler full-syncs instead."""
        s = int(delta.shard)
        if not 0 <= s < self.n_shards:
            raise ValueError(f"shard {s} out of range (S={self.n_shards})")
        cur = self._versions[s]
        if cur >= 0 and delta.is_full and delta.new_version == cur:
            # same-version full snapshot (anti-entropy against a shard
            # that never changed, e.g. a quiescent shard after a heal):
            # the rows are identical by the version contract, but the
            # heartbeat column is fresher — adopt liveness and refresh
            # the staleness clocks instead of rejecting the ship
            self.stats.full_syncs += 1
            self.stats.bytes_received += delta.wire_bytes()
            self._synced_at[s] = max(self._synced_at[s], now)
            self._hb_at[s] = max(self._hb_at[s], now)
            st, full = self._states[s], delta.full
            if len(full.peer_ids) == len(st.peer_ids) and \
                    not np.array_equal(full.last_heartbeat,
                                       st.last_heartbeat):
                # adopt a COPY: the shipped object is also the
                # publisher's delta base (and, with relays, every other
                # receiver's payload) — see delta.copy_state
                self._states[s] = copy_state(full)
                self._dirty = True
            return APPLIED
        if cur >= 0 and delta.new_version <= cur:
            self.stats.duplicates += 1
            return DUPLICATE
        if not delta.is_full and delta.base_version != cur:
            self.stats.gaps += 1
            raise DeltaGapError(
                f"shard {s}: delta base v{delta.base_version} != "
                f"mirrored v{cur} — anti-entropy full sync required")
        self.stats.bytes_received += delta.wire_bytes()
        if delta.is_full:
            self.stats.full_syncs += 1
        else:
            self.stats.deltas_applied += 1
        self._versions[s] = int(delta.new_version)
        # max-guarded: relayed messages may carry observation times older
        # than a confirmation this seeker already holds
        self._synced_at[s] = max(self._synced_at[s], now)
        if delta.is_full:
            # a full state carries liveness as fresh as its source
            self._hb_at[s] = max(self._hb_at[s], now)
        if delta.is_empty:
            # version-only advance (liveness flip / heartbeat drift):
            # the mirror content is untouched, every table cache survives
            return APPLIED
        old = self._states[s]
        if delta.is_full:
            # full snapshots are adopted as a COPY — the wire object
            # aliases the publisher's history entry and every
            # co-receiver's payload — and reset the digest from scratch
            new = copy_state(delta.full)
            self._digests[s] = state_digest(new, self._digest_seed)
        else:
            # incremental digest maintenance, O(changed rows): XOR out
            # the hashes of rows this delta drops (removed or replaced),
            # XOR in the upserted rows' hashes (core/digest.py)
            rows = delta.rows if delta.rows is not None else empty_state()
            drop = np.concatenate([delta.removed_ids, rows.peer_ids])
            dropped = np.nonzero(np.isin(old.peer_ids, drop))[0]
            self._digests[s] ^= (
                xor_rows(slice_state(old, dropped), self._digest_seed)
                ^ xor_rows(rows, self._digest_seed))
            new = apply_delta(old, delta)
        self._states[s] = new
        self._dirty = True
        if not (np.array_equal(old.peer_ids, new.peer_ids)
                and np.array_equal(old.seq, new.seq)):
            self._topo_dirty = True
        return APPLIED

    def refresh_heartbeats(self, shard: int, hb: np.ndarray,
                           now: float) -> bool:
        """Overwrite one shard mirror's liveness column from a fresh
        anchor export (the lease-renewal message the scheduler ships on
        the ``gossip_hb_refresh_frac`` cadence — heartbeat movement never
        bumps versions, so deltas alone would let the mirror TTL-expire
        live peers). Same contract as ``adopt_heartbeats``: a length
        mismatch (seeker behind on membership) is ignored and left for
        the data path to repair. Returns whether the column was taken."""
        st = self._states[shard]
        if len(hb) != len(st.peer_ids):
            return False
        col = np.asarray(hb, np.float64)
        self._hb_at[shard] = max(self._hb_at[shard], now)
        self.stats.hb_refreshes += 1
        if np.array_equal(col, st.last_heartbeat):
            return True             # nothing moved: every cache survives
        st.last_heartbeat = col
        self._dirty = True
        return True

    def hb_age(self, now: float) -> np.ndarray:
        """Per-shard age of the mirrored heartbeat column in seconds —
        what the scheduler compares against the refresh cadence."""
        return np.maximum(0.0, now - self._hb_at)

    # -- relay accessors (sync/relay.py) -------------------------------------

    def mirror(self, shard: int) -> RegistryState:
        """One shard's mirrored columnar state — what a relay node
        forwards. Read-only by contract: mutation goes through ``apply``
        / ``refresh_heartbeats`` (receivers adopt copies)."""
        return self._states[shard]

    def sync_stamp(self, shard: int) -> float:
        """When this shard's mirror was last confirmed (the clock behind
        ``staleness``)."""
        return float(self._synced_at[shard])

    def hb_stamp(self, shard: int) -> float:
        """When this shard's liveness column was last refreshed whole."""
        return float(self._hb_at[shard])

    def shard_digest(self, shard: int) -> int:
        """This shard mirror's content digest (incrementally maintained
        — see ``apply``). Equals the anchor's ``state_digest`` /
        ``shard_digest`` whenever the mirror is honest and at the same
        version; the relay plane quarantines senders whose chains break
        that equality."""
        return self._digests[shard]

    def checkpoint(self, shard: int) -> tuple:
        """Snapshot one shard's adoption-relevant state so a relay
        receiver can STAGE a neighbor's chain, verify the resulting
        digest, and roll back cleanly on mismatch (``restore``). Cheap:
        the state object is immutable-by-contract under ``apply`` (every
        application rebinds a new object), so the token holds references
        plus scalars — no column copies."""
        return (self._states[shard], self._versions[shard],
                self._digests[shard], float(self._synced_at[shard]),
                float(self._hb_at[shard]), self._dirty, self._topo_dirty)

    def invalidate_shard(self, shard: int) -> None:
        """Throw one shard's mirror away (digest verification found it
        poisoned): back to the boot state, so the next full snapshot
        adopts from scratch instead of hitting the same-version
        rows-are-identical fast path — a poisoned mirror at the anchor's
        version is exactly the case that contract cannot see. Staleness
        clocks are left untouched; the shard is *worse* than stale until
        repaired."""
        self._states[shard] = empty_state()
        self._versions[shard] = -1
        self._digests[shard] = empty_digest(self._digest_seed)
        self._dirty = True
        self._topo_dirty = True

    def restore(self, shard: int, token: tuple) -> None:
        """Roll one shard back to a ``checkpoint`` token — the reject
        path of digest-verified adoption. Table/composition caches are
        keyed on generations that only move in ``materialize``, so
        un-materialized staged state unwinds completely."""
        (self._states[shard], self._versions[shard], self._digests[shard],
         synced_at, hb_at, self._dirty, self._topo_dirty) = token
        self._synced_at[shard] = synced_at
        self._hb_at[shard] = hb_at

    # -- staleness -----------------------------------------------------------

    def staleness(self, now: float) -> np.ndarray:
        """Per-shard age in seconds since the shard last synced (clean
        version-vector observations count — freshness is about
        confirmation, not data motion)."""
        return np.maximum(0.0, now - self._synced_at)

    def staleness_rounds(self, now: float) -> np.ndarray:
        """Per-shard age in whole gossip rounds."""
        period = max(float(self.cfg.gossip_period_s), 1e-9)
        return np.floor(self.staleness(now) / period).astype(np.int64)

    # -- materialization -----------------------------------------------------

    def materialize(self, now: float) -> PeerTable:
        """Compose the shard mirrors into a ``PeerTable`` in global
        registration (seq) order — the anchor-composed snapshot's twin.
        Zero-copy while nothing changed: the identical table object comes
        back until a delta mutates some mirror or the liveness mask
        flips (same contract as ``AnchorRegistry.snapshot``)."""
        c = self._composed
        if not self._dirty and c is not None:
            alive = (now - c.hb) <= self.cfg.node_ttl_s
            if np.array_equal(alive, c.table.alive):
                return c.table
            self._gen += 1
            t = c.table
            table = PeerTable(
                peer_ids=t.peer_ids, layer_start=t.layer_start,
                layer_end=t.layer_end, trust=t.trust,
                latency_ms=t.latency_ms, alive=alive, snapshot_time=now,
                version=self._gen, topo_version=self._topo_gen,
                source_id=self.source_id,
            )
            self._composed = _Composed(table, c.hb, c.row_shard)
            return table
        states = self._states
        hb = np.concatenate([st.last_heartbeat for st in states])
        seq = np.concatenate([st.seq for st in states])
        row_shard = np.concatenate(
            [np.full(len(st), s, np.int32) for s, st in enumerate(states)])
        perm = np.argsort(seq, kind="stable")
        hb = hb[perm]
        if self._topo_dirty:
            self._topo_gen += 1
            self._topo_dirty = False
        self._gen += 1
        table = PeerTable(
            peer_ids=np.concatenate([st.peer_ids for st in states])[perm],
            layer_start=np.concatenate(
                [st.layer_start for st in states])[perm],
            layer_end=np.concatenate([st.layer_end for st in states])[perm],
            trust=np.concatenate([st.trust for st in states])[perm],
            latency_ms=np.concatenate(
                [st.latency_ms for st in states])[perm],
            alive=(now - hb) <= self.cfg.node_ttl_s,
            snapshot_time=now,
            version=self._gen, topo_version=self._topo_gen,
            source_id=self.source_id,
        )
        self._composed = _Composed(table, hb, row_shard[perm])
        self._dirty = False
        return table

    def __len__(self) -> int:
        return sum(len(st) for st in self._states)

    # -- staleness-bounded routing -------------------------------------------

    def routing_view(self, now: float) -> PeerTable:
        """The table routing should consume: stale shards' trust is
        discounted toward ``init_trust`` and docked the stale-round
        margin (see the module docstring). Returns the base table object
        itself when no adjustment applies, and caches the adjusted table
        per (base version, stale-round vector) so consecutive windows in
        the same round share one object — planner / window-router caches
        stay warm across a partition. (With ``gossip_stale_decay`` on,
        the per-second ages join the cache key: only same-instant calls
        share an object, the price of the documented decay law.)"""
        table = self.materialize(now)
        margin = float(self.cfg.gossip_stale_margin)
        decay = float(self.cfg.gossip_stale_decay)
        rounds = self.staleness_rounds(now)
        age = self.staleness(now)
        # each knob gates on its own clock: the margin is a per-ROUND
        # dock, the decay a per-SECOND law — sub-round staleness (age
        # under one gossip period) must still decay
        apply_margin = margin > 0.0 and bool(rounds.any())
        apply_decay = decay > 0.0 and bool(age.any())
        if not (apply_margin or apply_decay):
            return table
        key = (table.version, rounds.tobytes(),
               age.tobytes() if apply_decay else b"")
        hit = self._routing
        if hit is not None and hit[0] == key:
            return hit[1]
        c = self._composed
        age_row = age[c.row_shard]
        trust = table.trust
        if apply_decay:
            f = np.exp(-decay * age_row)
            trust = self.cfg.init_trust + (trust - self.cfg.init_trust) * f
        if apply_margin:
            dock = np.minimum(margin * rounds[c.row_shard],
                              self.cfg.gossip_stale_margin_max)
            trust = trust - dock
        trust = np.clip(trust, self.cfg.min_trust, self.cfg.max_trust)
        self._rgen += 1
        adjusted = PeerTable(
            peer_ids=table.peer_ids, layer_start=table.layer_start,
            layer_end=table.layer_end, trust=trust,
            latency_ms=table.latency_ms, alive=table.alive,
            snapshot_time=now,
            version=self._rgen, topo_version=table.topo_version,
            source_id=self._routing_source_id,
        )
        self._routing = (key, adjusted)
        return adjusted

"""Hybrid Trust Architecture (paper §IV-A).

``AnchorRegistry`` is the control-plane authority: it owns the global
registry Σ_t = {(p, c_p, r_p, l̂_p)}, ingests heartbeats, and applies
execution reports (trust/latency feedback). ``SeekerCache`` is the
seeker-side *stale* view Σ̃_t, refreshed by background synchronisation every
``T_gossip`` — never synchronously on the request path. Routing always reads
the cache, which is what decouples control-plane latency from the inference
critical path.

Snapshot-versioning contract (consumed by core/planner.py):

* ``version`` bumps on every record mutation (register / deregister /
  apply_report / reset_trust / adopt_state) and whenever the liveness
  vector changes at snapshot time (heartbeat-expiry or revival).
* ``topo_version`` bumps only on membership changes — the planner keys its
  compiled CSR graph on it, so trust/latency feedback never recompiles.
* ``snapshot(now)`` is zero-copy: while nothing changed it returns the
  *identical*, unmutated ``PeerTable`` object (``snapshot_time`` is the
  time the content was captured, not of the latest call); after a pure
  state change the new table shares the freshly-built column arrays of an
  internal columnar mirror, with no per-record Python loop on the
  unchanged path. Heartbeats update the mirror in place (a single
  array store), so steady-state heartbeat traffic never invalidates the
  snapshot.
* ``export_state`` / ``adopt_state`` replicate a registry as a handful of
  column arrays (no ``copy.deepcopy``); adopted state materialises back
  into ``PeerRecord`` objects lazily on first control-plane access.
* every registration is stamped with a monotonic *sequence number*
  (``_seq``): row order in the records dict is always ascending in seq
  (fresh arrivals append; re-registering a present peer keeps its
  position and its seq, exactly the dict semantics), so ``export_state``
  ships a ``seq`` column that makes row order location-independent — the
  contract the gossip sync plane (``repro_torch.sync``) and the sharded
  composed snapshot (core/sharding.py) both order by.

Port of ``repro.core.registry``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core import trust as T
from repro_torch.core.types import ExecReport, PeerRecord, PeerTable, RegistryState

_REGISTRY_IDS = itertools.count(0)


class _Mirror:
    """Columnar mirror of the records dict (rebuilt on version bump)."""

    __slots__ = ("peer_ids", "layer_start", "layer_end", "trust",
                 "latency_ms", "last_heartbeat", "successes", "failures",
                 "profiles", "_index")

    def __init__(self, records: List[PeerRecord]):
        n = len(records)
        self.peer_ids = np.fromiter((r.peer_id for r in records),
                                    np.int64, n)
        self.layer_start = np.fromiter((r.layer_start for r in records),
                                       np.int32, n)
        self.layer_end = np.fromiter((r.layer_end for r in records),
                                     np.int32, n)
        self.trust = np.fromiter((r.trust for r in records), np.float64, n)
        self.latency_ms = np.fromiter((r.latency_est_ms for r in records),
                                      np.float64, n)
        self.last_heartbeat = np.fromiter(
            (r.last_heartbeat for r in records), np.float64, n)
        self.successes = np.fromiter((r.successes for r in records),
                                     np.int64, n)
        self.failures = np.fromiter((r.failures for r in records),
                                    np.int64, n)
        self.profiles = [r.profile for r in records]
        self._index = None

    @classmethod
    def from_state(cls, state: RegistryState) -> "_Mirror":
        """Column-array construction (sweep / adopt path): O(#columns),
        no PeerRecord objects touched."""
        m = cls.__new__(cls)
        m.peer_ids = state.peer_ids
        m.layer_start = state.layer_start
        m.layer_end = state.layer_end
        m.trust = state.trust
        m.latency_ms = state.latency_ms
        m.last_heartbeat = state.last_heartbeat
        m.successes = state.successes
        m.failures = state.failures
        m.profiles = state.profiles
        m._index = None
        return m

    @property
    def index(self) -> Dict[int, int]:
        if self._index is None:   # built lazily: sweeps never pay for it
            self._index = {int(p): i for i, p in enumerate(self.peer_ids)}
        return self._index


class AnchorRegistry:
    """Stable infrastructure anchor — control plane only, never on the
    data path (§III-A)."""

    def __init__(self, cfg: GTRACConfig):
        self.cfg = cfg
        self._peers: Dict[int, PeerRecord] = {}
        self._pending_state: Optional[RegistryState] = None
        self.registry_id = next(_REGISTRY_IDS)
        self.version = 0        # any record mutation or liveness flip
        self.topo_version = 0   # membership changes only
        self._mirror: Optional[_Mirror] = None
        self._table: Optional[PeerTable] = None
        self._last_sweep = 0.0
        # registration sequence: peer_id -> monotonic arrival stamp; row
        # order in the records dict is always ascending in seq (see the
        # module docstring) — the sync plane's ordering contract
        self._seq: Dict[int, int] = {}
        self._seq_next = 0
        # rolling content digest, cached per version (core/digest.py):
        # any mutation bumps version, so the cache key IS the
        # recompute-on-mutation trigger — amortized incremental
        self._digest: Optional[int] = None
        self._digest_version: int = -1

    # -- record access -------------------------------------------------------

    @property
    def peers(self) -> Dict[int, PeerRecord]:
        if self._pending_state is not None:
            self._materialize()
        return self._peers

    def _touch(self, topo: bool = False) -> None:
        self.version += 1
        if topo:
            self.topo_version += 1
        self._mirror = None
        self._table = None

    # content-preserving rematerialization: the pending state was already
    # counted by the adopt/sweep that parked it, so no version bump here
    # repolint: allow[version-bump]
    def _materialize(self) -> None:
        st, self._pending_state = self._pending_state, None
        self._peers = {
            int(st.peer_ids[i]): PeerRecord(
                peer_id=int(st.peer_ids[i]),
                layer_start=int(st.layer_start[i]),
                layer_end=int(st.layer_end[i]),
                trust=float(st.trust[i]),
                latency_est_ms=float(st.latency_ms[i]),
                last_heartbeat=float(st.last_heartbeat[i]),
                successes=int(st.successes[i]),
                failures=int(st.failures[i]),
                profile=st.profiles[i],
            )
            for i in range(len(st.peer_ids))
        }

    # -- membership --------------------------------------------------------

    def register(self, peer_id: int, layer_start: int, layer_end: int,
                 now: float = 0.0, profile: str = "",
                 trust: Optional[float] = None,
                 latency_ms: Optional[float] = None) -> PeerRecord:
        rec = PeerRecord(
            peer_id=peer_id,
            layer_start=layer_start,
            layer_end=layer_end,
            trust=self.cfg.init_trust if trust is None else trust,
            latency_est_ms=(self.cfg.init_latency_ms
                            if latency_ms is None else latency_ms),
            last_heartbeat=now,
            profile=profile,
        )
        peers = self.peers
        if peer_id not in peers:
            # fresh arrival (or return after deregister / TTL expiry):
            # appended at the dict's end with a new sequence stamp
            self._seq[peer_id] = self._seq_next
            self._seq_next += 1
        peers[peer_id] = rec
        self._touch(topo=True)
        return rec

    def deregister(self, peer_id: int) -> None:
        if self.peers.pop(peer_id, None) is not None:
            self._seq.pop(peer_id, None)
            self._touch(topo=True)

    # -- liveness -----------------------------------------------------------

    def heartbeat(self, peer_id: int, now: float) -> None:
        rec = self.peers.get(peer_id)
        if rec is None:
            return
        rec.last_heartbeat = now
        m = self._mirror
        if m is not None:
            i = m.index.get(peer_id)
            if i is not None:
                m.last_heartbeat[i] = now

    def heartbeat_all(self, peer_ids: Iterable[int], now: float) -> None:
        for pid in peer_ids:
            self.heartbeat(pid, now)

    def live_peers(self, now: float) -> List[PeerRecord]:
        ttl = self.cfg.node_ttl_s
        return [r for r in self.peers.values()
                if (now - r.last_heartbeat) <= ttl]

    def sweep(self, now: float, *, expire_after_s: Optional[float] = None,
              decay_rate: Optional[float] = None) -> int:
        """Vectorized TTL expiry + trust decay over the columnar mirror.

        One numpy mask per sweep: peers whose last heartbeat is older than
        ``expire_after_s`` (default ``ttl_expire_factor × node_ttl_s``;
        a factor <= 0 disables expiry) are bulk-deregistered, and the
        survivors' trust decays exponentially toward ``init_trust`` at
        ``decay_rate`` (default ``trust_decay_rate``, per second since the
        last sweep; 0 disables). O(#columns): the new mirror is built by
        array slicing (``_Mirror.from_state``) and records rematerialize
        lazily through the ``adopt_state`` machinery — no per-record
        Python loop on the sweep path. Returns the number of peers
        expired; a sweep with nothing to do leaves versions (and thus
        every snapshot/plan cache) untouched.
        """
        if expire_after_s is None:
            expire_after_s = self.cfg.ttl_expire_factor * self.cfg.node_ttl_s
        rate = self.cfg.trust_decay_rate if decay_rate is None \
            else float(decay_rate)
        dt = max(0.0, now - self._last_sweep)
        self._last_sweep = now
        m = self._ensure_mirror()
        n = len(m.peer_ids)
        if n == 0:
            return 0
        keep = ((now - m.last_heartbeat) <= expire_after_s
                if expire_after_s > 0 else np.ones(n, bool))
        n_expired = int(n - keep.sum())
        decaying = rate > 0.0 and dt > 0.0
        if n_expired == 0 and not decaying:
            return 0
        trust = m.trust[keep]
        if decaying:
            f = float(np.exp(-rate * dt))
            trust = self.cfg.init_trust + (trust - self.cfg.init_trust) * f
            np.clip(trust, self.cfg.min_trust, self.cfg.max_trust,
                    out=trust)
        state = RegistryState(
            peer_ids=m.peer_ids[keep], layer_start=m.layer_start[keep],
            layer_end=m.layer_end[keep], trust=trust,
            latency_ms=m.latency_ms[keep],
            last_heartbeat=m.last_heartbeat[keep],
            successes=m.successes[keep], failures=m.failures[keep],
            profiles=[p for p, k in zip(m.profiles, keep) if k],
        )
        self._pending_state = state
        self._peers = {}
        self.version += 1
        if n_expired:
            self.topo_version += 1
            for pid in m.peer_ids[~keep]:
                self._seq.pop(int(pid), None)
        self._mirror = _Mirror.from_state(state)
        self._table = None
        return n_expired

    # -- feedback (Alg. 1 line 16: UPDATETRUST) ------------------------------

    def apply_report(self, report: ExecReport) -> None:
        peers = self.peers
        changed = False
        for hop in report.hops:
            rec = peers.get(hop.peer_id)
            if rec is None:
                continue
            if hop.success:
                rec.latency_est_ms = T.ewma_latency(
                    rec.latency_est_ms, hop.latency_ms, self.cfg.ewma_beta)
                changed = True
        if report.success:
            for pid in report.chain:
                rec = peers.get(pid)
                if rec is not None:
                    rec.trust = T.reward(rec.trust, self.cfg)
                    rec.successes += 1
                    changed = True
        elif report.failed_peer is not None:
            rec = peers.get(report.failed_peer)
            if rec is not None:
                rec.trust = T.penalize(rec.trust, self.cfg)
                rec.failures += 1
                changed = True
        if changed:
            self._touch()

    # -- snapshotting --------------------------------------------------------

    def _ensure_mirror(self) -> _Mirror:
        if self._mirror is None:
            self._mirror = _Mirror(list(self.peers.values()))
        return self._mirror

    def snapshot(self, now: float) -> PeerTable:
        """Versioned zero-copy snapshot: same object while unchanged."""
        m = self._ensure_mirror()
        alive = (now - m.last_heartbeat) <= self.cfg.node_ttl_s
        t = self._table
        if t is not None and np.array_equal(alive, t.alive):
            # zero-copy: the table object is shared with every holder, so
            # it is never mutated here — snapshot_time stays the time its
            # CONTENT was captured (not the time of this call)
            return t
        if t is not None:
            self.version += 1      # heartbeat-expiry / revival flipped a bit
        # the registry version IS the table version: every rebuilt table is
        # preceded by >= 1 bump (_touch or the liveness flip above), so
        # distinct tables never share a version
        t = PeerTable(
            peer_ids=m.peer_ids, layer_start=m.layer_start,
            layer_end=m.layer_end, trust=m.trust, latency_ms=m.latency_ms,
            alive=alive, snapshot_time=now,
            version=self.version, topo_version=self.topo_version,
            source_id=self.registry_id,
        )
        self._table = t
        return t

    def set_trust(self, peer_id: int, trust: float) -> None:
        """Out-of-band trust write (sims/operators). Mutating records
        directly bypasses snapshot versioning — use this instead."""
        rec = self.peers.get(peer_id)
        if rec is not None:
            rec.trust = trust
            self._touch()

    def reset_trust(self) -> None:
        """Paper §VI-A: trust state is reset between algorithm runs."""
        for rec in self.peers.values():
            rec.trust = self.cfg.init_trust
            rec.latency_est_ms = self.cfg.init_latency_ms
            rec.successes = rec.failures = 0
        self._touch()

    # -- columnar replication (failover.py) ----------------------------------

    def export_state(self) -> RegistryState:
        """Column arrays of the full registry state, shared zero-copy with
        the internal mirror where safe. Only ``last_heartbeat`` is copied:
        it is the one column mutated in place (heartbeat fast path); every
        other mutation rebuilds the mirror with fresh arrays."""
        m = self._ensure_mirror()
        return RegistryState(
            peer_ids=m.peer_ids, layer_start=m.layer_start,
            layer_end=m.layer_end, trust=m.trust, latency_ms=m.latency_ms,
            last_heartbeat=m.last_heartbeat.copy(),
            successes=m.successes, failures=m.failures,
            profiles=m.profiles,
            seq=np.fromiter((self._seq[int(p)] for p in m.peer_ids),
                            np.int64, len(m.peer_ids)),
        )

    def adopt_state(self, state: RegistryState) -> None:
        """Replace this registry's contents with a replicated column-array
        state. O(#columns) — records rematerialize lazily on access. The
        seq column (when shipped) is adopted too, so a promoted backup
        continues the exporter's registration sequence."""
        self._pending_state = state
        self._peers = {}
        if state.seq is not None:
            self._seq = {int(p): int(q)
                         for p, q in zip(state.peer_ids, state.seq)}
        else:
            self._seq = {int(p): i for i, p in enumerate(state.peer_ids)}
        self._seq_next = max(self._seq.values(), default=-1) + 1
        self._touch(topo=True)

    def state_digest(self) -> int:
        """Seeded content digest of this registry's exported state —
        what digest-verified gossip attests to seekers (core/digest.py:
        covers every column ``export_state`` ships except
        ``last_heartbeat``, seq included). Cached per ``version``; every
        mutation bumps the version, so the digest follows mutation
        without per-write bookkeeping."""
        if self._digest is not None and self._digest_version == self.version:
            return self._digest
        from repro_torch.core.digest import state_digest
        m = self._ensure_mirror()
        st = RegistryState(
            peer_ids=m.peer_ids, layer_start=m.layer_start,
            layer_end=m.layer_end, trust=m.trust, latency_ms=m.latency_ms,
            last_heartbeat=m.last_heartbeat,     # untouched by the digest
            successes=m.successes, failures=m.failures,
            profiles=m.profiles,
            seq=np.fromiter((self._seq[int(p)] for p in m.peer_ids),
                            np.int64, len(m.peer_ids)),
        )
        self._digest = state_digest(st, self.cfg.sync_digest_seed)
        self._digest_version = self.version
        return self._digest

    def export_heartbeats(self) -> np.ndarray:
        """Liveness column only, in this registry's row order — the cheap
        replication payload for ticks where nothing but heartbeats moved
        (heartbeats never bump ``version``, so version-delta replication
        would otherwise let a backup's liveness go stale)."""
        return self._ensure_mirror().last_heartbeat.copy()

    def adopt_heartbeats(self, hb: np.ndarray) -> None:
        """Overwrite the liveness column from a replicated heartbeat
        payload. Caller guarantees membership matches the exporter (ship
        full state when it doesn't; a length mismatch is ignored and left
        for the next full ship to repair). Versions stay untouched,
        exactly like live heartbeat traffic.

        While records are still pending (the usual passive-backup state)
        this is O(#columns): the new column replaces the pending state's,
        so lazy materialization stays lazy and picks it up later. Only a
        registry with materialized records pays the per-record loop —
        required so a later mirror rebuild from records cannot resurrect
        stale heartbeats."""
        if self._pending_state is not None:
            st = self._pending_state
            if len(hb) != len(st.peer_ids):
                return
            col = np.array(hb, np.float64)
            # NB: the RegistryState object may be shared with sibling
            # backups that received the same ship — reassigning the field
            # hands them the identical fresh column, which is harmless
            st.last_heartbeat = col
            if self._mirror is not None:    # sweep path: mirror shares state
                self._mirror.last_heartbeat = col
            return
        m = self._ensure_mirror()
        if len(hb) != len(m.peer_ids):
            return
        m.last_heartbeat[:] = hb
        for rec, t in zip(self.peers.values(), hb):
            rec.last_heartbeat = float(t)


class SeekerCache:
    """Seeker-side cached registry view Σ̃_t with background sync (§IV-A)."""

    def __init__(self, anchor: AnchorRegistry, cfg: GTRACConfig,
                 now: float = 0.0):
        self.anchor = anchor
        self.cfg = cfg
        self.table: PeerTable = anchor.snapshot(now)
        self.last_sync: float = now
        self.syncs: int = 0

    def maybe_sync(self, now: float) -> bool:
        """Background gossip tick: refresh if T_gossip elapsed. Returns
        whether a sync happened. NEVER called on the critical path by the
        router — the engine drives it from its clock."""
        if now - self.last_sync >= self.cfg.gossip_period_s:
            self.force_sync(now)
            return True
        return False

    def force_sync(self, now: float) -> None:
        """Array-copy sync: the anchor's snapshot is already columnar and
        version-cached, so an unchanged registry costs one liveness
        compare and hands back the identical table object."""
        self.table = self.anchor.snapshot(now)
        self.last_sync = now
        self.syncs += 1

    def view(self) -> PeerTable:
        """The (stale) table used for routing decisions."""
        return self.table

    @property
    def staleness(self) -> float:
        """Age of the cached content at the time we last synced: snapshots
        are zero-copy, so an unchanged registry hands back a table whose
        ``snapshot_time`` is when its content was captured."""
        return self.last_sync - self.table.snapshot_time

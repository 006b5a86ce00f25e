"""Sharded anchor registries with composed multi-shard snapshots.

The monolithic ``AnchorRegistry`` funnels every heartbeat, trust report,
and sweep through one object — the scalability ceiling once the planner
and the window router amortize everything downstream of the
snapshot. ``ShardedAnchorRegistry`` partitions peers across S independent
``AnchorRegistry`` shards by a stable peer-id hash (or by layer-slot
affinity, so one shard owns whole stage-replica groups) and exposes the
same register / heartbeat / apply_report / sweep / snapshot surface:

* **Per-shard fan-out** — control-plane writes route to the owning shard
  in O(1) (``_home`` map); ``apply_report`` splits one execution report
  into per-shard sub-reports so each shard only touches its own records;
  ``sweep`` fans out per shard and every clean shard's sweep is a cheap
  vectorized no-op that leaves its versions (and all caches) untouched.

* **Composed snapshots** — ``compose_snapshot(now)`` carries a per-shard
  version vector: when no shard changed it returns the *identical*
  ``PeerTable`` object (the zero-copy fast path, same contract as the
  monolithic ``snapshot``); otherwise only dirty shards rebuild their
  columns (clean shards hand back their cached zero-copy tables) and the
  composition concatenates + permutes into global **registration order**.
  Registration order is what makes the composed table bit-identical to a
  monolithic registry over the same peers: the planner's stable
  tie-breaks depend on row order, so S=1 and S>1 produce byte-for-byte
  the same ``RoutePlan`` chains and costs (tests/test_sharded_registry).

* **Planner compatibility** — the composed table carries its own
  ``(source_id, version, topo_version)``: ``version`` bumps exactly once
  per rebuilt composition, ``topo_version`` exactly once per membership
  change in any shard, so ``RoutePlanner.compile`` / ``BatchRouter``
  consume a sharded registry completely unchanged.

* **Per-shard replication** — ``export_shard_state`` /
  ``adopt_shard_state`` ship one shard's columnar ``RegistryState``
  (plus its global registration-sequence column) so ``ReplicatedAnchor``
  can restore a single lost shard without copying the others.

``make_registry(cfg, shards)`` is the factory serving/sim/launch use: it
returns the plain ``AnchorRegistry`` for ``shards <= 1`` (zero overhead
on the monolithic path) and a ``ShardedAnchorRegistry`` otherwise.

Port of ``repro.core.sharding``, copied verbatim except for its imports.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.registry import _REGISTRY_IDS, AnchorRegistry
from repro_torch.core.types import ExecReport, PeerRecord, PeerTable, RegistryState

_M64 = (1 << 64) - 1


def stable_peer_hash(peer_id: int) -> int:
    """splitmix64 finalizer — deterministic across processes/runs (unlike
    ``hash``, which is salted by PYTHONHASHSEED), so every participant
    agrees on peer->shard placement without coordination."""
    z = (peer_id + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & _M64


def stable_peer_hash_vec(peer_ids: np.ndarray) -> np.ndarray:
    """Vectorized ``stable_peer_hash`` over an int64 id array — uint64
    arithmetic wraps exactly like the masked Python-int version, so
    ``stable_peer_hash_vec(ids)[i] == stable_peer_hash(ids[i])`` always
    (the batched-heartbeat bucketing path must agree with per-peer
    placement). Returns uint64."""
    with np.errstate(over="ignore"):
        z = peer_ids.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


@runtime_checkable
class Registry(Protocol):
    """The control-plane surface serving / sim / replication code against —
    satisfied by both ``AnchorRegistry`` and ``ShardedAnchorRegistry``."""

    cfg: GTRACConfig
    registry_id: int

    def register(self, peer_id: int, layer_start: int, layer_end: int,
                 now: float = 0.0, profile: str = "",
                 trust: Optional[float] = None,
                 latency_ms: Optional[float] = None) -> PeerRecord: ...

    def deregister(self, peer_id: int) -> None: ...

    def heartbeat(self, peer_id: int, now: float) -> None: ...

    def heartbeat_all(self, peer_ids: Iterable[int], now: float) -> None: ...

    def live_peers(self, now: float) -> List[PeerRecord]: ...

    def sweep(self, now: float, *, expire_after_s: Optional[float] = None,
              decay_rate: Optional[float] = None) -> int: ...

    def apply_report(self, report: ExecReport) -> None: ...

    def snapshot(self, now: float) -> PeerTable: ...

    def set_trust(self, peer_id: int, trust: float) -> None: ...

    def reset_trust(self) -> None: ...


def make_registry(cfg: GTRACConfig, shards: int = 1,
                  shard_by: str = "peer",
                  backend: Optional[str] = None) -> Registry:
    """Factory: monolithic anchor for ``shards <= 1``, sharded otherwise.

    ``backend`` (default: ``cfg.control_plane``) selects where the shards
    live: ``"inproc"`` returns the in-process registries above;
    ``"procs"`` returns a ``ProcessShardedRegistry`` — every shard in its
    own worker process behind the RPC control plane
    (src/repro_torch/control_plane/), same surface, composed snapshots
    bit-identical. Imported lazily so the in-process path never pays for
    multiprocessing machinery."""
    if backend is None:
        backend = getattr(cfg, "control_plane", "inproc")
    if backend == "procs":
        from repro_torch.control_plane.registry import ProcessShardedRegistry
        return ProcessShardedRegistry(cfg, n_shards=max(1, int(shards)),
                                      shard_by=shard_by)
    if backend != "inproc":
        raise ValueError(f"control_plane backend must be 'inproc' or "
                         f"'procs', got {backend!r}")
    if shards <= 1:
        return AnchorRegistry(cfg)
    return ShardedAnchorRegistry(cfg, n_shards=shards, shard_by=shard_by)


class ShardedAnchorRegistry:
    """S ``AnchorRegistry`` shards behind the monolithic registry surface.

    ``shard_by="peer"`` places each peer by ``stable_peer_hash(peer_id)``
    (uniform fan-in spread); ``shard_by="layer"`` hashes the peer's
    ``layer_start`` instead, giving layer-slot affinity — every replica of
    one stage slot lands on the same shard, so a stage-local sweep or
    report touches exactly one shard.
    """

    def __init__(self, cfg: GTRACConfig, n_shards: int = 4,
                 shard_by: str = "peer"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if shard_by not in ("peer", "layer"):
            raise ValueError(f"shard_by must be 'peer' or 'layer', "
                             f"got {shard_by!r}")
        self.cfg = cfg
        self.n_shards = int(n_shards)
        self.shard_by = shard_by
        self.shards: List[AnchorRegistry] = [AnchorRegistry(cfg)
                                             for _ in range(self.n_shards)]
        self.registry_id = next(_REGISTRY_IDS)
        # shards whose state was lost (lose_shard) and not yet restored:
        # replication must not ship these, or it would overwrite the
        # backups' last good copy with the emptied state
        self.lost_shards: set = set()
        # global registration order: seq[pid] is the peer's arrival index;
        # the composed snapshot permutes concatenated shard columns into
        # seq order so it is bit-identical to a monolithic registry.
        self._seq: Dict[int, int] = {}
        self._seq_next = 0
        self._home: Dict[int, int] = {}    # peer_id -> owning shard index
        # composed-snapshot cache, keyed on the per-shard version vector;
        # _hb is a write-through copy of the composed last-heartbeat column
        # (updated in place by heartbeat()) so the no-change fast path is
        # ONE vectorized liveness check — the same cost as the monolithic
        # snapshot, independent of S. version/topo generation counters are
        # bumped per rebuilt composition so distinct tables never share a
        # version.
        self._composed: Optional[PeerTable] = None
        self._version_vec: Optional[Tuple[int, ...]] = None
        self._hb: Optional[np.ndarray] = None      # (P,) composed heartbeat
        self._row: Dict[int, int] = {}             # peer_id -> composed row
        self._gen = 0
        self._topo_gen = 0
        self._topo_key: Optional[Tuple[int, ...]] = None
        self._perm: Optional[np.ndarray] = None
        self._perm_key: Optional[Tuple[int, ...]] = None
        # per-shard content digests (core/digest.py) cached against each
        # shard's version; computed over export_shard_state — i.e. with
        # the GLOBAL seq column, the same rows a seeker mirrors
        self._digests: List[Optional[int]] = [None] * self.n_shards
        self._digest_keys: List[int] = [-1] * self.n_shards

    # -- placement -----------------------------------------------------------

    def shard_of(self, peer_id: int, layer_start: Optional[int] = None)\
            -> int:
        """Shard index a (new) peer is placed on. Existing peers route via
        the authoritative ``_home`` map (``owner_of``)."""
        if self.shard_by == "layer":
            if layer_start is None:
                raise ValueError("layer affinity placement needs layer_start")
            return stable_peer_hash(int(layer_start)) % self.n_shards
        return stable_peer_hash(int(peer_id)) % self.n_shards

    def owner_of(self, peer_id: int) -> Optional[int]:
        """Owning shard index for a registered peer (None if unknown)."""
        return self._home.get(peer_id)

    @property
    def version_vector(self) -> Tuple[int, ...]:
        """Per-shard registry versions — the staleness vector the composed
        snapshot is keyed on."""
        return tuple(sh.version for sh in self.shards)

    @property
    def topo_vector(self) -> Tuple[int, ...]:
        return tuple(sh.topo_version for sh in self.shards)

    @property
    def version(self) -> int:
        """Composed-snapshot generation (bumps once per rebuilt table)."""
        return self._gen

    @property
    def topo_version(self) -> int:
        return self._topo_gen

    # -- membership ----------------------------------------------------------

    def register(self, peer_id: int, layer_start: int, layer_end: int,
                 now: float = 0.0, profile: str = "",
                 trust: Optional[float] = None,
                 latency_ms: Optional[float] = None) -> PeerRecord:
        s = self.shard_of(peer_id, layer_start)
        prev = self._home.get(peer_id)
        # "present" = still registered somewhere (the _home entry may be
        # stale after a TTL sweep expired the peer inside its shard)
        present = prev is not None and peer_id in self.shards[prev].peers
        if present and prev != s:
            # layer-affinity re-registration moved the peer across shards;
            # like the monolithic dict, an in-place re-register keeps its
            # registration position — only the owning shard changes
            self.shards[prev].deregister(peer_id)
        if not present:
            # fresh arrival (first registration, or returning after a
            # deregister / TTL expiry): appended at the end, exactly like
            # re-inserting into the monolithic registry's dict
            self._seq[peer_id] = self._seq_next
            self._seq_next += 1
        self._home[peer_id] = s
        return self.shards[s].register(peer_id, layer_start, layer_end,
                                       now=now, profile=profile,
                                       trust=trust, latency_ms=latency_ms)

    def deregister(self, peer_id: int) -> None:
        s = self._home.pop(peer_id, None)
        self._seq.pop(peer_id, None)
        if s is not None:
            self.shards[s].deregister(peer_id)

    # -- liveness ------------------------------------------------------------

    def heartbeat(self, peer_id: int, now: float) -> None:
        s = self._home.get(peer_id)
        if s is not None:
            self.shards[s].heartbeat(peer_id, now)
            if self._hb is not None:    # write-through composed column
                i = self._row.get(peer_id)
                if i is not None:
                    self._hb[i] = now

    def heartbeat_all(self, peer_ids: Iterable[int], now: float) -> None:
        for pid in peer_ids:
            self.heartbeat(pid, now)

    def live_peers(self, now: float) -> List[PeerRecord]:
        recs = [r for sh in self.shards for r in sh.live_peers(now)]
        recs.sort(key=lambda r: self._seq.get(r.peer_id, r.peer_id))
        return recs

    def sweep(self, now: float, *, expire_after_s: Optional[float] = None,
              decay_rate: Optional[float] = None) -> int:
        """Per-shard sweep fan-out. Each shard's sweep is the vectorized
        O(#columns) TTL-expiry + trust-decay pass; a shard with nothing to
        do returns without touching its versions, so clean shards stay
        zero-copy in the next composed snapshot — only dirty shards'
        columns rebuild. Returns total peers expired across shards."""
        return sum(sh.sweep(now, expire_after_s=expire_after_s,
                            decay_rate=decay_rate)
                   for sh in self.shards)

    # -- feedback ------------------------------------------------------------

    def apply_report(self, report: ExecReport) -> None:
        """Split one execution report into per-shard sub-reports: each
        shard receives only the hops / chain peers / failure it owns, so
        the trust update fans out without any shard scanning foreign ids."""
        touched: Dict[int, Tuple[list, list]] = {}   # s -> (hops, chain)

        def bucket(s: int) -> Tuple[list, list]:
            got = touched.get(s)
            if got is None:
                got = touched[s] = ([], [])
            return got

        for hop in report.hops:
            s = self._home.get(hop.peer_id)
            if s is not None:
                bucket(s)[0].append(hop)
        if report.success:
            for pid in report.chain:
                s = self._home.get(pid)
                if s is not None:
                    bucket(s)[1].append(pid)
        failed_shard = (self._home.get(report.failed_peer)
                        if report.failed_peer is not None else None)
        if failed_shard is not None:
            bucket(failed_shard)
        for s, (hops, chain) in touched.items():
            self.shards[s].apply_report(ExecReport(
                success=report.success, chain=chain, hops=hops,
                failed_peer=(report.failed_peer
                             if s == failed_shard else None)))

    def set_trust(self, peer_id: int, trust: float) -> None:
        s = self._home.get(peer_id)
        if s is not None:
            self.shards[s].set_trust(peer_id, trust)

    def reset_trust(self) -> None:
        for sh in self.shards:
            sh.reset_trust()

    # -- record access -------------------------------------------------------

    @property
    def peers(self) -> Dict[int, PeerRecord]:
        """Merged record view in global registration order. Control-plane /
        test convenience only — the merged dict is rebuilt per access; the
        records themselves are the shards' live objects."""
        items = [(pid, rec) for sh in self.shards
                 for pid, rec in sh.peers.items()]
        items.sort(key=lambda pr: self._seq.get(pr[0], pr[0]))
        return dict(items)

    def __len__(self) -> int:
        return sum(len(sh.peers) for sh in self.shards)

    # -- composed snapshots --------------------------------------------------

    def snapshot(self, now: float) -> PeerTable:
        return self.compose_snapshot(now)

    def compose_snapshot(self, now: float) -> PeerTable:
        """Zero-copy composed snapshot over the per-shard version vector.

        Fast path (no shard mutated since the last composition, i.e. the
        version vector is unchanged): ONE vectorized liveness check over
        the write-through composed heartbeat column — identical table
        object back when nothing flipped, or a new table sharing every
        column but ``alive`` on a pure liveness flip. The cost matches the
        monolithic ``snapshot`` regardless of S; no per-shard calls.

        Slow path (some shard registered / expired / applied trust): each
        shard's own zero-copy ``snapshot`` is taken — only *dirty* shards
        rebuild their columns — and the composition concatenates and
        permutes them into global registration order. The permutation is
        cached against the per-shard topo vector, so pure trust / latency
        changes skip the argsort.

        As with the monolithic registry, heartbeats must go through
        ``heartbeat()`` (the write-through column is how the fast path
        sees them); out-of-band writes to shard internals are invisible
        until that shard's version bumps."""
        c = self._composed
        if (c is not None and self._hb is not None
                and self.version_vector == self._version_vec):
            alive = (now - self._hb) <= self.cfg.node_ttl_s
            if np.array_equal(alive, c.alive):
                return c
            # pure liveness flip: new table shares every column but alive
            self._gen += 1
            c = PeerTable(
                peer_ids=c.peer_ids, layer_start=c.layer_start,
                layer_end=c.layer_end, trust=c.trust,
                latency_ms=c.latency_ms, alive=alive, snapshot_time=now,
                version=self._gen, topo_version=self._topo_gen,
                source_id=self.registry_id,
            )
            self._composed = c
            return c
        tables = [sh.snapshot(now) for sh in self.shards]
        topo_key = self.topo_vector
        topo_changed = topo_key != self._topo_key
        if topo_changed:
            self._topo_gen += 1
            self._topo_key = topo_key
        self._gen += 1
        perm = self._permutation(tables, topo_key)
        composed = PeerTable(
            peer_ids=np.concatenate([t.peer_ids for t in tables])[perm],
            layer_start=np.concatenate([t.layer_start for t in tables])[perm],
            layer_end=np.concatenate([t.layer_end for t in tables])[perm],
            trust=np.concatenate([t.trust for t in tables])[perm],
            latency_ms=np.concatenate([t.latency_ms for t in tables])[perm],
            alive=np.concatenate([t.alive for t in tables])[perm],
            snapshot_time=now,
            version=self._gen,
            topo_version=self._topo_gen,
            source_id=self.registry_id,
        )
        # snapshot() above may bump shard versions (liveness flips), so the
        # vector is captured after; the heartbeat column is copied out of
        # the shard mirrors and kept in sync by heartbeat() write-through
        self._version_vec = self.version_vector
        self._hb = np.concatenate(
            [sh._ensure_mirror().last_heartbeat for sh in self.shards])[perm]
        if topo_changed or len(self._row) != len(composed.peer_ids):
            # row map only moves with membership; trust-only recompositions
            # keep the permutation and skip the O(P) dict rebuild
            self._row = {int(p): i for i, p in enumerate(composed.peer_ids)}
        self._composed = composed
        return composed

    def _permutation(self, tables: List[PeerTable],
                     topo_key: Tuple[int, ...]) -> np.ndarray:
        if self._perm is not None and self._perm_key == topo_key:
            return self._perm
        if tables:
            ids = np.concatenate([t.peer_ids for t in tables])
        else:
            ids = np.empty(0, np.int64)
        seq = np.fromiter((self._seq[int(p)] for p in ids), np.int64,
                          len(ids))
        self._perm = np.argsort(seq, kind="stable")
        self._perm_key = topo_key
        # membership just changed: drop seq/home entries for peers that
        # are gone (TTL-swept shards can't tell us *which* ids they
        # expired, so stale bookkeeping is pruned here, off the hot path)
        present = {int(p) for p in ids}
        for stale in [pid for pid in self._seq if pid not in present]:
            self._seq.pop(stale, None)
            self._home.pop(stale, None)
        return self._perm

    # -- per-shard columnar replication (failover.py) ------------------------

    def export_shard_state(self, shard: int) -> RegistryState:
        """One shard's columnar state + its global registration-seq column.
        O(#columns) — this is what per-shard replication ships, so a
        backup promoting ONE lost shard never copies the other S-1."""
        st = self.shards[shard].export_state()
        st.seq = np.fromiter((self._seq[int(p)] for p in st.peer_ids),
                             np.int64, len(st.peer_ids))
        return st

    def shard_digest(self, shard: int) -> int:
        """One shard's content digest over the state a seeker mirrors
        (``export_shard_state``: shard rows + global seq). The inner
        ``AnchorRegistry.state_digest`` digests the shard's LOCAL seq
        stamps, which a mirror never sees — so the sharded registry
        keeps its own per-shard digest cache keyed on shard version."""
        sh = self.shards[shard]
        key = sh.version
        if self._digests[shard] is not None \
                and self._digest_keys[shard] == key:
            return self._digests[shard]
        from repro_torch.core.digest import state_digest
        d = state_digest(self.export_shard_state(shard),
                         self.cfg.sync_digest_seed)
        self._digests[shard] = d
        self._digest_keys[shard] = key
        return d

    def digest_vector(self) -> Tuple[int, ...]:
        """Per-shard digests, aligned with ``version_vector`` — the
        attestation payload digest-verified gossip pushes to seekers."""
        return tuple(self.shard_digest(s) for s in range(self.n_shards))

    def adopt_shard_state(self, shard: int, state: RegistryState) -> None:
        """Replace one shard's contents from a replicated per-shard state
        (records rematerialize lazily). The other shards are untouched."""
        self.lost_shards.discard(shard)
        self.shards[shard].adopt_state(state)
        self._home = {pid: s for pid, s in self._home.items() if s != shard}
        self._seq = {pid: q for pid, q in self._seq.items()
                     if self._home.get(pid) is not None}
        for i, pid in enumerate(state.peer_ids):
            pid = int(pid)
            self._home[pid] = shard
            self._seq[pid] = (int(state.seq[i]) if state.seq is not None
                              else self._seq_next + i)
        if self._seq:
            self._seq_next = max(self._seq_next,
                                 max(self._seq.values()) + 1)

    def export_shard_heartbeats(self, shard: int) -> np.ndarray:
        """One shard's liveness column (clean-shard replication payload:
        heartbeats never bump shard versions, so version-delta ticks ship
        this instead of going silent and letting backups expire peers)."""
        return self.shards[shard].export_heartbeats()

    def adopt_shard_heartbeats(self, shard: int, hb: np.ndarray) -> None:
        """Refresh one shard's liveness column from the primary. The
        composed-snapshot cache is invalidated (not patched): adopted
        heartbeats bypass ``heartbeat()``'s write-through, so the next
        compose must take the slow path and reread the shard mirrors."""
        self.shards[shard].adopt_heartbeats(hb)
        self._version_vec = None

    def lose_shard(self, shard: int) -> int:
        """Simulate losing one shard's state (process crash): the shard is
        emptied in place (version-bumped, caches invalidated) and marked
        in ``lost_shards`` so replication ticks skip it — a gossip tick
        firing between loss and recovery must not overwrite the backups'
        last good copy with the emptied state. Returns the number of
        peers lost. ``ReplicatedAnchor.restore_shard`` brings the shard
        back from a backup without touching the surviving shards."""
        lost = len(self.shards[shard].peers)
        empty = RegistryState(
            peer_ids=np.empty(0, np.int64),
            layer_start=np.empty(0, np.int32),
            layer_end=np.empty(0, np.int32),
            trust=np.empty(0, np.float64),
            latency_ms=np.empty(0, np.float64),
            last_heartbeat=np.empty(0, np.float64),
            successes=np.empty(0, np.int64),
            failures=np.empty(0, np.int64),
            profiles=[],
            seq=np.empty(0, np.int64),
        )
        self.adopt_shard_state(shard, empty)
        self.lost_shards.add(shard)
        return lost

    # -- whole-registry columnar replication ---------------------------------

    def export_state(self) -> RegistryState:
        """All shards' state as one columnar payload in registration order
        (seq column included), for monolithic-style full replication."""
        states = [self.export_shard_state(s) for s in range(self.n_shards)]
        seq = np.concatenate([st.seq for st in states])
        perm = np.argsort(seq, kind="stable")
        profiles: List[str] = list(itertools.chain.from_iterable(
            st.profiles for st in states))
        return RegistryState(
            peer_ids=np.concatenate([st.peer_ids for st in states])[perm],
            layer_start=np.concatenate(
                [st.layer_start for st in states])[perm],
            layer_end=np.concatenate([st.layer_end for st in states])[perm],
            trust=np.concatenate([st.trust for st in states])[perm],
            latency_ms=np.concatenate([st.latency_ms for st in states])[perm],
            last_heartbeat=np.concatenate(
                [st.last_heartbeat for st in states])[perm],
            successes=np.concatenate([st.successes for st in states])[perm],
            failures=np.concatenate([st.failures for st in states])[perm],
            profiles=[profiles[i] for i in perm],
            seq=seq[perm],
        )

    def adopt_state(self, state: RegistryState) -> None:
        """Re-partition a full columnar state across this registry's
        shards (hash or layer-affinity placement, seq column preserved)."""
        n = len(state.peer_ids)
        rows_by_shard: List[List[int]] = [[] for _ in range(self.n_shards)]
        for i in range(n):
            s = self.shard_of(int(state.peer_ids[i]),
                              int(state.layer_start[i]))
            rows_by_shard[s].append(i)
        for s, rows in enumerate(rows_by_shard):
            idx = np.asarray(rows, np.int64)
            self.adopt_shard_state(s, RegistryState(
                peer_ids=state.peer_ids[idx],
                layer_start=state.layer_start[idx],
                layer_end=state.layer_end[idx],
                trust=state.trust[idx],
                latency_ms=state.latency_ms[idx],
                last_heartbeat=state.last_heartbeat[idx],
                successes=state.successes[idx],
                failures=state.failures[idx],
                profiles=[state.profiles[i] for i in rows],
                seq=(state.seq[idx] if state.seq is not None
                     else idx.copy()),
            ))

"""Composer: the process-backed sharded anchor registry.

``ProcessShardedRegistry`` exposes the same control-plane surface as
``ShardedAnchorRegistry`` (core/sharding.py) — register / heartbeat /
apply_report / sweep / snapshot / per-shard replication — but every
shard lives in its own worker process (control_plane/worker.py) behind
an ``RpcChannel`` (control_plane/rpc.py). The composer keeps one
``sync.seeker.SeekerCache`` as its local mirror: each ``sync(now)``
round pulls a ``ShardDelta`` (+ fresh heartbeat column) per shard and
``materialize`` composes the mirrors with the same stable seq argsort
as ``compose_snapshot`` — so a synced composer snapshot is bit-identical
to the in-process twin over the same operation sequence.

Ordering contract: heartbeats are buffered composer-side and flushed as
batched per-shard commands, but ALWAYS before any other command posts to
that shard — so the worker applies every operation in exactly the order
the caller issued it, and parity with the in-process twin is exact, not
just eventual.

Failure semantics (the robustness core):

* every RPC runs under ``RpcPolicy`` — deadline, bounded retries,
  exponential backoff on an injectable clock (deterministic tests);
* a shard that exhausts its retries (or whose process died) is
  **degraded**: its mirror serves the last synced slice, writes to it
  are dropped (and counted), and each sync probes it once (no retries)
  — the window cadence never blocks on a sick shard. Staleness is
  priced by ``routing_view``'s existing discount machinery, because the
  degraded shard's staleness clock simply stops being refreshed;
* a SIGKILLed worker is detected (``dead_workers``), ``restart_worker``
  respawns it and restores state — from the composer's own mirror by
  default, or from a ``ReplicatedAnchor`` ledger via
  ``adopt_shard_state`` — and the fresh worker re-adopts through the
  delta protocol's full-sync fallback (mirror invalidated, next pull
  ships the whole shard), so no window ever sees an empty slice.

Cross-shard moves while the previous owner is unreachable leave a
tombstone row on the sick shard (the release RPC cannot run); the TTL
sweep expires it after recovery, exactly like any silent peer.

Port of ``repro.control_plane.registry``, copied verbatim except for its
imports: it holds no JAX, and the port keeps its own copy rather than
importing the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.registry import _REGISTRY_IDS
from repro_torch.core.sharding import stable_peer_hash, stable_peer_hash_vec
from repro_torch.core.types import ExecReport, PeerRecord, PeerTable, RegistryState
from repro_torch.sync.delta import DeltaGapError, copy_state
from repro_torch.sync.seeker import SeekerCache

from repro_torch.control_plane.rpc import (
    Clock,
    RpcChannel,
    RpcPolicy,
    RpcStats,
    RpcTimeout,
    SystemClock,
    WorkerDown,
)
from repro_torch.control_plane.worker import ProcWorker


@dataclass
class ControlPlaneHealth(RpcStats):
    """RPC counters + composer-level robustness counters, shared with
    every channel so aggregation is free."""

    degraded_windows: int = 0   # syncs served with >= 1 degraded/dead shard
    worker_restarts: int = 0
    dropped_writes: int = 0     # writes discarded against sick shards
    full_resyncs: int = 0       # gap / regression repairs via full pull


class ProcessShardedRegistry:
    """S shard worker processes behind the sharded-registry surface."""

    def __init__(self, cfg: GTRACConfig, n_shards: int = 4,
                 shard_by: str = "peer",
                 policy: Optional[RpcPolicy] = None,
                 clock: Optional[Clock] = None,
                 transport_factory: Optional[Callable[[int], object]] = None,
                 start_method: Optional[str] = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if shard_by not in ("peer", "layer"):
            raise ValueError(f"shard_by must be 'peer' or 'layer', "
                             f"got {shard_by!r}")
        self.cfg = cfg
        self.n_shards = int(n_shards)
        self.shard_by = shard_by
        self.registry_id = next(_REGISTRY_IDS)
        self.policy = policy if policy is not None \
            else RpcPolicy.from_config(cfg)
        self.clock: Clock = clock if clock is not None else SystemClock()
        self.health = ControlPlaneHealth()
        if transport_factory is None:
            transport_factory = lambda s: ProcWorker(  # noqa: E731
                cfg, s, start_method=start_method)
        self._factory = transport_factory
        self.channels: List[RpcChannel] = [
            RpcChannel(transport_factory(s), self.policy, self.clock,
                       stats=self.health, channel_id=s)
            for s in range(self.n_shards)]
        # the composer's local shard mirrors — materialize() is the
        # composed snapshot, routing_view() the staleness-priced table
        self.mirror = SeekerCache(cfg, self.n_shards, now=0.0)
        self._home: Dict[int, int] = {}    # peer_id -> owning shard
        self._seq_next = 0                 # global registration counter
        self.degraded: set = set()         # shards with exhausted retries
        self._dead: set = set()            # shards whose process died
        self.lost_shards: set = set()      # surface parity (failover.tick)
        self._hb_buf: List[List[Tuple[np.ndarray, float]]] = \
            [[] for _ in range(self.n_shards)]
        self._prune_home = False
        self._closed = False

    # -- observability -------------------------------------------------------

    def set_tracer(self, tracer) -> None:
        """Attach an ``obs.trace`` tracer (rpc clock domain) to every
        channel — restarted workers' replacement channels inherit it via
        this same attribute (``restart_worker`` copies ``self.tracer``)."""
        self.tracer = tracer
        for ch in self.channels:
            ch.tracer = tracer

    # -- placement -----------------------------------------------------------

    def shard_of(self, peer_id: int,
                 layer_start: Optional[int] = None) -> int:
        if self.shard_by == "layer":
            if layer_start is None:
                raise ValueError("layer affinity placement needs layer_start")
            return stable_peer_hash(int(layer_start)) % self.n_shards
        return stable_peer_hash(int(peer_id)) % self.n_shards

    def owner_of(self, peer_id: int) -> Optional[int]:
        return self._home.get(peer_id)

    def _unavailable(self, shard: int) -> bool:
        return shard in self.degraded or shard in self._dead

    def _degrade(self, shard: int) -> None:
        self.degraded.add(shard)
        if not self.channels[shard].transport.alive():
            self._dead.add(shard)

    # -- RPC plumbing --------------------------------------------------------

    def _rpc(self, shard: int, op: str, *args,
             policy: Optional[RpcPolicy] = None):
        """Ordered synchronous RPC: buffered heartbeats for the shard
        flush first, so the worker sees operations in issue order."""
        self._flush_shard(shard)
        return self.channels[shard].request(op, *args, policy=policy)

    def _try_rpc(self, shard: int, op: str, *args) -> Tuple[bool, object]:
        try:
            return True, self._rpc(shard, op, *args)
        except (RpcTimeout, WorkerDown):
            self._degrade(shard)
            return False, None

    # -- membership ----------------------------------------------------------

    def _local_record(self, pid: int, layer_start: int, layer_end: int,
                      now: float, profile: str, trust, latency_ms)\
            -> PeerRecord:
        """Degraded-path register result: the record the worker WOULD
        have built — callers keep their contract, the write is dropped."""
        return PeerRecord(
            peer_id=pid, layer_start=layer_start, layer_end=layer_end,
            trust=self.cfg.init_trust if trust is None else trust,
            latency_est_ms=(self.cfg.init_latency_ms
                            if latency_ms is None else latency_ms),
            last_heartbeat=now, profile=profile)

    def register(self, peer_id: int, layer_start: int, layer_end: int,
                 now: float = 0.0, profile: str = "",
                 trust: Optional[float] = None,
                 latency_ms: Optional[float] = None) -> PeerRecord:
        pid = int(peer_id)
        s = self.shard_of(pid, layer_start)
        prev = self._home.get(pid)
        forced_seq: Optional[int] = None
        if prev is not None and prev != s and not self._unavailable(prev):
            # cross-shard move: the previous owner surrenders the peer's
            # seq stamp (dict semantics — a re-register keeps its row
            # position); a stale _home entry (TTL-swept) reports absent
            ok, rel = self._try_rpc(prev, "release", pid)
            if ok and rel[0]:
                forced_seq = int(rel[1])
        if self._unavailable(s):
            self.health.dropped_writes += 1
            return self._local_record(pid, layer_start, layer_end, now,
                                      profile, trust, latency_ms)
        candidate = self._seq_next
        ok, reply = self._try_rpc(s, "register", pid, int(layer_start),
                                  int(layer_end), float(now), profile,
                                  trust, latency_ms, candidate, forced_seq)
        if not ok:
            self.health.dropped_writes += 1
            return self._local_record(pid, layer_start, layer_end, now,
                                      profile, trust, latency_ms)
        fresh, rec = reply
        if fresh:
            self._seq_next = candidate + 1
        if forced_seq is not None:
            self._seq_next = max(self._seq_next, forced_seq + 1)
        self._home[pid] = s
        return rec

    def deregister(self, peer_id: int) -> None:
        pid = int(peer_id)
        s = self._home.pop(pid, None)
        if s is None:
            return
        if self._unavailable(s):
            self.health.dropped_writes += 1
            return
        ok, _ = self._try_rpc(s, "deregister", pid)
        if not ok:
            self.health.dropped_writes += 1

    # -- liveness (buffered, batched) ----------------------------------------

    def _shard_for_hb(self, peer_id: int) -> Optional[int]:
        if self.shard_by == "peer":
            # placement is pure hash: no _home lookup needed, and a
            # heartbeat for an unknown peer no-ops at the worker exactly
            # like the twin's _home miss
            return stable_peer_hash(int(peer_id)) % self.n_shards
        return self._home.get(int(peer_id))

    def heartbeat(self, peer_id: int, now: float) -> None:
        s = self._shard_for_hb(peer_id)
        if s is None:
            return
        self._hb_buf[s].append(
            (np.asarray([int(peer_id)], np.int64), float(now)))

    def heartbeat_all(self, peer_ids, now: float) -> None:
        ids = np.asarray(peer_ids if isinstance(peer_ids, np.ndarray)
                         else list(peer_ids), np.int64)
        if ids.size == 0:
            return
        if self.shard_by == "peer":
            sh = (stable_peer_hash_vec(ids)
                  % np.uint64(self.n_shards)).astype(np.int64)
            for s in range(self.n_shards):
                sel = ids[sh == s]
                if sel.size:
                    self._hb_buf[s].append((sel, float(now)))
        else:
            by: Dict[int, List[int]] = {}
            for pid in ids:
                s = self._home.get(int(pid))
                if s is not None:
                    by.setdefault(s, []).append(int(pid))
            for s, lst in by.items():
                self._hb_buf[s].append(
                    (np.asarray(lst, np.int64), float(now)))

    @staticmethod
    def _merged(buf: List[Tuple[np.ndarray, float]])\
            -> List[Tuple[np.ndarray, float]]:
        """Coalesce adjacent same-stamp batches into one command."""
        merged: List[Tuple[np.ndarray, float]] = []
        for ids, t in buf:
            if merged and merged[-1][1] == t:
                merged[-1] = (np.concatenate([merged[-1][0], ids]), t)
            else:
                merged.append((ids, t))
        return merged

    def _flush_shard(self, shard: int) -> None:
        buf = self._hb_buf[shard]
        if not buf:
            return
        self._hb_buf[shard] = []
        if self._unavailable(shard):
            self.health.dropped_writes += len(buf)
            return
        ch = self.channels[shard]
        rids = [ch.post("heartbeats", ids, t) for ids, t in
                self._merged(buf)]
        for rid in rids:
            try:
                ch.collect(rid)
            except (RpcTimeout, WorkerDown):
                self._degrade(shard)
                return

    def flush_heartbeats(self) -> None:
        """Flush every shard's buffered heartbeats, pipelined: all
        commands post before any reply is collected — the fan-in path
        the bench gates."""
        posted: List[Tuple[int, List[int]]] = []
        for s in range(self.n_shards):
            buf = self._hb_buf[s]
            if not buf:
                continue
            self._hb_buf[s] = []
            if self._unavailable(s):
                self.health.dropped_writes += len(buf)
                continue
            ch = self.channels[s]
            posted.append((s, [ch.post("heartbeats", ids, t)
                               for ids, t in self._merged(buf)]))
        for s, rids in posted:
            for rid in rids:
                try:
                    self.channels[s].collect(rid)
                except (RpcTimeout, WorkerDown):
                    self._degrade(s)
                    break

    def live_peers(self, now: float) -> List[PeerRecord]:
        ttl = self.cfg.node_ttl_s
        return [r for r in self.peers.values()
                if (now - r.last_heartbeat) <= ttl]

    # -- feedback ------------------------------------------------------------

    def apply_report(self, report: ExecReport) -> None:
        """Split into per-shard sub-reports (same bucketing as the
        in-process twin), pipelined across the touched shards."""
        touched: Dict[int, Tuple[list, list]] = {}

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
        posted: List[Tuple[int, int]] = []
        for s, (hops, chain) in touched.items():
            if self._unavailable(s):
                self.health.dropped_writes += 1
                continue
            self._flush_shard(s)
            sub = ExecReport(success=report.success, chain=chain, hops=hops,
                             failed_peer=(report.failed_peer
                                          if s == failed_shard else None))
            posted.append((s, self.channels[s].post("apply_report", sub)))
        for s, rid in posted:
            try:
                self.channels[s].collect(rid)
            except (RpcTimeout, WorkerDown):
                self._degrade(s)

    def sweep(self, now: float, *,
              expire_after_s: Optional[float] = None,
              decay_rate: Optional[float] = None) -> int:
        self.flush_heartbeats()
        posted: List[Tuple[int, int]] = []
        for s in range(self.n_shards):
            if self._unavailable(s):
                continue
            posted.append((s, self.channels[s].post(
                "sweep", float(now), expire_after_s, decay_rate)))
        total = 0
        for s, rid in posted:
            try:
                total += int(self.channels[s].collect(rid))
            except (RpcTimeout, WorkerDown):
                self._degrade(s)
        if total:
            self._prune_home = True
        return total

    def set_trust(self, peer_id: int, trust: float) -> None:
        s = self._home.get(int(peer_id))
        if s is None:
            return
        if self._unavailable(s):
            self.health.dropped_writes += 1
            return
        self._try_rpc(s, "set_trust", int(peer_id), float(trust))

    def reset_trust(self) -> None:
        for s in range(self.n_shards):
            if self._unavailable(s):
                self.health.dropped_writes += 1
                continue
            self._try_rpc(s, "reset_trust")

    # -- sync / composed snapshots -------------------------------------------

    @property
    def _probe_policy(self) -> RpcPolicy:
        """Degraded shards get ONE attempt per sync — a recovery probe
        that cannot stall the window cadence with backoff loops."""
        return RpcPolicy(timeout_s=self.policy.timeout_s, retries=0,
                         backoff_base_s=self.policy.backoff_base_s,
                         backoff_factor=self.policy.backoff_factor)

    def _check_workers(self) -> None:
        for s, ch in enumerate(self.channels):
            if s not in self._dead and not ch.transport.alive():
                self._dead.add(s)
                self.degraded.add(s)

    def _apply_pull(self, shard: int, delta, hb, now: float) -> None:
        cur = self.mirror.version_vector[shard]
        if delta.is_full and -1 < delta.new_version < cur:
            # version regression: the worker restarted behind our mirror
            # (it should come back through adopt_shard_state, but a full
            # ship must never be silently absorbed as a duplicate)
            self.health.full_resyncs += 1
            self.mirror.invalidate_shard(shard)
        try:
            self.mirror.apply(delta, now)
        except DeltaGapError:
            self.health.full_resyncs += 1
            delta, hb = self.channels[shard].request("pull", -1)
            if delta.is_full and delta.new_version < \
                    self.mirror.version_vector[shard]:
                self.mirror.invalidate_shard(shard)
            self.mirror.apply(delta, now)
        if delta.is_full or len(delta.removed_ids):
            self._prune_home = True
        self.mirror.refresh_heartbeats(shard, np.asarray(hb, np.float64),
                                       now)
        # refresh only this shard's staleness clock
        self.mirror.observe(self.mirror.version_vector, now,
                            reachable=[i == shard
                                       for i in range(self.n_shards)])

    def sync(self, now: float) -> None:
        """One composer round: flush writes, pull a delta (+ fresh
        heartbeat column) from every reachable shard, degrade the rest.
        Never blocks the cadence on a sick shard beyond its (bounded)
        probe."""
        self._check_workers()
        self.flush_heartbeats()
        posted: List[Tuple[int, int]] = []
        for s in range(self.n_shards):
            if s in self._dead:
                continue
            posted.append((s, self.channels[s].post(
                "pull", int(self.mirror.version_vector[s]))))
        for s, rid in posted:
            pol = self._probe_policy if s in self.degraded else None
            try:
                delta, hb = self.channels[s].collect(rid, policy=pol)
            except (RpcTimeout, WorkerDown):
                self._degrade(s)
                continue
            self._apply_pull(s, delta, hb, now)
            self.degraded.discard(s)
        if self.degraded or self._dead:
            self.health.degraded_windows += 1
        if self._prune_home:
            self._do_prune_home()

    def _do_prune_home(self) -> None:
        """Drop _home entries for peers no reachable mirror contains
        (TTL sweeps expire rows worker-side; sick shards keep theirs —
        we cannot tell what a shard we can't talk to still holds)."""
        self._prune_home = False
        present = [set(int(p) for p in self.mirror.mirror(s).peer_ids)
                   for s in range(self.n_shards)]
        sick = self.degraded | self._dead
        self._home = {pid: s for pid, s in self._home.items()
                      if s in sick or pid in present[s]}

    def snapshot(self, now: float) -> PeerTable:
        self.sync(now)
        return self.mirror.materialize(now)

    def compose_snapshot(self, now: float) -> PeerTable:
        return self.snapshot(now)

    def routing_view(self, now: float) -> PeerTable:
        """Staleness-priced table over the CURRENT mirrors (no sync —
        the serving loop syncs on its snapshot cadence): degraded shards'
        rows get their trust discounted by exactly the gossip staleness
        machinery, because their staleness clocks stopped refreshing."""
        return self.mirror.routing_view(now)

    @property
    def version_vector(self) -> Tuple[int, ...]:
        return self.mirror.version_vector

    @property
    def version(self) -> int:
        """Composed-table generation (bumps per rebuilt composition)."""
        return self.mirror._gen

    @property
    def topo_version(self) -> int:
        return self.mirror._topo_gen

    def staleness(self, now: float) -> np.ndarray:
        return self.mirror.staleness(now)

    def shard_digest(self, shard: int) -> int:
        return self.mirror.shard_digest(shard)

    def digest_vector(self) -> Tuple[int, ...]:
        return tuple(self.mirror.shard_digest(s)
                     for s in range(self.n_shards))

    # -- record access (as of the last sync) ---------------------------------

    @property
    def peers(self) -> Dict[int, PeerRecord]:
        """Merged record view in global registration order, built from
        the composer mirrors — i.e. as of the last ``sync``."""
        rows: List[Tuple[int, PeerRecord]] = []
        for s in range(self.n_shards):
            st = self.mirror.mirror(s)
            for i in range(len(st.peer_ids)):
                rows.append((int(st.seq[i]), PeerRecord(
                    peer_id=int(st.peer_ids[i]),
                    layer_start=int(st.layer_start[i]),
                    layer_end=int(st.layer_end[i]),
                    trust=float(st.trust[i]),
                    latency_est_ms=float(st.latency_ms[i]),
                    last_heartbeat=float(st.last_heartbeat[i]),
                    successes=int(st.successes[i]),
                    failures=int(st.failures[i]),
                    profile=st.profiles[i] if st.profiles else "")))
        rows.sort(key=lambda sr: sr[0])
        return {r.peer_id: r for _, r in rows}

    def __len__(self) -> int:
        return len(self.mirror)

    # -- per-shard replication (failover.py) ---------------------------------

    def export_shard_state(self, shard: int) -> RegistryState:
        """The composer mirror's copy (global seq included) — what the
        replication tick ships to backups."""
        return copy_state(self.mirror.mirror(shard))

    def export_shard_heartbeats(self, shard: int) -> np.ndarray:
        return self.mirror.mirror(shard).last_heartbeat.copy()

    def adopt_shard_heartbeats(self, shard: int, hb: np.ndarray) -> None:
        if self._unavailable(shard):
            self.health.dropped_writes += 1
            return
        ok, _ = self._try_rpc(shard, "adopt_heartbeats",
                              np.asarray(hb, np.float64))
        if ok:
            self.mirror.refresh_heartbeats(
                shard, np.asarray(hb, np.float64),
                self.mirror.hb_stamp(shard))

    def adopt_shard_state(self, shard: int, state: RegistryState) -> None:
        """Restore one shard from a replicated state (the
        ``ReplicatedAnchor`` ledger path). Composer-initiated worker
        resets are the ONLY way a worker's version stream restarts, and
        this method immediately invalidates the mirror and full-pulls —
        so the mirror can never mistake the restarted stream for
        duplicates, and no window serves an empty slice."""
        if not self.channels[shard].transport.alive():
            raise WorkerDown(
                f"shard {shard}: worker is dead — restart_worker first")
        self._hb_buf[shard] = []    # pre-restore liveness is obsolete
        self.channels[shard].request("adopt", state)
        self.lost_shards.discard(shard)
        self._home = {pid: s for pid, s in self._home.items()
                      if s != shard}
        for pid in state.peer_ids:
            self._home[int(pid)] = shard
        if state.seq is not None and len(state.seq):
            self._seq_next = max(self._seq_next,
                                 int(state.seq.max()) + 1)
        self.mirror.invalidate_shard(shard)
        self.degraded.discard(shard)
        self._dead.discard(shard)
        now = max((self.mirror.sync_stamp(s)
                   for s in range(self.n_shards)), default=0.0)
        self._flush_shard(shard)
        delta, hb = self.channels[shard].request("pull", -1)
        self._apply_pull(shard, delta, hb, now)

    # -- worker lifecycle (chaos / recovery) ---------------------------------

    def dead_workers(self) -> List[int]:
        self._check_workers()
        return sorted(self._dead)

    def kill_worker(self, shard: int) -> None:
        """SIGKILL one shard's worker — the chaos drill."""
        tr = self.channels[shard].transport
        kill = getattr(tr, "kill", None)
        if kill is None:
            raise ValueError(f"shard {shard}: transport cannot be killed")
        kill()
        self.degraded.add(shard)
        self._dead.add(shard)

    def restart_worker(self, shard: int,
                       state: Optional[RegistryState] = None) -> None:
        """Respawn a shard worker and restore its state — from the
        composer's own mirror by default (the freshest local copy), or
        from a replication-ledger export. The fresh worker re-adopts
        through the delta protocol's full-sync fallback."""
        old = self.channels[shard].transport
        for name in ("close", "kill"):
            fn = getattr(old, name, None)
            if fn is not None:
                try:
                    fn()
                except Exception:
                    pass
                break
        self.channels[shard] = RpcChannel(
            self._factory(shard), self.policy, self.clock,
            stats=self.health, channel_id=shard)
        if "tracer" in self.__dict__:      # keep tracing across restarts
            self.channels[shard].tracer = self.tracer
        self.health.worker_restarts += 1
        self._dead.discard(shard)
        self._hb_buf[shard] = []
        if state is None:
            state = self.export_shard_state(shard)
        self.adopt_shard_state(shard, state)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for ch in self.channels:
            tr = ch.transport
            try:
                if tr.alive():
                    tr.post((0, "stop", ()))
            except Exception:
                pass
        for ch in self.channels:
            fn = getattr(ch.transport, "close", None)
            if fn is not None:
                try:
                    fn()
                except Exception:
                    pass

    def __enter__(self) -> "ProcessShardedRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

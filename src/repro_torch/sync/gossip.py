"""Gossip scheduler: anchors push version vectors, seekers pull dirty
shards, anti-entropy repairs partitions.

``GossipPublisher`` is the anchor-side sync endpoint over any registry
(monolithic ``AnchorRegistry`` = one shard; ``ShardedAnchorRegistry`` =
its shard set). Every pull exports the owning shard's columnar state
fresh (zero-copy except the heartbeat column) and retains a bounded
history of past per-shard states keyed by version, so a seeker's pull is
delta-encoded against exactly the version it mirrors; seekers whose base
has aged out of the history get a full shard snapshot instead.

``GossipScheduler`` drives rounds on the ``gossip_period_s`` cadence:

* **push** — each round every seeker observes the publisher's per-shard
  version vector (clean shards refresh their staleness clock for free);
* **pull** — each seeker pulls at most ``gossip_fanout`` *dirty* shards,
  stalest first (the rest defer to later rounds — the bandwidth cap);
* **partition** — ``partition(seeker, shards)`` makes a subset of anchor
  shards unreachable for one seeker: no pushes, no pulls, staleness
  grows, and staleness-bounded routing (sync/seeker.py) takes over;
* **anti-entropy** — ``full_sync`` ships whole shard snapshots (boot,
  partition heal, or a ``DeltaGapError`` on a version gap), after which
  the seeker is bit-identical to the anchor again (``converged``);
* **relay** — with ``relay_enabled`` the anchor leg runs only against
  ``gossip_fanout`` rotating seed seekers per round and an epidemic
  seeker→seeker relay round (sync/relay.py) carries the rest: anchor
  push cost O(fanout), convergence O(log N) rounds.

Port of ``repro.sync.gossip``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

import time as _time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.types import RegistryState
from repro_torch.obs.trace import NOOP_TRACER
from repro_torch.sync.delta import HEADER_BYTES, DeltaGapError, ShardDelta, full_delta, make_delta
from repro_torch.sync.relay import RelayPlane
from repro_torch.sync.seeker import SeekerCache


def registry_n_shards(registry) -> int:
    """Shard count of any registry (monolithic = 1). Duck-typed so the
    process-backed composer (control_plane/registry.py) publishes
    through the same endpoints as the in-process registries."""
    return int(getattr(registry, "n_shards", 1))


def registry_version_vector(registry) -> Tuple[int, ...]:
    """Per-shard version vector of any registry (monolithic = 1-vector)."""
    vv = getattr(registry, "version_vector", None)
    if vv is not None:
        return tuple(vv)
    return (registry.version,)


def registry_shard_state(registry, shard: int) -> RegistryState:
    """One shard's columnar state with its seq column (monolithic:
    the whole registry is shard 0)."""
    if hasattr(registry, "export_shard_state"):
        return registry.export_shard_state(shard)
    if shard != 0:
        raise ValueError(f"monolithic registry has only shard 0, "
                         f"got {shard}")
    return registry.export_state()


def registry_shard_digest(registry, shard: int) -> int:
    """One shard's content digest (core/digest.py) — the attestation
    digest-verified gossip pushes alongside the version vector."""
    if hasattr(registry, "shard_digest"):
        return registry.shard_digest(shard)
    if shard != 0:
        raise ValueError(f"monolithic registry has only shard 0, "
                         f"got {shard}")
    return registry.state_digest()


def registry_shard_heartbeats(registry, shard: int) -> np.ndarray:
    """One shard's fresh liveness column (the hb-refresh payload)."""
    if hasattr(registry, "export_shard_heartbeats"):
        return registry.export_shard_heartbeats(shard)
    return registry.export_heartbeats()


def registry_poke_liveness(registry, now: float) -> None:
    """Fold liveness flips into the version vector: heartbeat EXPIRY (or
    revival) only bumps a shard's version when its snapshot is taken —
    take each shard's zero-copy snapshot so a peer going TTL-dead at the
    anchor becomes a version bump the gossip push can advertise. O(#P)
    vectorized compare per round, the same cost as the composed-snapshot
    fast path."""
    shards = getattr(registry, "shards", None)
    if shards is not None:
        for sh in shards:
            sh.snapshot(now)
    elif hasattr(registry, "sync"):
        # process-backed composer: a pull round refreshes the mirrors
        # (and their heartbeat columns) the publisher exports from
        registry.sync(now)
    else:
        registry.snapshot(now)


@dataclass
class GossipStats:
    rounds: int = 0
    pushes: int = 0           # version-vector pushes delivered to seekers
    deltas: int = 0           # delta messages shipped
    delta_bytes: int = 0
    full_syncs: int = 0       # anti-entropy full shard snapshots shipped
    full_bytes: int = 0
    deferred: int = 0         # dirty shards past the fanout cap, deferred
    gap_repairs: int = 0      # DeltaGapErrors repaired by full sync
    hb_refreshes: int = 0     # heartbeat-column lease renewals accepted
    hb_bytes: int = 0
    hb_refresh_dropped: int = 0   # renewals the seeker could not take
    digest_mismatches: int = 0    # anchor-leg ships whose resulting
                                  # mirror digest contradicted the
                                  # publisher's (poisoned base), each
                                  # repaired by a forced full resync

    def anchor_bytes(self) -> int:
        """Total bytes the ANCHOR shipped (deltas + full syncs + hb
        leases) — the cost the relay plane keeps O(fanout) per round.
        Relay traffic is seeker→seeker and counted separately
        (RelayStats.msg_bytes / peer_full_bytes)."""
        return self.delta_bytes + self.full_bytes + self.hb_bytes


class GossipPublisher:
    """Anchor-side per-shard state keeper + delta source."""

    def __init__(self, registry, cfg: Optional[GTRACConfig] = None):
        self.registry = registry
        self.cfg = cfg or registry.cfg
        self.n_shards = registry_n_shards(registry)
        self.history_size = max(1, int(self.cfg.gossip_history))
        # per-shard bounded history of exported states keyed by version —
        # the delta bases for seekers mirroring past versions
        self._history: List["OrderedDict[int, RegistryState]"] = [
            OrderedDict() for _ in range(self.n_shards)]

    def version_vector(self) -> Tuple[int, ...]:
        return registry_version_vector(self.registry)

    def shard_state(self, shard: int) -> Tuple[int, RegistryState]:
        """Fresh export of one shard (recorded into the delta history)."""
        version = self.version_vector()[shard]
        state = registry_shard_state(self.registry, shard)
        hist = self._history[shard]
        # replace any earlier capture at this version: same rows, fresher
        # heartbeat column
        hist[version] = state
        hist.move_to_end(version)
        while len(hist) > self.history_size:
            hist.popitem(last=False)
        return version, state

    def pull(self, shard: int, have_version: int) -> ShardDelta:
        """A seeker's pull: delta from the version it mirrors to the
        current shard state, or a full snapshot when that base has aged
        out of the history (anti-entropy)."""
        version, state = self.shard_state(shard)
        base = self._history[shard].get(have_version) \
            if have_version != version else state
        if have_version == version or base is None:
            # up to date (shouldn't normally be pulled) or base unknown:
            # ship the whole shard
            return full_delta(state, shard=shard, new_version=version)
        return make_delta(base, state, shard=shard,
                          base_version=have_version, new_version=version)

    def full(self, shard: int) -> ShardDelta:
        """The anti-entropy message: one whole shard snapshot."""
        version, state = self.shard_state(shard)
        return full_delta(state, shard=shard, new_version=version)

    def heartbeats(self, shard: int) -> np.ndarray:
        """One shard's fresh liveness column — the hb-refresh payload
        (8 bytes/peer; never touches versions, exactly like live
        heartbeat traffic)."""
        return registry_shard_heartbeats(self.registry, shard)

    def digest(self, shard: int) -> int:
        """One shard's current content digest (registry-cached per
        version)."""
        return registry_shard_digest(self.registry, shard)

    def digest_vector(self) -> Tuple[int, ...]:
        """Per-shard digests aligned with ``version_vector()`` — what
        anchor sightings attest to seekers."""
        return tuple(self.digest(s) for s in range(self.n_shards))


class GossipScheduler:
    """Round-driver between one publisher and its subscribed seekers.

    With ``relay_enabled`` (sync/relay.py) the anchor leg shrinks to
    ``gossip_fanout`` rotating *seed* seekers per round — each seeded
    fully (every reachable dirty shard, plus the hb-lease renewals) so
    it is a clean epidemic source — and a relay round then spreads seed
    state seeker→seeker; anchor cost per round is O(fanout), not
    O(seekers)."""

    #: sim-domain tracer: rounds are instantaneous in sim time, so a
    #: round span is zero-duration at ``now`` with the actual shipping
    #: work recorded as wall_us on the per-ship events beneath it
    tracer = NOOP_TRACER

    def __init__(self, publisher: GossipPublisher,
                 seekers: Sequence[SeekerCache],
                 cfg: Optional[GTRACConfig] = None,
                 fanout: Optional[int] = None,
                 period_s: Optional[float] = None,
                 relay: Optional[bool] = None):
        self.publisher = publisher
        self.seekers: List[SeekerCache] = list(seekers)
        cfg = cfg or publisher.cfg
        self.fanout = int(cfg.gossip_fanout if fanout is None else fanout)
        self.period_s = float(cfg.gossip_period_s if period_s is None
                              else period_s)
        self._last_round: Optional[float] = None
        # keyed by SeekerCache.source_id (stable and unique) — keying by
        # id(seeker) let a garbage-collected seeker's reused id silently
        # hand its partition state to a fresh seeker
        self._blocked: Dict[int, Set[int]] = {}
        self.stats = GossipStats()
        # digest verification of the anchor leg: after every ship the
        # seeker's (incrementally maintained) mirror digest must equal
        # the publisher's — a mismatch means the base was poisoned
        # (unattested optimistic relay adoption) and forces a full
        # resync. Same master switch as the relay plane's verification.
        self.verify = bool(cfg.relay_verify)
        relay_on = cfg.relay_enabled if relay is None else bool(relay)
        self.relay: Optional[RelayPlane] = (RelayPlane(cfg)
                                            if relay_on else None)

    # -- membership ----------------------------------------------------------

    def add_seeker(self, seeker: SeekerCache) -> None:
        if seeker not in self.seekers:
            self.seekers.append(seeker)

    def remove_seeker(self, seeker: SeekerCache) -> None:
        """Unsubscribe a seeker and drop every per-seeker state keyed on
        it (partition set, relay node) — nothing may leak onto a future
        seeker."""
        self.seekers = [s for s in self.seekers if s is not seeker]
        self._blocked.pop(seeker.source_id, None)
        if self.relay is not None:
            self.relay.forget(seeker)

    # -- partition control ---------------------------------------------------

    def partition(self, seeker: SeekerCache,
                  shards: Optional[Sequence[int]] = None) -> None:
        """Cut one seeker off from a subset of anchor shards (default:
        all of them). Blocked shards get no pushes and no pulls until
        ``heal`` — their staleness grows every round. The relay plane is
        unaffected: an anchor-partitioned seeker keeps converging
        through its neighbors."""
        all_shards = range(self.publisher.n_shards)
        add = set(all_shards) if shards is None else set(shards)
        self._blocked.setdefault(seeker.source_id, set()).update(add)

    def heal(self, seeker: SeekerCache,
             shards: Optional[Sequence[int]] = None) -> None:
        """Restore reachability (default: fully). Reconciliation happens
        on the following rounds: pulls for shards whose base version is
        still in the publisher's history, anti-entropy full syncs for
        the rest."""
        blocked = self._blocked.get(seeker.source_id)
        if blocked is None:
            return
        blocked -= set(range(self.publisher.n_shards)) \
            if shards is None else set(shards)
        if not blocked:
            self._blocked.pop(seeker.source_id, None)

    def blocked_shards(self, seeker: SeekerCache) -> Set[int]:
        return set(self._blocked.get(seeker.source_id, set()))

    # -- rounds --------------------------------------------------------------

    #: catch-up bound: a driver that stalled longer than this many
    #: periods fires this many rounds (plenty for the epidemic to
    #: drain) and resynchronizes the cadence clock
    MAX_CATCHUP_ROUNDS = 16

    def maybe_tick(self, now: float) -> bool:
        """Catch the cadence up to ``now``: run one round per elapsed
        ``gossip_period_s`` (capped at ``MAX_CATCHUP_ROUNDS``), the
        rounds a background sync thread would have fired while a sim
        driver stalled inside a long request. Matters most on the relay
        plane, where information moves one hop per ROUND — a single
        round per multi-period stall would let relayed observation
        times (and so staleness) lag arbitrarily. Every catch-up round
        runs AT ``now``: the registry reads genuinely happen now, and
        back-dating their stamps would make present-time heartbeat
        data look future-dated to the relay plane's plausibility
        checks (honest lease columns rejected as fabrications)."""
        if self._last_round is None or self.period_s <= 0:
            # no cadence (period 0 = tick every call), or first round
            self.tick(now)
            return True
        missed = int((now - self._last_round) / self.period_s)
        if missed <= 0:
            return False
        for _ in range(min(missed, self.MAX_CATCHUP_ROUNDS)):
            self.tick(now)
        return True

    def tick(self, now: float) -> None:
        """One gossip round: fold anchor-side liveness flips into the
        version vector, push it to every seeker (relay mode: only the
        round's seeds), let each pushed seeker pull its dirtiest
        reachable shards (fanout-capped; relay seeds pull everything),
        renew aging heartbeat-column leases
        (``gossip_hb_refresh_frac``), then run one epidemic relay round
        when the relay plane is on."""
        self._last_round = now
        self.stats.rounds += 1
        tr = self.tracer
        sp = (tr.begin("gossip.round", cat="gossip", t0=now, push=True,
                       round=self.stats.rounds) if tr.enabled else None)
        targets: Sequence[SeekerCache] = ()
        try:
            registry_poke_liveness(self.publisher.registry, now)
            vv = self.publisher.version_vector()
            n = self.publisher.n_shards
            cfg = self.publisher.cfg
            refresh_s = cfg.gossip_hb_refresh_frac * cfg.node_ttl_s
            if self.relay is None:
                targets, shard_cap = self.seekers, self.fanout
            else:
                # seeds pull every reachable dirty shard: anchor cost
                # stays O(fanout seekers), and a fully-fresh seed is
                # what makes the epidemic converge in O(log N) rounds
                targets, shard_cap = self._seed_seekers(n), n
            # the attestation payload riding every anchor sighting
            # (registry-cached per shard version — O(S) on clean rounds)
            dv = (self.publisher.digest_vector()
                  if self.relay is not None else None)
            for seeker in targets:
                self._anchor_round(seeker, vv, dv, n, now, refresh_s,
                                   shard_cap)
            if self.relay is not None:
                self.relay.round(self.seekers, now,
                                 anchor_pull=self._relay_pull)
        finally:
            if sp is not None:
                tr.end(sp, t1=now, targets=len(targets))

    def _seed_seekers(self, n_shards: int) -> List[SeekerCache]:
        """This round's anchor-push seeds: ``gossip_fanout`` seekers in
        rotation (so every seeker periodically talks to the anchor),
        skipping fully-partitioned ones."""
        n_seek = len(self.seekers)
        count = min(self.fanout, n_seek)
        start = (self.stats.rounds - 1) * count
        seeds: List[SeekerCache] = []
        for i in range(n_seek):
            sk = self.seekers[(start + i) % n_seek]
            if len(self._blocked.get(sk.source_id, ())) >= n_shards:
                continue
            seeds.append(sk)
            if len(seeds) >= count:
                break
        return seeds

    def _anchor_round(self, seeker: SeekerCache, vv: Tuple[int, ...],
                      dv: Optional[Tuple[int, ...]], n: int, now: float,
                      refresh_s: float, shard_cap: int) -> None:
        """The anchor→seeker leg for one seeker: version-vector push,
        stalest-first dirty pulls up to ``shard_cap``, hb-lease renewal."""
        blocked = self._blocked.get(seeker.source_id, ())
        if len(blocked) >= n:
            return               # fully partitioned: no push reaches it
        reachable = [s not in blocked for s in range(n)]
        dirty = seeker.observe(vv, now, reachable=reachable)
        self.stats.pushes += 1
        if self.relay is not None:
            # a direct push is an authoritative vv + digest sighting the
            # seeker will relay onward (with its observation time)
            self.relay.observe_anchor(seeker, vv, now, digests=dv)
        ages = seeker.staleness(now)
        dirty.sort(key=lambda s: -ages[s])    # stalest first
        take, defer = dirty[:shard_cap], dirty[shard_cap:]
        self.stats.deferred += len(defer)
        for s in take:
            self._ship(seeker, s, now)
        if refresh_s <= 0:
            return
        hb_ages = seeker.hb_age(now)
        behind = set(defer)    # deferred data: membership may lag,
        for s in range(n):     # a refresh would only bounce — skip
            if reachable[s] and s not in behind \
                    and hb_ages[s] >= refresh_s:
                hb = self.publisher.heartbeats(s)
                if seeker.refresh_heartbeats(s, hb, now):
                    self.stats.hb_refreshes += 1
                    self.stats.hb_bytes += int(hb.nbytes) + \
                        HEADER_BYTES
                else:
                    self.stats.hb_refresh_dropped += 1

    def _relay_pull(self, seeker: SeekerCache, shard: int,
                    now: float) -> bool:
        """Relay gap repair: anti-entropy pull from the anchor — the
        root of trust — when the shard is reachable for this seeker.
        Returns False when partitioned off (the relay plane then falls
        back to a neighbor's full mirror)."""
        if shard in self._blocked.get(seeker.source_id, ()):
            return False
        self._ship(seeker, shard, now)
        return True

    def _ship(self, seeker: SeekerCache, shard: int, now: float) -> None:
        traced = self.tracer.enabled
        wall0 = _time.perf_counter() if traced else 0.0
        if self.relay is not None:
            # a ship IS direct anchor contact: refresh the seeker's
            # attestation store first, so what it is about to apply —
            # and then forward — is covered by a sighting it can relay
            # (the invariant that keeps honest chains from ever being
            # deferred as unattested downstream)
            self.relay.observe_anchor(seeker,
                                      self.publisher.version_vector(),
                                      now,
                                      digests=self.publisher.digest_vector())
        delta = self.publisher.pull(shard, seeker.version_vector[shard])
        try:
            seeker.apply(delta, now)
        except DeltaGapError:
            # version gap (history aged out mid-flight): anti-entropy
            delta = self.publisher.full(shard)
            seeker.apply(delta, now)
            self.stats.gap_repairs += 1
        if delta.is_full:
            self.stats.full_syncs += 1
            self.stats.full_bytes += delta.wire_bytes()
        else:
            self.stats.deltas += 1
            self.stats.delta_bytes += delta.wire_bytes()
        if traced:
            self.tracer.event(
                "gossip.delta", cat="gossip", t=now, shard=shard,
                seeker=seeker.source_id, bytes=delta.wire_bytes(),
                full=delta.is_full,
                wall_us=(_time.perf_counter() - wall0) * 1e6)
        if self.verify and \
                seeker.shard_digest(shard) != self.publisher.digest(shard):
            # the shipped-to mirror contradicts the root of trust: its
            # base was poisoned (optimistic relay adoption before any
            # attestation covered it). A same-version full ship cannot
            # repair this — the version contract assumes identical rows
            # — so the mirror is invalidated and re-adopted wholesale.
            self.stats.digest_mismatches += 1
            if traced:
                self.tracer.event("gossip.digest_mismatch", cat="gossip",
                                  t=now, shard=shard,
                                  seeker=seeker.source_id)
            seeker.invalidate_shard(shard)
            full = self.publisher.full(shard)
            seeker.apply(full, now)
            self.stats.full_syncs += 1
            self.stats.full_bytes += full.wire_bytes()
        elif not delta.is_full and self.relay is not None:
            self.relay.record(seeker, delta)

    # -- anti-entropy --------------------------------------------------------

    def full_sync(self, seeker: SeekerCache, now: float,
                  shards: Optional[Sequence[int]] = None) -> int:
        """Ship whole shard snapshots (boot sync / partition-heal
        reconciliation). Returns total wire bytes shipped."""
        total = 0
        for s in (range(self.publisher.n_shards) if shards is None
                  else shards):
            delta = self.publisher.full(s)
            seeker.apply(delta, now)
            self.stats.full_syncs += 1
            total += delta.wire_bytes()
        self.stats.full_bytes += total
        if self.relay is not None:
            # direct anchor contact: an authoritative vv + digest sighting
            self.relay.observe_anchor(
                seeker, self.publisher.version_vector(), now,
                digests=self.publisher.digest_vector())
        return total

    # -- convergence ---------------------------------------------------------

    def converged(self, seeker: SeekerCache, now: float,
                  check_table: bool = True) -> bool:
        """A seeker is converged when it mirrors the anchor's version
        vector and (optionally) its materialized table matches the
        anchor's composed snapshot column-for-column."""
        if seeker.version_vector != self.publisher.version_vector():
            return False
        if not check_table:
            return True
        ts = seeker.materialize(now)
        ta = self.publisher.registry.snapshot(now)
        return (np.array_equal(ta.peer_ids, ts.peer_ids)
                and np.array_equal(ta.trust, ts.trust)
                and np.array_equal(ta.latency_ms, ts.latency_ms)
                and np.array_equal(ta.alive, ts.alive))

    def all_converged(self, now: float, check_table: bool = False) -> bool:
        """Every subscribed seeker converged (the relay-lane bench's
        per-round probe; table check off by default — it is O(P) per
        seeker)."""
        return all(self.converged(sk, now, check_table=check_table)
                   for sk in self.seekers)


def make_sync_plane(registry, cfg: Optional[GTRACConfig] = None,
                    n_seekers: int = 1, now: float = 0.0,
                    boot_sync: bool = True)\
        -> Tuple[GossipPublisher, List[SeekerCache], GossipScheduler]:
    """Wire a publisher + N seeker caches + scheduler over one registry
    (the serving/sim/bench entry point). ``boot_sync`` anti-entropies
    every seeker so they start bit-identical to the anchor."""
    cfg = cfg or registry.cfg
    pub = GossipPublisher(registry, cfg)
    seekers = [SeekerCache(cfg, pub.n_shards, now=now)
               for _ in range(n_seekers)]
    sched = GossipScheduler(pub, seekers, cfg=cfg)
    if boot_sync:
        for sk in seekers:
            sched.full_sync(sk, now)
    return pub, seekers, sched

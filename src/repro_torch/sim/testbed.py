"""The paper's 336-peer heterogeneous testbed (§V-A), simulated.

GPT-2-Large (36 layers) partitioned into contiguous shards of 3, 6, or 9
layers; multiple virtual replicas per shard slot with software-defined
performance–reliability profiles (honeypot / turtle / golden). The default
mix gives every slot replicas of each profile so that every algorithm has a
feasible chain, and honeypots dominate the low-latency frontier — the trap
that breaks latency-greedy routing (§VI-A).

Also provides fault-injection controls for the robustness experiments:
``crash_peers`` (heartbeats stop → TTL expiry) and ``partition`` (a subset
becomes unreachable for a time window).

Port of ``repro.sim.testbed``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.sharding import Registry, make_registry
from repro_torch.sim.peers import PROFILES, SimPeer, make_peer

GPT2_LARGE_LAYERS = 36
SHARD_SIZES = (3, 6, 9)


@dataclass
class Testbed:
    cfg: GTRACConfig
    total_layers: int
    peers: Dict[int, SimPeer]
    anchor: Registry      # monolithic AnchorRegistry or sharded (sharding.py)
    rng: np.random.Generator
    now: float = 0.0
    partitioned: set = field(default_factory=set)

    # -- time & liveness -----------------------------------------------------

    def advance(self, dt_s: float) -> None:
        """Advance sim clock; live peers heartbeat on the T_hb cadence.

        Heartbeats are applied as one batched stamp at the end of the window
        (every reachable peer would have heartbeated within T_hb ≪ T_ttl of
        it, so TTL liveness semantics are unchanged); crashed or partitioned
        peers keep their stale timestamp and expire naturally."""
        self.now += dt_s
        hb = self.now if dt_s >= self.cfg.heartbeat_s else None
        for p in self.peers.values():
            if p.alive and p.peer_id not in self.partitioned:
                self.anchor.heartbeat(p.peer_id, hb if hb is not None
                                      else self.now)

    # -- fault injection ------------------------------------------------------

    def crash_peers(self, peer_ids: Sequence[int]) -> None:
        for pid in peer_ids:
            if pid in self.peers:
                self.peers[pid].alive = False

    def recover_peers(self, peer_ids: Sequence[int]) -> None:
        for pid in peer_ids:
            if pid in self.peers:
                self.peers[pid].alive = True

    def partition(self, peer_ids: Sequence[int]) -> None:
        """Network partition: peers keep running but can't reach the anchor
        (heartbeats lost) nor serve hops."""
        self.partitioned |= set(peer_ids)

    def heal_partition(self) -> None:
        self.partitioned.clear()

    def reachable(self, peer_id: int) -> bool:
        p = self.peers.get(peer_id)
        return bool(p and p.alive and peer_id not in self.partitioned)

    # -- views -----------------------------------------------------------------

    def peers_by_profile(self, name: str) -> List[SimPeer]:
        return [p for p in self.peers.values() if p.profile.name == name]

    # -- shard-aware fault injection ------------------------------------------

    def crash_anchor_shard(self, shard: int,
                           kill_worker: bool = False) -> List[int]:
        """Crash every peer homed on one anchor shard (requires a sharded
        anchor): their heartbeats stop, the shard's next sweep TTL-expires
        them, and — because the other shards stay clean — only that shard's
        columns rebuild in the composed snapshot. Returns the crashed ids.

        ``kill_worker=True`` additionally SIGKILLs the shard's worker
        process (process backend only — ``cfg.control_plane='procs'``):
        the control-plane failure domain goes down WITH its peers, the
        composer degrades the shard, and recovery goes through
        ``restart_worker`` / the ``ReplicatedAnchor`` ledger.

        Both preconditions are checked before ANY state is touched — a
        rejected call must not leave half the peers crashed."""
        anchor = self.anchor
        if not hasattr(anchor, "owner_of"):
            raise ValueError("crash_anchor_shard needs a sharded anchor")
        if kill_worker and not hasattr(anchor, "kill_worker"):
            raise ValueError(
                "kill_worker=True needs a process-backed anchor "
                "(cfg.control_plane='procs')")
        pids = [pid for pid in self.peers if anchor.owner_of(pid) == shard]
        if kill_worker:
            anchor.kill_worker(shard)
        self.crash_peers(pids)
        return pids


@dataclass
class ChurnStats:
    """Outcome of ``run_churn``: what membership churn did to the anchor."""

    joined: int = 0
    crashed: int = 0
    expired: int = 0              # TTL-swept by per-window sweeps
    windows: int = 0
    snapshots_rebuilt: int = 0    # composed/zero-copy snapshot rebuilds
    final_peers: int = 0


def run_churn(bed: Testbed, windows: int = 10, window_s: float = 2.0,
              joins_per_window: int = 2, crashes_per_window: int = 2,
              expire_after_s: Optional[float] = None,
              profile: str = "golden") -> ChurnStats:
    """Membership churn driver (shard-aware when the anchor is sharded).

    Each window: crash a few random live peers (heartbeats stop), register
    a few fresh replicas on random shard slots (the registry routes them to
    their owning anchor shard by stable peer-id hash), advance the clock,
    sweep (TTL-expiring peers dead longer than ``expire_after_s``, default
    2 x node_ttl_s), and take a composed snapshot. Only shards whose
    membership actually moved rebuild their snapshot columns; the stats
    count how many windows rebuilt at all."""
    cfg = bed.cfg
    if expire_after_s is None:
        expire_after_s = 2.0 * cfg.node_ttl_s
    slots = []
    for size in SHARD_SIZES:
        for s in range(0, bed.total_layers, size):
            slots.append((s, s + size))
    stats = ChurnStats()
    next_pid = max(bed.peers) + 1 if bed.peers else 0
    prev = bed.anchor.snapshot(bed.now)
    for _ in range(windows):
        live = [pid for pid, p in bed.peers.items() if p.alive]
        k = min(crashes_per_window, max(0, len(live) - 1))
        if k:
            idx = bed.rng.choice(len(live), size=k, replace=False)
            bed.crash_peers([live[i] for i in idx])
            stats.crashed += k
        for _ in range(joins_per_window):
            s, e = slots[int(bed.rng.integers(len(slots)))]
            peer = make_peer(next_pid, s, e, PROFILES[profile], bed.rng)
            bed.peers[next_pid] = peer
            bed.anchor.register(next_pid, s, e, now=bed.now, profile=profile)
            bed.anchor.heartbeat(next_pid, bed.now)
            next_pid += 1
            stats.joined += 1
        bed.advance(window_s)
        stats.expired += bed.anchor.sweep(bed.now,
                                          expire_after_s=expire_after_s)
        table = bed.anchor.snapshot(bed.now)
        stats.snapshots_rebuilt += int(table is not prev)
        prev = table
        stats.windows += 1
    stats.final_peers = len(bed.anchor.snapshot(bed.now))
    return stats


@dataclass
class PartitionStats:
    """Outcome of ``simulate_partition``: what a seeker-side partition
    did to the sync plane."""

    partition_windows: int = 0
    max_stale_rounds: int = 0      # worst per-shard staleness while cut off
    rounds_to_convergence: int = -1   # gossip rounds after heal (-1: never)
    converged: bool = False
    # relay scenario class (sync/relay.py): a seeker partitioned from
    # the anchor but reachable by relay neighbors keeps converging —
    # checked at the END of the partition phase, before the heal
    converged_during_partition: bool = False
    # wire bytes shipped during reconciliation, over BOTH legs: the
    # anchor leg (scheduler delta/full ships) and — when the scheduler
    # carries a relay plane — the seeker→seeker leg (messages,
    # summaries, pull requests, neighbor full syncs)
    delta_bytes: int = 0
    full_bytes: int = 0
    relay_bytes: int = 0           # the seeker→seeker share of the above
    gap_repairs: int = 0           # DeltaGapErrors repaired by anti-entropy


def simulate_partition(bed: Testbed, sched, seeker,
                       shards: Sequence[int],
                       partition_windows: int = 5, window_s: float = 2.0,
                       max_heal_rounds: int = 32,
                       mutate: Optional[Callable[[Testbed], None]] = None,
                       ) -> PartitionStats:
    """Partition a gossip seeker from a subset of anchor shards, keep the
    world moving, heal, and drive gossip until the seeker reconverges.

    Each partitioned window: ``mutate(bed)`` (optional churn — reports,
    crashes, registrations), advance the sim clock, sweep the anchor,
    and run a gossip round (reachable shards keep syncing; the cut-off
    shards' staleness grows — staleness-bounded routing territory).
    After ``heal`` the loop ticks until ``sched.converged`` confirms the
    seeker mirrors the anchor's version vector AND its materialized
    table matches the composed snapshot column-for-column, counting the
    rounds reconciliation took. ``sched``/``seeker`` are a
    ``repro_torch.sync.gossip.GossipScheduler`` and its ``SeekerCache``
    (duck-typed to keep sim free of a hard sync-plane import).

    With a relay-enabled scheduler this doubles as the epidemic
    scenario class: the partition blocks only the anchor leg, so a
    relay-reachable seeker keeps converging through its neighbors —
    ``converged_during_partition`` records whether it was already
    caught up before the heal (and the post-heal loop then typically
    reports 0 reconciliation rounds)."""
    stats = PartitionStats(partition_windows=partition_windows)
    b0 = (sched.stats.delta_bytes, sched.stats.full_bytes,
          sched.stats.gap_repairs)
    relay = getattr(sched, "relay", None)
    rb0 = ((relay.stats.msg_bytes + relay.stats.summary_bytes
            + relay.stats.pull_req_bytes, relay.stats.peer_full_bytes)
           if relay is not None else (0, 0))
    sched.partition(seeker, shards)
    for _ in range(partition_windows):
        if mutate is not None:
            mutate(bed)
        bed.advance(window_s)
        bed.anchor.sweep(bed.now)
        sched.tick(bed.now)
        stats.max_stale_rounds = max(
            stats.max_stale_rounds,
            int(seeker.staleness_rounds(bed.now).max()))
    stats.converged_during_partition = sched.converged(seeker, bed.now)
    sched.heal(seeker, shards)
    for r in range(max_heal_rounds):
        if sched.converged(seeker, bed.now):
            stats.rounds_to_convergence = r
            stats.converged = True
            break
        bed.advance(window_s)
        sched.tick(bed.now)
    else:
        stats.converged = sched.converged(seeker, bed.now)
        if stats.converged:
            stats.rounds_to_convergence = max_heal_rounds
    stats.delta_bytes = sched.stats.delta_bytes - b0[0]
    stats.full_bytes = sched.stats.full_bytes - b0[1]
    stats.gap_repairs = sched.stats.gap_repairs - b0[2]
    if relay is not None:
        # the relay leg moves real wire bytes too — incremental payloads
        # (messages / summaries / pull requests) count as delta traffic,
        # neighbor anti-entropy fulls as full traffic
        rs = relay.stats
        d = (rs.msg_bytes + rs.summary_bytes + rs.pull_req_bytes) - rb0[0]
        f = rs.peer_full_bytes - rb0[1]
        stats.delta_bytes += d
        stats.full_bytes += f
        stats.relay_bytes = d + f
    return stats


@dataclass
class ByzantineStats:
    """Outcome of ``simulate_byzantine``: what F lying relays did (and
    failed to do) to the honest majority of the epidemic plane."""

    n_liars: int = 0
    rounds: int = 0                  # gossip rounds driven under attack
    resurrect_pid: int = -1          # the deregistered id liars push
    fabricated_summaries: int = 0    # corrupted handshake openers sent
    fabricated_msgs: int = 0         # corrupted data payloads sent
    honest_converged: bool = False   # every honest seeker at anchor parity
    rounds_to_convergence: int = -1  # post-churn rounds until parity
    poisoned_mirrors: int = 0        # honest seekers NOT at parity at end
    resurrected_seen: int = 0        # honest mirrors holding the dead id
    # relay-plane hardening counters, scenario-windowed
    rejected_chains: int = 0
    digest_mismatches: int = 0
    quarantines: int = 0
    quarantine_drops: int = 0
    deferred_unattested: int = 0
    hb_rejected: int = 0


def make_liar_hook(plane, liar_ids, resurrect_pid: int = -1,
                   resurrect_home: int = 0, trust_ceiling: float = 1.0,
                   stats: Optional[ByzantineStats] = None):
    """Build a ``RelayPlane.fault_hook`` that turns the seekers in
    ``liar_ids`` (by ``source_id``) into Byzantine relays.

    A liar corrupts every payload it originates, per shard, picking the
    nastiest fabrication the receiver's state admits:

    - receiver behind an attested version → fabricate a delta chain up
      to it, rows copied from the receiver's own mirror with trust
      inflated to ``trust_ceiling`` plus a resurrection row for the
      deregistered ``resurrect_pid`` (a verifiable lie: the staged
      digest can never match the attestation, so honest receivers
      reject, roll back, and quarantine);
    - receiver fully current → claim its own version with a junk digest
      (handshake divergence) and a future-dated heartbeat lease (hb
      plausibility rejection);
    - nothing newer attested → claim ``cur + 1``, a version the anchor
      does not have (deferred as unattested; convicted after the
      receiver's next anchor repair finds no such version).

    What a liar can NOT do is forge the anchor-signed vv/digest
    sightings riding ``vv_obs`` / ``vv_obs_digests`` — those are passed
    through untouched (see the threat model in README/ROADMAP)."""
    from dataclasses import replace

    from repro_torch.core.types import RegistryState
    from repro_torch.sync.delta import ShardDelta, slice_state
    from repro_torch.sync.relay import RelayMessage, RelaySummary

    liar_ids = set(int(i) for i in liar_ids)

    def _junk_digest(shard: int, version: int) -> int:
        return (0xBAD0_DEAD << 24) ^ (shard << 20) ^ (int(version) & 0xFFFFF)

    def _poison_rows(mirror: RegistryState, shard: int,
                     stamp: float) -> Optional[RegistryState]:
        n = len(mirror.peer_ids)
        if n == 0:
            return None
        k = min(2, n)
        rows = slice_state(mirror, np.arange(k))
        rows.trust[:] = trust_ceiling          # dead peers, glowing scores
        rows.last_heartbeat[:] = stamp
        if resurrect_pid >= 0 and shard == resurrect_home \
                and resurrect_pid not in set(int(p) for p in rows.peer_ids):
            seq_base = (int(mirror.seq.max()) + 1
                        if mirror.seq is not None and len(mirror.seq)
                        else 1 << 40)
            rows = RegistryState(
                peer_ids=np.append(rows.peer_ids,
                                   np.int64(resurrect_pid)),
                layer_start=np.append(rows.layer_start,
                                      mirror.layer_start[0]),
                layer_end=np.append(rows.layer_end, mirror.layer_end[0]),
                trust=np.append(rows.trust, trust_ceiling),
                latency_ms=np.append(rows.latency_ms, 1.0),
                last_heartbeat=np.append(rows.last_heartbeat, stamp),
                successes=np.append(rows.successes, np.int64(1000)),
                failures=np.append(rows.failures, np.int64(0)),
                profiles=(rows.profiles + ["golden"] if rows.profiles
                          else []),
                seq=np.append(rows.seq, np.int64(seq_base)),
            )
        return rows

    def _corrupt_summary(p, receiver):
        node = plane.node(receiver)
        versions, digests = list(p.versions), list(p.digests)
        hb = p.hb_times.copy()
        for s in range(len(versions)):
            cur = receiver.version_vector[s]
            latest = node.latest_attested(s)
            if latest is not None and latest > cur:
                versions[s] = latest           # bait a verifiable pull
            elif latest is not None and latest == cur:
                versions[s] = cur              # contradict held state
            else:
                versions[s] = cur + 1          # claim the future
            digests[s] = _junk_digest(s, versions[s])
            hb[s] = receiver.hb_stamp(s) + 1.0
        if stats is not None:
            stats.fabricated_summaries += 1
        return replace(p, versions=tuple(versions),
                       digests=tuple(digests), hb_times=hb)

    def _corrupt_message(m, receiver):
        node = plane.node(receiver)
        n_shards = len(m.versions)
        versions = list(m.versions)
        chains: List[List[ShardDelta]] = [[] for _ in range(n_shards)]
        hb_cols: List[Optional[np.ndarray]] = [None] * n_shards
        hb_times = m.hb_times.copy()
        for s in range(n_shards):
            cur = receiver.version_vector[s]
            latest = node.latest_attested(s)
            mirror = receiver.mirror(s)
            stamp = receiver.hb_stamp(s) + 1.0
            if latest is not None and latest == cur:
                # nothing to gain on versions: fabricate liveness — a
                # lease column postdating its own stamp
                versions[s] = cur
                if len(mirror.peer_ids):
                    hb_times[s] = stamp
                    hb_cols[s] = np.full(len(mirror.peer_ids),
                                         stamp + 60.0)
                continue
            target = latest if (latest is not None and latest > cur) \
                else cur + 1
            versions[s] = target
            rows = _poison_rows(mirror, s, stamp)
            if rows is None:
                continue
            chains[s] = [ShardDelta(shard=s, base_version=cur,
                                    new_version=target,
                                    removed_ids=np.empty(0, np.int64),
                                    rows=rows)]
        if stats is not None:
            stats.fabricated_msgs += 1
        return replace(m, versions=tuple(versions), chains=chains,
                       hb_cols=hb_cols, hb_times=hb_times,
                       _wire_bytes=None)

    def hook(payload, receiver):
        if int(payload.sender_id) not in liar_ids:
            return payload
        if isinstance(payload, RelaySummary):
            return _corrupt_summary(payload, receiver)
        if isinstance(payload, RelayMessage):
            return _corrupt_message(payload, receiver)
        return payload

    return hook


def simulate_byzantine(bed: Testbed, sched, seekers: Sequence,
                       n_liars: int = 3, churn_windows: int = 5,
                       window_s: float = 2.0,
                       max_rounds: Optional[int] = None,
                       mutate: Optional[Callable[[Testbed], None]] = None,
                       ) -> ByzantineStats:
    """Byzantine scenario class: F lying relays inside an otherwise
    honest epidemic plane.

    ``seekers[1 : 1 + n_liars]`` turn Byzantine (seeker 0 — the routing
    seeker in the serving stack — stays honest); one live peer is
    crashed AND deregistered from the anchor, and the liars keep pushing
    fabricated chains resurrecting it with inflated trust. The scenario
    drives ``churn_windows`` mutated windows under attack, then freezes
    churn and gives the plane the epidemic bound ``ceil(log2 N) + 2``
    rounds to reach anchor parity on every honest seeker. The liars stay
    active throughout — convergence must be achieved THROUGH the attack,
    not after it. ``sched``/``seekers`` are duck-typed like
    ``simulate_partition``; the scheduler must carry a relay plane."""
    import math

    relay = getattr(sched, "relay", None)
    if relay is None:
        raise ValueError("simulate_byzantine needs a relay-enabled "
                         "scheduler (cfg.relay_enabled)")
    liar_set = set(sk.source_id for sk in seekers[1:1 + n_liars])
    honest = [sk for sk in seekers if sk.source_id not in liar_set]
    stats = ByzantineStats(n_liars=len(liar_set))
    # the resurrection target: a real peer, properly deregistered
    live = sorted(pid for pid, p in bed.peers.items() if p.alive)
    if live:
        stats.resurrect_pid = live[-1]
        bed.crash_peers([stats.resurrect_pid])
        bed.anchor.deregister(stats.resurrect_pid)
    owner = getattr(bed.anchor, "owner_of", None)
    home = (owner(stats.resurrect_pid)
            if owner is not None and stats.resurrect_pid >= 0 else 0)
    rs = relay.stats
    r0 = (rs.rejected_chains, rs.digest_mismatches, rs.quarantines,
          rs.quarantine_drops, rs.deferred_unattested, rs.hb_rejected)
    relay.fault_hook = make_liar_hook(
        relay, liar_set, resurrect_pid=stats.resurrect_pid,
        resurrect_home=home, stats=stats)
    try:
        for _ in range(churn_windows):
            if mutate is not None:
                mutate(bed)
            bed.advance(window_s)
            bed.anchor.sweep(bed.now)
            sched.tick(bed.now)
            stats.rounds += 1
        bound = max_rounds if max_rounds is not None \
            else math.ceil(math.log2(max(2, len(seekers)))) + 2
        for r in range(bound + 1):
            if all(sched.converged(sk, bed.now) for sk in honest):
                stats.rounds_to_convergence = r
                stats.honest_converged = True
                break
            bed.advance(window_s)
            bed.anchor.sweep(bed.now)
            sched.tick(bed.now)
            stats.rounds += 1
    finally:
        relay.fault_hook = None
    for sk in honest:
        if not sched.converged(sk, bed.now):
            stats.poisoned_mirrors += 1
        if stats.resurrect_pid >= 0 and any(
                stats.resurrect_pid in set(int(p) for p in
                                           sk.mirror(s).peer_ids)
                for s in range(sk.n_shards)):
            stats.resurrected_seen += 1
    stats.rejected_chains = rs.rejected_chains - r0[0]
    stats.digest_mismatches = rs.digest_mismatches - r0[1]
    stats.quarantines = rs.quarantines - r0[2]
    stats.quarantine_drops = rs.quarantine_drops - r0[3]
    stats.deferred_unattested = rs.deferred_unattested - r0[4]
    stats.hb_rejected = rs.hb_rejected - r0[5]
    return stats


def build_paper_testbed(cfg: Optional[GTRACConfig] = None,
                        seed: int = 0,
                        total_layers: int = GPT2_LARGE_LAYERS,
                        replicas_per_slot: Dict[str, int] = None,
                        shards: int = 1,
                        ) -> Testbed:
    """336 concurrent peers spanning all pipeline stages (§V-A).

    Slots: 36/3 + 36/6 + 36/9 = 12 + 6 + 4 = 22 shard slots.
    Default replicas per slot: 5 honeypot + 5 turtle + 5 golden = 15
    → 22 × 15 = 330, topped up to 336 with extra honeypots on the first
    slots of each granularity (the paper's honey-pot-rich search space).
    """
    cfg = cfg or GTRACConfig()
    rng = np.random.default_rng(seed)
    anchor = make_registry(cfg, shards=shards, shard_by=cfg.shard_by)
    # profile proportions are not published; this mix reproduces the paper's
    # Fig. 3 ordering and magnitudes (see EXPERIMENTS.md §Reproduction)
    replicas = replicas_per_slot or {"honeypot": 4, "turtle": 5, "golden": 6}

    peers: Dict[int, SimPeer] = {}
    pid = 0

    def add(start: int, end: int, profile_name: str):
        nonlocal pid
        peer = make_peer(pid, start, end, PROFILES[profile_name], rng)
        peers[pid] = peer
        anchor.register(pid, start, end, now=0.0, profile=profile_name,
                        latency_ms=cfg.init_latency_ms)
        anchor.heartbeat(pid, 0.0)
        pid += 1

    slots = []
    for size in SHARD_SIZES:
        for s in range(0, total_layers, size):
            slots.append((s, s + size))
    for (s, e) in slots:
        for name, n in replicas.items():
            for _ in range(n):
                add(s, e, name)
    # top up to 336 with honeypots (the adversarial frontier)
    i = 0
    while pid < 336:
        s, e = slots[i % len(slots)]
        add(s, e, "honeypot")
        i += 1
    return Testbed(cfg=cfg, total_layers=total_layers, peers=peers,
                   anchor=anchor, rng=rng)


def build_scaling_testbed(n_peers: int, cfg: Optional[GTRACConfig] = None,
                          seed: int = 0,
                          total_layers: int = GPT2_LARGE_LAYERS,
                          shards: int = 1) -> Testbed:
    """Uniform-random testbed for the decision-overhead experiment (§VI-E):
    N peers spread across shard slots with mixed profiles."""
    cfg = cfg or GTRACConfig()
    rng = np.random.default_rng(seed)
    anchor = make_registry(cfg, shards=shards, shard_by=cfg.shard_by)
    peers: Dict[int, SimPeer] = {}
    slots = []
    for size in SHARD_SIZES:
        for s in range(0, total_layers, size):
            slots.append((s, s + size))
    names = list(PROFILES)
    for pid in range(n_peers):
        s, e = slots[pid % len(slots)]
        name = names[int(rng.integers(len(names)))]
        peer = make_peer(pid, s, e, PROFILES[name], rng)
        peers[pid] = peer
        anchor.register(pid, s, e, now=0.0, profile=name,
                        trust=float(rng.uniform(0.5, 1.0)),
                        latency_ms=float(rng.uniform(20, 400)))
        anchor.heartbeat(pid, 0.0)
    return Testbed(cfg=cfg, total_layers=total_layers, peers=peers,
                   anchor=anchor, rng=rng)

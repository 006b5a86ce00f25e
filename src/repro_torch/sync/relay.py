"""Epidemic seeker→seeker relay: the anchor's fanout stays O(seeds)
while trust updates reach every edge peer in O(log N) rounds — and no
lying neighbor can poison an honest mirror.

Without the relay, the gossip plane pushes anchor state to every
subscribed seeker each round — O(seekers) anchor cost, the scaling wall
of a multi-seeker gossip topology. With ``relay_enabled`` the
anchor talks to only ``gossip_fanout`` *seed* seekers per round
(rotating, so every seeker is periodically a seed) and the seekers carry
the rest themselves:

* **RelayTopology** — deterministic k-regular-out random peer sampling:
  each round every seeker pushes to ``relay_fanout`` neighbors drawn by
  a seeded RNG keyed on (relay_seed, round), so runs are reproducible
  and the expected in-degree equals the fanout.
* **RelayNode** — per-seeker relay state: a ``relay_history``-bounded
  per-shard chain of the (non-full) ``ShardDelta``s the seeker applied,
  the freshest anchor version-vector observation it has heard (directly
  as a seed, or relayed), a bounded per-shard **attestation store** of
  anchor ``(version → digest)`` sightings (core/digest.py) riding those
  observations, and the receiver-side **quarantine ledger** of senders
  caught lying.
* **RelaySummary / RelayMessage** — with ``relay_handshake`` (default) a
  round opens with summaries: versions + digests + lease/confirmation
  stamps + the relayed anchor sighting, ~32 B/shard. The receiver pulls
  only the shards it actually lacks; the response ``RelayMessage``
  carries chains/hb columns for exactly those. Steady state is
  summaries only — the duplicate deliveries blind push pays (every
  chain re-shipped ``relay_fanout``-fold, measured by
  ``RelayStats.duplicates``) never hit the wire. ``relay_handshake
  False`` restores blind push (the bench baseline).
* **Digest verification** — receivers STAGE a neighbor's chain
  (``SeekerCache.checkpoint``), verify the staged mirror digest against
  the attested anchor digest at every version the store covers, and
  only then commit + record for forwarding. On mismatch: roll back,
  reject the chain, quarantine the sender for
  ``relay_quarantine_rounds`` (only when the pre-chain mirror itself
  digest-matched an attestation — an unverified base makes blame
  ambiguous, and quarantining on ambiguity is how honest senders get
  falsely convicted), and anti-entropy repair from the anchor, the root
  of trust. Chains reaching past every attested version are deferred,
  not adopted on faith.
* **RelayPlane.round** — build every seeker's payload first (a round is
  a simultaneous exchange), then deliver along the topology. Receivers
  apply chain deltas strictly in version order through the existing
  ``SeekerCache.apply`` contract: duplicates are idempotent skips, and
  a chain that cannot link to the receiver's version is a *gap* —
  repaired by an anti-entropy pull from the anchor when the shard is
  reachable, or by adopting the sender's (digest-verified, when an
  attestation covers it) full shard mirror when it is not. Heartbeat
  columns are adopted only at matching shard versions (identical
  membership), only when strictly fresher, never from a quarantined
  sender, and never with future-dated entries (past the receiver's own
  clock) — staleness is never overstated as freshness.
* **fault_hook** — an injection point on every payload hand-off
  (summary and message): tests and the Byzantine scenario
  (sim/testbed.py) corrupt arbitrary payloads at arbitrary rounds to
  model lying relays. The hook may rewrite chains, hb columns, claimed
  versions — everything a relay could forge. Anchor observations
  (``vv_obs`` + digests) are modeled as SIGNED sightings a relay can
  drop but not forge; the README threat model spells out that boundary.

The scheduler (sync/gossip.py) owns the cadence: one relay round per
gossip round, after the anchor's seed pushes.

Port of ``repro.sync.relay``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.obs.trace import NOOP_TRACER
from repro_torch.sync.delta import HEADER_BYTES, ShardDelta, full_delta
from repro_torch.sync.seeker import SeekerCache

#: gap-repair callback: (seeker, shard, now) -> True iff an anchor pull
#: repaired the shard (False when the shard is partitioned off)
AnchorPull = Callable[[SeekerCache, int, float], bool]

#: per-request framing on the handshake pull leg: shard index + the
#: receiver's mirrored version (what the sender trims the chain against)
PULL_CHAIN_BYTES = 12
PULL_HB_BYTES = 4


@dataclass
class RelayStats:
    rounds: int = 0
    msgs: int = 0                 # relay messages delivered
    msg_bytes: int = 0            # measured wire bytes of those messages
    deltas_applied: int = 0       # chain deltas receivers committed
    duplicates: int = 0           # chain entries skipped as already-held
    wasted_bytes: int = 0         # delivered payload that bought nothing:
                                  # duplicate chain deltas + lease columns
                                  # not adopted — the duplicate-delivery
                                  # volume the handshake exists to cut
    gaps: int = 0                 # chains that could not link
    anchor_repairs: int = 0       # gaps repaired by an anchor pull
    peer_full_syncs: int = 0      # gaps repaired by a neighbor's mirror
    peer_full_bytes: int = 0
    hb_adopted: int = 0           # heartbeat columns taken from neighbors
    vv_forwarded: int = 0         # fresher anchor vv observations adopted
    # -- digest handshake (relay_handshake) ----------------------------------
    summaries: int = 0            # summary payloads delivered
    summary_bytes: int = 0
    chain_pulls: int = 0          # summaries that triggered a pull
    pull_req_bytes: int = 0       # measured pull-request bytes
    # -- Byzantine hardening (relay_verify) ----------------------------------
    digest_mismatches: int = 0    # staged/held state contradicting an
                                  # attested anchor digest
    rejected_chains: int = 0      # staged deltas rolled back on mismatch
    quarantines: int = 0          # senders quarantined for lying
    quarantine_drops: int = 0     # payloads dropped from quarantined senders
    deferred_unattested: int = 0  # chain deltas past every attested version
    mismatch_repairs: int = 0     # mismatches repaired by an anchor pull
    hb_rejected: int = 0          # implausible (future-dated) hb columns

    def seeker_wire_bytes(self) -> int:
        """Total seeker→seeker wire bytes: chain/response messages,
        summaries, pull requests, neighbor full syncs — the quantity the
        handshake gate compares against the blind-push baseline."""
        return (self.msg_bytes + self.summary_bytes
                + self.pull_req_bytes + self.peer_full_bytes)


class RelayTopology:
    """Deterministic k-regular-out random peer sampling per round."""

    def __init__(self, fanout: int, seed: int = 0):
        self.fanout = int(fanout)
        self.seed = int(seed)

    def neighbors(self, n: int, round_idx: int) -> List[np.ndarray]:
        """Per-seeker push targets for one round: ``n`` rows of
        ``min(fanout, n-1)`` distinct indices, never the seeker itself.
        Identical (seed, round) → identical topology."""
        k = min(self.fanout, n - 1)
        if n <= 1 or k <= 0:
            return [np.empty(0, np.int64) for _ in range(n)]
        rng = np.random.default_rng([self.seed, int(round_idx)])
        out = []
        for i in range(n):
            pick = rng.choice(n - 1, size=k, replace=False)
            pick = pick + (pick >= i)          # skip self
            out.append(pick.astype(np.int64))
        return out


@dataclass
class RelaySummary:
    """The handshake's opening leg: what the sender HAS, not the data
    itself. Per shard: mirrored version, mirror digest, hb-lease stamp,
    confirmation stamp; plus the relayed anchor sighting."""

    sender_id: int
    versions: Tuple[int, ...]
    digests: Tuple[int, ...]
    hb_times: np.ndarray                      # (S,) sender lease stamps
    sync_stamps: np.ndarray                   # (S,) confirmation times
    vv_obs: Optional[Tuple[int, ...]] = None
    vv_obs_digests: Optional[Tuple[int, ...]] = None
    vv_obs_time: float = float("-inf")

    def wire_bytes(self) -> int:
        # version + digest + hb stamp + sync stamp per shard, vv stamp once
        n = HEADER_BYTES + 32 * len(self.versions) + 8
        if self.vv_obs is not None:
            n += 8 * len(self.vv_obs)
        if self.vv_obs_digests is not None:
            n += 8 * len(self.vv_obs_digests)
        return n


@dataclass
class RelayMessage:
    """One seeker's data payload: blind-push mode ships it to every
    neighbor whole; handshake mode ships it per receiver, trimmed to the
    shards (and chain suffixes) the receiver asked for."""

    sender_id: int
    versions: Tuple[int, ...]                 # sender's mirrored versions
    chains: List[List[ShardDelta]]            # per shard, version order
    hb_cols: List[Optional[np.ndarray]]       # None = lease too old to help
    hb_times: np.ndarray                      # (S,) sender lease stamps
    sync_stamps: np.ndarray                   # (S,) sender confirmation times
    vv_obs: Optional[Tuple[int, ...]] = None  # freshest anchor vv heard
    vv_obs_digests: Optional[Tuple[int, ...]] = None   # its shard digests
    vv_obs_time: float = float("-inf")
    _wire_bytes: Optional[int] = None         # memo — the message is
                                              # immutable once built

    def wire_bytes(self) -> int:
        if self._wire_bytes is not None:
            return self._wire_bytes
        # versions + sync stamps + hb stamps ride per shard; vv stamp once
        n = HEADER_BYTES + 24 * len(self.versions) + 8
        if self.vv_obs is not None:
            n += 8 * len(self.vv_obs)
        if self.vv_obs_digests is not None:
            n += 8 * len(self.vv_obs_digests)
        for chain in self.chains:
            n += sum(d.wire_bytes() for d in chain)
        for col in self.hb_cols:
            if col is not None:
                n += int(col.nbytes)
        self._wire_bytes = n
        return n


class RelayNode:
    """Relay state riding on one ``SeekerCache``."""

    def __init__(self, seeker: SeekerCache, cfg: GTRACConfig):
        self.seeker = seeker
        self.history = max(1, int(cfg.relay_history))
        self._chains: List["OrderedDict[int, ShardDelta]"] = [
            OrderedDict() for _ in range(seeker.n_shards)]
        self.vv_obs: Optional[Tuple[int, ...]] = None
        self.vv_obs_digests: Optional[Tuple[int, ...]] = None
        self.vv_obs_time: float = float("-inf")
        # attestation store: per shard, anchor (version -> digest)
        # sightings, bounded like the chain history. Sightings are
        # modeled as anchor-signed (a relay can withhold but not forge
        # them — see the threat model); every sighting is collected,
        # freshness-gating applies only to the forwarded vv_obs.
        self._attest: List["OrderedDict[int, int]"] = [
            OrderedDict() for _ in range(seeker.n_shards)]
        # receiver-side quarantine ledger: sender_id -> plane round at
        # which the sentence ends
        self.quarantined: Dict[int, int] = {}

    # -- attestations --------------------------------------------------------

    def note_attestations(self, vv: Sequence[int],
                          digests: Optional[Sequence[int]]) -> None:
        if digests is None:
            return
        for s, (v, d) in enumerate(zip(vv, digests)):
            store = self._attest[s]
            store[int(v)] = int(d)
            store.move_to_end(int(v))
            while len(store) > self.history:
                store.popitem(last=False)

    def attested(self, shard: int, version: int) -> Optional[int]:
        """The attested anchor digest at one (shard, version), if the
        store has heard it."""
        return self._attest[shard].get(int(version))

    def latest_attested(self, shard: int) -> Optional[int]:
        """The freshest attested version for one shard — the adoption
        cap verification enforces (None = nothing attested yet, the
        pre-boot optimistic regime)."""
        store = self._attest[shard]
        return max(store) if store else None

    # -- anchor sightings ----------------------------------------------------

    def observe_anchor(self, vv: Sequence[int], now: float,
                       digests: Optional[Sequence[int]] = None) -> None:
        """An authoritative version-vector (+ digest) sighting (seed
        push or full sync) — what this node will relay onward."""
        self.note_attestations(vv, digests)
        if now >= self.vv_obs_time:
            self.vv_obs, self.vv_obs_time = tuple(vv), float(now)
            if digests is not None:
                self.vv_obs_digests = tuple(int(d) for d in digests)

    def observe_relayed(self, vv: Optional[Tuple[int, ...]], t: float,
                        digests: Optional[Tuple[int, ...]] = None) -> bool:
        """Adopt a neighbor's anchor observation: attestations are
        collected unconditionally (signed facts don't age into lies),
        the forwarded vv_obs only iff strictly fresher. Returns whether
        the sighting was taken."""
        if vv is None:
            return False
        self.note_attestations(vv, digests)
        if t <= self.vv_obs_time:
            return False
        self.vv_obs, self.vv_obs_time = tuple(vv), float(t)
        if digests is not None:
            self.vv_obs_digests = tuple(int(d) for d in digests)
        return True

    # -- quarantine ----------------------------------------------------------

    def quarantine(self, sender_id: int, until_round: int) -> None:
        self.quarantined[int(sender_id)] = int(until_round)

    def is_quarantined(self, sender_id: int, round_idx: int) -> bool:
        until = self.quarantined.get(int(sender_id))
        if until is None:
            return False
        if round_idx >= until:
            del self.quarantined[int(sender_id)]   # sentence served
            return False
        return True

    # -- payloads ------------------------------------------------------------

    def record(self, delta: ShardDelta) -> None:
        """Buffer one applied-and-verified delta for forwarding. Chains
        stay delta-only (full snapshots re-ship on demand via the gap
        path — recording them would multiply whole-shard payloads
        through every hop) and ``relay_history``-bounded; empty
        version-only advances ARE recorded, they are what keeps a chain
        linkable."""
        if delta.is_full:
            return
        chain = self._chains[delta.shard]
        v = int(delta.new_version)
        chain[v] = delta
        chain.move_to_end(v)
        while len(chain) > self.history:
            chain.popitem(last=False)

    def message(self, now: float, ttl_s: float,
                shards: Optional[Set[int]] = None,
                hb_shards: Optional[Set[int]] = None,
                floors: Optional[Dict[int, int]] = None) -> RelayMessage:
        """Snapshot this node's push payload. Blind push sends it whole;
        the handshake passes ``shards`` / ``hb_shards`` (what the
        receiver asked for) and ``floors`` (the receiver's mirrored
        versions) to trim chains to the suffix the receiver lacks."""
        sk = self.seeker
        chains: List[List[ShardDelta]] = []
        hb_cols: List[Optional[np.ndarray]] = []
        hb_times = np.empty(sk.n_shards, np.float64)
        sync_stamps = np.empty(sk.n_shards, np.float64)
        for s in range(sk.n_shards):
            t = sk.hb_stamp(s)
            hb_times[s] = t
            sync_stamps[s] = sk.sync_stamp(s)
            # forward liveness only while the lease is still informative
            want_hb = hb_shards is None or s in hb_shards
            hb_cols.append(sk.mirror(s).last_heartbeat
                           if want_hb and now - t <= ttl_s else None)
            if shards is not None and s not in shards:
                chains.append([])
                continue
            chain = list(self._chains[s].values())
            if floors is not None and s in floors:
                floor = floors[s]
                chain = [d for d in chain if d.new_version > floor]
            chains.append(chain)
        return RelayMessage(
            sender_id=sk.source_id, versions=sk.version_vector,
            chains=chains, hb_cols=hb_cols, hb_times=hb_times,
            sync_stamps=sync_stamps, vv_obs=self.vv_obs,
            vv_obs_digests=self.vv_obs_digests,
            vv_obs_time=self.vv_obs_time)

    def summary(self, now: float) -> RelaySummary:
        """Snapshot this node's handshake opening leg."""
        sk = self.seeker
        hb_times = np.empty(sk.n_shards, np.float64)
        sync_stamps = np.empty(sk.n_shards, np.float64)
        for s in range(sk.n_shards):
            hb_times[s] = sk.hb_stamp(s)
            sync_stamps[s] = sk.sync_stamp(s)
        return RelaySummary(
            sender_id=sk.source_id, versions=sk.version_vector,
            digests=tuple(sk.shard_digest(s)
                          for s in range(sk.n_shards)),
            hb_times=hb_times, sync_stamps=sync_stamps,
            vv_obs=self.vv_obs, vv_obs_digests=self.vv_obs_digests,
            vv_obs_time=self.vv_obs_time)


#: fault-injection hook: (payload, receiver) -> corrupted payload, or
#: None to drop it. Applied to every summary and message hand-off —
#: how tests and sim/testbed.py's Byzantine scenario model lying relays.
FaultHook = Callable[[Union[RelayMessage, RelaySummary], SeekerCache],
                     Optional[Union[RelayMessage, RelaySummary]]]


class RelayPlane:
    """Topology + per-seeker relay nodes + one-round drive."""

    #: sim-domain tracer (rounds and handshakes are instantaneous in
    #: sim time — markers carry the payload sizes and verdicts)
    tracer = NOOP_TRACER

    def __init__(self, cfg: GTRACConfig, fanout: Optional[int] = None,
                 seed: Optional[int] = None,
                 stats: Optional[RelayStats] = None):
        self.cfg = cfg
        self.topology = RelayTopology(
            cfg.relay_fanout if fanout is None else fanout,
            cfg.relay_seed if seed is None else seed)
        self._nodes: Dict[int, RelayNode] = {}     # by seeker.source_id
        self.stats = stats if stats is not None else RelayStats()
        self._round = 0
        self.verify = bool(cfg.relay_verify)
        self.handshake = bool(cfg.relay_handshake)
        self.quarantine_rounds = max(1, int(cfg.relay_quarantine_rounds))
        self.fault_hook: Optional[FaultHook] = None

    def node(self, seeker: SeekerCache) -> RelayNode:
        node = self._nodes.get(seeker.source_id)
        if node is None:
            node = self._nodes[seeker.source_id] = RelayNode(seeker,
                                                             self.cfg)
        return node

    def forget(self, seeker: SeekerCache) -> None:
        """Drop a departed seeker's relay state (scheduler hygiene)."""
        self._nodes.pop(seeker.source_id, None)

    def record(self, seeker: SeekerCache, delta: ShardDelta) -> None:
        """Scheduler hook: an anchor ship this seeker applied — buffer
        it for forwarding."""
        self.node(seeker).record(delta)

    def observe_anchor(self, seeker: SeekerCache, vv: Sequence[int],
                       now: float,
                       digests: Optional[Sequence[int]] = None) -> None:
        self.node(seeker).observe_anchor(vv, now, digests)

    # -- one epidemic round --------------------------------------------------

    def round(self, seekers: Sequence[SeekerCache], now: float,
              anchor_pull: Optional[AnchorPull] = None) -> None:
        """Every seeker pushes to ``relay_fanout`` neighbors drawn for
        this round. Payloads are built first — a round models a
        simultaneous exchange, so what spreads is the state seekers held
        at the round's start. Handshake mode opens with summaries and
        ships data on demand; blind mode pushes whole messages."""
        self.stats.rounds += 1
        n = len(seekers)
        ttl = float(self.cfg.node_ttl_s)
        nbrs = self.topology.neighbors(n, self._round)
        self._round += 1
        tr = self.tracer
        sp = (tr.begin("relay.round", cat="relay", t0=now, push=True,
                       round=self.stats.rounds, seekers=n,
                       handshake=self.handshake) if tr.enabled else None)
        try:
            if self.handshake:
                summaries = [self.node(sk).summary(now) for sk in seekers]
                for i, sk in enumerate(seekers):
                    for j in nbrs[i]:
                        self.exchange(summaries[i], self.node(sk),
                                      seekers[int(j)], now, anchor_pull)
            else:
                msgs = [self.node(sk).message(now, ttl) for sk in seekers]
                for i, sk in enumerate(seekers):
                    for j in nbrs[i]:
                        self.deliver(msgs[i], self.node(sk),
                                     seekers[int(j)], now, anchor_pull)
        finally:
            if sp is not None:
                tr.end(sp, t1=now)

    # -- handshake -----------------------------------------------------------

    def exchange(self, summary: RelaySummary, sender: RelayNode,
                 receiver: SeekerCache, now: float,
                 anchor_pull: Optional[AnchorPull] = None) -> None:
        """One handshake: the sender's summary reaches the receiver,
        which pulls exactly the shards it lacks (chains where behind,
        hb columns where the lease is fresher). Steady state ends here —
        no data moves. A same-version digest divergence is settled
        against the attestation store: a receiver whose own mirror
        matches the attested digest quarantines the contradicting
        sender; one whose mirror doesn't repairs itself from the
        anchor."""
        st = self.stats
        if self.fault_hook is not None:
            summary = self.fault_hook(summary, receiver)
            if summary is None:
                return
        node = self.node(receiver)
        if node.is_quarantined(summary.sender_id, self._round):
            st.quarantine_drops += 1
            return
        st.summaries += 1
        st.summary_bytes += summary.wire_bytes()
        if self.tracer.enabled:
            self.tracer.event("relay.handshake", cat="relay", t=now,
                              sender=summary.sender_id,
                              receiver=receiver.source_id,
                              bytes=summary.wire_bytes())
        if node.observe_relayed(summary.vv_obs, summary.vv_obs_time,
                                summary.vv_obs_digests):
            st.vv_forwarded += 1
        if summary.vv_obs is not None:
            receiver.observe(summary.vv_obs, summary.vv_obs_time)
        want: List[int] = []
        want_hb: List[int] = []
        for s in range(receiver.n_shards):
            cur = receiver.version_vector[s]
            if summary.versions[s] > cur:
                want.append(s)
            elif (self.verify and summary.versions[s] == cur
                    and summary.digests[s] != receiver.shard_digest(s)):
                st.digest_mismatches += 1
                att = node.attested(s, cur)
                if att is None:
                    continue            # no referee — leave it to repair
                if receiver.shard_digest(s) == att:
                    # receiver provably holds anchor state; the sender's
                    # contradicting claim is a lie
                    self._quarantine(node, summary.sender_id, now=now)
                    break
                elif anchor_pull is not None and \
                        anchor_pull(receiver, s, now):
                    st.mismatch_repairs += 1
            if (summary.versions[s] >= receiver.version_vector[s]
                    and summary.hb_times[s] > receiver.hb_stamp(s)):
                want_hb.append(s)
        if node.is_quarantined(summary.sender_id, self._round):
            return                      # convicted mid-handshake
        if not want and not want_hb:
            return
        st.chain_pulls += 1
        st.pull_req_bytes += (HEADER_BYTES + PULL_CHAIN_BYTES * len(want)
                              + PULL_HB_BYTES * len(want_hb))
        msg = sender.message(
            now, float(self.cfg.node_ttl_s), shards=set(want),
            hb_shards=set(want_hb),
            floors={s: receiver.version_vector[s] for s in want})
        self.deliver(msg, sender, receiver, now, anchor_pull)

    # -- delivery ------------------------------------------------------------

    def deliver(self, msg: RelayMessage, sender: RelayNode,
                receiver: SeekerCache, now: float,
                anchor_pull: Optional[AnchorPull] = None) -> None:
        """Apply one relay message to one receiver (see module
        docstring for the verify / gap / duplicate / liveness
        semantics)."""
        st = self.stats
        if self.fault_hook is not None:
            msg = self.fault_hook(msg, receiver)
            if msg is None:
                return
        node = self.node(receiver)
        if node.is_quarantined(msg.sender_id, self._round):
            st.quarantine_drops += 1
            return
        st.msgs += 1
        st.msg_bytes += msg.wire_bytes()
        if self.tracer.enabled:
            self.tracer.event("relay.deliver", cat="relay", t=now,
                              sender=msg.sender_id,
                              receiver=receiver.source_id,
                              bytes=msg.wire_bytes())
        if node.observe_relayed(msg.vv_obs, msg.vv_obs_time,
                                msg.vv_obs_digests):
            st.vv_forwarded += 1
        if msg.vv_obs is not None:
            # refresh staleness clocks on shards the relayed vv confirms
            # (observe is max-guarded: an older sighting cannot rewind)
            receiver.observe(msg.vv_obs, msg.vv_obs_time)
        verify = self.verify
        for s in range(receiver.n_shards):
            if node.is_quarantined(msg.sender_id, self._round):
                break       # convicted on an earlier shard: nothing
                            # else in this message is trusted
            cur = receiver.version_vector[s]
            if verify:
                att0 = node.attested(s, cur)
                if att0 is not None and att0 != receiver.shard_digest(s):
                    # the RECEIVER's held mirror contradicts an attested
                    # digest: poisoned earlier (optimistic adoption
                    # before the attestation arrived) — repair from the
                    # anchor; this sender is not implicated
                    st.digest_mismatches += 1
                    if anchor_pull is not None and \
                            anchor_pull(receiver, s, now):
                        st.mismatch_repairs += 1
                    continue
                # blame is attributable only from a KNOWN-good base
                base_verified = att0 is not None
                cap = node.latest_attested(s)
            else:
                base_verified, cap = False, None
            # chain applications inherit the SENDER's confirmation time
            # (the same contract as _peer_full_sync): data that was last
            # anchor-confirmed at the sender's stamp must not reset the
            # receiver's staleness clock to the delivery time — a
            # behind-the-anchor receiver has to keep routing on a
            # discounted view (apply's max-guard keeps it monotonic)
            t_chain = min(now, float(msg.sync_stamps[s]))
            token = receiver.checkpoint(s)
            applied: List[ShardDelta] = []
            clean = True
            for delta in msg.chains[s]:
                if delta.new_version <= cur:
                    st.duplicates += 1
                    st.wasted_bytes += delta.wire_bytes()
                    continue
                if delta.base_version != cur:
                    break               # chain no longer links — gap
                if cap is not None and delta.new_version > cap:
                    # reaches past every attested version: unverifiable,
                    # defer (the anchor leg will cover it)
                    st.deferred_unattested += 1
                    break
                receiver.apply(delta, t_chain)
                applied.append(delta)
                cur = int(delta.new_version)
                if verify:
                    att = node.attested(s, cur)
                    if att is not None and \
                            att != receiver.shard_digest(s):
                        clean = False
                        break
            if not clean:
                # staged chain contradicts an attested digest: reject it
                # wholesale, repair from the root of trust, and convict
                # the sender if the base it lied on top of was verified
                receiver.restore(s, token)
                st.digest_mismatches += 1
                st.rejected_chains += len(applied)
                if self.tracer.enabled:
                    self.tracer.event("relay.reject", cat="relay", t=now,
                                      shard=s, sender=msg.sender_id,
                                      receiver=receiver.source_id,
                                      chains=len(applied))
                if base_verified:
                    self._quarantine(node, msg.sender_id, now=now)
                if anchor_pull is not None and \
                        anchor_pull(receiver, s, now):
                    st.mismatch_repairs += 1
                continue
            for delta in applied:
                node.record(delta)      # forwardable next round
                st.deltas_applied += 1
            cur = receiver.version_vector[s]
            if cur < msg.versions[s]:
                st.gaps += 1
                if anchor_pull is not None and \
                        anchor_pull(receiver, s, now):
                    st.anchor_repairs += 1
                    if verify and \
                            receiver.version_vector[s] < msg.versions[s]:
                        # the receiver just synced with the root of
                        # trust and the sender's claimed version STILL
                        # doesn't exist there — versions are anchor-
                        # monotonic, so the claim is fabricated (this is
                        # what bounds the repair-bait DoS: one wasted
                        # pull per quarantine sentence, not per round)
                        self._quarantine(node, msg.sender_id, now=now)
                        continue
                else:
                    self._peer_full_sync(sender, receiver, s,
                                         msg.sender_id)
            # liveness epidemic: adopt the sender's lease only at the
            # SAME mirrored version (identical membership), only when
            # strictly fresher, and only when plausible — no entry in a
            # lease column may postdate the receiver's own clock. The
            # carried stamps are NOT the bound: an honest sender's
            # stamps can legitimately understate its data (catch-up
            # ticks back-date lease/confirmation times while shipping
            # current registry columns), but no honest heartbeat can
            # come from the future — which is exactly what a liar
            # forging liveness for a dead peer has to claim to beat a
            # receiver whose lease outlives the quarantine
            col = msg.hb_cols[s]
            if col is not None:
                adopted = False
                if (receiver.version_vector[s] == msg.versions[s]
                        and msg.hb_times[s] > receiver.hb_stamp(s)):
                    horizon = max(float(now), float(msg.hb_times[s]))
                    if verify and len(col) \
                            and float(col.max()) > horizon:
                        st.hb_rejected += 1
                    elif receiver.refresh_heartbeats(
                            s, col.copy(), float(msg.hb_times[s])):
                        st.hb_adopted += 1
                        adopted = True
                if not adopted:
                    st.wasted_bytes += int(col.nbytes)

    def _quarantine(self, node: RelayNode, sender_id: int,
                    now: Optional[float] = None) -> None:
        node.quarantine(sender_id, self._round + self.quarantine_rounds)
        self.stats.quarantines += 1
        if self.tracer.enabled:
            self.tracer.event("relay.quarantine", cat="relay", t=now,
                              sender=sender_id,
                              receiver=node.seeker.source_id,
                              until_round=self._round
                              + self.quarantine_rounds)

    def _peer_full_sync(self, sender: RelayNode, receiver: SeekerCache,
                        shard: int, sender_id: int) -> None:
        """Neighbor anti-entropy: the receiver adopts the sender's full
        shard mirror (the anchor-partitioned-but-relay-reachable path).
        The payload is anchor-originated state at the sender's mirrored
        version — digest-verified against the attestation store when a
        sighting covers that version, adopted optimistically when
        nothing attests it (and audited on later rounds once an
        attestation lands) — and it is stamped with the sender's own
        confirmation/lease clocks, so the receiver inherits the
        sender's staleness rather than claiming freshness."""
        st = self.stats
        v_now = sender.seeker.version_vector[shard]
        if v_now <= receiver.version_vector[shard]:
            return                      # receiver already caught up
        node = self.node(receiver)
        if self.verify:
            cap = node.latest_attested(shard)
            if cap is not None and v_now > cap:
                # claims a version past every signed sighting — an
                # honest sender's head is always covered by the
                # vv_obs_digests it just forwarded, so this can only be
                # a fabricated future: refuse rather than adopt a full
                # no referee can ever audit
                st.deferred_unattested += 1
                return
        fd = full_delta(sender.seeker.mirror(shard), shard=shard,
                        new_version=v_now)
        st.peer_full_bytes += fd.wire_bytes()
        t = min(sender.seeker.sync_stamp(shard),
                sender.seeker.hb_stamp(shard))
        token = receiver.checkpoint(shard)
        receiver.apply(fd, t)           # copy-on-adopt inside apply
        if self.verify:
            att = node.attested(shard, v_now)
            if att is not None and att != receiver.shard_digest(shard):
                receiver.restore(shard, token)
                st.digest_mismatches += 1
                st.rejected_chains += 1
                self._quarantine(node, sender_id)
                return
        st.peer_full_syncs += 1

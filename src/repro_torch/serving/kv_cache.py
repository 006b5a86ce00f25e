"""KV locality for the serving layer: ``KVLocalityTracker``, the
per-stream record of which peer chain holds warm KV state, which is what
turns chain *reuse* into a routing input.

Port of ``repro.serving.kv_cache`` (``KVLocalityTracker`` only, copied
verbatim). The reference's ``cache_bytes`` and ``grow_cache`` join the
port with its KV-cache engine.

Locality model
--------------
Pipeline hops in gtrac_serve are stateless over the wire (activations
relayed per window), but a peer that executed a stream's hops retains that
stream's KV state for its stage. A hop routed back to the same peer only
processes the tokens appended since (``new = prefix_len - warm_pos``); a
hop routed to a fresh peer recomputes the whole prefix. The tracker records
``(stream, peer) -> warm position`` after every successful chain execution,
and the window router folds a per-request reuse *bonus* (a multiplicative
edge-cost discount, configs.base.GTRACConfig.kv_reuse_bonus) over the warm
peers so the K-best DP prefers — never requires — the warm chain.

Invalidation rides the registry/SeekerCache version bumps: ``validate``
is called once per routing window with the current ``PeerTable`` and lazily
drops warm entries for peers that expired out of the registry or whose
trust collapsed below the routing floor (their KV may be gone or should
not attract traffic), so a degraded warm chain loses its bonus the same
window the routing view learns about it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np



class KVLocalityTracker:
    """Which peers hold warm KV for which streams, and how far.

    ``record`` is called after every successful chain execution;
    ``warm_pos`` prices a hop at execution time; ``warm_ids`` feeds the
    window router's per-request reuse bonus; ``validate`` invalidates
    against a fresh routing table (version-keyed, lazy — zero cost while
    the table object is unchanged).
    """

    def __init__(self):
        # stream -> peer -> warm token position
        self._streams: Dict[int, Dict[int, int]] = {}
        # stream -> last successfully executed chain (peer ids, in order)
        self._chains: Dict[int, Tuple[int, ...]] = {}
        self._validated_key: Tuple[int, int] = (-2, -2)
        self.invalidated_peers = 0      # warm entries dropped by validate
        self.invalidated_streams = 0    # streams whose chain record dropped

    # -- recording -----------------------------------------------------------

    def record(self, stream_id: int, chain: Sequence[int],
               pos: int) -> None:
        """Peers on ``chain`` now hold ``stream_id``'s KV through token
        position ``pos`` (the prefix length just executed)."""
        warm = self._streams.setdefault(int(stream_id), {})
        for pid in chain:
            warm[int(pid)] = int(pos)
        self._chains[int(stream_id)] = tuple(int(p) for p in chain)

    def drop_stream(self, stream_id: int) -> None:
        """Stream completed/aborted: its KV slots are reclaimable."""
        self._streams.pop(int(stream_id), None)
        self._chains.pop(int(stream_id), None)

    # -- queries -------------------------------------------------------------

    def warm_pos(self, stream_id: int, peer_id: int) -> int:
        """Tokens of ``stream_id``'s KV held by ``peer_id`` (0 = cold)."""
        return self._streams.get(int(stream_id), {}).get(int(peer_id), 0)

    def warm_ids(self, stream_id: int) -> List[int]:
        """Peers holding any warm KV for the stream (reuse-bonus input)."""
        return list(self._streams.get(int(stream_id), {}))

    def warm_chain(self, stream_id: int) -> Optional[Tuple[int, ...]]:
        """The stream's last successfully executed chain, if still whole
        (every hop's warm entry survived invalidation)."""
        chain = self._chains.get(int(stream_id))
        if chain is None:
            return None
        warm = self._streams.get(int(stream_id), {})
        if all(p in warm for p in chain):
            return chain
        return None

    def chain_warm(self, stream_id: int, chain: Sequence[int],
                   pos: int) -> bool:
        """True iff EVERY hop of ``chain`` holds the stream's KV through
        ``pos`` — the executed step was a full warm-chain hit."""
        warm = self._streams.get(int(stream_id), {})
        return all(warm.get(int(p), 0) >= int(pos) for p in chain)

    # -- invalidation --------------------------------------------------------

    def invalidate_peer(self, peer_id: int) -> int:
        """Drop every stream's warm entry on ``peer_id`` (crash/evict)."""
        pid = int(peer_id)
        dropped = 0
        for warm in self._streams.values():
            if warm.pop(pid, None) is not None:
                dropped += 1
        self.invalidated_peers += dropped
        return dropped

    def validate(self, table, trust_floor: float) -> int:
        """Invalidate warm entries against a routing table snapshot.

        Keyed on the table's ``(source_id, version)`` — while the serving
        window routes from the same snapshot object this is a dict probe.
        On a version bump, warm entries whose peer has left the table, is
        liveness-masked, or fell below ``trust_floor`` are dropped: the
        peer's KV is unreachable (expiry) or must not attract reuse-bonus
        traffic (trust collapse). Returns entries dropped."""
        key = (int(getattr(table, "source_id", -1)),
               int(getattr(table, "version", -1)))
        if key == self._validated_key and key != (-1, -1):
            return 0
        self._validated_key = key
        tracked = {p for warm in self._streams.values() for p in warm}
        if not tracked:
            return 0
        ids = np.asarray(table.peer_ids, np.int64)
        ok_mask = table.alive & (table.trust >= float(trust_floor))
        ok = set(int(p) for p in ids[ok_mask])
        dead = [p for p in tracked if p not in ok]
        dropped = 0
        for pid in dead:
            for warm in self._streams.values():
                if warm.pop(pid, None) is not None:
                    dropped += 1
        if dead:
            for sid in list(self._chains):
                chain = self._chains[sid]
                if any(p not in self._streams.get(sid, {}) for p in chain):
                    del self._chains[sid]
                    self.invalidated_streams += 1
        self.invalidated_peers += dropped
        return dropped

"""Seeded content digests over columnar ``RegistryState`` — the sync
plane's integrity primitive.

A shard digest is the XOR of one 64-bit hash per row (splitmix64-style
finalizer folded over every identity/trust column plus the global ``seq``
stamp) XORed with a seed-keyed empty-state constant. Two properties make
it the right shape for digest-verified gossip (sync/relay.py):

* **Order-independence with order-safety.** XOR composition ignores row
  order, but every row hash folds in ``seq`` — and materialization order
  IS seq order (core/sharding.py, sync/seeker.py) — so two states with
  equal digests compose into bit-identical route tables.
* **Incremental maintenance.** Removing rows R and upserting rows U maps
  to ``digest ^= xor(hash(r) for r in R) ^ xor(hash(u) for u in U)`` —
  O(changed rows), which is exactly what a seeker applying a
  ``ShardDelta`` pays (sync/seeker.py keeps its mirror digests this way;
  the Hypothesis suite pins incremental == from-scratch).

``last_heartbeat`` is deliberately excluded: liveness drifts without
version bumps (delta.py ships it opportunistically, hb leases overwrite
it wholesale), so a digest covering it could never match across honest
replicas at equal versions. Heartbeat fabrication is therefore *not*
detected by digests — see the README threat model for how the quarantine
plane bounds that residual.

The seed (``GTRACConfig.sync_digest_seed``) keys every row hash; a
deployment-private seed turns accidental-collision resistance into
mild adversarial resistance. This is an integrity *checksum* against a
protocol-level liar, not a MAC: a liar who knows the seed can forge a
colliding fabrication, which is why the threat model roots trust in the
anchor's attested (modeled-as-signed) digest sightings, not in digest
secrecy.

Port of ``repro.core.digest``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

import zlib
from typing import Dict

import numpy as np

from repro_torch.core.types import RegistryState

_MASK = 0xFFFFFFFFFFFFFFFF
_GAMMA = 0x9E3779B97F4A7C15          # splitmix64 increment
_EMPTY_SALT = 0xA5A50F0FC3C35A5A     # keys the zero-row digest

_U64 = np.uint64


def mix64(x: int) -> int:
    """Scalar splitmix64 finalizer (the same mixer as
    ``sharding.stable_peer_hash``, reused so digest quality matches the
    shard-placement hash)."""
    x &= _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _mix64_arr(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over a uint64 array."""
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


_PROFILE_HASHES: Dict[str, int] = {}


def _profile_hash(profile: str) -> int:
    """64-bit hash of one profile label, memoized — the label alphabet
    is tiny (a handful of behavior profiles) and reused across every
    row of every digest."""
    h = _PROFILE_HASHES.get(profile)
    if h is None:
        raw = profile.encode("utf-8")
        h = mix64(zlib.crc32(raw) ^ (len(raw) << 32) ^ _GAMMA)
        _PROFILE_HASHES[profile] = h
    return h


def _as_u64(col: np.ndarray) -> np.ndarray:
    """Reinterpret one column as uint64 lanes: integer columns convert
    (negatives wrap, deterministically), float columns go in by bit
    pattern so the digest is exact, not tolerance-based."""
    if col.dtype.kind == "f":
        return np.ascontiguousarray(col, np.float64).view(_U64)
    return col.astype(_U64)


def row_hashes(state: RegistryState, seed: int) -> np.ndarray:
    """One seeded 64-bit hash per row over every digested column
    (identity, layer segment, trust, latency, counters, profile, seq —
    NOT ``last_heartbeat``). Rows hash independently, so any subset's
    contribution to a state digest is the XOR of its row hashes."""
    if state.seq is None:
        raise ValueError("state digest needs a seq column")
    n = len(state.peer_ids)
    h = np.full(n, _U64(mix64(seed ^ _GAMMA)), _U64)
    if n and len(state.profiles) == n:
        prof = np.fromiter((_profile_hash(p) for p in state.profiles),
                           _U64, n)
    else:
        prof = np.zeros(n, _U64)
    with np.errstate(over="ignore"):
        for col in (state.peer_ids, state.layer_start, state.layer_end,
                    state.trust, state.latency_ms, state.successes,
                    state.failures, state.seq):
            h = _mix64_arr(h ^ _as_u64(col))
        h = _mix64_arr(h ^ prof)
    return h


def xor_rows(state: RegistryState, seed: int) -> int:
    """XOR-fold of ``row_hashes`` — the incremental-update term for a
    set of removed or upserted rows."""
    h = row_hashes(state, seed)
    return int(np.bitwise_xor.reduce(h)) if len(h) else 0


def empty_digest(seed: int) -> int:
    """Digest of a zero-row state — the constant every state digest is
    anchored to (and a seeker mirror's boot value)."""
    return mix64((seed & _MASK) ^ _EMPTY_SALT)


def state_digest(state: RegistryState, seed: int) -> int:
    """From-scratch digest of one shard state. O(rows); registries cache
    it per version, seekers maintain it incrementally via ``xor_rows``."""
    return empty_digest(seed) ^ xor_rows(state, seed)

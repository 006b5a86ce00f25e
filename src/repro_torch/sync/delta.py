"""Delta-encoded registry dissemination — the sync plane's wire format.

The anchor control plane owns per-shard columnar ``RegistryState``s whose
``version`` bumps on every record mutation. A gossip round ships each
seeker only what changed since the shard version it mirrors:
``make_delta(base, target)`` diffs two states of one shard and encodes

* ``removed_ids`` — peers present in ``base`` and gone in ``target``
  (deregistered or TTL-swept), and
* ``rows`` — the *changed-row index set* of ``target`` (new peers plus
  peers whose trust / latency / layer segment / counters / seq moved) as
  full column slices in seq order,

with a measured ``wire_bytes()`` accessor and a full-snapshot fallback:
when the delta would ship at least as many bytes as the whole shard
state (mass churn, ``reset_trust``), the delta degrades to ``full``.

Row ordering is the ``seq`` column: every registration carries a
monotonic arrival stamp (core/registry.py), registry row order is always
ascending in seq, and ``apply_delta`` merges surviving base rows with
upserted rows by one stable argsort over seq — so the applied state is
byte-identical to the target, and a seeker composing S shard mirrors in
global seq order reproduces the anchor's composed snapshot bit-for-bit.

``last_heartbeat`` is deliberately NOT a diffed column (steady-state
heartbeat traffic touches every row every round and never bumps shard
versions): liveness freshness rides along on rows shipped for other
reasons and on anti-entropy full syncs, and the seeker prices the drift
via staleness-bounded routing (sync/seeker.py). Pass
``include_heartbeats=True`` for an exact state mirror (tests).

Port of ``repro.sync.delta``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.types import RegistryState

# fixed per-message framing: shard index, base/new versions, column
# lengths — small and constant, counted so empty deltas aren't "free"
HEADER_BYTES = 32

# columns diffed by make_delta (seq is handled separately; last_heartbeat
# is excluded by default — see the module docstring)
_DIFF_COLS = ("layer_start", "layer_end", "trust", "latency_ms",
              "successes", "failures")
_ALL_COLS = ("peer_ids", "layer_start", "layer_end", "trust",
             "latency_ms", "last_heartbeat", "successes", "failures")


class DeltaGapError(RuntimeError):
    """A delta's base version does not match the mirrored shard version:
    the seeker missed an update (or got one out of order) and must
    anti-entropy full-sync that shard."""


def _columns_bytes(state: RegistryState) -> int:
    """Payload bytes of one state's column arrays (+ profile strings,
    NUL-terminated)."""
    n = sum(int(getattr(state, c).nbytes) for c in _ALL_COLS)
    if state.seq is not None:
        n += int(state.seq.nbytes)
    n += sum(len(p) for p in state.profiles) + len(state.profiles)
    return n


def state_wire_bytes(state: RegistryState) -> int:
    """Wire size of shipping ``state`` whole (the full-snapshot cost a
    delta is measured against)."""
    return HEADER_BYTES + _columns_bytes(state)


def slice_state(state: RegistryState, idx: np.ndarray) -> RegistryState:
    """Row-slice a columnar state (fancy-indexed copy of each column)."""
    rows = [int(i) for i in idx]
    return RegistryState(
        peer_ids=state.peer_ids[idx],
        layer_start=state.layer_start[idx],
        layer_end=state.layer_end[idx],
        trust=state.trust[idx],
        latency_ms=state.latency_ms[idx],
        last_heartbeat=state.last_heartbeat[idx],
        successes=state.successes[idx],
        failures=state.failures[idx],
        profiles=[state.profiles[i] for i in rows] if state.profiles
        else [],
        seq=state.seq[idx] if state.seq is not None else None,
    )


def _concat_states(a: RegistryState, b: RegistryState) -> RegistryState:
    return RegistryState(
        peer_ids=np.concatenate([a.peer_ids, b.peer_ids]),
        layer_start=np.concatenate([a.layer_start, b.layer_start]),
        layer_end=np.concatenate([a.layer_end, b.layer_end]),
        trust=np.concatenate([a.trust, b.trust]),
        latency_ms=np.concatenate([a.latency_ms, b.latency_ms]),
        last_heartbeat=np.concatenate([a.last_heartbeat,
                                       b.last_heartbeat]),
        successes=np.concatenate([a.successes, b.successes]),
        failures=np.concatenate([a.failures, b.failures]),
        profiles=list(a.profiles) + list(b.profiles),
        seq=np.concatenate([a.seq, b.seq]),
    )


def copy_state(state: RegistryState) -> RegistryState:
    """Defensive copy for mirror adoption: a fresh ``RegistryState``
    object whose ``last_heartbeat`` column is a private array.

    Full-snapshot messages ship the *same* state object the publisher
    keeps as its delta base (and, on the relay plane, the same object to
    ``relay_fanout`` receivers at once). Adopting it directly would let
    a later ``refresh_heartbeats`` on one seeker rebind the shared
    object's liveness column under every other holder. Row columns are
    never mutated after export (every registry mutation rebuilds them),
    so they stay shared zero-copy; only the object identity and the one
    in-place-refreshed column need to be private."""
    return RegistryState(
        peer_ids=state.peer_ids, layer_start=state.layer_start,
        layer_end=state.layer_end, trust=state.trust,
        latency_ms=state.latency_ms,
        last_heartbeat=state.last_heartbeat.copy(),
        successes=state.successes, failures=state.failures,
        profiles=list(state.profiles),
        seq=state.seq,
    )


def empty_state() -> RegistryState:
    """A zero-row state with a seq column — the seeker's boot mirror."""
    return RegistryState(
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


@dataclass
class ShardDelta:
    """One shard's update: changed rows + removals, or a full snapshot.

    ``base_version`` is the shard version this delta applies on top of
    (``-1`` for full snapshots, which apply on any base);
    ``new_version`` is the shard version after application — the
    seeker's mirrored version vector entry.
    """

    shard: int
    base_version: int
    new_version: int
    removed_ids: np.ndarray                  # (D,) int64
    rows: Optional[RegistryState] = None     # upserted rows, seq order
    full: Optional[RegistryState] = None     # full-snapshot fallback

    @property
    def is_full(self) -> bool:
        return self.full is not None

    @property
    def is_empty(self) -> bool:
        """Version-only advance: nothing to apply (e.g. a liveness-flip
        version bump, or heartbeat-only movement with diffing off)."""
        return (not self.is_full and len(self.removed_ids) == 0
                and (self.rows is None or len(self.rows) == 0))

    def wire_bytes(self) -> int:
        """Measured wire size of this message."""
        if self.full is not None:
            return HEADER_BYTES + _columns_bytes(self.full)
        n = HEADER_BYTES + int(self.removed_ids.nbytes)
        if self.rows is not None:
            n += _columns_bytes(self.rows)
        return n


def full_delta(state: RegistryState, *, shard: int,
               new_version: int) -> ShardDelta:
    """Wrap a whole shard state as the anti-entropy full-sync message."""
    return ShardDelta(shard=shard, base_version=-1,
                      new_version=new_version,
                      removed_ids=np.empty(0, np.int64), full=state)


def make_delta(base: RegistryState, target: RegistryState, *,
               shard: int = 0, base_version: int, new_version: int,
               include_heartbeats: bool = False) -> ShardDelta:
    """Diff two states of one shard into a ``ShardDelta``.

    Vectorized over the id columns: one ``intersect1d`` for the matching,
    one boolean reduction per diffed column. Falls back to a full
    snapshot when the encoded delta would not be smaller than shipping
    the target whole. Both states must carry ``seq`` columns (every
    registry export does).
    """
    if base.seq is None or target.seq is None:
        raise ValueError("delta encoding needs seq columns on both states")
    a_ids, b_ids = base.peer_ids, target.peer_ids
    _, ia, ib = np.intersect1d(a_ids, b_ids, return_indices=True)
    removed = np.setdiff1d(a_ids, b_ids).astype(np.int64)
    added = np.ones(len(b_ids), bool)
    added[ib] = False
    changed = base.seq[ia] != target.seq[ib]
    for col in _DIFF_COLS:
        changed |= getattr(base, col)[ia] != getattr(target, col)[ib]
    if include_heartbeats:
        changed |= base.last_heartbeat[ia] != target.last_heartbeat[ib]
    if base.profiles and target.profiles:
        pa = np.asarray(base.profiles, object)
        pb = np.asarray(target.profiles, object)
        changed |= pa[ia] != pb[ib]
    elif base.profiles or target.profiles:
        changed |= True   # one side dropped its profile labels entirely
    upsert = np.sort(np.concatenate(
        [ib[changed], np.nonzero(added)[0]])).astype(np.int64)
    d = ShardDelta(shard=shard, base_version=base_version,
                   new_version=new_version, removed_ids=removed,
                   rows=slice_state(target, upsert))
    if d.wire_bytes() >= state_wire_bytes(target):
        return full_delta(target, shard=shard, new_version=new_version)
    return d


def apply_delta(base: RegistryState, delta: ShardDelta) -> RegistryState:
    """Apply one delta: drop removed/upserted rows from ``base``, merge
    the upserted rows back in by one stable seq argsort. For a delta
    produced by ``make_delta(base, target)`` the result equals ``target``
    exactly (modulo untouched rows' ``last_heartbeat`` when heartbeat
    diffing was off). Version gating is the caller's job
    (sync/seeker.py) — this is the pure state transform."""
    if delta.full is not None:
        return delta.full
    rows = delta.rows if delta.rows is not None else empty_state()
    if base.seq is None:
        raise ValueError("apply_delta needs a seq column on the base")
    drop = np.concatenate([delta.removed_ids, rows.peer_ids])
    keep = np.nonzero(~np.isin(base.peer_ids, drop))[0]
    kept = slice_state(base, keep)
    merged = _concat_states(kept, rows)
    perm = np.argsort(merged.seq, kind="stable")
    return slice_state(merged, perm)

"""Shard worker: one anchor shard behind a real message boundary.

``ShardHost`` wraps one ``AnchorRegistry`` with the command surface the
composer speaks — register / release / deregister / heartbeats /
apply_report / sweep / set_trust / reset_trust / pull / adopt — and
serves ``pull`` with the sync plane's ``ShardDelta`` wire format
(sync/delta.py): a bounded version→state history makes recent pulls
cheap deltas, anything older (or a respawned worker with no history)
degrades to the anti-entropy full-snapshot fallback. Replies are
deduplicated by request id (a bounded cache of id → reply), so the
composer's retry loop re-posting a lost command gets the original
answer instead of a second application — exactly-once effects over
at-least-once delivery.

Sequence stamps are GLOBAL here: the composer owns the arrival counter
(``_seq_next``) and ships each registration's stamp in the command, and
the host stores it directly in its registry's ``_seq`` map. That makes
``export_state`` ship globally-ordered seq columns natively — the
composer's mirrors compose with one stable argsort, bit-identical to
``ShardedAnchorRegistry.compose_snapshot`` — and keeps ``state_digest``
meaningful across the process boundary with zero re-stamping.

``worker_main`` is the process entry (numpy-only — a shard worker runs
no torch op and never touches CUDA); ``ProcWorker`` is its parent-side
handle implementing the rpc ``Transport`` protocol over multiprocessing
queues, with ``kill()`` (SIGKILL, for chaos drills) and graceful
``close()``. ``LoopbackTransport`` services a host in-process through the
same pickled message path for deterministic tests and benches.

Port of ``repro.control_plane.worker``, copied verbatim except for its
imports and for how ``ProcWorker`` starts a worker. The reference forks;
the port spawns (``START_METHOD``), because the server builds its anchor
in a process that already holds a CUDA context and torch's threads, and
a child forked from such a process may not touch CUDA and may inherit a
lock another thread held. A spawned worker imports ``repro_torch`` (and
with it torch) afresh, which can take longer than an RPC deadline, so
the worker reports ready once it can serve, and ``ProcWorker`` waits for
that report (up to ``STARTUP_TIMEOUT_S``) before it delivers the first
reply: start-up never counts against an RPC's deadline. A worker that
does not report ready fails the call that waits on it (``RuntimeError``);
nothing falls back to an in-process shard.
"""
from __future__ import annotations

import collections
import multiprocessing as mp
import os
import pickle
import queue as _queue
import signal
import time as _time
from typing import Any, Callable, Optional, Tuple

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.registry import AnchorRegistry
from repro_torch.core.types import RegistryState
from repro_torch.sync.delta import ShardDelta, full_delta, make_delta

from repro_torch.control_plane.rpc import RpcTimeout

# replies remembered per worker for retry dedup; retries arrive within a
# handful of in-flight commands of the original, so a small cache is ample
DEDUP_CACHE = 512
#: how ``ProcWorker`` starts a worker process (the reference: ``fork``)
START_METHOD = "spawn"
#: seconds a started worker has to report ready (a fresh interpreter
#: importing torch takes seconds; a worker that misses this fails the run)
STARTUP_TIMEOUT_S = 120.0
#: the reply tag a worker sends once, when it is ready to serve
_READY = "ready"


class ShardHost:
    """One shard's registry + command dispatch (transport-agnostic)."""

    def __init__(self, cfg: GTRACConfig, shard: int,
                 svc_clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg
        self.shard = int(shard)
        self.reg = AnchorRegistry(cfg)
        # version -> exported state, bounded like GossipPublisher history:
        # pull bases we can still delta against
        self.history: "collections.OrderedDict[int, RegistryState]" = \
            collections.OrderedDict()
        self.history_size = max(1, int(getattr(cfg, "gossip_history", 8)))
        self._seen: "collections.OrderedDict[int, Tuple[bool, Any]]" = \
            collections.OrderedDict()
        self.dedup_hits = 0
        # worker-side service-time measurement (cross-process tracing):
        # the worker's own clock — injectable so tests get exact stamps
        self.svc_clock = (svc_clock if svc_clock is not None
                          else _time.perf_counter)
        self._span_seq = 0
        self._stamps: "collections.OrderedDict[int, Tuple[int, float]]" = \
            collections.OrderedDict()

    # -- dispatch ------------------------------------------------------------

    def handle(self, req_id: int, op: str, args: Tuple) -> Tuple[bool, Any]:
        """Service one command; replies are cached by request id so a
        composer retry is answered without re-applying."""
        hit = self._seen.get(req_id)
        if hit is not None:
            self.dedup_hits += 1
            return hit
        try:
            reply = (True, getattr(self, "_op_" + op)(*args))
        except Exception as e:                          # ships as a string:
            reply = (False, f"{type(e).__name__}: {e}")  # tracebacks don't
        self._seen[req_id] = reply                       # pickle reliably
        while len(self._seen) > DEDUP_CACHE:
            self._seen.popitem(last=False)
        return reply

    def handle_stamped(self, req_id: int, op: str,
                       args: Tuple) -> Tuple[bool, Any, Tuple[int, float]]:
        """``handle`` plus a worker-side span stamp ``(span_id, dur_s)``
        — service time measured on the WORKER's clock, shipped in the
        reply so the composer can lay a cross-process ``rpc.worker``
        span under its ``rpc.attempt``. A dedup hit returns the
        original command's stamp (the retry did no new work)."""
        if req_id in self._seen:
            ok, payload = self.handle(req_id, op, args)  # counts the hit
            return ok, payload, self._stamps.get(req_id)
        t0 = self.svc_clock()
        ok, payload = self.handle(req_id, op, args)
        self._span_seq += 1
        stamp = (self._span_seq, float(self.svc_clock() - t0))
        self._stamps[req_id] = stamp
        while len(self._stamps) > DEDUP_CACHE:
            self._stamps.popitem(last=False)
        return ok, payload, stamp

    # -- membership ----------------------------------------------------------

    def _op_register(self, pid: int, layer_start: int, layer_end: int,
                     now: float, profile: str, trust, latency_ms,
                     candidate_seq: int, forced_seq: Optional[int]):
        """Register under a composer-issued global seq stamp.

        ``candidate_seq`` is the composer's next arrival stamp, used only
        if the peer is genuinely fresh on this shard; a present peer keeps
        its stamp (dict semantics), and ``forced_seq`` carries a stamp
        released by the peer's previous shard on a cross-shard move.
        Returns ``(fresh, record)`` — fresh tells the composer to advance
        its counter."""
        reg = self.reg
        present = pid in reg.peers
        rec = reg.register(pid, layer_start, layer_end, now=now,
                           profile=profile, trust=trust,
                           latency_ms=latency_ms)
        if not present:
            reg._seq[pid] = int(forced_seq if forced_seq is not None
                                else candidate_seq)
        used = int(reg._seq[pid])
        reg._seq_next = max(reg._seq_next, used + 1)
        return (not present and forced_seq is None, rec)

    def _op_release(self, pid: int):
        """Cross-shard move, step 1: surrender the peer (and its seq
        stamp) to the composer. Returns ``(present, seq)``."""
        present = pid in self.reg.peers
        seq = int(self.reg._seq[pid]) if present else -1
        if present:
            self.reg.deregister(pid)
        return (present, seq)

    def _op_deregister(self, pid: int):
        self.reg.deregister(pid)
        return True

    # -- liveness / feedback -------------------------------------------------

    def _op_heartbeats(self, ids: np.ndarray, now: float):
        self.reg.heartbeat_all(ids, now)
        return len(ids)

    def _op_apply_report(self, report):
        self.reg.apply_report(report)
        return True

    def _op_sweep(self, now: float, expire_after_s, decay_rate):
        return self.reg.sweep(now, expire_after_s=expire_after_s,
                              decay_rate=decay_rate)

    def _op_set_trust(self, pid: int, trust: float):
        self.reg.set_trust(pid, trust)
        return True

    def _op_reset_trust(self):
        self.reg.reset_trust()
        return True

    # -- sync (the ShardDelta wire) ------------------------------------------

    def _op_pull(self, have_version: int):
        """Ship everything since ``have_version`` as a ``ShardDelta``
        plus the full current heartbeat column (heartbeats never bump
        versions, so every pull refreshes liveness whole — the composer
        mirrors stay exact without per-heartbeat version churn)."""
        reg = self.reg
        version = int(reg.version)
        state = reg.export_state()
        self.history[version] = state
        self.history.move_to_end(version)
        while len(self.history) > self.history_size:
            self.history.popitem(last=False)
        have = int(have_version)
        if have == version:
            delta = ShardDelta(shard=self.shard, base_version=version,
                               new_version=version,
                               removed_ids=np.empty(0, np.int64))
        else:
            base = self.history.get(have) if have >= 0 else None
            if base is None:
                delta = full_delta(state, shard=self.shard,
                                   new_version=version)
            else:
                delta = make_delta(base, state, shard=self.shard,
                                   base_version=have, new_version=version,
                                   include_heartbeats=False)
        return (delta, state.last_heartbeat)

    def _op_adopt(self, state: RegistryState):
        """Restore from a replication ledger (composer-initiated — the
        composer invalidates its mirror right after, so the follow-up
        pull full-syncs)."""
        self.reg.adopt_state(state)
        self.history.clear()
        return int(self.reg.version)

    def _op_adopt_heartbeats(self, hb: np.ndarray):
        self.reg.adopt_heartbeats(hb)
        return True

    def _op_export(self):
        """Ground-truth state for parity checks (tests/bench)."""
        return self.reg.export_state()

    def _op_digest(self):
        return self.reg.state_digest()

    def _op_ping(self):
        return True


def worker_main(cfg: GTRACConfig, shard: int, cmd_q, rep_q) -> None:
    """Process entry: service commands until ``stop``. SIGINT is ignored
    (the composer owns shutdown; ^C in the parent must not orphan-kill
    workers mid-reply), SIGKILL is the chaos path."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    host = ShardHost(cfg, shard)
    # CLOCK_MONOTONIC is system-wide, so the parent reads start-up time
    # from this stamp whenever it gets round to the reply
    rep_q.put((0, True, (_READY, _time.monotonic())))
    while True:
        req_id, op, args = cmd_q.get()
        if op == "stop":
            rep_q.put((req_id, True, True))
            break
        ok, payload, stamp = host.handle_stamped(req_id, op, args)
        rep_q.put((req_id, ok, payload, stamp))


class ProcWorker:
    """Parent-side handle for one shard worker process — the queue-backed
    ``Transport``."""

    def __init__(self, cfg: GTRACConfig, shard: int,
                 start_method: Optional[str] = None):
        self.start_method = start_method or START_METHOD
        #: ms from the start call to the worker's ready report; None
        #: until the first ``poll`` has read that report
        self.startup_ms: Optional[float] = None
        ctx = mp.get_context(self.start_method)
        self.cmd_q = ctx.Queue()
        self.rep_q = ctx.Queue()
        self.proc = ctx.Process(target=worker_main,
                                args=(cfg, int(shard), self.cmd_q,
                                      self.rep_q),
                                name=f"anchor-shard-{int(shard)}",
                                daemon=True)
        self._t_start = _time.monotonic()
        self.proc.start()

    def _wait_ready(self) -> None:
        """Block until the worker reports ready and record its start-up
        ms. Raises ``RuntimeError`` when it dies or stays silent past
        ``STARTUP_TIMEOUT_S``: a worker that cannot start fails the run."""
        if self.startup_ms is not None:
            return
        deadline = self._t_start + STARTUP_TIMEOUT_S
        while True:
            try:
                _, _, (tag, t_ready) = self.rep_q.get(timeout=0.05)
                break
            except _queue.Empty:
                pass
            if not self.proc.is_alive():
                raise RuntimeError(
                    f"{self.proc.name}: worker exited during start-up "
                    f"(exit code {self.proc.exitcode})")
            if _time.monotonic() > deadline:
                raise RuntimeError(
                    f"{self.proc.name}: no ready report within "
                    f"{STARTUP_TIMEOUT_S:.0f}s ({self.start_method})")
        if tag != _READY:
            raise RuntimeError(f"{self.proc.name}: first reply {tag!r} is "
                               "not the ready report")
        self.startup_ms = (t_ready - self._t_start) * 1e3

    # Transport protocol
    def post(self, msg: Tuple) -> None:
        self.cmd_q.put(msg)

    def poll(self, timeout_s: float) -> Tuple:
        self._wait_ready()
        try:
            return self.rep_q.get(timeout=max(1e-4, float(timeout_s)))
        except _queue.Empty:
            raise RpcTimeout(
                f"{self.proc.name}: no reply within {timeout_s:.3f}s")

    def alive(self) -> bool:
        return self.proc.is_alive()

    # lifecycle
    def kill(self) -> None:
        """SIGKILL — the chaos drill. No flush, no goodbye."""
        if self.proc.is_alive() and self.proc.pid is not None:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.join(timeout=5.0)

    def close(self) -> None:
        """Graceful stop (best effort), then reap and release queues."""
        if self.proc.is_alive():
            try:
                self.cmd_q.put((0, "stop", ()))
                self.proc.join(timeout=2.0)
            except Exception:
                pass
        if self.proc.is_alive():
            self.kill()
        for q in (self.cmd_q, self.rep_q):
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass


class LoopbackTransport:
    """In-process ``Transport`` servicing a ``ShardHost`` synchronously.

    Messages and replies pickle-roundtrip by default, so tests exercise
    the exact serialization surface the process transport does (array
    dtypes, dataclass payloads) minus the scheduling nondeterminism.
    Test doubles subclass/wrap this to drop, duplicate, or reorder
    replies."""

    def __init__(self, host: ShardHost, roundtrip: bool = True):
        self.host = host
        self.roundtrip = roundtrip
        self._out: "collections.deque[Tuple[int, bool, Any]]" = \
            collections.deque()
        self._alive = True

    def _codec(self, obj):
        return pickle.loads(pickle.dumps(obj)) if self.roundtrip else obj

    def post(self, msg: Tuple) -> None:
        if not self._alive:
            return                      # a dead worker eats the command
        req_id, op, args = self._codec(msg)
        if op == "stop":
            self._alive = False
            self._out.append((req_id, True, True))
            return
        ok, payload, stamp = self.host.handle_stamped(req_id, op, args)
        self._out.append(self._codec((req_id, ok, payload, stamp)))

    def poll(self, timeout_s: float) -> Tuple:
        if not self._out:
            raise RpcTimeout("loopback: no reply buffered")
        return self._out.popleft()

    def alive(self) -> bool:
        return self._alive

    def kill(self) -> None:
        self._alive = False
        self._out.clear()

    def close(self) -> None:
        self._alive = False

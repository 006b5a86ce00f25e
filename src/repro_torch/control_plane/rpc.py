"""RPC substrate for the out-of-process anchor control plane.

Every composer↔worker exchange goes through an ``RpcChannel``: requests
carry a monotonic per-channel id, replies are matched by that id (so
out-of-order and interleaved delivery is handled by construction), and
every *collect* runs under an ``RpcPolicy`` — a deadline per attempt,
bounded retries, exponential backoff between attempts. Time comes from
an injectable ``Clock``, so tests drive the whole timeout/retry state
machine deterministically with ``FakeClock`` (no sleeps, no flaky wall
time).

Retries RE-POST the same request id: the worker keeps a bounded dedup
cache of request id → reply (control_plane/worker.py), so a command
whose reply was lost is answered from cache instead of being applied
twice — exactly-once application, at-least-once delivery. Replies for
ids the channel no longer waits on (the original reply arriving after a
retry was already answered) are counted and dropped.

``Transport`` is the minimal seam: ``post`` / ``poll`` / ``alive``.
``ProcWorker`` (worker.py) implements it over multiprocessing queues;
``LoopbackTransport`` services a ``ShardHost`` in-process for tests and
deterministic benches, and test doubles wrap either to inject drops,
delays, and duplication.

Port of ``repro.control_plane.rpc``, copied verbatim except for its imports:
it holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Tuple

from repro_torch.configs.base import GTRACConfig
from repro_torch.obs.trace import NOOP_TRACER


class RpcTimeout(RuntimeError):
    """A request exhausted its deadline (and, from ``collect``, its
    retries) without a reply."""


class WorkerDown(RuntimeError):
    """The transport's far end is dead (killed / crashed worker) — no
    amount of retrying will produce a reply."""


class RpcRemoteError(RuntimeError):
    """The worker raised while servicing the command. Deterministic —
    never retried (a retry would just re-raise from the dedup cache)."""


class Clock(Protocol):
    """Injectable time source: monotonic seconds + backoff sleep."""

    def monotonic(self) -> float: ...

    def sleep(self, dt_s: float) -> None: ...


class SystemClock:
    """Wall time — production."""

    def monotonic(self) -> float:
        return _time.monotonic()

    def sleep(self, dt_s: float) -> None:
        if dt_s > 0:
            _time.sleep(dt_s)


class FakeClock:
    """Deterministic test clock: ``sleep`` advances time instantly and
    records each backoff, so a test asserts the exact schedule."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)
        self.sleeps: List[float] = []

    def monotonic(self) -> float:
        return self.t

    def sleep(self, dt_s: float) -> None:
        self.sleeps.append(float(dt_s))
        self.t += max(0.0, float(dt_s))

    def advance(self, dt_s: float) -> None:
        self.t += float(dt_s)


@dataclass(frozen=True)
class RpcPolicy:
    """Deadline + bounded-retry + exponential-backoff parameters."""

    timeout_s: float = 2.0
    retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0

    @classmethod
    def from_config(cls, cfg: GTRACConfig) -> "RpcPolicy":
        return cls(timeout_s=float(cfg.cp_rpc_timeout_s),
                   retries=int(cfg.cp_rpc_retries),
                   backoff_base_s=float(cfg.cp_backoff_base_s),
                   backoff_factor=float(cfg.cp_backoff_factor))

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based): base * factor^n."""
        return self.backoff_base_s * (self.backoff_factor ** attempt)


class Transport(Protocol):
    """One worker's message pipe. ``poll`` returns the next reply tuple
    — ``(req_id, ok, payload)``, or the span-stamped form
    ``(req_id, ok, payload, (worker_span_id, service_dur_s))`` from
    workers that trace their service time — or raises ``RpcTimeout``
    after ``timeout_s`` with nothing to deliver. Channels unpack both
    forms, so transports (and test doubles) may pass tuples through
    opaquely."""

    def post(self, msg: Tuple) -> None: ...

    def poll(self, timeout_s: float) -> Tuple[int, bool, Any]: ...

    def alive(self) -> bool: ...


@dataclass
class RpcStats:
    """Shared mutable counter block (the registry hands one instance to
    every channel, so health counters aggregate for free)."""

    rpc_retries: int = 0        # re-posts after a deadline expiry
    rpc_timeouts: int = 0       # deadline expiries (whether retried or not)
    stale_replies: int = 0      # replies for ids nobody waits on anymore
    remote_errors: int = 0


class RpcChannel:
    """Request/reply channel with pipelining: ``post`` fires a command
    and returns its id; ``collect`` blocks (under the policy's deadline
    / retry / backoff) until that id's reply lands. Replies arriving for
    *other* outstanding ids while collecting are buffered — the batched
    heartbeat fan-in posts to all shards first and collects after, and
    nothing is lost to interleaving."""

    #: span tracer for the rpc clock domain (assigned by the registry
    #: when tracing is on; the class default is the shared no-op)
    tracer = NOOP_TRACER

    def __init__(self, transport: Transport, policy: RpcPolicy,
                 clock: Optional[Clock] = None,
                 stats: Optional[RpcStats] = None,
                 channel_id: int = 0):
        self.transport = transport
        self.policy = policy
        self.clock: Clock = clock if clock is not None else SystemClock()
        self.stats = stats if stats is not None else RpcStats()
        self.channel_id = channel_id
        # per-channel ids namespaced by channel so a respawned worker's
        # fresh dedup cache never collides with another shard's ids
        self._next_id = channel_id << 40
        self._pending: Dict[int, Tuple] = {}    # req_id -> posted msg
        self._replies: Dict[int, Tuple[bool, Any]] = {}

    def post(self, op: str, *args) -> int:
        self._next_id += 1
        req_id = self._next_id
        msg = (req_id, op, args)
        self._pending[req_id] = msg
        self.transport.post(msg)
        return req_id

    def collect(self, req_id: int,
                policy: Optional[RpcPolicy] = None) -> Any:
        """Wait for one posted request's reply under the (overridable)
        policy. Raises ``RpcTimeout`` after the last retry's deadline,
        ``WorkerDown`` as soon as a deadline expires against a dead far
        end, ``RpcRemoteError`` if the worker raised."""
        pol = policy if policy is not None else self.policy
        msg = self._pending.get(req_id)
        if msg is None:
            raise KeyError(f"request {req_id} is not outstanding")
        tr = self.tracer
        traced = tr.enabled
        root = (tr.begin("rpc.collect", cat="rpc", op=msg[1],
                         req_id=req_id, shard=self.channel_id)
                if traced else None)
        attempt = 0
        outcome = "ok"
        try:
            while True:
                att = (tr.begin("rpc.attempt", cat="rpc", parent=root,
                                attempt=attempt) if traced else None)
                got = self._wait_one(req_id, pol.timeout_s)
                if got is not None:
                    self._pending.pop(req_id, None)
                    ok, payload, stamp = got
                    if traced:
                        tr.end(att, ok=bool(ok))
                        if stamp is not None:
                            # worker-side service span, measured by the
                            # worker's own clock and laid back-to-back
                            # against the attempt's end
                            tr.add("rpc.worker", att.t1 - stamp[1],
                                   att.t1, cat="rpc", parent=att,
                                   worker_span=stamp[0])
                    if not ok:
                        self.stats.remote_errors += 1
                        outcome = "remote_error"
                        raise RpcRemoteError(str(payload))
                    return payload
                if traced:
                    tr.end(att, ok=False, timeout=True)
                self.stats.rpc_timeouts += 1
                if not self.transport.alive():
                    self._pending.pop(req_id, None)
                    outcome = "worker_down"
                    raise WorkerDown(f"request {req_id}: worker is dead")
                if attempt >= pol.retries:
                    self._pending.pop(req_id, None)
                    outcome = "timeout"
                    raise RpcTimeout(
                        f"request {req_id}: no reply after "
                        f"{attempt + 1} attempt(s) of {pol.timeout_s}s")
                bo = (tr.begin("rpc.backoff", cat="rpc", parent=root,
                               attempt=attempt) if traced else None)
                self.clock.sleep(pol.backoff(attempt))
                if traced:
                    tr.end(bo)
                attempt += 1
                self.stats.rpc_retries += 1
                self.transport.post(msg)   # same id: worker dedups
        finally:
            if traced:
                tr.end(root, outcome=outcome, attempts=attempt + 1)

    def request(self, op: str, *args,
                policy: Optional[RpcPolicy] = None) -> Any:
        return self.collect(self.post(op, *args), policy=policy)

    def _wait_one(self, req_id: int,
                  timeout_s: float) -> Optional[Tuple[bool, Any, Any]]:
        """One deadline's worth of polling for ``req_id``. Buffers other
        outstanding ids' replies; drops (and counts) stale ones. Returns
        ``(ok, payload, stamp)`` where ``stamp`` is the worker's span
        stamp or ``None`` for un-stamped (legacy 3-tuple) replies."""
        hit = self._replies.pop(req_id, None)
        if hit is not None:
            return hit
        deadline = self.clock.monotonic() + timeout_s
        while True:
            remaining = deadline - self.clock.monotonic()
            if remaining <= 0:
                return None
            try:
                item = self.transport.poll(remaining)
            except RpcTimeout:
                return None
            rid, ok, payload = item[0], item[1], item[2]
            stamp = item[3] if len(item) > 3 else None
            if rid == req_id:
                return (ok, payload, stamp)
            if rid in self._pending:
                # keep only the FIRST reply per outstanding id (a retry
                # raced its original; the worker served both from the
                # same dedup slot, so they are identical)
                if rid not in self._replies:
                    self._replies[rid] = (ok, payload, stamp)
                else:
                    self.stats.stale_replies += 1
            else:
                self.stats.stale_replies += 1

    def forget(self, req_id: int) -> None:
        """Abandon an outstanding request (degraded-shard cleanup)."""
        self._pending.pop(req_id, None)
        self._replies.pop(req_id, None)

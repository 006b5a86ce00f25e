"""Serving admission: the request record and the window admission queue
the trust-routed pipeline server (gtrac_serve.py) batches its windows
from.

Port of ``repro.serving.engine`` — ``Request``, ``_deprecated_submit`` and
``AdmissionQueue``, copied verbatim. The reference's KV-cache
``ServingEngine`` joins the port with its decode-attention kernel.

Submission goes through the unified ``SubmitSpec`` surface
(serving/api.py); the legacy ``submit(prompt, ...)`` keyword form is a
deprecated shim. Request ids come from the admission queue's monotonic
counter, never from queue-state arithmetic.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.api import SubmitSpec


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = field(default_factory=list)
    done: bool = False
    # per-request trust floor for trust-routed serving (gtrac_serve.py);
    # None -> the router's configured floor. Plain engines ignore it.
    tau: Optional[float] = None
    # sim-clock arrival (seconds): admission defers until the window
    # clock reaches it (0.0 = already arrived, the classic behavior)
    arrival_time: float = 0.0
    # stream kind for disaggregated serving: auto | prefill | decode
    kind: str = "auto"

    @classmethod
    def from_spec(cls, spec: SubmitSpec, request_id: int) -> "Request":
        return cls(request_id=int(request_id),
                   prompt=np.asarray(spec.prompt, np.int32),
                   max_new_tokens=int(spec.max_new_tokens),
                   eos_id=spec.eos_id, tau=spec.tau,
                   arrival_time=float(spec.arrival_time), kind=spec.kind)


def _deprecated_submit(owner: str) -> None:
    warnings.warn(
        f"{owner}.submit(prompt, ...) keyword form is deprecated; "
        f"pass a repro_torch.serving.api.SubmitSpec instead",
        DeprecationWarning, stacklevel=3)


class AdmissionQueue:
    """FIFO admission with window batching and arrival-time gating.

    Pending requests are admitted in windows of at most ``max_batch``:
    the plain engine drains whole windows into its static batcher, the
    trust-routed pipeline server tops its active stream set up to the
    window size each token step (continuous batching). Factored out of
    ``ServingEngine`` so both serving layers share one admission policy.

    The queue owns the request-id space: ``next_request_id()`` is a
    monotonic counter (seeded by ``id_base``), so ids stay unique under
    any interleaving of submissions and window pops — the old
    ``len(queue) + admitted`` arithmetic collided as soon as requests
    entered the queue by any path other than the engine's own submit
    (hand-built ``Request`` objects, capacity-deferred arrivals).

    ``registry`` (any registry with a ``sweep(now)`` — the monolithic
    ``AnchorRegistry`` in this slice) couples admission to registry hygiene: each window pop
    that carries a clock runs one ``sweep(now)`` before requests are
    admitted, so TTL expiry / trust decay land ahead of the window's
    routing DP. With a sharded registry the sweep fans out per shard and
    clean shards no-op without touching their snapshot versions.
    """

    def __init__(self, max_batch: int = 64, registry=None, id_base: int = 0):
        self.max_batch = int(max_batch)
        self.registry = registry     # Optional[AnchorRegistry]
        self.pending: List[Request] = []
        self.admitted = 0
        self.swept_peers = 0         # total peers TTL-expired by our sweeps
        self._next_id = int(id_base)

    def __len__(self) -> int:
        return len(self.pending)

    def next_request_id(self) -> int:
        """Allocate the next request id (monotonic, never reused)."""
        rid = self._next_id
        self._next_id += 1
        return rid

    def submit(self, req: Request) -> Request:
        # explicit ids above the counter advance it past them, so a later
        # auto-allocated id can never collide with a pinned one
        self._next_id = max(self._next_id, req.request_id + 1)
        self.pending.append(req)
        return req

    def next_arrival(self) -> Optional[float]:
        """Earliest pending arrival time (None when the queue is empty) —
        the window scheduler's idle-jump target."""
        if not self.pending:
            return None
        return min(r.arrival_time for r in self.pending)

    def next_window(self, capacity: Optional[int] = None,
                    now: Optional[float] = None) -> List[Request]:
        """Pop the next admission window (up to min(max_batch, capacity))
        of *arrived* requests (``arrival_time <= now``; a missing clock
        admits everything). When a registry and a clock are supplied,
        sweep first."""
        if self.registry is not None and now is not None:
            self.swept_peers += self.registry.sweep(now)
        n = self.max_batch if capacity is None \
            else max(0, min(self.max_batch, capacity))
        if now is None:
            window, self.pending = self.pending[:n], self.pending[n:]
        else:
            window, rest = [], []
            for r in self.pending:
                if len(window) < n and r.arrival_time <= now:
                    window.append(r)
                else:
                    rest.append(r)
            self.pending = rest
        self.admitted += len(window)
        return window

    @staticmethod
    def by_prompt_length(reqs: List[Request]) -> Dict[int, List[Request]]:
        """Group a window by prompt length (padding a causal prompt shifts
        RoPE positions and leaks attention onto pad tokens; bucketing is
        the standard fix)."""
        groups: Dict[int, List[Request]] = {}
        for r in reqs:
            groups.setdefault(len(r.prompt), []).append(r)
        return groups

    @staticmethod
    def split_by_kind(reqs: List[Request], prefill_threshold: int)\
            -> Tuple[List[Request], List[Request]]:
        """Classify a window into (prefill, decode) streams.

        The prompt-length buckets decide the split: buckets longer than
        ``prefill_threshold`` (one prefill chunk) become dedicated
        prefill streams; the rest prefill inline in their first decode
        step. A request's explicit ``kind`` ("prefill"/"decode")
        overrides its bucket."""
        prefill: List[Request] = []
        decode: List[Request] = []
        for length, group in sorted(
                AdmissionQueue.by_prompt_length(reqs).items()):
            for r in group:
                if r.kind == "prefill" or \
                        (r.kind == "auto" and length > prefill_threshold):
                    prefill.append(r)
                else:
                    decode.append(r)
        return prefill, decode

"""Batched serving engine: prefill + decode with greedy/temperature
sampling, EOS detection, and a window admission queue (static batching;
the trust-routed pipeline server in gtrac_serve.py layers G-TRAC on top
and shares ``AdmissionQueue`` for its window-batched routing loop).

Port of ``repro.serving.engine``: ``Request``, ``_deprecated_submit`` and
``AdmissionQueue`` copied verbatim, and ``ServingEngine``, the KV-cache
engine, which serves any family ``models/api.build_model`` serves: with
``cfg.attn_impl == "flash"`` a dense model's every decode step runs kernel
K4 (``decode_attention``) in each layer and its prompt kernel K3
(``flash_attention``); RWKV6's prompt runs K5, and Zamba2's runs K6 in
each Mamba2 block and K3 / K4 in each shared-block application.

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
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import build_model
from repro_torch.models.common import strict_fp32_matmul
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


def next_tokens(logits, greedy: bool = True, temperature: float = 1.0,
                generator=None):
    """(B, V) logits -> (B,) next tokens: the first maximum (``greedy``, as
    ``jnp.argmax``), or one draw per row from softmax(logits / temperature)
    with ``generator``."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class ServingEngine:
    """The KV-cache engine: requests admitted in queue windows, grouped by
    prompt length, each group prefilled once into a cache of capacity
    ``S + max_new + capacity_margin`` and decoded one token per step.

    ``device`` is where the model runs: ``cuda`` unless the caller passes
    another (``"cpu"`` in the tests); with no CUDA and no device given this
    raises rather than quietly running on the CPU. ``params`` must already
    live there. Greedy decoding takes the first maximum of the logits, as
    ``jnp.argmax``; sampling draws from a ``torch.Generator`` seeded from
    ``seed`` (the reference's ``jax.random.categorical`` stream cannot be
    reproduced, so sampled tokens differ from the reference's; their
    distribution does not). ``prefills`` and ``decode_steps`` count the
    model calls."""

    def __init__(self, cfg: ModelConfig, params, capacity_margin: int = 64,
                 max_batch: int = 64, device=None):
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = params
        self.margin = capacity_margin
        self.device = resolve_device(device)
        emb = params["embed"]["tok"]
        if emb.device != self.device:
            raise ValueError(f"params live on {emb.device}, the engine runs "
                             f"on {self.device}: build them there "
                             "(init_params / params_from_jax take a device)")
        if self.device.type == "cuda":
            strict_fp32_matmul()   # f32 runs stay full f32 (no TF32)
        self.admission = AdmissionQueue(max_batch=max_batch)
        self.prefills = 0
        self.decode_steps = 0

    @property
    def queue(self) -> List[Request]:
        return self.admission.pending

    def _prefill(self, params, toks, cap: int):
        self.prefills += 1
        return self.model.prefill(params, tokens=toks, capacity=cap)

    def _decode(self, params, token, cache):
        self.decode_steps += 1
        return self.model.decode_step(params, token, cache)

    def submit(self, spec, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None) -> Request:
        """Queue one stream. ``spec`` is a ``SubmitSpec`` (the canonical
        surface); passing a raw prompt array with keywords is the
        deprecated form and forwards through a shim."""
        if not isinstance(spec, SubmitSpec):
            _deprecated_submit("ServingEngine")
            spec = SubmitSpec(prompt=spec,
                              max_new_tokens=(16 if max_new_tokens is None
                                              else max_new_tokens),
                              eos_id=eos_id)
        rid = (self.admission.next_request_id()
               if spec.request_id is None else spec.request_id)
        return self.admission.submit(Request.from_spec(spec, rid))

    def run_batch(self, reqs: Optional[List[Request]] = None,
                  greedy: bool = True, temperature: float = 1.0,
                  seed: int = 0) -> List[Request]:
        """Serve requests to completion, admitted in queue windows and
        grouped by prompt length (``AdmissionQueue.by_prompt_length``)."""
        if reqs is None:
            served: List[Request] = []
            while len(self.admission):
                served += self.run_batch(self.admission.next_window(),
                                         greedy, temperature, seed)
            return served
        if not reqs:
            return []
        for group in AdmissionQueue.by_prompt_length(reqs).values():
            self._run_equal_batch(group, greedy, temperature, seed)
        return reqs

    @torch.inference_mode()
    def _run_equal_batch(self, reqs: List[Request], greedy: bool,
                         temperature: float, seed: int) -> List[Request]:
        toks = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                               dtype=torch.int64, device=self.device)
        max_new = max(r.max_new_tokens for r in reqs)
        cap = toks.shape[1] + max_new + self.margin
        logits, cache = self._prefill(self.params, toks, cap)
        gen = None if greedy else \
            torch.Generator(device=self.device).manual_seed(seed)
        cur = None
        for t in range(max_new):
            if cur is None:
                step_logits = logits
            else:
                step_logits, cache = self._decode(self.params, cur, cache)
            nxt = next_tokens(step_logits[:, -1, :], greedy, temperature, gen)
            cur = nxt[:, None]
            nxt_host = nxt.tolist()
            for i, r in enumerate(reqs):
                if r.done or t >= r.max_new_tokens:
                    continue
                tok = int(nxt_host[i])
                r.output.append(tok)
                if r.eos_id is not None and tok == r.eos_id:
                    r.done = True
            if all(r.done or len(r.output) >= r.max_new_tokens
                   for r in reqs):
                break
        for r in reqs:
            r.done = True
        return reqs

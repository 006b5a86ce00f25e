"""Trust-aware routed pipeline serving — the paper's system, end to end,
with REAL model compute.

The served model is split into contiguous layer stages (StagePartition).
Each *peer* is a stage replica with its own latency/reliability profile
(sim/peers.py); the Anchor tracks trust; the Seeker routes each token's
chain from its cached view (G-TRAC / any baseline), and the ChainExecutor
runs the hops — each hop executes the stage's actual jitted forward on the
hidden states, exactly the paper's layer-sharded activation relay. Hop
payloads are stateless (full-prefix recompute per token), matching the
paper's testbed semantics and making Bounded One-Shot Repair trivially
correct: a replacement peer needs no KV-state transfer.

Peers do, however, retain per-stream KV for their own stage, so the
window-batched loop (``run_queue``) prices every hop by the tokens it must
*freshly* process: a hop routed back to a warm peer pays for the increment,
a cold hop recomputes the prefix (serving/kv_cache.KVLocalityTracker).
``cfg.kv_reuse_bonus`` folds that locality into routing as a per-request
edge-cost discount — the batched K-best DP prefers, never requires, the
warm chain. ``cfg.disaggregate`` splits admission windows by prompt length
(AdmissionQueue.split_by_kind): long prompts prefill in dedicated chunked
windows (``cfg.prefill_chunk_tokens`` per chunk, at most the decode token
budget per window) that run asynchronously against the decode cadence and
hand their warm streams to the continuous decode pool.

Port of ``repro.serving.gtrac_serve``: ``make_stage_fns``, ``sample_token``,
``ServeMetrics``, ``latency_summary``, ``RoutedRequest`` and
``GTRACPipelineServer`` (``submit``, ``run_queue`` with disaggregated
chunked prefill, and ``generate`` under every routing policy of
``core.routing.ALGORITHMS``). Stage compute is PyTorch on an explicit
``device``: every layer's attention goes through kernel K3 with
``attn_impl="flash"``, and each window's batched K-best DP through kernel
K1 when the router backend resolves to ``kernel``. Token tensors stay on
the device. As in the reference, ``run_queue`` always routes through the
batched G-TRAC router, whatever ``algorithm`` says; the anchor may be
sharded (``anchor_shards``), and with ``gossip_enabled`` every window
routes from the gossip seeker's staleness-bounded ``routing_view``
(optionally behind the seeker→seeker relay plane); with
``control_plane="procs"`` every anchor shard lives in its own worker
process behind the RPC control plane (``repro_torch.control_plane``), and
with ``hedge_enabled`` each stream runs the hedged executor
(``core/hedging.py``), whose backup hops run real stage forwards too.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GTRACConfig, ModelConfig
from repro_torch.core.executor import ChainExecutor, split_reports
from repro_torch.core.hedging import HedgedChainExecutor
from repro_torch.core.planner import RoutePlanner, plan_route
from repro_torch.core.registry import SeekerCache
from repro_torch.core.routing import ALGORITHMS
from repro_torch.core.sharding import make_registry
from repro_torch.core.types import HopReport
from repro_torch.distributed.pipeline import StagePartition
from repro_torch.models.common import (apply_norm, cast_matmul_weights,
                                       cast_once_count, embed_tokens,
                                       logits_head, strict_fp32_matmul)
from repro_torch.models.rope import positional_angles
from repro_torch.models.transformer import block_forward, require_decoder
from repro_torch.obs.metrics import MetricsRegistry, percentiles
from repro_torch.obs.trace import (NOOP_SPAN, NOOP_TRACER, TraceBuffer,
                                   Tracer, wall)
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.batch_router import BatchRouter
from repro_torch.serving.engine import (AdmissionQueue, Request,
                                        _deprecated_submit)
from repro_torch.serving.kv_cache import KVLocalityTracker
from repro_torch.sim.peers import PROFILES, SimPeer, make_peer
from repro_torch.sim.testbed import Testbed
from repro_torch.sync.gossip import make_sync_plane


# ---------------------------------------------------------------------------
# Real stage compute
# ---------------------------------------------------------------------------


def make_stage_fns(cfg: ModelConfig, params, partition: StagePartition):
    """One fn per stage: stage 0 embeds, last stage emits logits.

    A payload is ``(tokens (B, S) int64, x)`` with ``x`` None at stage 0;
    the last stage returns ``(tokens, logits (B, 1, V))`` of the last
    position. Every payload holds its stream's whole prefix, so positions
    run 0..S-1 in every hop: a RoPE stage builds its angles from them, and
    an M-RoPE (vlm) stage its text-only angles (the three streams equal),
    as the reference does in each stage. Serves the dense, MoE and vlm
    decoders (an MoE layer's load-balance loss is dropped, as the
    reference's stage drops it). Runs under ``torch.inference_mode``. Wall
    span ``model.stage`` around ``model.embed`` (stage 0), the layers'
    spans and ``model.head`` (last stage).

    The stages close over one ``cast_matmul_weights`` copy of ``params``,
    taken here and shared by every replica of a stage: their matmuls read
    the activation-dtype weights without a cast. A caller that changes
    ``params`` afterwards builds the stage functions (or the server)
    anew."""
    require_decoder(cfg)
    n = partition.n_stages
    params = cast_matmul_weights(cfg, params)

    def stage_fn(i: int):
        s, e = partition.segment(i)
        layers = params["layers"][s:e]

        @torch.inference_mode()
        def fn(payload):
            tokens, x = payload                     # x may be None at stage 0
            B, S = tokens.shape
            tr = wall()
            with tr.span("model.stage") if tr.enabled else NOOP_SPAN:
                if i == 0:
                    with tr.span("model.embed") if tr.enabled else NOOP_SPAN:
                        x = embed_tokens(cfg, params["embed"], tokens)
                pos = torch.arange(S, device=tokens.device)[None, :].expand(
                    B, S)
                angles = positional_angles(cfg, pos)  # None unless rotary
                for lp in layers:
                    x, _ = block_forward(cfg, lp, x, angles)
                if i == n - 1:
                    with tr.span("model.head") if tr.enabled else NOOP_SPAN:
                        x = apply_norm(cfg, params["final_norm"], x)
                        x = logits_head(cfg, params["embed"], x[:, -1:, :])
                return tokens, x

        return fn

    return [stage_fn(i) for i in range(n)]


@dataclass
class StageStats:
    """The stage forwards the routed hops run (``_hop_fn``; repairs and
    hedge backups included), counted with plain integer adds:
    ``forwards``; ``positions``, the sum of B·S·layers, what the stages
    compute, each hop's payload holding its stream's whole prefix;
    ``fresh``, the sum of ntok·layers, what the simulation charges (the
    prefix less the peer's warm KV). ``positions / fresh`` is how many
    positions the card computes for each one charged. Each server keeps
    its own (``stage_stats``, exposed as ``stage/*``); ``last_stage_stats``
    hands the newest server's to a reader with no handle on the server."""
    forwards: int = 0
    positions: int = 0
    fresh: int = 0


_last_stage_stats: Optional[StageStats] = None


def last_stage_stats() -> Optional[StageStats]:
    """The stage counters of the server made last in this process (they
    outlive it); None before any."""
    return _last_stage_stats


def sample_token(logits, rng: np.random.Generator,
                 temperature: float = 1.0) -> int:
    """Temperature sampling off the testbed RNG: softmax of the last
    position's logits at ``temperature``, one categorical draw. Runs on
    host numpy — the testbed's RNG is the single source of randomness
    for the whole sim (failures, latencies, sampling), which keeps runs
    reproducible per seed."""
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    z = np.asarray(logits, np.float64).reshape(-1)
    z = z / max(float(temperature), 1e-6)
    z -= z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


# ---------------------------------------------------------------------------
# Routed pipeline server
# ---------------------------------------------------------------------------


@dataclass
class ServeMetrics:
    tokens: int = 0
    failures: int = 0
    repairs: int = 0
    rerouted: int = 0
    token_latency_ms: List[float] = field(default_factory=list)
    infeasible: int = 0
    # hedged window serving (cfg.hedge_enabled): cumulative hedge counters
    # mirrored from the stream's HedgedChainExecutor after every window
    hedges_fired: int = 0
    hedges_won: int = 0
    # gossip serving (cfg.gossip_enabled): worst per-shard seeker-cache
    # staleness (in gossip rounds) seen while this stream was active
    stale_rounds_max: int = 0
    # relay serving (cfg.relay_enabled): cumulative relay-plane totals
    # (payloads delivered — data messages AND handshake summaries — and
    # measured seeker→seeker wire bytes) at stream completion
    relay_msgs: int = 0
    relay_bytes: int = 0
    # Byzantine hardening (cfg.relay_verify): duplicate deliveries the
    # handshake suppresses, plus the digest-verification outcome totals
    relay_duplicates: int = 0
    relay_digest_mismatches: int = 0
    relay_rejected_chains: int = 0
    relay_quarantines: int = 0
    # process control plane (cfg.control_plane="procs"): cumulative
    # composer health totals (control_plane/registry.py) at stream
    # completion — RPC deadline expiries / re-posts, windows served with
    # >= 1 degraded or dead shard, and worker respawns
    shard_rpc_retries: int = 0
    shard_timeouts: int = 0
    degraded_windows: int = 0
    worker_restarts: int = 0
    # streaming latency: sim-clock emission stamp (ms) of every token and
    # time-to-first-token relative to the request's arrival_time; ITL is
    # the diff of consecutive emission stamps (see ``itl_ms``)
    ttft_ms: float = -1.0                  # -1 until the first token lands
    emit_ms: List[float] = field(default_factory=list)
    # disaggregated serving (cfg.disaggregate): dedicated prefill windows
    # executed for this stream before it joined the decode pool
    prefill_chunks: int = 0
    prefill_tokens: int = 0
    # KV locality (serving/kv_cache.py): decode steps whose routed chain
    # held the stream's warm KV end to end vs. steps routed off it and
    # recomputing (first-contact steps with nothing to reuse count as
    # neither)
    kv_warm_hits: int = 0
    kv_cold_steps: int = 0

    def itl_ms(self) -> List[float]:
        """Inter-token latencies: diffs of consecutive emission stamps."""
        e = self.emit_ms
        return [b - a for a, b in zip(e, e[1:])]


def latency_summary(reqs: Sequence["RoutedRequest"]) -> Dict[str, float]:
    """Aggregate p50/p99 TTFT + inter-token latency, the warm-chain hit
    rate, and the completion rate over a set of served streams
    (launch/serve.py, benchmarks). Percentiles are -1.0 when no samples
    exist (``obs.metrics.percentiles`` — the repo-wide helper).

    A stream whose ``ttft_ms`` is still the -1 sentinel never emitted a
    token (infeasible route, unrepaired failure): it is counted as
    ``incomplete`` and excluded from the TTFT percentiles rather than
    silently poisoning them."""
    ttfts = [r.metrics.ttft_ms for r in reqs if r.metrics.ttft_ms >= 0]
    itls: List[float] = []
    for r in reqs:
        itls += r.metrics.itl_ms()
    warm = sum(r.metrics.kv_warm_hits for r in reqs)
    cold = sum(r.metrics.kv_cold_steps for r in reqs)
    t50, t99 = percentiles(ttfts, (50, 99))
    i50, i99 = percentiles(itls, (50, 99))
    n = len(reqs)
    completed = len(ttfts)
    return {"ttft_p50_ms": t50, "ttft_p99_ms": t99,
            "itl_p50_ms": i50, "itl_p99_ms": i99,
            "warm_hit_rate": warm / max(1, warm + cold),
            "requests": n, "completed": completed,
            "incomplete": n - completed,
            "completion_rate": completed / n if n else -1.0}


# ServeMetrics stream field <- obs.MetricsRegistry snapshot keys (summed).
# A field fills only when every key is present, i.e. when the layer that
# owns it was wired into the registry — absent layers leave the dataclass
# defaults, exactly like the old per-layer mirroring did.
_STREAM_VIEW: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("relay_msgs", ("relay/msgs", "relay/summaries")),
    ("relay_bytes", ("relay/wire_bytes",)),
    ("relay_duplicates", ("relay/duplicates",)),
    ("relay_digest_mismatches", ("relay/digest_mismatches",)),
    ("relay_rejected_chains", ("relay/rejected_chains",)),
    ("relay_quarantines", ("relay/quarantines",)),
    ("shard_rpc_retries", ("control_plane/rpc_retries",)),
    ("shard_timeouts", ("control_plane/rpc_timeouts",)),
    ("degraded_windows", ("control_plane/degraded_windows",)),
    ("worker_restarts", ("control_plane/worker_restarts",)),
)


@dataclass
class RoutedRequest(Request):
    """Engine admission request + per-stream routed serving state."""

    metrics: ServeMetrics = field(default_factory=ServeMetrics)
    tokens: Optional[torch.Tensor] = None   # (1, S) running token tensor
    # ChainExecutor, or HedgedChainExecutor when cfg.hedge_enabled
    executor: Optional[object] = None
    # disaggregated prefill progress: prompt tokens prefilled so far, the
    # sim time the in-flight chunk completes, and the first decode token
    # computed by the final chunk (emitted at promotion time)
    prefill_pos: int = 0
    busy_until: float = 0.0
    _pending_tok: int = 0


class GTRACPipelineServer:
    """Serve a model across simulated stage-replica peers under a routing
    policy. Peers execute REAL stage compute; failures/latency are injected
    per their profile; trust state evolves exactly as in the paper."""

    def __init__(self, cfg: ModelConfig, params,
                 layers_per_stage: int,
                 replicas: Dict[str, int] = None,
                 gcfg: Optional[GTRACConfig] = None,
                 algorithm: str = "gtrac",
                 seed: int = 0,
                 device=None,
                 router_backend: str = "auto"):
        """``device`` is where stage compute and the routing DP run:
        ``cuda`` unless the caller passes another (``"cpu"`` in the
        tests); with no CUDA and no device given this raises rather than
        quietly running on the CPU. ``params`` must already live there.
        The stage functions serve from a copy of its matmul weights cast
        to the activation dtype now (``make_stage_fns``); ``cast_once``
        counts the leaves copied and their bytes. ``router_backend``
        picks the window router's DP (``serving/batch_router.BACKENDS``)."""
        self.cfg = cfg
        self.gcfg = gcfg or GTRACConfig()
        self.algorithm = algorithm
        self.device = resolve_device(device)
        emb = params["embed"]["tok"]
        if emb.device != self.device:
            raise ValueError(f"params live on {emb.device}, the server runs "
                             f"on {self.device}: build them there "
                             "(init_params / params_from_jax take a device)")
        if self.device.type == "cuda":
            strict_fp32_matmul()   # f32 runs stay full f32 (no TF32)
        self.partition = StagePartition.uniform(cfg.num_layers,
                                                layers_per_stage)
        self.stage_fns = make_stage_fns(cfg, params, self.partition)
        self.cast_once = cast_once_count(cfg, params)
        rng = np.random.default_rng(seed)
        # any Registry (core/sharding.py): monolithic anchor for
        # cfg.anchor_shards=1, hash-partitioned ShardedAnchorRegistry
        # otherwise — the planner / window router consume its composed
        # snapshot unchanged
        anchor = make_registry(self.gcfg, shards=self.gcfg.anchor_shards,
                               shard_by=self.gcfg.shard_by)
        # process-backed control plane (cfg.control_plane="procs"): the
        # composer carries health counters and its own staleness-priced
        # routing_view (degraded shards' slices serve stale, discounted)
        self._cp = anchor if hasattr(anchor, "health") else None
        peers: Dict[int, SimPeer] = {}
        replicas = replicas or {"honeypot": 2, "turtle": 2, "golden": 2}
        pid = 0
        for i in range(self.partition.n_stages):
            s, e = self.partition.segment(i)
            for name, k in replicas.items():
                for _ in range(k):
                    peer = make_peer(pid, s, e, PROFILES[name], rng)
                    peers[pid] = peer
                    anchor.register(pid, s, e, now=0.0, profile=name)
                    anchor.heartbeat(pid, 0.0)
                    pid += 1
        self.bed = Testbed(cfg=self.gcfg, total_layers=cfg.num_layers,
                           peers=peers, anchor=anchor, rng=rng)
        self.seeker = SeekerCache(anchor, self.gcfg, now=0.0)
        # gossip sync plane (cfg.gossip_enabled): routing reads a
        # delta-synced shard-mirror cache (repro_torch.sync) instead of the
        # in-process snapshot; staleness-bounded routing_view discounts
        # trust on shards the seeker cannot confirm
        self.gossip = None
        self.sync_seeker = None
        if self.gcfg.gossip_enabled:
            # routing reads seeker 0; with cfg.relay_enabled the rest of
            # cfg.gossip_seekers carry the epidemic relay plane (the
            # anchor then pushes only to gossip_fanout seeds per round)
            _, sync_seekers, self.gossip = make_sync_plane(
                anchor, self.gcfg,
                n_seekers=max(1, self.gcfg.gossip_seekers), now=0.0)
            self.sync_seeker = sync_seekers[0]
        # per-server planner: compiled CSR graph + K-best plans are reused
        # across every token routed from an unchanged registry snapshot
        self.planner = RoutePlanner(cfg.num_layers,
                                    k_best=self.gcfg.k_best_routes,
                                    cache_size=self.gcfg.planner_cache_size)
        # window-batched routing: concurrent streams submitted per token
        # window are solved in ONE batched device DP (serving/batch_router)
        self.router = BatchRouter(planner=self.planner, cfg=self.gcfg,
                                  total_layers=cfg.num_layers,
                                  backend=router_backend,
                                  device=self.device)
        # admission owns the per-window registry sweep (per-shard fan-out
        # when the anchor is sharded) AND the request-id space: ids come
        # from its monotonic counter, seeded clear of generate()'s
        self.admission = AdmissionQueue(max_batch=self.gcfg.router_max_batch,
                                        registry=anchor, id_base=10_000)
        # which peers hold which stream's warm KV — prices hops by freshly
        # processed tokens and feeds the router's chain-reuse bonus
        self.kv = KVLocalityTracker()
        # (request_id, peer_id) -> rescale factor for the last multi-token
        # hop charge; consumed by _apply_report before the anchor EMA
        self._tok_scale: Dict[Tuple[int, int], float] = {}
        self._stage_of = {}  # layer_start -> stage idx
        self._stage_layers = []
        for i in range(self.partition.n_stages):
            s, e = self.partition.segment(i)
            self._stage_of[s] = i
            self._stage_layers.append(e - s)
        # unified telemetry plane: every layer's live stats object is a
        # view in ONE registry — router, gossip, relay (plus the derived
        # wire-byte total) and the composer's health counters — and the
        # per-stream ServeMetrics relay/control-plane fields fill from
        # its snapshot (_fill_stream_metrics), not from hand-written
        # mirroring per layer
        self.obs = MetricsRegistry()
        self.obs.expose("router", self.router.stats)
        global _last_stage_stats
        self.stage_stats = _last_stage_stats = StageStats()
        self.obs.expose("stage", self.stage_stats)
        if self.gossip is not None:
            self.obs.expose("gossip", self.gossip.stats)
            if self.gossip.relay is not None:
                rs = self.gossip.relay.stats
                self.obs.expose("relay", rs)
                self.obs.derived("relay/wire_bytes", rs.seeker_wire_bytes)
        if self._cp is not None:
            self.obs.expose("control_plane", self._cp.health)
        # end-to-end tracing (cfg.trace_enabled): one sim-clock tracer
        # shared by routing, serving, executors, gossip and relay, plus
        # an "rpc" scope on the composer's wall clock so control-plane
        # spans keep their own time domain in the same buffer. Disabled,
        # every site sees the shared NOOP_TRACER and pays one attribute
        # check — no allocation, no clock read.
        self.trace: Optional[TraceBuffer] = None
        self.tracer = NOOP_TRACER
        self._req_spans: Dict[int, object] = {}
        if self.gcfg.trace_enabled:
            self.trace = TraceBuffer(self.gcfg.trace_capacity)
            self.tracer = Tracer(self.trace, clock=lambda: self.bed.now,
                                 domain="serve")
            self.router.tracer = self.tracer
            if self.gossip is not None:
                self.gossip.tracer = self.tracer
                if self.gossip.relay is not None:
                    self.gossip.relay.tracer = self.tracer
            if self._cp is not None:
                self._cp.set_tracer(self.tracer.scope(
                    "rpc", clock=self._cp.clock.monotonic))

    # -- hop adapter -----------------------------------------------------------

    def _hop_fn(self, request_id: int, kv_tracked: bool = False):
        """Hop closure for one stream. With ``kv_tracked`` (the window
        loop) a hop is charged for the tokens it freshly processes —
        prefix length minus the peer's warm KV position — so warm chains
        decode at incremental cost while cold hops recompute. The default
        keeps ``generate``'s classic flat per-token charge. Each stage
        forward counts into ``stage_stats``."""
        def hop(peer_id: int, k: int, payload):
            peer = self.bed.peers[peer_id]
            if not self.bed.reachable(peer_id) or \
                    peer.fails_in_request(request_id, self.bed.rng):
                detect = self.gcfg.request_timeout_ms * 0.25
                return payload, detect, False
            stage = self._stage_of[peer.layer_start]
            out = self.stage_fns[stage](payload)   # REAL compute
            B, prefix = payload[0].shape
            ntok = 1
            if kv_tracked:
                ntok = max(1, prefix - self.kv.warm_pos(request_id, peer_id))
                if ntok > 1:
                    # latency_est_ms means ONE decode step everywhere
                    # (routing costs, hedge triggers) — remember how to
                    # rescale this multi-token observation back to its
                    # single-token equivalent before the anchor EMA sees
                    # it, or a prefill chunk / cold recompute makes the
                    # charged peer look slow and routing ping-pongs
                    # between replicas, each flip paying a full-prefix
                    # recompute.
                    one = peer.compute_ms(1) + peer.net_delay_ms
                    full = peer.compute_ms(ntok) + peer.net_delay_ms
                    self._tok_scale[(request_id, peer_id)] = one / full
            layers = self._stage_layers[stage]
            st = self.stage_stats
            st.forwards += 1
            st.positions += B * prefix * layers
            st.fresh += ntok * layers
            return out, peer.hop_latency_ms(self.bed.rng, tokens=ntok), True

        return hop

    # -- route-table source ----------------------------------------------------

    def _sync_and_view(self):
        """Background sync tick + the table routing consumes this window:
        the gossip seeker's staleness-bounded ``routing_view`` when the
        sync plane is on, the classic in-process snapshot cache
        otherwise. Never a synchronous registry read on the request path
        either way."""
        now = self.bed.now
        if self.gossip is not None:
            self.gossip.maybe_tick(now)
            return self.sync_seeker.routing_view(now)
        self.seeker.maybe_sync(now)
        if self._cp is not None:
            # process backend: the sync above pulled the shard mirrors;
            # route on the composer's staleness-priced view so degraded
            # shards' rows are trust-discounted instead of trusted stale
            return self._cp.routing_view(now)
        return self.seeker.view()

    # -- serving ---------------------------------------------------------------

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 request_id: int = 0, greedy: bool = True,
                 temperature: float = 1.0)\
            -> Tuple[np.ndarray, ServeMetrics]:
        tokens = self._token_tensor(prompt)
        metrics = ServeMetrics()
        t_start = self.bed.now
        route_fn = ALGORITHMS[self.algorithm]
        executor = ChainExecutor(self.gcfg, self._hop_fn(request_id))
        tr = self.tracer
        traced = tr.enabled
        rsp = None
        if traced:
            executor.tracer = tr
            rsp = tr.begin("request", cat="request", t0=t_start,
                           rid=request_id)

        for _ in range(max_new_tokens):
            table = self._sync_and_view()
            plan = None
            if self.algorithm == "gtrac":
                # planner path: K-best plan cached per snapshot version
                route, plan = plan_route(table, self.cfg.num_layers,
                                         self.gcfg, planner=self.planner)
            else:
                kwargs = ({"rng": self.bed.rng}
                          if self.algorithm == "naive" else {})
                route = route_fn(table, self.cfg.num_layers, self.gcfg,
                                 **kwargs)
            if not route.feasible:
                metrics.infeasible += 1
                break
            t_tok = self.bed.now
            report, payload = executor.execute(route.chain, table,
                                               payload=(tokens, None),
                                               plan=plan)
            for rep in split_reports(report):
                self.bed.anchor.apply_report(rep)
            metrics.repairs += int(report.repaired)
            metrics.rerouted += int(report.repaired)
            self.bed.advance(report.total_latency_ms / 1e3)
            if traced:
                ssp = tr.add("decode.step", t_tok, self.bed.now,
                             cat="decode", parent=rsp, rid=request_id,
                             emitted=report.success,
                             first_token=(report.success
                                          and metrics.ttft_ms < 0))
                self._trace_hops(ssp, t_tok, report)
            if not report.success:
                metrics.failures += 1
                break
            _, logits = payload
            if greedy:
                nxt = torch.argmax(logits[:, -1, :], -1)
            else:
                tok = sample_token(logits[:, -1, :], self.bed.rng,
                                   temperature)
                nxt = torch.full((tokens.shape[0],), tok, dtype=tokens.dtype,
                                 device=tokens.device)
            tokens = torch.cat([tokens, nxt[:, None].to(tokens.dtype)], dim=1)
            metrics.tokens += 1
            metrics.token_latency_ms.append(report.total_latency_ms)
            metrics.emit_ms.append(self.bed.now * 1e3)
            if metrics.ttft_ms < 0:
                metrics.ttft_ms = (self.bed.now - t_start) * 1e3
        self.bed.peers and [p.forget_request(request_id)
                            for p in self.bed.peers.values()]
        if traced:
            tr.end(rsp, t1=self.bed.now, ttft_ms=metrics.ttft_ms,
                   stale_rounds_max=metrics.stale_rounds_max)
        self._fill_stream_metrics(metrics)
        return tokens[0, len(prompt):].cpu().numpy().astype(np.int32), metrics

    def _fill_stream_metrics(self, metrics: ServeMetrics) -> None:
        """Surface cumulative relay-plane / composer-health totals on a
        stream's metrics from ONE registry snapshot (``_STREAM_VIEW``).
        Fields whose owning layer is absent keep their defaults."""
        snap = self.obs.snapshot()
        for name, keys in _STREAM_VIEW:
            if all(k in snap for k in keys):
                setattr(metrics, name, sum(snap[k] for k in keys))

    def close(self) -> None:
        """Release control-plane resources (shard worker processes).
        Idempotent; a no-op for in-process registries."""
        fn = getattr(self.bed.anchor, "close", None)
        if fn is not None:
            fn()

    def _token_tensor(self, prompt) -> torch.Tensor:
        """(1, S) int64 token tensor on the server's device."""
        return torch.as_tensor(np.asarray(prompt, np.int64),
                               device=self.device)[None, :]

    def _trace_hops(self, parent, t0: float, report) -> None:
        """Synthesize per-hop child spans under an exec span from the
        report's drawn latencies — hop latencies tile the step exactly
        (sum == total_latency_ms), so the serving hot path never reads
        the clock per hop."""
        tr = self.tracer
        t = t0
        for h in report.hops:
            t1 = t + h.latency_ms / 1e3
            tr.add("hop", t, t1, cat="exec", parent=parent,
                   peer=h.peer_id, ok=h.success)
            t = t1

    # -- window-batched serving (the batch router path) ------------------------

    def submit(self, spec, max_new_tokens: int = 16,
               tau: Optional[float] = None,
               request_id: Optional[int] = None) -> RoutedRequest:
        """Queue a stream for window-batched serving.

        ``spec`` is a ``repro.serving.api.SubmitSpec`` — the unified
        submission surface; its ``tau`` is this request's trust floor
        (row of the batched DP's tau vector, None = configured floor),
        ``arrival_time`` defers admission, ``kind`` pins the stream to
        the prefill/decode split under ``cfg.disaggregate``. Passing a
        raw prompt array with keywords is the deprecated pre-SubmitSpec
        form and forwards through a shim."""
        if not isinstance(spec, SubmitSpec):
            _deprecated_submit("GTRACPipelineServer")
            spec = SubmitSpec(prompt=spec, max_new_tokens=max_new_tokens,
                              tau=tau, request_id=request_id)
        rid = (self.admission.next_request_id()
               if spec.request_id is None else spec.request_id)
        req = RoutedRequest.from_spec(spec, rid)
        req.tokens = self._token_tensor(req.prompt)
        hop = self._hop_fn(rid, kv_tracked=True)
        # hedged window serving: behind cfg.hedge_enabled each stream runs
        # the hedging executor (fires a backup hop when the primary exceeds
        # hedge_quantile_factor x its latency estimate); plans splice
        # identically in both executors, so routing is unchanged
        req.executor = (HedgedChainExecutor(
            self.gcfg, hop,
            quantile_factor=self.gcfg.hedge_quantile_factor)
            if self.gcfg.hedge_enabled else ChainExecutor(self.gcfg, hop))
        if self.tracer.enabled:
            req.executor.tracer = self.tracer
        return self.admission.submit(req)

    def _emit_token(self, req: RoutedRequest, tok: int,
                    t_emit: float) -> None:
        """Append one generated token and stamp its emission time (wall
        span ``loop.emit``)."""
        wtr = wall()
        with wtr.span("loop.emit") if wtr.enabled else NOOP_SPAN:
            req.tokens = torch.cat(
                [req.tokens, torch.full((1, 1), int(tok), dtype=req.tokens.dtype,
                                        device=req.tokens.device)], dim=1)
            req.output.append(int(tok))
            req.metrics.tokens += 1
            req.metrics.emit_ms.append(t_emit * 1e3)
            if req.metrics.ttft_ms < 0:
                req.metrics.ttft_ms = (t_emit - req.arrival_time) * 1e3
            if (req.eos_id is not None and int(tok) == req.eos_id) or \
                    len(req.output) >= req.max_new_tokens:
                req.done = True

    def _finish_stream(self, req: RoutedRequest) -> None:
        """Stream left the pools: reclaim KV slots and failure draws (wall
        span ``loop.emit``)."""
        wtr = wall()
        with wtr.span("loop.emit") if wtr.enabled else NOOP_SPAN:
            rid = req.request_id
            self.kv.drop_stream(rid)
            for key in [k for k in self._tok_scale if k[0] == rid]:
                del self._tok_scale[key]
            for p in self.bed.peers.values():
                p.forget_request(rid)
            sp = self._req_spans.pop(rid, None)
            if sp is not None:
                self.tracer.end(sp, t1=self.bed.now,
                                ttft_ms=req.metrics.ttft_ms,
                                stale_rounds_max=req.metrics.stale_rounds_max)

    def _normalized_report(self, request_id: int, report):
        """Anchor-facing copy of ``report`` with every multi-token hop
        charge rescaled to its single-token equivalent. The wall latency
        (sim clock, TTFT/ITL stamps) keeps the real multi-token cost;
        only the trust plane's ``latency_est_ms`` EMA — whose unit is one
        decode step — is fed the normalized observation. Jitter survives:
        the rescale is a deterministic factor on the drawn latency."""
        hops, changed = [], False
        for h in report.hops:
            s = self._tok_scale.pop((request_id, h.peer_id), None)
            if s is not None and h.success:
                hops.append(HopReport(h.peer_id, h.latency_ms * s, True))
                changed = True
            else:
                hops.append(h)
        return replace(report, hops=hops) if changed else report

    def _apply_report(self, req: RoutedRequest, report) -> None:
        """Fold one chain execution's outcome into trust + metrics (wall
        span ``loop.trust``)."""
        wtr = wall()
        with wtr.span("loop.trust") if wtr.enabled else NOOP_SPAN:
            anchor_rep = self._normalized_report(req.request_id, report)
            for rep in split_reports(anchor_rep):
                self.bed.anchor.apply_report(rep)
            req.metrics.repairs += int(report.repaired)
            req.metrics.rerouted += int(report.repaired)
            stats = getattr(req.executor, "stats", None)
            if stats is not None:         # hedged executor: surface counts
                req.metrics.hedges_fired = stats.hedges_fired
                req.metrics.hedges_won = stats.hedges_won

    def run_queue(self) -> List[RoutedRequest]:
        """Serve every queued stream to completion under continuous
        window batching. Each window: one registry sweep (vectorized TTL
        / trust decay), one seeker sync check, one KV-locality
        validation, ONE batched device DP for all runnable streams'
        routes, then chain execution per stream.

        Decode streams run one token per window and advance the sim
        clock by the window's max decode-chain latency. Under
        ``cfg.disaggregate``, long-prompt streams instead prefill in
        dedicated chunked windows: each window launches at most the
        decode token budget (``cfg.router_max_batch`` tokens) of prefill
        chunks, a launched chunk occupies its stream until ``busy_until``
        (asynchronous — decode cadence is NOT stretched by prefill
        compute), and the final chunk's logits yield the first token, at
        which point the now-warm stream joins the decode pool. When
        nothing is runnable the clock jumps to the next chunk completion
        or pending arrival.

        Wall spans (``obs.trace.wall``), on the host's clock beside the
        simulated one's: ``loop.window`` around each pass, and in it
        ``loop.admit`` (the sweep, the split, the promotions),
        ``loop.view`` (the table, KV validation, staleness),
        ``loop.route`` (the submits and ``route_window``),
        ``loop.readback`` (each token read back to the host), and the
        ``loop.trust`` and ``loop.emit`` spans of the methods it calls."""
        served: List[RoutedRequest] = []
        active: List[RoutedRequest] = []      # decode pool
        prefill: List[RoutedRequest] = []     # dedicated prefill streams
        gcfg = self.gcfg
        tr = self.tracer
        traced = tr.enabled
        while active or prefill or len(self.admission):
            wtr = wall()
            with wtr.span("loop.window") if wtr.enabled else NOOP_SPAN:
                now = self.bed.now
                with wtr.span("loop.admit") if wtr.enabled else NOOP_SPAN:
                    # admission sweeps the registry (per-shard fan-out when the
                    # anchor is sharded) before the window is admitted
                    admitted = self.admission.next_window(
                        capacity=self.admission.max_batch - len(active)
                        - len(prefill), now=now)
                    served += admitted
                    if traced:
                        for req in admitted:
                            rsp = tr.begin("request", cat="request",
                                           t0=req.arrival_time, rid=req.request_id)
                            self._req_spans[req.request_id] = rsp
                            if now > req.arrival_time:
                                tr.add("queue.wait", req.arrival_time, now,
                                       cat="serve", parent=rsp, rid=req.request_id)
                    if gcfg.disaggregate:
                        pre, dec = AdmissionQueue.split_by_kind(
                            admitted, gcfg.prefill_chunk_tokens)
                    else:
                        pre, dec = [], admitted
                    for req in pre:
                        req.busy_until = now
                    prefill += pre
                    active += dec
                    # promote prefill streams whose final chunk has completed:
                    # emit the pending first token (stamped at chunk completion)
                    # and hand the warm stream to the decode pool
                    waiting: List[RoutedRequest] = []
                    for req in prefill:
                        if req.prefill_pos >= int(req.tokens.shape[1]) \
                                and req.busy_until <= now:
                            self._emit_token(req, req._pending_tok, req.busy_until)
                            if req.done:
                                self._finish_stream(req)
                            else:
                                active.append(req)
                        else:
                            waiting.append(req)
                    prefill = waiting
                # launch prefill chunks up to the per-window token budget —
                # the decode token budget, so prefill can never claim more
                # window capacity than a full decode batch would. The budget
                # protects decode streams; when the decode pool is empty
                # there is nothing to displace, so every runnable stream
                # launches (chunk size stays capped at the decode budget)
                budget = self.admission.max_batch if active else None
                chunks: List[Tuple[RoutedRequest, int]] = []
                for req in prefill:
                    if budget is not None and budget <= 0:
                        break
                    if req.busy_until > now:
                        continue                   # chunk still in flight
                    c = min(gcfg.prefill_chunk_tokens,
                            int(req.tokens.shape[1]) - req.prefill_pos,
                            self.admission.max_batch)
                    if budget is not None:
                        c = min(c, budget)
                        budget -= c
                    chunks.append((req, c))
                if not active and not chunks:
                    # nothing runnable now: jump to the next chunk completion
                    # or the next arrival (bursty workloads)
                    targets = [r.busy_until for r in prefill]
                    nxt_arrival = self.admission.next_arrival()
                    if nxt_arrival is not None and nxt_arrival > now:
                        targets.append(nxt_arrival)
                    if not targets:
                        break
                    self.bed.advance(min(targets) - now)
                    continue
                wsp = (tr.begin("serve.window", cat="window", t0=now, push=True,
                                decode=len(active), prefill_launches=len(chunks))
                       if traced else None)
                with wtr.span("loop.view") if wtr.enabled else NOOP_SPAN:
                    table = self._sync_and_view()
                    self.kv.validate(table, gcfg.trust_floor)
                    stale_rounds = (int(self.sync_seeker.staleness_rounds(
                        self.bed.now).max())
                        if self.sync_seeker is not None else 0)
                with wtr.span("loop.route") if wtr.enabled else NOOP_SPAN:
                    for req in active + [r for r, _ in chunks]:
                        self.router.submit(
                            req.request_id, req.tau,
                            warm_ids=self.kv.warm_ids(req.request_id))
                        req.metrics.stale_rounds_max = max(
                            req.metrics.stale_rounds_max, stale_rounds)
                    plans = self.router.route_window(table)   # ONE batched DP
                # -- prefill chunk launches (asynchronous: charge busy_until,
                #    the decode window below does not wait for them) --------
                fail_ms = 0.0
                for req, c in chunks:
                    plan = plans[req.request_id]
                    if not plan.feasible:
                        req.metrics.infeasible += 1
                        req.done = True
                        continue
                    end = req.prefill_pos + c
                    prev_busy = req.busy_until
                    report, out = req.executor.execute(
                        plan.chain_ids(0), table,
                        payload=(req.tokens[:, :end], None), plan=plan)
                    self._apply_report(req, report)
                    if traced:
                        psp = self._req_spans.get(req.request_id)
                        if now - prev_busy > 1e-12:
                            # window-cadence gap between the previous chunk
                            # completing and this launch
                            tr.add("prefill.stall", prev_busy, now,
                                   cat="prefill", parent=psp,
                                   rid=req.request_id)
                        csp = tr.add("prefill.chunk", now,
                                     now + report.total_latency_ms / 1e3,
                                     cat="prefill", parent=psp,
                                     rid=req.request_id, tokens=c,
                                     ok=report.success)
                        self._trace_hops(csp, now, report)
                    if not report.success:
                        req.metrics.failures += 1
                        req.done = True
                        fail_ms = max(fail_ms, report.total_latency_ms)
                        continue
                    self.kv.record(req.request_id, report.chain, end)
                    req.metrics.prefill_chunks += 1
                    req.metrics.prefill_tokens += c
                    req.prefill_pos = end
                    req.busy_until = now + report.total_latency_ms / 1e3
                    if end == int(req.tokens.shape[1]):
                        _, logits = out            # final chunk: first token
                        with (wtr.span("loop.readback") if wtr.enabled
                              else NOOP_SPAN):
                            req._pending_tok = int(torch.argmax(
                                logits[:, -1, :], -1)[0])
                # -- decode window: one token per stream --------------------
                window_ms = 0.0
                w_spans: List[Tuple[object, float]] = []
                for req in active:
                    plan = plans[req.request_id]
                    if not plan.feasible:
                        req.metrics.infeasible += 1
                        req.done = True
                        continue
                    prefix = int(req.tokens.shape[1])
                    report, payload = req.executor.execute(
                        plan.chain_ids(0), table, payload=(req.tokens, None),
                        plan=plan)
                    self._apply_report(req, report)
                    window_ms = max(window_ms, report.total_latency_ms)
                    if traced:
                        ssp = tr.add("decode.step", now,
                                     now + report.total_latency_ms / 1e3,
                                     cat="decode",
                                     parent=self._req_spans.get(req.request_id),
                                     rid=req.request_id, emitted=report.success,
                                     first_token=(report.success
                                                  and req.metrics.ttft_ms < 0))
                        self._trace_hops(ssp, now, report)
                        w_spans.append((ssp, report.total_latency_ms))
                    if not report.success:
                        req.metrics.failures += 1
                        req.done = True
                        continue
                    # reuse accounting: only steps where the stream HAD warm
                    # KV somewhere count — a first-contact step (inline
                    # prefill, nothing recorded yet) is neither hit nor miss
                    if self.kv.warm_ids(req.request_id):
                        if self.kv.chain_warm(req.request_id, report.chain,
                                              prefix - 1):
                            req.metrics.kv_warm_hits += 1
                        else:
                            req.metrics.kv_cold_steps += 1
                    self.kv.record(req.request_id, report.chain, prefix)
                    _, logits = payload
                    with (wtr.span("loop.readback") if wtr.enabled
                          else NOOP_SPAN):
                        tok = int(torch.argmax(logits[:, -1, :], -1)[0])
                    req.metrics.token_latency_ms.append(report.total_latency_ms)
                    self._emit_token(req, tok,
                                     now + report.total_latency_ms / 1e3)
                # decode streams run concurrently: the clock advances by the
                # window's max decode latency; a pure-prefill window advances
                # to its earliest chunk completion instead
                if traced:
                    # drag: the batch-synchronization gap between a stream's
                    # own step finishing and the window's max latency — it
                    # delays the stream's NEXT token, so ITL_k+1 = exec_k+1 +
                    # drag_k (obs.report.itl_breakdown). Known only once the
                    # window closes, hence the late stamp.
                    for ssp, own in w_spans:
                        ssp.set(drag_ms=window_ms - own)
                if active:
                    self.bed.advance(window_ms / 1e3)
                elif chunks:
                    # ALL in-flight streams, not just this window's launches —
                    # an earlier chunk may complete (and promote) first
                    waits = [r.busy_until for r in prefill
                             if not r.done and r.busy_until > now]
                    self.bed.advance((min(waits) - now) if waits
                                     else fail_ms / 1e3)
                if traced:
                    tr.end(wsp, t1=self.bed.now, window_ms=window_ms)
                for req in active:
                    if req.done:
                        self._finish_stream(req)
                for req, _ in chunks:
                    if req.done:
                        self._finish_stream(req)
                active = [r for r in active if not r.done]
                prefill = [r for r in prefill if not r.done]
        for req in served:
            self._fill_stream_metrics(req.metrics)
        return served

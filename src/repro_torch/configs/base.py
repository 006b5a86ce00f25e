"""Config system: model / shape / mesh / train / serve configuration.

Port of ``repro.configs.base``, copied verbatim: it holds no JAX, and the
port keeps its own copy rather than importing the reference.

Every assigned architecture gets one ``<arch>.py`` module exporting a
``CONFIG: ModelConfig`` with the exact published dimensions, plus a
``reduced()`` variant for CPU smoke tests. Configs are frozen dataclasses so
they are hashable and safe to close over in jitted functions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (family-dispatched)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM / hybrid (Mamba2 / Zamba2) ---
    ssm_state: int = 0          # N, state dimension per head
    ssm_expand: int = 2         # d_inner = expand * d_model
    ssm_head_dim: int = 64      # P, channels per SSM head
    ssm_conv_width: int = 4
    attn_every: int = 0         # zamba2: shared attn block every N mamba blocks

    # --- RWKV6 ---
    rwkv_head_dim: int = 64

    # --- positional / misc ---
    pos_type: str = "rope"      # rope | mrope | learned | none
    max_position: int = 32_768  # learned-position table size
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)  # qwen2-vl (t, h, w)
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"           # silu (SwiGLU) | gelu (plain MLP)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    enc_layers: int = 0

    # --- attention variants ---
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0     # 0 = full attention

    # --- numerics / implementation switches ---
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    # xla: plain PyTorch | flash: the CUDA kernels (attention K3/K4; on an
    # RWKV6 config the prefill's WKV scan, K5)
    attn_impl: str = "xla"
    attn_chunk_threshold: int = 1024   # seq len above which chunked attention engages
    attn_chunk_size: int = 1024
    remat: bool = True
    scan_layers: bool = True
    # MoE dispatch implementation: "sorted_scatter" (default) or "dense_onehot"
    moe_impl: str = "sorted_scatter"
    # decode KV-cache sequence sharding (beyond-paper optimization lever)
    decode_seq_shard: bool = False
    # shard-local masked cache write (for sequence-sharded decode caches;
    # avoids GSPMD gathering the cache around dynamic_update_slice)
    decode_masked_write: bool = False
    # rematerialize each attention KV-chunk in backward (flash-style:
    # scores recomputed, scan residuals shrink from O(S·chunk) to O(S))
    attn_chunk_remat: bool = False
    # logits computed in fp32
    logits_dtype: str = "float32"
    # cross-entropy implementation: "full" materialises (B,S,V) logits;
    # "chunked" scans over sequence chunks (huge-vocab memory lever)
    ce_impl: str = "full"
    ce_chunk: int = 512
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived quantities ---------------------------------------------------

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def param_count(self) -> int:
        """Approximate parameter count N (used for 6·N·D model FLOPs)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hq = self.num_heads * self.head_dim
        hkv = self.num_kv_heads * self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm", "audio"):
            attn = d * hq + 2 * d * hkv + hq * d
            mlp = 3 * d * f if self.act == "silu" else 2 * d * f
            per_layer = attn + mlp + 2 * d
            total = emb + L * per_layer
            if self.is_encoder_decoder:
                # encoder layers + decoder cross attention
                total += self.enc_layers * per_layer + L * (d * hq + 2 * d * hkv + hq * d)
            return total
        if self.family == "moe":
            attn = d * hq + 2 * d * hkv + hq * d
            router = d * self.num_experts
            mlp = self.num_experts * (3 * d * f if self.act == "silu" else 2 * d * f)
            return emb + L * (attn + router + mlp + 2 * d)
        if self.family == "ssm":  # rwkv6
            # time-mix: r,k,v,g,w projections + output; channel-mix: 2 mats
            tm = 5 * d * d + d * d
            cm = d * self.d_ff + self.d_ff * d
            return emb + L * (tm + cm + 2 * d)
        if self.family == "hybrid":  # zamba2
            d_in = self.ssm_expand * d
            n_heads_ssm = d_in // self.ssm_head_dim
            # in_proj d -> (2*d_in + 2*N + n_heads), depthwise conv, out_proj
            mamba = (d * (2 * d_in + 2 * self.ssm_state + n_heads_ssm)
                     + self.ssm_conv_width * (d_in + 2 * self.ssm_state)
                     + d_in * d)
            attn = d * hq + 2 * d * hkv + hq * d + 3 * d * self.d_ff
            return emb + L * (mamba + 2 * d) + attn  # attn block SHARED (one copy)
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hq = self.num_heads * self.head_dim
        hkv = self.num_kv_heads * self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hq + 2 * d * hkv + hq * d
        mlp = self.experts_per_token * (3 * d * f if self.act == "silu" else 2 * d * f)
        return emb + L * (attn + d * self.num_experts + mlp + 2 * d)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads > 0 else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=256,
            remat=False,
        )
        if self.family == "moe":
            kw.update(num_experts=4, experts_per_token=2)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=32, rwkv_head_dim=32)
        if self.family == "hybrid":
            kw.update(attn_every=1, num_layers=2)
        if self.is_encoder_decoder:
            kw.update(enc_layers=2)
        if self.pos_type == "mrope":
            kw.update(mrope_sections=(8, 4, 4))
        kw.update(overrides)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shape configuration (the assigned shape grid)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

#: archs that may run long_500k (sub-quadratic state/sequence handling)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


# ---------------------------------------------------------------------------
# Mesh / training / serving configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1          # gradient accumulation
    zero1: bool = True             # shard optimizer state over data axis
    grad_compression: str = "none"  # none | int8
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    seed: int = 0


@dataclass(frozen=True)
class GTRACConfig:
    """Paper Table III parameters."""

    trust_floor: float = 0.96        # tau
    risk_tolerance: float = 0.0      # epsilon; if >0, tau derived via design guarantee
    ewma_beta: float = 0.30          # latency EWMA factor
    init_latency_ms: float = 250.0   # l_init
    trust_reward: float = 0.03       # delta r+
    trust_penalty: float = 0.20      # delta r-
    heartbeat_s: float = 2.0         # T_hb
    node_ttl_s: float = 15.0         # T_ttl (liveness timeout)
    request_timeout_ms: float = 25_000.0  # T_timeout
    gossip_period_s: float = 2.0     # T_gossip
    repair_enabled: bool = True
    # optimistic boot: peers start above the floor; failures isolate them
    # (one Δr⁻=0.2 hit drops below τ=0.96 until Δr⁺ successes earn it back)
    init_trust: float = 1.0
    max_trust: float = 1.0
    min_trust: float = 0.0
    # route planner (core/planner.py): alternates retained per plan so
    # mid-chain failures splice a precomputed suffix instead of re-searching
    k_best_routes: int = 4
    # compiled snapshots / cached plans kept per planner (LRU)
    planner_cache_size: int = 8
    # registry sweeps (registry.AnchorRegistry.sweep, run once per serving
    # window): peers dead longer than ttl_expire_factor × node_ttl_s are
    # bulk-deregistered with one numpy mask (<= 0 disables), and trust
    # decays toward init_trust at trust_decay_rate per second (0 disables)
    ttl_expire_factor: float = 0.0
    trust_decay_rate: float = 0.0
    # serving window router (serving/batch_router.py): max concurrent
    # streams admitted per token window
    router_max_batch: int = 64
    # prefill/decode disaggregation (serving/gtrac_serve.run_queue):
    # with disaggregate on, streams whose prompt exceeds one prefill
    # chunk run dedicated chunked prefill windows — each stream advances
    # <= prefill_chunk_tokens per chunk and a window launches at most
    # router_max_batch prefill tokens total (the decode pool's per-window
    # token budget), so a long prompt never stalls the decode cadence —
    # and hand their warm stream to the continuous decode pool on
    # completion. Off, every stream prefills inline in its first decode
    # step (the pre-disaggregation behavior).
    disaggregate: bool = False
    prefill_chunk_tokens: int = 64
    # KV-locality-aware routing (serving/kv_cache.KVLocalityTracker +
    # batch_router): peers holding a stream's warm KV get their effective
    # edge cost scaled by (1 - kv_reuse_bonus) in that stream's row of
    # the batched K-best DP, so routing PREFERS the warm chain but never
    # requires it — the trust floor still masks degraded peers and the
    # K-best alternates take over when the warm chain's trust collapses.
    # 0 disables (bit-identical routing to the bonus-free path).
    kv_reuse_bonus: float = 0.0
    # anchor sharding (core/sharding.py): number of AnchorRegistry shards
    # behind the control plane (1 = monolithic) and the placement key
    # ("peer" = stable peer-id hash, "layer" = layer-slot affinity)
    anchor_shards: int = 1
    shard_by: str = "peer"
    # hedged window serving (core/hedging.py threaded through
    # serving/gtrac_serve.run_queue): fire a backup hop when the primary
    # exceeds hedge_quantile_factor x its latency estimate
    hedge_enabled: bool = False
    hedge_quantile_factor: float = 2.0
    # gossip sync plane (src/repro/sync/): delta-encoded dissemination of
    # per-shard registry state from anchors to edge seeker caches.
    # gossip_enabled routes serving from a gossip-synced seeker instead of
    # in-process snapshots; per round each seeker pulls at most
    # gossip_fanout dirty shards (the rest wait — bandwidth cap), and the
    # publisher retains gossip_history past per-shard states as delta
    # bases (older seekers fall back to a full shard snapshot).
    gossip_enabled: bool = False
    gossip_fanout: int = 2
    gossip_history: int = 8
    # heartbeat-column refresh cadence, as a fraction of node_ttl_s:
    # steady-state heartbeat traffic never bumps shard versions (it would
    # make every delta ship every row), so each seeker's mirror of a
    # shard's liveness column is re-shipped whole once it is older than
    # gossip_hb_refresh_frac x node_ttl_s — 8 bytes/peer amortized over
    # half a TTL, the price of never routing to a TTL-expired mirror
    # (<= 0 disables; liveness then only refreshes on full syncs)
    gossip_hb_refresh_frac: float = 0.5
    # staleness-bounded routing (sync/seeker.SeekerCache.routing_view):
    # per stale gossip round a shard's peers lose gossip_stale_margin of
    # routing trust (an inflated trust floor, capped at
    # gossip_stale_margin_max), and trust is first discounted toward
    # init_trust at gossip_stale_decay per second of staleness — the
    # seeker-side mirror of the anchor sweep's trust_decay_rate. Both
    # default off; a fully-synced cache routes bit-identically either way.
    gossip_stale_margin: float = 0.0
    gossip_stale_margin_max: float = 0.3
    gossip_stale_decay: float = 0.0
    # seeker caches in the serving sync plane (gossip_enabled): routing
    # reads seeker 0; the rest exist to carry the relay plane
    gossip_seekers: int = 1
    # epidemic seeker->seeker relay (sync/relay.py): with relay_enabled
    # the anchor pushes only to gossip_fanout *seed* seekers per round
    # (its per-round cost stays O(fanout), not O(seekers)) and every
    # seeker then forwards its freshest per-shard delta chains to
    # relay_fanout neighbors drawn by seeded k-regular random sampling
    # (relay_seed), so updates reach all N seekers in O(log N) rounds.
    # relay_history bounds the per-shard delta chain a seeker retains
    # for forwarding; receivers behind the chain anti-entropy pull from
    # the anchor when reachable, or adopt a neighbor's full shard
    # mirror when not (the anchor stays the root of trust either way).
    relay_enabled: bool = False
    relay_fanout: int = 2
    relay_history: int = 8
    relay_seed: int = 0
    # Byzantine hardening of the relay plane (core/digest.py,
    # sync/relay.py): every anchor sighting carries per-shard state
    # digests keyed by sync_digest_seed; with relay_verify on, receivers
    # stage relayed chains, verify the resulting mirror digest against
    # the freshest attested digest at that version, and on mismatch roll
    # back, quarantine the sender for relay_quarantine_rounds relay
    # rounds, and anti-entropy repair from the anchor. relay_handshake
    # replaces blind chain-push with a summary/pull/response handshake
    # (push version vectors + digests, ship only what the receiver
    # lacks) — steady-state seeker->seeker traffic shrinks to summaries.
    relay_verify: bool = True
    relay_handshake: bool = True
    relay_quarantine_rounds: int = 8
    sync_digest_seed: int = 0x5EED
    # out-of-process anchor control plane (src/repro/control_plane/):
    # control_plane="procs" runs every anchor shard in its own worker
    # process behind multiprocessing queues — register / heartbeat /
    # apply_report / sweep commands go to the owning worker, and a
    # composer mirrors each shard via the sync-plane ShardDelta wire
    # format, composing snapshots bit-identical to the in-process
    # ShardedAnchorRegistry. Every composer<->worker RPC gets a deadline
    # (cp_rpc_timeout_s) and bounded retries (cp_rpc_retries) with
    # exponential backoff (cp_backoff_base_s * cp_backoff_factor**n),
    # driven by an injectable clock so tests are deterministic. A shard
    # that exhausts its retries degrades: its slice is served stale from
    # the last composed snapshot (priced by the routing_view staleness
    # machinery) instead of blocking the window cadence.
    control_plane: str = "inproc"        # inproc | procs
    cp_rpc_timeout_s: float = 2.0
    cp_rpc_retries: int = 2
    cp_backoff_base_s: float = 0.05
    cp_backoff_factor: float = 2.0
    # observability plane (src/repro/obs/): trace_enabled turns on span
    # tracing across serving / routing / gossip / relay / control plane
    # into a bounded ring of trace_capacity completed spans (oldest
    # evicted). Off, every instrumentation point is a single attribute
    # check on a shared no-op tracer — no allocation, no clock reads.
    trace_enabled: bool = False
    trace_capacity: int = 65536


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)

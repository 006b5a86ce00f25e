"""RWKV6 "Finch" — attention-free LM with data-dependent per-channel decay.

Port of ``repro.models.rwkv6`` for the serving path. Time-mix recurrence
per head (K = V = head size):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state  S: (K, V))
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with data-dependent decay ``w_t = exp(-exp(w0 + tanh(x W_d1) W_d2))`` and
bonus ``u`` for the current token. Prefill runs the chunked form
(``kernels/rwkv6_chunk``): with ``cfg.attn_impl == "flash"`` through
``ops.wkv6`` — kernel K5 on a CUDA tensor, its plain version on a CPU one —
and with ``"xla"`` through the plain version ``wkv6_chunked``. Either takes
any prompt length (the reference asserts ``S % min(32, S) == 0``). Decode
is the plain recurrence ``wkv6_step`` (kernels/rwkv6_chunk) in PyTorch
ops; the reference has no
kernel for it, so K5 launches once per layer per prefill and never in
decode.

The parameter dict has the dense transformer's outer shape (``embed``,
``layers`` as a list of per-layer dicts, ``final_norm``), so
``transformer.params_from_jax`` carries the reference's tree. The state
keeps the reference's layout — ``tm_last`` and ``cm_last`` (L, B, d) in
the activation dtype, ``wkv`` (L, B, H, K, K) in f32 — and the serving
cache adds ``index``, the number of tokens seen, kept on the host as an
int. ``forward_hidden`` writes each layer's new state into the state it is
given, in place (one allocation per prefill, none per decode step beyond
the step's own temporaries). The training loss ``loss_fn`` runs the layers
from the zero state and keeps no state (``train_hidden``: an in-place
write would break autograd), through the plain chunked form under
``attn_impl="xla"``; kernel K5 has no gradient, as the reference's Pallas
kernel has none. The reference's activation constraints (``constrain``)
sit at the same places; they redistribute DTensors inside an activation
policy (``distributed/sharding.py``) and are the identity outside one.
Inside a policy the WKV scan and the one-token step run on each rank's
own batch rows and heads (``sharding.per_shard``), and a prefill builds
its state in the ``cache_pspecs`` layout (``sharding.cache_zeros``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (cache_zeros, constrain,
                                               per_shard, reshape)
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_chunk import (
    wkv6_chunked_plain as wkv6_chunked, wkv6_step)
from repro_torch.models.common import (Params, adtype, apply_norm,
                                       chunked_cross_entropy,
                                       cross_entropy_loss, dense_init,
                                       embed_tokens, init_embeddings,
                                       init_norm, logits_head, pdtype, remat)

DECAY_LORA = 64


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _heads(cfg: ModelConfig):
    K = cfg.rwkv_head_dim
    H = cfg.d_model // K
    return H, K


def init_block(cfg: ModelConfig, generator: torch.Generator,
               device) -> Params:
    """One layer with the reference's ``init_block`` distributions: mixes
    0.5, base decay -6, ``wd2`` × 0.01, bonus 0.1, groupnorm ones/zeros,
    every other matrix ``dense_init`` × 0.02."""
    d, pd = cfg.d_model, pdtype(cfg)
    H, K = _heads(cfg)

    def full(shape, value):
        return torch.full(shape, value, dtype=pd, device=device)

    def dense(shape, scale=0.02):
        return dense_init(shape, generator, device, pd, scale)

    return {
        "norm1": init_norm(cfg, device),
        "norm2": init_norm(cfg, device),
        # time-mix
        "mu": full((5, d), 0.5),          # r,k,v,g,w token-shift mixes
        "wr": dense((d, d)),
        "wk": dense((d, d)),
        "wv": dense((d, d)),
        "wg": dense((d, d)),
        "wo": dense((d, d)),
        "w0": full((d,), -6.0),           # base decay (w ~ exp(-exp(-6)))
        "wd1": dense((d, DECAY_LORA)),
        "wd2": dense((DECAY_LORA, d), scale=0.01),
        "u": full((H, K), 0.1),           # bonus
        "gn_w": full((d,), 1.0),          # per-head groupnorm
        "gn_b": full((d,), 0.0),
        # channel-mix
        "cm_mu": full((2, d), 0.5),
        "cm_k": dense((d, cfg.d_ff)),
        "cm_v": dense((cfg.d_ff, d)),
        "cm_r": dense((d, d)),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights from ``generator`` on ``device``: the reference's
    ``init`` distributions, not its draws."""
    return {"embed": init_embeddings(cfg, generator, device),
            "layers": [init_block(cfg, generator, device)
                       for _ in range(cfg.num_layers)],
            "final_norm": init_norm(cfg, device)}


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def _token_shift(x, x_last):
    """x (B,S,d); x_last (B,d) carry from the previous segment -> shifted x."""
    return torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)


def _decay(p: Params, xw):
    """Data-dependent per-channel log-decay (<= 0). xw (B,S,d) -> lw f32."""
    dt = xw.dtype
    lora = torch.tanh(xw @ p["wd1"].to(dt)) @ p["wd2"].to(dt)
    return -torch.exp(p["w0"].float() + lora.float())


def _tm_projections(cfg: ModelConfig, p: Params, x, x_last):
    """r, k, v (B,S,H,K), g (B,S,d) and the log-decay lw (B,S,H,K) f32."""
    H, K = _heads(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    xs = _token_shift(x, x_last)
    mu = p["mu"].to(dt)
    xr, xk, xv, xg, xw = (x + (xs - x) * mu[i] for i in range(5))
    def c(a):
        return constrain(reshape(a, B, S, H, K), "batch", "seq", "heads",
                         None)
    r = c(xr @ p["wr"].to(dt))
    k = c(xk @ p["wk"].to(dt))
    v = c(xv @ p["wv"].to(dt))
    g = constrain(xg @ p["wg"].to(dt), "batch", "seq", "ff")
    lw = c(_decay(p, xw))
    return r, k, v, g, lw


def _head_groupnorm(y, w, b, eps: float = 1e-5):
    """y (B,S,H,K) -> layernorm per head in f32, scaled by (d,) params."""
    B, S, H, K = y.shape
    yf = y.float()
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(yf - mu), dim=-1, keepdim=True)
    yn = reshape((yf - mu) * torch.rsqrt(var + eps), B, S, H * K)
    return yn * w.float() + b.float()


def time_mix(cfg: ModelConfig, p: Params, x, x_last, wkv_state, *,
             single_step: bool):
    """Full time-mix sublayer. Returns (out, new_x_last, new_state)."""
    r, k, v, g, lw = _tm_projections(cfg, p, x, x_last)
    rf, kf, vf = (a.float() for a in (r, k, v))
    u = p["u"].float()
    if single_step:
        fn, names = wkv6_step, ("batch", "heads", None)
        args = (rf[:, 0], kf[:, 0], vf[:, 0], lw[:, 0], u, wkv_state)
    else:
        fn = ops.wkv6 if cfg.attn_impl == "flash" else wkv6_chunked
        names = ("batch", "seq", "heads", None)
        args = (rf, kf, vf, lw, u, wkv_state)
    # under a policy on each rank's batch rows and heads (``per_shard``)
    sn = ("batch", "heads", None, None)
    y, state = per_shard(fn, args, (names,) * 4 + (("heads", None), sn),
                         (names, sn)) or fn(*args)
    if single_step:
        y = y[:, None]
    y = _head_groupnorm(y, p["gn_w"], p["gn_b"])
    # the output's layout pinned as channel_mix pins its own: a partial
    # sum left pending here would meet the token shift's carry (sharded
    # on d), a redistribution some torch releases cannot plan
    out = constrain((y.to(x.dtype) * F.silu(g)) @ p["wo"].to(x.dtype),
                    "batch", "seq", "embed")
    return out, x[:, -1, :], state


def channel_mix(cfg: ModelConfig, p: Params, x, x_last):
    """ReLU² key, sigmoid receptance gate. Returns (out, new_x_last)."""
    dt = x.dtype
    xs = _token_shift(x, x_last)
    mu = p["cm_mu"].to(dt)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    kk = torch.square(torch.relu(
        constrain(xk @ p["cm_k"].to(dt), "batch", "seq", "ff")))
    out = torch.sigmoid(xr @ p["cm_r"].to(dt)) * (kk @ p["cm_v"].to(dt))
    return constrain(out, "batch", "seq", "embed"), x[:, -1, :]


def block(cfg: ModelConfig, p: Params, x, state, *, single_step: bool):
    """state = (tm_last (B,d), cm_last (B,d), wkv (B,H,K,V))."""
    tm_last, cm_last, wkv = state
    h = apply_norm(cfg, p["norm1"], x)
    out, tm_last, wkv = time_mix(cfg, p, h, tm_last, wkv,
                                 single_step=single_step)
    x = x + out
    h = apply_norm(cfg, p["norm2"], x)
    out, cm_last = channel_mix(cfg, p, h, cm_last)
    return x + out, (tm_last, cm_last, wkv)


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def make_state(cfg: ModelConfig, batch: int, device) -> Params:
    """Zero recurrent state on ``device``: token-shift carries (L, B, d) in
    the activation dtype, WKV states (L, B, H, K, K) in f32."""
    H, K = _heads(cfg)
    L, d = cfg.num_layers, cfg.d_model
    return {"tm_last": torch.zeros((L, batch, d), dtype=adtype(cfg),
                                   device=device),
            "cm_last": torch.zeros((L, batch, d), dtype=adtype(cfg),
                                   device=device),
            "wkv": torch.zeros((L, batch, H, K, K), dtype=torch.float32,
                               device=device)}


def make_cache(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> Params:
    """An empty serving cache on ``device`` (``cuda`` unless the caller
    passes another): the zero recurrent state (``make_state``, independent
    of ``capacity``) and index 0, as the reference."""
    state = make_state(cfg, batch, resolve_device(device))
    state["index"] = 0
    return state


def forward_hidden(cfg: ModelConfig, params: Params, tokens,
                   state: Optional[Params] = None, *,
                   single_step: bool = False):
    """tokens (B,S) -> (final-normed hidden (B,S,d), state). ``state``
    (``make_state``'s layout; zeros when None) is advanced in place, layer
    by layer, and returned."""
    if state is None:
        state = cache_zeros(
            cfg, lambda dev: make_state(cfg, tokens.shape[0], dev), tokens)
    x = embed_tokens(cfg, params["embed"], tokens)
    for l, lp in enumerate(params["layers"]):
        x, (tl, cl, wk) = block(cfg, lp, x,
                                (state["tm_last"][l], state["cm_last"][l],
                                 state["wkv"][l]),
                                single_step=single_step)
        state["tm_last"][l] = tl
        state["cm_last"][l] = cl
        state["wkv"][l] = wk
    return apply_norm(cfg, params["final_norm"], x), state


def train_hidden(cfg: ModelConfig, params: Params, tokens):
    """tokens (B,S) -> final-normed hidden (B,S,d) from the zero state,
    keeping no state: ``forward_hidden``'s arithmetic for the loss, each
    layer rematerialised in backward under ``cfg.remat``."""
    B = tokens.shape[0]
    zero = make_state(cfg, B, tokens.device)
    x = embed_tokens(cfg, params["embed"], tokens)
    for l, lp in enumerate(params["layers"]):
        state = (zero["tm_last"][l], zero["cm_last"][l], zero["wkv"][l])
        x = remat(cfg.remat, lambda x, lp, state: block(
            cfg, lp, x, state, single_step=False)[0], x, lp, state)
    return apply_norm(cfg, params["final_norm"], x)


def loss_fn(cfg: ModelConfig, params: Params, batch):
    """batch: tokens (B,S), labels (B,S) [, mask] -> mean token
    cross-entropy (f32, 0-d)."""
    x = train_hidden(cfg, params, batch["tokens"])
    if cfg.ce_impl == "chunked":
        return chunked_cross_entropy(cfg, params["embed"], x,
                                     batch["labels"], chunk=cfg.ce_chunk,
                                     mask=batch.get("mask"))
    logits = logits_head(cfg, params["embed"], x)
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


def prefill(cfg: ModelConfig, params: Params, tokens,
            capacity: Optional[int] = None):
    """Process the prompt (B, S); returns (last-token logits (B,1,V),
    cache). The state's size does not depend on the sequence, so
    ``capacity`` (the engine's KV budget) is accepted and unused."""
    x, state = forward_hidden(cfg, params, tokens)
    logits = logits_head(cfg, params["embed"], x[:, -1:, :])
    state["index"] = int(tokens.shape[1])
    return logits, state


def decode_step(cfg: ModelConfig, params: Params, token, cache):
    """token (B,1) int; cache from prefill/make_cache. One serve step:
    returns (logits (B,1,V), cache) with the state advanced in place and
    the index (a host int) incremented."""
    index = int(cache.get("index", 0))
    state = {n: t for n, t in cache.items() if n != "index"}
    x, _ = forward_hidden(cfg, params, token, state, single_step=True)
    logits = logits_head(cfg, params["embed"], x)
    cache["index"] = index + 1
    return logits, cache

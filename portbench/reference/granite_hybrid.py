"""The model module of Granite-4.0-H (``"model": "granite_hybrid"``): a
decoder stack of Mamba2 mixers and NoPE GQA attention layers, each followed
by a capacity-limited mixture of SwiGLU experts plus one shared SwiGLU
expert, with Granite's four multipliers and a tied head. It imports
nothing of the program; the routed experts' arithmetic, the float8
control and the norms are ``decoder.py``'s, written for the decoder
configurations.

* ``layout``: the parameter tree ``portbench/weights.py`` fills, leaf by
  leaf in buffer order;
* ``served_logits``: the plain reference, in float32 plain PyTorch, with
  no kernel, cache or batching, that decides ``correct``;
* ``token_flops`` / ``span_flops``: the operations a token needs in a
  deployment that keeps each layer's state (KV rows, SSM state);
* ``attention_layers`` / ``ssm_layers``: how many layers of a stretch
  launch K3 (the attention layers) and K6 (the Mamba2 layers).

The layer equations (``ibm-granite/granite-4.0-h-small``'s
``granitemoehybrid``, as the port serves them in ``src/repro_torch/models/
{transformer,mamba2,moe,attention}.py``), written out again:

* x = 12 * embedding rows (``embedding_multiplier``); per layer h =
  rmsnorm1(x), x += 0.22 * mixer(h) (``residual_multiplier``); h =
  rmsnorm2(x), x += 0.22 * (experts(h) + shared(h)); logits =
  final_norm(x) E^T / 16 (``logits_scaling``, the head tied to E).
* Attention (layers 5, 15, 25, 35): q, k, v = h Wq, h Wk, h Wv with no
  bias and no rotary (NoPE), causal softmax(q k^T * 1/128) v
  (``attention_multiplier``, not 1/sqrt(128)), query head h reading KV
  head h // 4, x-branch o Wo.
* Mamba2 (every other layer): z, xBC, dt = split(h W_in) (d_in, d_in + 2N,
  H); xBC = silu(causal depthwise conv of width 4 with a bias); x, B, C =
  split(xBC) (d_in, N, N; one group, B and C shared by the heads); dt =
  softplus(dt + dt_bias), a = exp(-exp(A_log) dt) per head; per head the
  state h (N x P) runs h_t = a_t h_{t-1} + dt_t B_t x_t^T, y_t = h_t^T C_t
  + D x_t from a zero state; y = rmsnorm(y * silu(z)) over d_in times the
  gated-norm weight; the branch is y W_out.
* Experts: ``decoder.py``'s MoE (router softmax in f32, the top
  ``experts_per_token`` renormalised, each expert keeping its first C
  tokens in token order, C from the forward's token count and the
  capacity factor); the shared expert (silu(h Wi) * (h Wg)) Wo of width
  ``shared_expert_ff`` sees every token.

The scan here is the state-space model's chunked form at the published
``mamba_chunk_size`` of 256 tokens (the program's kernel and plain version
take 64; the two are the same arithmetic, exactly): within a chunk the
quadratic form y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s,
across chunks the state h carried in float32, every exponent <= 0.

As in ``decoder.py`` an MoE layer's capacity depends on the forward's
token count, and every layer is causal for a fixed capacity, so
``served_logits`` groups the positions by capacity and runs one forward a
group. The reference holds one float32 copy of one matrix at a time
beside the benchmark's bfloat16 weights (``decoder._mm``): a layer's
f32 activations, not its f32 weights, are what it keeps, so it fits on
the card beside the 64 GB of bfloat16 weights. ``quant="fp8"`` is the
control: every matrix product's operands, the scan's x, B and C among
them, rounded to float8 e4m3 with a per-tensor scale.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import decoder

#: tokens per chunk of the reference's scan (the published mamba_chunk_size)
SCAN_CHUNK = 256
#: the A_log leaf's scale on the seeded buffer (0.02 x normal): a standard
#: deviation of 3, so that exp(A_log) spans orders of magnitude and some
#: heads carry their state across hundreds of tokens
A_LOG_SCALE = 150.0
#: the conv kernel's scale on the seeded buffer: 0.1 x normal, the port's
#: ``init_mamba2`` distribution
CONV_SCALE = 5.0
#: the scale on the seeded buffer of the norm before each Mamba2 mixer
#: (its layer's ``norm1``): 0.3 x normal, so that the mixer takes inputs of
#: RMS 0.3. The sign a weight draws is absorbed by the seeded projection
#: that reads the norm's output. At weights of one the 36 random mixers at
#: the published widths carry bfloat16's rounding into the logits about as
#: far as float8's (0.8 against 3-4 standard deviations on the card), and
#: no limit parts the two (PERF.md)
MIXER_NORM_SCALE = 15.0
#: the same for the norm before each feed-forward (``norm2``): 0.5 x
#: normal, which shrinks the experts' branch about fourfold, and with it
#: what one token's MoE drop or top-k tie, decided apart on the two sides,
#: moves that token's logits by; the attention layers' ``norm1`` and the
#: final norm stay ones
FFN_NORM_SCALE = 25.0


def kinds(cfg) -> Sequence[str]:
    """Each layer's mixer, ``"attention"`` or ``"mamba"``."""
    return cfg.layer_types or ("attention",) * cfg.num_layers


def mamba_dims(cfg):
    """(d_in, heads H, head size P, state size N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def layout(cfg) -> Iterator[tuple]:
    """Every leaf of the port's parameter dict (``models/transformer.py``
    with Mamba2 layers: ``embed`` {``tok``}, the head tied to it;
    ``layers`` a list of {``mamba`` or ``attn``, ``ffn`` with ``shared``,
    ``norm1``, ``norm2``}; ``final_norm``) as ``(path, shape, fill[,
    dtype])``, in buffer order: per layer the mixer's and the feed-
    forward's seeded leaves, then every norm. A Mamba2 mixer's ``A_log``
    is seeded in float32 at ``A_LOG_SCALE``, its conv kernel at
    ``CONV_SCALE``; ``D`` is ones and ``dt_bias`` zeros in float32, the
    gated-norm weight ones, as the port keeps them. A Mamba2 layer's
    ``norm1`` is seeded at ``MIXER_NORM_SCALE``, every ``norm2`` at
    ``FFN_NORM_SCALE``; the other norms are ones."""
    d, V = cfg.d_model, cfg.vocab_size
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    d_in, H, P, N = mamba_dims(cfg)
    conv = d_in + 2 * N
    E, f, fs = cfg.num_experts, cfg.d_ff, cfg.shared_expert_ff
    yield ("embed", "tok"), (V, d), 1.0
    if not cfg.tie_embeddings:
        yield ("embed", "head"), (V, d), 1.0
    for i, kind in enumerate(kinds(cfg)):
        L = ("layers", str(i))
        if kind == "mamba":
            M = L + ("mamba",)
            yield M + ("in_proj",), (d, 2 * d_in + 2 * N + H), 1.0
            yield M + ("conv_w",), (cfg.ssm_conv_width, conv), CONV_SCALE
            yield M + ("conv_b",), (conv,), 1.0
            yield M + ("A_log",), (H,), A_LOG_SCALE, "float32"
            yield M + ("D",), (H,), "ones", "float32"
            yield M + ("dt_bias",), (H,), "zeros", "float32"
            yield M + ("gn_w",), (d_in,), "ones"
            yield M + ("out_proj",), (d_in, d), 1.0
        else:
            yield L + ("attn", "wq"), (d, hq), 1.0
            yield L + ("attn", "wk"), (d, hkv), 1.0
            yield L + ("attn", "wv"), (d, hkv), 1.0
            yield L + ("attn", "wo"), (hq, d), 1.0
        yield L + ("ffn", "router"), (d, E), 1.0
        yield L + ("ffn", "wi"), (E, d, f), 1.0
        yield L + ("ffn", "wo"), (E, f, d), 1.0
        yield L + ("ffn", "wg"), (E, d, f), 1.0
        if fs:
            yield L + ("ffn", "shared", "wi"), (d, fs), 1.0
            yield L + ("ffn", "shared", "wo"), (fs, d), 1.0
            yield L + ("ffn", "shared", "wg"), (d, fs), 1.0
    for i, kind in enumerate(kinds(cfg)):
        yield ("layers", str(i), "norm1", "weight"), (d,), \
            MIXER_NORM_SCALE if kind == "mamba" else "ones"
        yield ("layers", str(i), "norm2", "weight"), (d,), FFN_NORM_SCALE
    yield ("final_norm", "weight"), (d,), "ones"


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------


def _mixer_matmul_params(cfg, kind: str) -> int:
    d = cfg.d_model
    if kind == "mamba":
        d_in, H, P, N = mamba_dims(cfg)
        return d * (2 * d_in + 2 * N + H) + d_in * d
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return d * hq + 2 * d * hkv + hq * d


def _ffn_matmul_params(cfg) -> int:
    """Router, the ``experts_per_token`` routed experts and the shared
    expert: the weights one token multiplies in a feed-forward."""
    d = cfg.d_model
    return d * cfg.num_experts + 3 * d * (cfg.experts_per_token * cfg.d_ff
                                          + cfg.shared_expert_ff)


def _state_flops(cfg) -> int:
    """A Mamba2 layer's per-token work beside its projections: the conv
    (2 per tap and channel) and the recurrence, 2 N P per head for the
    state update and 2 N P for the output."""
    d_in, H, P, N = mamba_dims(cfg)
    return 2 * cfg.ssm_conv_width * (d_in + 2 * N) + 4 * H * N * P


def token_flops(cfg, position: int, head: bool) -> float:
    """Operations one token at ``position`` (0-based) needs in a deployment
    that keeps each layer's state: 2 per weight it multiplies in every
    layer (the mixer's projections, the router, the routed and the shared
    experts), the Mamba2 layers' conv and recurrence, attention over its
    ``position + 1`` visible keys in the attention layers (QK^T and PV, 2
    each per key, head and channel), and the head when its logits are
    read."""
    out = 0
    for kind in kinds(cfg):
        out += 2 * (_mixer_matmul_params(cfg, kind) + _ffn_matmul_params(cfg))
        if kind == "mamba":
            out += _state_flops(cfg)
        else:
            out += 4 * cfg.num_heads * cfg.head_dim * (position + 1)
    if head:
        out += 2 * cfg.d_model * cfg.vocab_size
    return float(out)


def span_flops(cfg, start: int, end: int, head_last: bool) -> float:
    """``token_flops`` summed over positions ``start .. end - 1``, the
    head counted for the last position only when ``head_last``."""
    n = end - start
    if n <= 0:
        return 0.0
    keys = (end * (end + 1) - start * (start + 1)) // 2
    out = 0
    for kind in kinds(cfg):
        out += 2 * (_mixer_matmul_params(cfg, kind)
                    + _ffn_matmul_params(cfg)) * n
        if kind == "mamba":
            out += _state_flops(cfg) * n
        else:
            out += 4 * cfg.num_heads * cfg.head_dim * keys
    if head_last:
        out += 2 * cfg.d_model * cfg.vocab_size
    return float(out)


def attention_layers(cfg, start: int, end: int) -> int:
    """Attention layers in ``[start, end)``: those that launch K3."""
    return sum(1 for k in kinds(cfg)[start:end] if k == "attention")


def ssm_layers(cfg, start: int, end: int) -> int:
    """Mamba2 layers in ``[start, end)``: those that launch K6."""
    return sum(1 for k in kinds(cfg)[start:end] if k == "mamba")


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


def _attention(cfg, q, k, v, quant):
    """Causal GQA over one sequence at the configuration's score scale:
    q (S, Hq, D), k, v (S, Hkv, D)."""
    S, Hq, D = q.shape
    G = Hq // k.shape[1]
    q, k, v = decoder._qdq(q, quant), decoder._qdq(k, quant), \
        decoder._qdq(v, quant)
    scale = cfg.attention_multiplier
    if scale is None:
        scale = D ** -0.5
    kk = k.repeat_interleave(G, dim=1).transpose(0, 1)    # (Hq, S, D)
    vv = v.repeat_interleave(G, dim=1).transpose(0, 1)
    qq = q.transpose(0, 1)
    out = torch.empty_like(qq)
    for a in range(0, S, decoder.ATTN_BLOCK):
        b = min(S, a + decoder.ATTN_BLOCK)
        s = (qq[:, a:b] @ kk[:, :b].transpose(1, 2)) * scale
        mask = torch.arange(b, device=q.device)[None, :] > \
            torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, a:b] = torch.softmax(s, dim=-1) @ vv[:, :b]
    return out.transpose(0, 1)


def scan(x, dt, la, Bm, Cm, chunk: int = SCAN_CHUNK):
    """The SSM over one sequence from a zero state, chunk by chunk:
    x (S, H, P), dt and la = -exp(A_log) dt (S, H), Bm and Cm (S, N) ->
    y (S, H, P), without the D term. Within a chunk the quadratic form
    over s <= t with decays exp(cum_t - cum_s); across chunks the state
    (H, N, P) carried in f32."""
    S, H, P = x.shape
    N = Bm.shape[1]
    h = torch.zeros((H, N, P), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for a in range(0, S, chunk):
        b = min(S, a + chunk)
        n = b - a
        cum = torch.cumsum(la[a:b], dim=0)                  # (n, H)
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=x.device).tril()
        expo = (cum[:, None, :] - cum[None, :, :]).masked_fill(
            ~causal[..., None], float("-inf"))              # (t, s, H)
        dx = x[a:b] * dt[a:b, :, None]                      # (n, H, P)
        w = (Cm[a:b] @ Bm[a:b].T)[..., None] * torch.exp(expo)
        y[a:b] = torch.einsum("tsh,shp->thp", w, dx) + \
            torch.einsum("tn,hnp->thp", Cm[a:b], h) * \
            torch.exp(cum)[..., None]
        last = torch.exp(cum[-1:] - cum)                    # (n, H)
        h = torch.exp(cum[-1])[:, None, None] * h + \
            torch.einsum("sn,shp->hnp", Bm[a:b], dx * last[..., None])
    return y


def _mamba(cfg, p: Dict, h, quant):
    """One Mamba2 mixer over one sequence h (S, d) from a zero state."""
    S = h.shape[0]
    d_in, H, P, N = mamba_dims(cfg)
    proj = decoder._mm(h, p["in_proj"], quant)
    z, xBC, dt = proj[:, :d_in], proj[:, d_in:2 * d_in + 2 * N], \
        proj[:, 2 * d_in + 2 * N:]
    W = cfg.ssm_conv_width
    w = p["conv_w"].float()
    padded = F.pad(xBC, (0, 0, W - 1, 0))
    conv = p["conv_b"].float() + sum(padded[j:j + S] * w[j]
                                     for j in range(W))
    xBC = F.silu(conv)
    x = xBC[:, :d_in].reshape(S, H, P)
    Bm, Cm = xBC[:, d_in:d_in + N], xBC[:, d_in + N:]
    dt = F.softplus(dt + p["dt_bias"].float())
    la = -torch.exp(p["A_log"].float()) * dt
    y = scan(decoder._qdq(x, quant), dt, la, decoder._qdq(Bm, quant),
             decoder._qdq(Cm, quant))
    y = (y + x * p["D"].float()[:, None]).reshape(S, d_in)
    g = y * F.silu(z)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + cfg.norm_eps) * \
        p["gn_w"].float()
    return decoder._mm(g, p["out_proj"], quant)


def _ffn(cfg, p: Dict, h, capacity: int, quant):
    y = decoder._moe(cfg, p, h, capacity, quant)
    if cfg.shared_expert_ff:
        s = p["shared"]
        a = F.silu(decoder._mm(h, s["wi"], quant)) * \
            decoder._mm(h, s["wg"], quant)
        y = y + decoder._mm(a, s["wo"], quant)
    return y


def _branch(cfg, y):
    m = cfg.residual_multiplier
    return y if m == 1.0 else m * y


@torch.no_grad()
def forward_logits(cfg, W: Dict, tokens: torch.Tensor,
                   read: Sequence[int], capacity_tokens: int = 0,
                   quant: Optional[str] = None) -> torch.Tensor:
    """Logits (len(read), V) in f32 at positions ``read`` of one sequence
    ``tokens`` (S,); the forward runs over ``tokens[:max(read) + 1]``. The
    MoE layers' capacity is that of a forward of ``capacity_tokens``
    tokens (default: the forward's own length)."""
    n = max(read) + 1
    x = W["embed"]["tok"][tokens[:n]].float() * cfg.embedding_multiplier
    cap = decoder.moe_capacity(cfg, capacity_tokens or n)
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for kind, lp in zip(kinds(cfg), W["layers"]):
        h = decoder._norm(cfg, lp["norm1"], x)
        if kind == "mamba":
            y = _mamba(cfg, lp["mamba"], h, quant)
        else:
            a = lp["attn"]
            q = decoder._mm(h, a["wq"], quant).view(n, Hq, D)
            k = decoder._mm(h, a["wk"], quant).view(n, Hkv, D)
            v = decoder._mm(h, a["wv"], quant).view(n, Hkv, D)
            o = _attention(cfg, q, k, v, quant).reshape(n, Hq * D)
            y = decoder._mm(o, a["wo"], quant)
        x = x + _branch(cfg, y)
        h = decoder._norm(cfg, lp["norm2"], x)
        x = x + _branch(cfg, _ffn(cfg, lp["ffn"], h, cap, quant))
    rows = x[torch.as_tensor(list(read), device=x.device)]
    rows = decoder._norm(cfg, W["final_norm"], rows)
    head = W["embed"]["tok" if cfg.tie_embeddings else "head"]
    return decoder._mm(rows, head.t(), quant) / cfg.logits_scaling


def served_logits(cfg, W: Dict, prompt: torch.Tensor, output: List[int],
                  per_step_capacity: bool,
                  quant: Optional[str] = None) -> torch.Tensor:
    """(len(output), V) logits: row j is the distribution the j-th served
    token was taken from, at position len(prompt) - 1 + j of prompt +
    output. With ``per_step_capacity`` (full-prefix forwards, one per
    token) row j comes from a forward of len(prompt) + j tokens, in as
    many forwards as there are distinct capacities."""
    P0 = int(prompt.shape[0])
    seq = torch.cat([prompt.to(torch.int64),
                     torch.as_tensor(output, dtype=torch.int64,
                                     device=prompt.device)])
    reads = [P0 - 1 + j for j in range(len(output))]
    if not per_step_capacity:
        return forward_logits(cfg, W, seq, reads, quant=quant)
    groups: Dict[int, List[int]] = {}
    for j in range(len(output)):
        groups.setdefault(decoder.moe_capacity(cfg, P0 + j), []).append(j)
    out = torch.empty((len(output), cfg.vocab_size), dtype=torch.float32,
                      device=prompt.device)
    for js in groups.values():
        longest = P0 + max(js)
        out[js] = forward_logits(cfg, W, seq, [reads[j] for j in js],
                                 capacity_tokens=longest, quant=quant)
    return out

"""The model module of the decoder configurations (``"model":
"decoder"``): a dense LayerNorm / GELU / RoPE / GQA decoder (StarCoder2),
an RMSNorm / SiLU / RoPE / GQA decoder with a capacity-limited mixture of
experts (Qwen3-MoE), and a LayerNorm / GELU decoder with learned
positions and a tied head (GPT-2). Everything the harness needs to know of
the architecture is here, and it imports nothing of the program:

* ``layout``: the parameter tree ``portbench/weights.py`` fills, leaf by
  leaf in buffer order;
* ``served_logits``: the plain reference, in float32 plain PyTorch, with
  no kernel, cache or batching, that decides ``correct``;
* ``token_flops`` / ``span_flops``: the operations ``mfu`` and
  ``mfu.decode`` count;
* ``attention_layers``: how many layers of a stretch launch K3 / K4.

The reference reads the benchmark's weights and follows the layer
equations the port serves (``src/repro_torch/models/{common,attention,
mlp,moe,rope,transformer}.py`` at commit 0da9266), written out again:

* x = embedding rows (plus the learned position rows, where the
  configuration has them); per layer h = norm1(x), q, k, v = h Wq, h Wk, h Wv
  (no biases), RoPE (half-split pairs, angles position / theta^(2i/D)),
  causal softmax(q k^T / sqrt(D)) v with query head h reading KV head
  h // (Hq / Hkv), x += o Wo; h = norm2(x), x += FFN(h);
  logits = final_norm(x) W_head^T.
* Dense FFN: gelu_tanh(h Wi) Wo. MoE FFN: router softmax over the experts
  in f32, the top ``experts_per_token`` renormalised; each expert keeps
  the first C tokens routed to it in token order and drops the rest, C =
  max(8, 8 * ceil(ceil(T k / E * capacity_factor) / 8)) for T tokens in
  the forward; a kept token adds gate * (silu(h Wi_e) * (h Wg_e)) Wo_e.

The number of tokens in a forward sets C, so a token's output depends on
how long the forward it was served in was. Tokens are causal for a fixed
C (attention and the expert queues look only backwards), so one forward
over the longest prefix of a run of positions that share C gives every
one of them; ``served_logits`` groups the positions so.

``quant="fp8"`` is the control: every matrix product's operands (weights,
activations, q, k and v) rounded to float8 e4m3 with a per-tensor scale
before the float32 product, the precision below the configuration's
bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F

#: query rows per block of the attention, to bound the score memory
ATTN_BLOCK = 1024
_E4M3_MAX = 448.0


def layout(cfg) -> Iterator[tuple]:
    """Every leaf of the port's parameter dict (``models/transformer.py``:
    ``embed`` {``tok``, ``pos``, ``head``}, ``layers`` a list of {``attn``,
    ``ffn``, ``norm1``, ``norm2``}, ``final_norm``) as ``(path, shape,
    fill)``, in buffer order: the matrices at the seeded buffer's values,
    then the norms, weights ones and LayerNorm biases zeros, as the port's
    ``init_norm`` makes them. The learned position table
    ((``max_position``, d), the port's shape) follows the token embedding
    only where the configuration has learned positions."""
    d, V = cfg.d_model, cfg.vocab_size
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    yield ("embed", "tok"), (V, d), 1.0
    if cfg.pos_type == "learned":
        yield ("embed", "pos"), (cfg.max_position, d), 1.0
    if not cfg.tie_embeddings:
        yield ("embed", "head"), (V, d), 1.0
    for i in range(cfg.num_layers):
        L = ("layers", str(i))
        yield L + ("attn", "wq"), (d, hq), 1.0
        yield L + ("attn", "wk"), (d, hkv), 1.0
        yield L + ("attn", "wv"), (d, hkv), 1.0
        yield L + ("attn", "wo"), (hq, d), 1.0
        f = cfg.d_ff
        if cfg.family == "moe":
            E = cfg.num_experts
            yield L + ("ffn", "router"), (d, E), 1.0
            yield L + ("ffn", "wi"), (E, d, f), 1.0
            yield L + ("ffn", "wo"), (E, f, d), 1.0
            if cfg.act == "silu":
                yield L + ("ffn", "wg"), (E, d, f), 1.0
        else:
            yield L + ("ffn", "wi"), (d, f), 1.0
            yield L + ("ffn", "wo"), (f, d), 1.0
            if cfg.act == "silu":
                yield L + ("ffn", "wg"), (d, f), 1.0
    norms = [("layers", str(i), n) for i in range(cfg.num_layers)
             for n in ("norm1", "norm2")] + [("final_norm",)]
    for path in norms:
        yield path + ("weight",), (d,), "ones"
        if cfg.norm_type != "rmsnorm":
            yield path + ("bias",), (d,), "zeros"


def layer_matmul_params(cfg) -> int:
    """Weights one token multiplies in one layer: the attention
    projections and the feed-forward (for an MoE layer the router and the
    ``experts_per_token`` routed experts only)."""
    d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    attn = d * hq + 2 * d * hkv + hq * d
    mats = 3 if cfg.act == "silu" else 2
    if cfg.family == "moe":
        ffn = d * cfg.num_experts + cfg.experts_per_token * mats * d * cfg.d_ff
    else:
        ffn = mats * d * cfg.d_ff
    return attn + ffn


def token_flops(cfg, position: int, head: bool) -> float:
    """Operations one token at ``position`` (0-based) needs in a KV-cache
    deployment: 2 per weight it multiplies in every layer, attention over
    its ``position + 1`` visible keys (QK^T and PV, 2 each per key, head
    and channel), and the output head when its logits are read
    (``launch/roofline.py``'s 2·N per token at commit 0da9266, N the
    parameters a token passes through, the routed experts only for an MoE
    layer, with attention over the prefix added)."""
    per_layer = 2 * layer_matmul_params(cfg) + \
        4 * cfg.num_heads * cfg.head_dim * (position + 1)
    out = cfg.num_layers * per_layer
    if head:
        out += 2 * cfg.d_model * cfg.vocab_size
    return float(out)


def span_flops(cfg, start: int, end: int, head_last: bool) -> float:
    """``token_flops`` summed over positions ``start .. end - 1``, the
    head counted for the last position only when ``head_last``: a prompt
    chunk in closed form."""
    n = end - start
    if n <= 0:
        return 0.0
    per_layer = 2 * layer_matmul_params(cfg) * n + \
        4 * cfg.num_heads * cfg.head_dim * ((end * (end + 1)
                                             - start * (start + 1)) // 2)
    out = cfg.num_layers * per_layer
    if head_last:
        out += 2 * cfg.d_model * cfg.vocab_size
    return float(out)


def attention_layers(cfg, start: int, end: int) -> int:
    """Layers in ``[start, end)`` that launch the attention kernels: every
    layer of a decoder."""
    return end - start


def _qdq(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return t
    if quant != "fp8":
        raise ValueError(f"unknown quantisation {quant!r}")
    s = t.abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(a, w, quant):
    return _qdq(a, quant) @ _qdq(w.float(), quant)


def _norm(cfg, p: Dict, x):
    w = p["weight"].float()
    if cfg.norm_type == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + cfg.norm_eps) * w
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + cfg.norm_eps) * w
    if "bias" in p:
        out = out + p["bias"].float()
    return out


def _rope(x, pos, theta: float):
    """x (S, H, D), pos (S,) -> rotated x (half-split pairs)."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = pos.float()[:, None] * inv                      # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(cfg, q, k, v, quant):
    """Causal GQA over one sequence: q (S, Hq, D), k, v (S, Hkv, D)."""
    S, Hq, D = q.shape
    G = Hq // k.shape[1]
    q, k, v = _qdq(q, quant), _qdq(k, quant), _qdq(v, quant)
    kk = k.repeat_interleave(G, dim=1).transpose(0, 1)    # (Hq, S, D)
    vv = v.repeat_interleave(G, dim=1).transpose(0, 1)
    qq = q.transpose(0, 1)
    out = torch.empty_like(qq)
    scale = 1.0 / math.sqrt(D)
    for a in range(0, S, ATTN_BLOCK):
        b = min(S, a + ATTN_BLOCK)
        s = (qq[:, a:b] @ kk[:, :b].transpose(1, 2)) * scale
        mask = torch.arange(b, device=q.device)[None, :] > \
            torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, a:b] = torch.softmax(s, dim=-1) @ vv[:, :b]
    return out.transpose(0, 1)


def moe_capacity(cfg, tokens: int) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                  * cfg.moe_capacity_factor)
    return max(8, 8 * math.ceil(c / 8))


def _moe(cfg, p: Dict, h, capacity: int, quant):
    T = h.shape[0]
    logits = h @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    routed = torch.zeros((T, cfg.num_experts), dtype=torch.bool,
                         device=h.device)
    routed.scatter_(1, idx, True)
    rank = torch.cumsum(routed.to(torch.int64), dim=0) - 1
    kept = routed & (rank < capacity)
    gate_of = torch.zeros((T, cfg.num_experts), dtype=torch.float32,
                          device=h.device)
    gate_of.scatter_(1, idx, gates)
    y = torch.zeros_like(h)
    wi, wo = p["wi"], p["wo"]
    wg = p.get("wg")
    for e in torch.nonzero(kept.any(0)).flatten().tolist():
        rows = torch.nonzero(kept[:, e]).flatten()
        he = h[rows]
        a = _mm(he, wi[e], quant)
        if cfg.act == "silu":
            a = F.silu(a) * _mm(he, wg[e], quant)
        else:
            a = F.gelu(a, approximate="tanh")
        y[rows] += gate_of[rows, e][:, None] * _mm(a, wo[e], quant)
    return y


def _ffn(cfg, p: Dict, h, capacity: int, quant):
    if cfg.family == "moe":
        return _moe(cfg, p, h, capacity, quant)
    a = _mm(h, p["wi"], quant)
    if cfg.act == "silu":
        a = F.silu(a) * _mm(h, p["wg"], quant)
    else:
        a = F.gelu(a, approximate="tanh")
    return _mm(a, p["wo"], quant)


@torch.no_grad()
def forward_logits(cfg, W: Dict, tokens: torch.Tensor,
                   read: Sequence[int], capacity_tokens: int = 0,
                   quant: Optional[str] = None) -> torch.Tensor:
    """Logits (len(read), V) in f32 at positions ``read`` of one sequence
    ``tokens`` (S,); the forward runs over ``tokens[:max(read) + 1]``. An
    MoE layer's capacity is that of a forward of ``capacity_tokens``
    tokens (default: the forward's own length)."""
    n = max(read) + 1
    toks = tokens[:n]
    x = W["embed"]["tok"][toks].float()
    pos = torch.arange(n, device=x.device)
    if cfg.pos_type == "learned":
        x = x + W["embed"]["pos"][pos].float()
    cap = moe_capacity(cfg, capacity_tokens or n) \
        if cfg.family == "moe" else 0
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for lp in W["layers"]:
        a = lp["attn"]
        h = _norm(cfg, lp["norm1"], x)
        q = _mm(h, a["wq"], quant).view(n, H, D)
        k = _mm(h, a["wk"], quant).view(n, Hkv, D)
        v = _mm(h, a["wv"], quant).view(n, Hkv, D)
        if cfg.pos_type == "rope":
            q, k = _rope(q, pos, cfg.rope_theta), _rope(k, pos, cfg.rope_theta)
        o = _attention(cfg, q, k, v, quant).reshape(n, H * D)
        x = x + _mm(o, a["wo"], quant)
        x = x + _ffn(cfg, lp["ffn"], _norm(cfg, lp["norm2"], x), cap, quant)
    rows = x[torch.as_tensor(list(read), device=x.device)]
    rows = _norm(cfg, W["final_norm"], rows)
    head = W["embed"]["tok" if cfg.tie_embeddings else "head"]
    return _mm(rows, head.t(), quant)


def served_logits(cfg, W: Dict, prompt: torch.Tensor, output: List[int],
                  per_step_capacity: bool,
                  quant: Optional[str] = None) -> torch.Tensor:
    """(len(output), V) logits: row j is the distribution the j-th served
    token was taken from, at position len(prompt) - 1 + j of prompt +
    output. With ``per_step_capacity`` (an MoE served by full-prefix
    forwards, one per token) row j comes from a forward of len(prompt) + j
    tokens, in as many forwards as there are distinct capacities."""
    P0 = int(prompt.shape[0])
    seq = torch.cat([prompt.to(torch.int64),
                     torch.as_tensor(output, dtype=torch.int64,
                                     device=prompt.device)])
    reads = [P0 - 1 + j for j in range(len(output))]
    if not (per_step_capacity and cfg.family == "moe"):
        return forward_logits(cfg, W, seq, reads, quant=quant)
    groups: Dict[int, List[int]] = {}
    for j in range(len(output)):
        groups.setdefault(moe_capacity(cfg, P0 + j), []).append(j)
    out = torch.empty((len(output), cfg.vocab_size), dtype=torch.float32,
                      device=prompt.device)
    for js in groups.values():
        # the forward of the group's longest prefix has the group's C
        longest = P0 + max(js)
        out[js] = forward_logits(cfg, W, seq, [reads[j] for j in js],
                                 capacity_tokens=longest, quant=quant)
    return out

"""The plain reference of the decoder configurations: a dense
LayerNorm / GELU / RoPE / GQA decoder (StarCoder2) and an RMSNorm / SiLU /
RoPE / GQA decoder with a capacity-limited mixture of experts (Qwen3-MoE),
in float32 plain PyTorch, with no kernel, cache or batching.

It imports nothing of the program. It reads the benchmark's weights (the
parameter dict ``portbench/weights.py`` makes) and follows the layer
equations the port serves (``src/repro_torch/models/{common,attention,
mlp,moe,rope,transformer}.py`` at commit 0da9266), written out again:

* x = embedding rows; per layer h = norm1(x), q, k, v = h Wq, h Wk, h Wv
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
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

#: query rows per block of the attention, to bound the score memory
ATTN_BLOCK = 1024
_E4M3_MAX = 448.0


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

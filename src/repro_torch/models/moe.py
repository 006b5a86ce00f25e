"""Mixture-of-Experts layer with sorted-scatter capacity dispatch.

Port of ``repro.models.moe`` (phi3.5-moe, qwen3-moe). The algorithm is the
reference's, per layer:

  1. router logits (f32) -> softmax -> top-k experts, gates renormalised by
     ``max(sum, 1e-9)``;
  2. flatten the (token, k) assignments and stable-sort them by expert id;
  3. rank within each expert from the counts and their exclusive prefix
     sums; a rank >= capacity C is dropped;
  4. an (E, C, d) buffer of the kept tokens goes through the batched expert
     FFN, is gathered back and combined with the gates.

Each token picks an expert at most once, so a stable sort puts every
expert's queue in token order whatever order ``topk`` returned a token's k
choices in: the kept set, and so the drops, are exactly the reference's.

No step reads a device value back to the host (``torch.bincount`` on a
CUDA tensor would, to size its output): the counts come from a
``searchsorted`` over the sorted expert ids.

Deterministic on the card. ``index_add_`` and scatter-add accumulate with
atomics in no fixed order on CUDA, which would make two runs of the same
inputs differ in the last bits (and break the f32 kernel-path = plain-path
token gate). So nothing here accumulates through a scatter:

* the buffer is filled by a gather: slot (e, r) reads the one sorted
  assignment ``starts[e] + r`` when ``r < min(counts[e], C)`` and is zero
  otherwise, which is what the reference's scatter-add into zeros leaves
  there (every kept (expert, rank) slot is unique);
* the combine writes each of the T·k weighted rows to its own (t, j) slot
  of a (T, k, d) tensor, with each token's k choices ordered by ascending
  expert id, and sums the k rows of a token one after another in that
  order: the order in which the reference's ``.at[sorted_token].add``
  accumulates them.

The expert products are plain batched matmuls (``torch.bmm``), as the
reference leaves its ``einsum``s to XLA; no kernel of the reference's
``kernels/`` is involved. The reference's activation constraints
(``constrain``: tokens on the data axis, expert stacks on the model axis)
sit at the same places: the expert buffer, the expert products, the
gathered-back rows and the output. The reference also constrains the
(T·k, d) rows it scatters into the buffer; here the gather fills the
buffer directly and no such tensor exists, so the buffer's constraint is
the one. Each redistributes DTensors inside an activation policy
(``distributed/sharding.py``) and is the identity outside one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain, per_shard, reshape,
                                               take_rows)
from repro_torch.models.common import Params, dense_init, pdtype


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    cap = math.ceil(num_tokens * cfg.experts_per_token / cfg.num_experts
                    * cfg.moe_capacity_factor)
    return max(8, int(math.ceil(cap / 8) * 8))


def init_moe(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Router (d, E) and expert stacks wi, wg (E, d, f) and wo (E, f, d),
    each ``dense_init`` × 0.02 in ``param_dtype``, as the reference (``wg``
    for the gated ``silu`` experts only)."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init((d, E), generator, device, pdtype(cfg)),
        "wi": dense_init((E, d, f), generator, device, pdtype(cfg)),
        "wo": dense_init((E, f, d), generator, device, pdtype(cfg)),
    }
    if cfg.act == "silu":
        p["wg"] = dense_init((E, d, f), generator, device, pdtype(cfg))
    return p


def route_topk(cfg: ModelConfig, p: Params, xf):
    """xf (T, d) -> gates (T, k) f32, idx (T, k) int64, router probs
    (T, E) f32."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def load_balance_loss(cfg: ModelConfig, probs, idx):
    """Switch-style auxiliary loss: E * sum_e f_e * P_e."""
    E = cfg.num_experts
    experts = torch.arange(E, device=idx.device)
    frac_tokens = (idx[..., None] == experts).sum(dim=(0, 1)).float() \
        / idx.shape[0]                                       # (E,)
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs) / cfg.experts_per_token


def _dispatch_plan(idx_asc, E: int, C: int):
    """The dispatch's bookkeeping from each token's k choices in
    ascending expert order, idx_asc (T, k): the sorted assignment each
    buffer slot (e, r) reads (E, C), whether it holds one (E, C), the
    buffer row e·C + rank each assignment (t, j) reads back (T·k), and
    whether it was kept (T·k)."""
    T, k = idx_asc.shape
    dev = idx_asc.device
    flat_expert = idx_asc.reshape(T * k)                 # row-major: t*k + j
    sorted_expert, order = torch.sort(flat_expert, stable=True)
    sorted_token = order // k
    # expert e's queue starts at the first sorted assignment >= e
    starts = torch.searchsorted(sorted_expert, torch.arange(E, device=dev))
    counts = torch.diff(starts, append=starts.new_full((1,), T * k))
    # dispatch: slot (e, r) holds sorted assignment starts[e] + r
    r = torch.arange(C, device=dev)
    filled = r[None, :] < counts[:, None]                # (E, C)
    src = torch.clamp(starts[:, None] + r[None, :], max=T * k - 1)
    # combine: assignment (t, j) sits at sorted position pos, rank
    # pos - starts[e] in its expert's queue (a permutation: no collisions)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k, device=dev)
    rank = pos - starts[flat_expert]
    keep = rank < C
    slot = flat_expert * C + torch.where(keep, rank, 0)
    return sorted_token[src], filled, slot, keep


def apply_moe(cfg: ModelConfig, p: Params, x, return_aux: bool = False):
    """x (B, S, d) -> (B, S, d) [, aux_loss].

    Inside an activation policy the bookkeeping (``_dispatch_plan``: the
    sort and the counts over every token of the batch, which decide the
    drops) runs whole on every rank (``sharding.per_shard`` with no
    dimension sharded: T·k ids), and the buffer and the combine gather
    their rows by ``sharding.take_rows``."""
    B, S, d = x.shape
    T = B * S
    k = cfg.experts_per_token
    E = cfg.num_experts
    C = moe_capacity(cfg, T)
    dt = x.dtype
    xf = x.reshape(T, d)

    gates, idx, probs = route_topk(cfg, p, xf)
    # each token's k choices in ascending expert order: the combine's order
    idx_asc, perm = torch.sort(idx, dim=-1)
    flat_gate = torch.gather(gates, 1, perm).reshape(T * k)
    plan = per_shard(lambda i: _dispatch_plan(i, E, C), (idx_asc,),
                     ((None, None),), ((None, None),) * 2 + ((None,),) * 2)
    src, filled, slot, keep = plan or _dispatch_plan(idx_asc, E, C)

    buf = torch.where(filled[..., None], take_rows(xf, src), 0.0)
    buf = constrain(buf, "expert", None, None)

    h = constrain(torch.bmm(buf, p["wi"].to(dt)), "expert", None, None)
    if cfg.act == "silu":
        h = F.silu(h) * torch.bmm(buf, p["wg"].to(dt))
    else:
        h = F.gelu(h, approximate="tanh")
    out = constrain(torch.bmm(h, p["wo"].to(dt)),        # (E, C, d)
                    "expert", None, None)

    w = (flat_gate * keep).to(dt)[:, None]
    rows = constrain(take_rows(out.reshape(E * C, d), slot), "batch", None)
    rows = reshape(rows * w, T, k, d)
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    y = constrain(reshape(y, B, S, d), "batch", "seq", "embed")
    if return_aux:
        return y, load_balance_loss(cfg, probs, idx)
    return y

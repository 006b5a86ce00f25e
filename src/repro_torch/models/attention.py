"""GQA attention: projections and the core implementations.

Port of ``repro.models.attention``. ``attend`` dispatches as the reference
does, on ``cfg.attn_impl`` and the sequence length:

* ``flash`` — kernel K3 through ``kernels.ops.flash_attention``: the
  hand-written CUDA kernel for tensors on the card, its plain version on
  the CPU. Taken whenever ``attn_impl="flash"`` and no ``kv_len`` is
  given: causal self-attention, non-causal attention (Whisper's encoder)
  and Sq != Sk (Whisper's cross-attention, one query row at a decode
  step).
* ``chunked`` — plain PyTorch (``attention_chunked``): the reference's
  online softmax over KV chunks, for ``Sk > cfg.attn_chunk_threshold``
  without ``kv_len`` or ``q_offset`` (chunk ``max(attn_chunk_size,
  Sk // 8)``; a ragged Sk falls back to ``direct``).
* ``direct`` — plain PyTorch (``attention_direct``): scores in f32, the
  reference's -1e30 mask bias, softmax in f32, probabilities cast to the
  activation dtype for the PV product.

The KV-cache decode step has two routes: ``decode_attend`` sends
``flash`` to kernel K4 (``kernels.ops.decode_attention``) and ``xla`` to
``attention_direct`` with ``kv_len``, the reference's own decode math.

GQA is computed natively with grouped einsums — KV heads are not
materially repeated on one device. Inside an activation policy
(``distributed/sharding.py``) the plain paths take the reference's
sharded layout instead: KV heads repeated to the query-head count
(``_repeat_kv``) so that the head dimension can shard on ``model``, and
under ``cfg.decode_seq_shard`` the sequence-parallel decode layout (the
scores sharded along the cache's sequence). Each ``constrain`` sits where
the reference's does and is the identity outside a policy.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain, mesh_axis_size,
                                               per_shard, policy_mesh,
                                               reshape)
from repro_torch.kernels import ops
from repro_torch.models.common import Params, dense_init, pdtype, remat


def init_attention(cfg: ModelConfig, generator: torch.Generator, device,
                   d_in=None) -> Params:
    d = d_in or cfg.d_model
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    return {
        "wq": dense_init((d, hq), generator, device, pdtype(cfg)),
        "wk": dense_init((d, hkv), generator, device, pdtype(cfg)),
        "wv": dense_init((d, hkv), generator, device, pdtype(cfg)),
        "wo": dense_init((hq, cfg.d_model), generator, device, pdtype(cfg)),
    }


def qkv_proj(cfg: ModelConfig, p: Params, x):
    """x (B, S, d) -> q (B,S,Hq,D), k,v (B,S,Hkv,D)."""
    B, S, _ = x.shape
    dt = x.dtype
    q = reshape(x @ p["wq"].to(dt), B, S, cfg.num_heads, cfg.head_dim)
    k = reshape(x @ p["wk"].to(dt), B, S, cfg.num_kv_heads, cfg.head_dim)
    v = reshape(x @ p["wv"].to(dt), B, S, cfg.num_kv_heads, cfg.head_dim)
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "heads", None)
    v = constrain(v, "batch", "seq", "heads", None)
    return q, k, v


def out_proj(cfg: ModelConfig, p: Params, o):
    B, S = o.shape[:2]
    o = constrain(o, "batch", "seq", "heads", None)
    out = reshape(o, B, S, cfg.num_heads * cfg.head_dim) @ \
        p["wo"].to(o.dtype)
    return constrain(out, "batch", "seq", "embed")


def _repeat_kv(k, num_q_heads):
    """(B,S,Hkv,D) -> (B,S,Hq,D) where that lets the heads shard, ``k``
    itself elsewhere.

    The reference repeats GQA KV heads to the full query-head count so
    that the head dimension stays shardable under tensor parallelism
    (scores with Hkv < TP degree would otherwise replicate). The grouped
    einsum needs no copy, so the port repeats only inside an activation
    policy whose ``model`` axis divides the query heads and not the KV
    heads: there the repeat changes the layout. Elsewhere (one device, a
    model axis of 1, heads that shard or replicate either way) the scores
    are the same products without it, and their rounding stays that of
    the one-device path.
    """
    mesh = policy_mesh()
    if mesh is None:
        return k
    B, S, Hkv, D = k.shape
    G = num_q_heads // Hkv
    m = mesh_axis_size(mesh, "model")
    if G == 1 or m == 1 or num_q_heads % m or Hkv % m == 0:
        return k
    k = reshape(k[:, :, :, None, :].expand(B, S, Hkv, G, D),
                B, S, Hkv * G, D)                  # jnp.repeat(k, G, axis=2)
    return constrain(k, "batch", "seq", "heads", None)


def _per_shard(fn, q, k, v, kv_len=None, q_offset=0):
    """Inside an activation policy, on DTensors: ``fn(q, k, v, kv_len,
    q_offset)`` on each rank's own batch rows and heads, as
    tensor-parallel attention runs (``sharding.per_shard``), the result a
    DTensor of q's layout; None elsewhere. The sequence is gathered (a
    sequence-sharded cache is all-gathered, as GSPMD does for the
    reference's non-sequence-parallel decode); ``kv_len`` and
    ``q_offset`` of one entry per batch row are cut to this rank's rows.
    DTensor would otherwise run the products as one batched matmul over
    batch x heads, a flatten of two sharded dimensions that some torch
    releases refuse."""
    B = q.shape[0]

    def rows(t):
        return ("batch",) if isinstance(t, torch.Tensor) and \
            t.dim() == 1 and t.shape[0] == B > 1 else None
    names = ("batch", None, "heads", None)
    return per_shard(fn, (q, k, v, kv_len, q_offset),
                     (names,) * 3 + (rows(kv_len), rows(q_offset)), names)


def attention_direct(q, k, v, *, causal: bool, q_offset=0,
                     kv_len=None, window: int = 0, seq_shard: bool = False,
                     scale=None):
    """q (B,Sq,Hq,D); k,v (B,Sk,Hkv,D) -> (B,Sq,Hq,D).

    ``q_offset`` (int or (B,)) is the position of the first query row.
    ``kv_len`` (scalar or (B,)) masks out key positions >= kv_len.
    ``window`` > 0 restricts attention to the trailing window.
    ``seq_shard``: the reference's sequence-parallel decode layout (q
    replicated over ``model``, the cache and the scores sharded along the
    sequence, grouped KV heads never repeated); the same arithmetic, and
    nothing changes outside an activation policy. ``scale`` multiplies the
    f32 scores (None: 1/sqrt(D)).
    """
    B, Sq, Hq, D = q.shape
    if seq_shard:
        q = constrain(q, "batch", None, None, None)
        k = constrain(k, "batch", "seq_model", None, None)
        v = constrain(v, "batch", "seq_model", None, None)
    else:
        k = _repeat_kv(k, Hq)
        v = _repeat_kv(v, Hq)
        out = _per_shard(lambda q, k, v, kv_len, q_offset: attention_direct(
            q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
            window=window, scale=scale), q, k, v, kv_len, q_offset)
        if out is not None:
            return out
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    if scale is None:
        # 1/sqrt(D) rounded in f32, as the reference's f32 constant
        scale = torch.tensor(float(D), dtype=torch.float32).rsqrt().item()
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * scale
    if seq_shard:
        scores = constrain(scores, "batch", None, None, None, "seq_model")
    q_pos = (torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
             + torch.arange(Sq, device=dev))[:, :, None]   # (B or 1, Sq, 1)
    k_pos = torch.arange(Sk, device=dev)
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > (q_pos - window))
    bias = _mask_bias(mask)[:, None, None]            # (B or 1,1,1,Sq,Sk)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev)
        live = k_pos[None, :] < kv_len.reshape(-1, 1)        # (B or 1, Sk)
        bias = bias + _mask_bias(live)[:, None, None, None, :]
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, D)


def _mask_bias(mask):
    return torch.where(mask, 0.0, -1e30).to(torch.float32)


def attention_chunked(q, k, v, *, causal: bool, chunk: int = 1024,
                      window: int = 0, unroll: bool = False,
                      chunk_remat: bool = False, scale=None):
    """Online-softmax attention over KV chunks of ``chunk`` keys: the
    reference's ``attention_chunked``, the same arithmetic in a Python
    loop (f32 scores, the -1e30 mask bias, running max / sum / output in
    f32, each chunk's PV product in q's dtype). Peak score memory is
    (B, Hq, Sq, chunk). A ragged ``Sk % chunk != 0`` falls back to
    ``attention_direct``, as in the reference. ``chunk_remat``
    rematerialises each chunk's step in backward, as the reference's
    ``jax.checkpoint`` of its scan body. ``unroll`` picks how XLA traces
    the reference's scan (unrolled for the dry-run's cost analysis); an
    eager loop has no such choice, so it is accepted and ignored.
    ``scale`` multiplies the f32 scores (None: 1/sqrt(D))."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    if Sk % chunk != 0:
        return attention_direct(q, k, v, causal=causal, window=window,
                                scale=scale)
    k = _repeat_kv(k, Hq)
    v = _repeat_kv(v, Hq)
    out = _per_shard(lambda q, k, v, _kv_len, _q_offset: attention_chunked(
        q, k, v, causal=causal, chunk=chunk, window=window,
        chunk_remat=chunk_remat, scale=scale), q, k, v)
    if out is not None:
        return out
    Hkv = k.shape[2]
    G = Hq // Hkv
    dev = q.device
    if scale is None:
        scale = torch.tensor(float(D), dtype=torch.float32).rsqrt().item()
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    q_pos = torch.arange(Sq, device=dev)[:, None]

    def body(m, l, o, kc, vc, c0: int):
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) * scale
        k_pos = c0 + torch.arange(chunk, device=dev)
        mask = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window:
            mask = mask & (k_pos > (q_pos - window))
        scores = scores + _mask_bias(mask)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(q.dtype), vc).float()
        return m_new, l, o

    m = torch.full((B, Hkv, G, Sq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    for c0 in range(0, Sk, chunk):
        m, l, o = remat(chunk_remat, body, m, l, o, k[:, c0:c0 + chunk],
                        v[:, c0:c0 + chunk], c0)
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Hq, Sq, D).transpose(1, 2).to(q.dtype)


def attention_flash(q, k, v, *, causal: bool, scale=None):
    """Kernel K3 (``kernels/flash_attention.py``) through its dispatch."""
    return ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, scale=scale)


def attend(cfg: ModelConfig, q, k, v, *, causal: bool = True,
           q_offset: int = 0, kv_len=None, window: int = 0, scale=None):
    """Dispatch on ``cfg.attn_impl`` and the key length, as the reference:
    flash (K3) when ``attn_impl="flash"`` and no ``kv_len``, causal or
    not, Sq equal to Sk or not; otherwise ``attention_chunked`` when
    ``Sk > cfg.attn_chunk_threshold`` with no ``kv_len`` and ``q_offset``
    0; otherwise ``attention_direct``. The reference's flash path silently
    ignores ``sliding_window``; here ``window > 0`` with
    ``attn_impl="flash"`` raises ``ValueError`` instead (no shipped config
    sets a window). ``scale`` multiplies the scores in f32 on every route
    (None: 1/sqrt(D); Granite-4.0-H passes its ``attention_multiplier``)."""
    Sk = k.shape[1]
    if cfg.attn_impl == "flash" and kv_len is None:
        if window:
            raise ValueError("attn_impl='flash' does not implement "
                             f"sliding_window={window}; use attn_impl='xla'")
        return attention_flash(q, k, v, causal=causal, scale=scale)
    if Sk > cfg.attn_chunk_threshold and kv_len is None and q_offset == 0:
        chunk = max(cfg.attn_chunk_size, Sk // 8)
        return attention_chunked(q, k, v, causal=causal, chunk=chunk,
                                 window=window, unroll=not cfg.scan_layers,
                                 chunk_remat=cfg.attn_chunk_remat,
                                 scale=scale)
    return attention_direct(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len, window=window, scale=scale)


# ---------------------------------------------------------------------------
# KV-cache decode step
# ---------------------------------------------------------------------------


def decode_attend(cfg: ModelConfig, q, cache_k, cache_v, kv_len,
                  window: int = 0):
    """One-token decode: q (B,1,Hq,D) against cache (B,Smax,Hkv,D).

    ``kv_len`` — (B,) int32 tensor on q's device: the number of valid
    positions in the cache *including* the newly-written token (the
    reference's ``index``; the decode step builds it once for all layers).
    With ``attn_impl="flash"`` and no window this is kernel K4
    (``ops.decode_attention`` over the live rows; ``kv_len`` >= 1 always
    holds here, which is K4's contract); otherwise the reference's
    ``attention_direct`` with ``kv_len``. A sliding window on the flash
    path raises on the card, as ``attend`` does for K3, and keeps the
    reference's math on the CPU. ``cfg.decode_seq_shard`` selects the
    reference's sequence-parallel layout on the plain path
    (``attention_direct(seq_shard=...)``), which only an activation policy
    makes differ from the one-device layout."""
    if cfg.attn_impl == "flash" and not window:
        o = ops.decode_attention(q[:, 0].contiguous(), cache_k, cache_v,
                                 kv_len)
        return o.reshape(q.shape)
    if cfg.attn_impl == "flash" and q.device.type == "cuda":
        raise ValueError("attn_impl='flash' does not implement "
                         f"sliding_window={window} in decode; use "
                         "attn_impl='xla'")
    return attention_direct(q, cache_k, cache_v, causal=False,
                            kv_len=kv_len, window=window,
                            q_offset=(kv_len - 1) if window else 0,
                            seq_shard=cfg.decode_seq_shard)


def cache_update(cache_k, cache_v, k_new, v_new, index: int,
                 masked: bool = False):
    """Write (B,1,Hkv,D) new KV at position ``index`` of (B,Smax,Hkv,D).

    Unlike the reference (pure functions), the write is in place: the
    caches are updated and returned, so a decode step never copies the
    cache. ``masked`` (``cfg.decode_masked_write``) selects the reference's
    shard-local where() write for a sequence-sharded cache, a GSPMD layout
    choice like ``decode_seq_shard``: on one card it gives the same tensors
    as the slice write, so it is accepted and ignored."""
    cache_k[:, index:index + 1] = k_new.to(cache_k.dtype)
    cache_v[:, index:index + 1] = v_new.to(cache_v.dtype)
    return cache_k, cache_v

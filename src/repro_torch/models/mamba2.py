"""Mamba2 mixer (SSD — state-space duality), chunked + recurrent forms.

Port of ``repro.models.mamba2``. Per-head recurrence (head dim P =
ssm_head_dim, state dim N = ssm_state, n_groups = 1 so B/C are shared
across heads):

    h_t = a_t h_{t-1} + dt_t * (B_t ⊗ x_t)        h: (N, P)
    y_t = C_t · h_t + D ⊙ x_t

with scalar-per-head decay ``a_t = exp(-exp(A_log) * dt_t)``. The full
sequence (prefill) runs the chunked scan (``kernels/ssd_chunk``): with
``cfg.attn_impl == "flash"`` through ``ops.ssd`` — kernel K6 on a CUDA
tensor, its plain version on a CPU one — and with ``"xla"`` through the
plain version ``ssd_chunked``. Either takes any sequence length (the
reference asserts ``S % min(64, S) == 0``). One token (decode) is the
plain recurrence ``ssd_step``; the reference has no kernel for it.

The causal depthwise convolution is W shifted multiply-adds, as the
reference writes it: ``F.conv1d`` would go through cuDNN, which runs f32
convolutions in TF32 by default. The reference's activation constraints
(``constrain``) sit at the same places; they redistribute DTensors inside
an activation policy (``distributed/sharding.py``) and are the identity
outside one; inside one the SSD scan and the one-token step run on each
rank's own batch rows and heads (``sharding.per_shard``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, per_shard, reshape
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunk import ssd_chunked_plain as ssd_chunked, ssd_step
from repro_torch.models.common import Params, dense_init, pdtype


def dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_in // P
    N = cfg.ssm_state
    return d_in, H, P, N


def init_mamba2(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """The reference's ``init_mamba2`` distributions: projections
    ``dense_init`` × 0.02, the conv kernel × 0.1, zero conv bias and
    dt_bias, A_log = 0 (A = -1), D = 1, unit gated-norm weight."""
    d = cfg.d_model
    d_in, H, P, N = dims(cfg)
    conv_ch = d_in + 2 * N
    pd = pdtype(cfg)
    return {
        "in_proj": dense_init((d, 2 * d_in + 2 * N + H), generator, device,
                              pd),
        "conv_w": dense_init((cfg.ssm_conv_width, conv_ch), generator,
                             device, pd, scale=0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=pd, device=device),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "gn_w": torch.ones((d_in,), dtype=pd, device=device),
        "out_proj": dense_init((d_in, d), generator, device, pd),
    }


def _split_proj(cfg: ModelConfig, proj):
    d_in, H, P, N = dims(cfg)
    z = proj[..., :d_in]
    xBC = proj[..., d_in:2 * d_in + 2 * N]
    dt = proj[..., 2 * d_in + 2 * N:]
    return z, xBC, dt


def causal_conv(xBC, w, b):
    """Depthwise causal conv. xBC (B,S,Ch); w (W,Ch). Under an activation
    policy on each rank's own batch rows and channels
    (``sharding.per_shard``): DTensor's rule for the padding is not
    dependable across torch releases."""
    out = per_shard(_causal_conv, (xBC, w, b),
                    (("batch", None, "ff"), (None, "ff"), ("ff",)),
                    ("batch", None, "ff"))
    return out if out is not None else _causal_conv(xBC, w, b)


def _causal_conv(xBC, w, b):
    W = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, W):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def conv_step(x_new, conv_state, w, b):
    """x_new (B,Ch); conv_state (B,W-1,Ch) past inputs."""
    full = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # (B,W,Ch)
    out = torch.einsum("bwc,wc->bc", full, w) + b[None, :]
    return out, full[:, 1:, :]


def _gated_rmsnorm(y, z, w, eps: float = 1e-5):
    yf = (y * F.silu(z)).float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * w.float()


def _dt_decay(p: Params, dt):
    """dt (…, H) projection -> (dt, la) f32. ``F.softplus`` switches to the
    identity above 20 where ``jax.nn.softplus`` computes log1p(exp(x));
    the two differ there by log1p(exp(-x)) < 2.1e-9, below f32's
    resolution of values above 20."""
    dt = F.softplus(dt.float() + p["dt_bias"])
    return dt, -torch.exp(p["A_log"]) * dt


def _scan_per_shard(fn, lead, x, dt, la, Bm, Cm, h):
    """``fn(x, dt, la, Bm, Cm, h)``, the chunked scan (``lead`` = batch,
    seq) or the one-token step (``lead`` = batch): under an activation
    policy on each rank's batch rows and heads (``sharding.per_shard``),
    as GSPMD partitions the reference's scan; plain otherwise."""
    heads = lead + ("heads",)
    xn = heads + (None,)
    hn = ("batch", "heads", None, None)
    args = (x, dt, la, Bm, Cm, h)
    return per_shard(fn, args, (xn, heads, heads, lead + (None,),
                                lead + (None,), hn), (xn, hn)) or fn(*args)


def mamba2_forward(cfg: ModelConfig, p: Params, x, state=None):
    """Full-sequence mixer. x (B,S,d) -> (B,S,d), (conv_state, ssm_state).

    ``state`` (conv (B,W-1,Ch), ssm (B,H,N,P)) continues a segment, as in
    the reference; None starts from zeros."""
    Bz, S, d = x.shape
    d_in, H, P, N = dims(cfg)
    dt_a = x.dtype
    proj = constrain(x @ p["in_proj"].to(dt_a), "batch", "seq", "ff")
    z, xBC, dt = _split_proj(cfg, proj)
    w, b = p["conv_w"].to(dt_a), p["conv_b"].to(dt_a)
    if state is not None:
        conv_state, h0 = state
        # prepend cached conv inputs (segment-continuation mode)
        xBC_in = torch.cat([conv_state, xBC], dim=1)
        xBC_conv = causal_conv(xBC_in, w, b)[:, conv_state.shape[1]:]
    else:
        xBC_conv = causal_conv(xBC, w, b)
        h0 = torch.zeros((Bz, H, N, P), dtype=torch.float32,
                         device=x.device)
    xBC_conv = F.silu(xBC_conv)
    xs = reshape(xBC_conv[..., :d_in], Bz, S, H, P).float()
    xs = constrain(xs, "batch", "seq", "heads", None)
    Bm = xBC_conv[..., d_in:d_in + N].float()
    Cm = xBC_conv[..., d_in + N:].float()
    dt, la = _dt_decay(p, dt)                                   # (B,S,H)
    if cfg.attn_impl == "flash":
        # K6 takes contiguous tensors only: xs, Bm and Cm are slices
        def scan(*a):
            return ops.ssd(*(t.contiguous() for t in a))
    else:
        scan = ssd_chunked
    y, h = _scan_per_shard(scan, ("batch", "seq"), xs, dt, la, Bm, Cm, h0)
    y = y + xs * p["D"][None, None, :, None]
    y = constrain(reshape(y, Bz, S, d_in), "batch", "seq", "ff")
    y = _gated_rmsnorm(y, z.float(), p["gn_w"])
    out = constrain(y.to(dt_a) @ p["out_proj"].to(dt_a),
                    "batch", "seq", "embed")
    W1 = cfg.ssm_conv_width - 1
    if S >= W1:
        new_conv = xBC[:, -W1:, :]
    else:
        new_conv = F.pad(xBC, (0, 0, W1 - S, 0))
    return out, (new_conv, h)


def mamba2_step(cfg: ModelConfig, p: Params, x, state):
    """One-token mixer. x (B,1,d); state = (conv (B,W-1,Ch), ssm
    (B,H,N,P))."""
    Bz, _, d = x.shape
    d_in, H, P, N = dims(cfg)
    dt_a = x.dtype
    conv_state, h = state
    proj = x[:, 0] @ p["in_proj"].to(dt_a)
    z, xBC, dt = _split_proj(cfg, proj)
    xBC_c, conv_state = conv_step(xBC, conv_state, p["conv_w"].to(dt_a),
                                  p["conv_b"].to(dt_a))
    xBC_c = F.silu(xBC_c)
    xs = reshape(xBC_c[..., :d_in], Bz, H, P).float()
    Bm = xBC_c[..., d_in:d_in + N].float()
    Cm = xBC_c[..., d_in + N:].float()
    dt, la = _dt_decay(p, dt)                                   # (B,H)
    y, h = _scan_per_shard(ssd_step, ("batch",), xs, dt, la, Bm, Cm, h)
    y = y + xs * p["D"][None, :, None]
    y = _gated_rmsnorm(reshape(y, Bz, d_in), z.float(), p["gn_w"])
    out = (y.to(dt_a) @ p["out_proj"].to(dt_a))[:, None, :]
    return out, (conv_state, h)

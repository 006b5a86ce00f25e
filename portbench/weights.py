"""Seeded random weights, made by the benchmark on the device and handed
to the program and to the reference alike.

Every matrix is a view into one flat buffer in the type the configuration
serves it in, filled by ``normal_(0, 0.02)`` from one generator on the
device in a few large calls (at most ``CHUNK`` values each): the port's
own distributions (``dense_init``: 0.02 x standard normal), not its
draws. Norm weights are ones and LayerNorm biases zeros, as the port's
``init_norm`` makes them. The layout is the port's parameter dict
(``models/transformer.py``): ``embed`` {``tok``, ``head``}, ``layers`` a
list of {``attn``, ``norm1``, ``norm2``, ``ffn``}, ``final_norm``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

#: values per ``normal_`` call
CHUNK = 1 << 30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _matrix_shapes(cfg) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(path, shape) of every random matrix, in buffer order."""
    d, V = cfg.d_model, cfg.vocab_size
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    out = [(("embed", "tok"), (V, d))]
    if not cfg.tie_embeddings:
        out.append((("embed", "head"), (V, d)))
    for i in range(cfg.num_layers):
        L = ("layers", str(i))
        out += [(L + ("attn", "wq"), (d, hq)), (L + ("attn", "wk"), (d, hkv)),
                (L + ("attn", "wv"), (d, hkv)), (L + ("attn", "wo"), (hq, d))]
        if cfg.family == "moe":
            E, f = cfg.num_experts, cfg.d_ff
            out += [(L + ("ffn", "router"), (d, E)),
                    (L + ("ffn", "wi"), (E, d, f)),
                    (L + ("ffn", "wo"), (E, f, d))]
            if cfg.act == "silu":
                out.append((L + ("ffn", "wg"), (E, d, f)))
        else:
            f = cfg.d_ff
            out += [(L + ("ffn", "wi"), (d, f)), (L + ("ffn", "wo"), (f, d))]
            if cfg.act == "silu":
                out.append((L + ("ffn", "wg"), (d, f)))
    return out


def count(cfg) -> int:
    """Number of random values (the matrices; norms excluded)."""
    n = 0
    for _, shape in _matrix_shapes(cfg):
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def make_params(cfg, seed: int, device) -> Dict:
    """The parameter dict of ``cfg`` on ``device`` from ``seed``."""
    dtype = _DTYPES[cfg.param_dtype]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    total = count(cfg)
    buf = torch.empty(total, dtype=dtype, device=dev)
    for a in range(0, total, CHUNK):
        buf[a:a + CHUNK].normal_(0.0, 0.02, generator=gen)
    params: Dict = {"embed": {}, "layers": [dict() for _ in
                                            range(cfg.num_layers)]}
    off = 0
    for path, shape in _matrix_shapes(cfg):
        n = 1
        for s in shape:
            n *= s
        leaf = buf[off:off + n].view(shape)
        off += n
        if path[0] == "embed":
            params["embed"][path[1]] = leaf
        else:
            layer = params["layers"][int(path[1])]
            layer.setdefault(path[2], {})[path[3]] = leaf
    for layer in params["layers"]:
        layer["norm1"] = _norm(cfg, dtype, dev)
        layer["norm2"] = _norm(cfg, dtype, dev)
    params["final_norm"] = _norm(cfg, dtype, dev)
    return params


def _norm(cfg, dtype, dev) -> Dict:
    p = {"weight": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
    if cfg.norm_type != "rmsnorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
    return p

"""Seeded random weights, made by the benchmark on the device and handed
to the program and to the reference alike.

The configuration's model module (``reference/<model>.py``, named by the
configuration file's ``"model"``) lays the parameter tree out: its
``layout(cfg)`` yields every leaf in buffer order as ``(path, shape,
fill)`` or ``(path, shape, fill, dtype)``:

* ``path``: a tuple of keys of any depth; a part made of digits indexes a
  list (``("layers", "3", "attn", "wq")``);
* ``fill``: a number, the leaf's scale on the seeded buffer (1.0: the
  buffer's values as they are), or ``"ones"`` / ``"zeros"``, a constant;
* ``dtype``: ``"float32"`` or ``"bfloat16"``, where the leaf is not in
  ``cfg.param_dtype``.

The seeded leaves take consecutive stretches of one flat buffer in
``cfg.param_dtype``, filled by ``normal_(0, 0.02)`` from one generator on
the device in a few large calls (at most ``CHUNK`` values each): the
port's own distributions (``dense_init``: 0.02 x standard normal), not
its draws. A leaf in that type at scale 1 is a view of its stretch; any
other is a copy of it, cast and scaled. Constants are small tensors of
their own and take nothing from the buffer.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import torch

#: values per ``normal_`` call
CHUNK = 1 << 30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def count(cfg, layout: Callable[[object], Iterable]) -> int:
    """Number of seeded values (the constants excluded)."""
    return sum(math.prod(leaf[1]) for leaf in layout(cfg)
               if not isinstance(leaf[2], str))


def make_params(cfg, seed: int, device, layout: Callable) -> Dict:
    """The parameter tree ``layout`` lays out for ``cfg`` on ``device``
    from ``seed``."""
    dtype = _DTYPES[cfg.param_dtype]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    total = count(cfg, layout)
    buf = torch.empty(total, dtype=dtype, device=dev)
    for a in range(0, total, CHUNK):
        buf[a:a + CHUNK].normal_(0.0, 0.02, generator=gen)
    tree: Dict = {}
    off = 0
    for path, shape, fill, *kind in layout(cfg):
        dt = _DTYPES[kind[0]] if kind else dtype
        if fill == "ones":
            leaf = torch.ones(shape, dtype=dt, device=dev)
        elif fill == "zeros":
            leaf = torch.zeros(shape, dtype=dt, device=dev)
        else:
            n = math.prod(shape)
            leaf = buf[off:off + n].view(shape)
            off += n
            if dt != dtype or fill != 1:
                leaf = leaf.to(dt) * fill
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _listify(tree)


def _listify(node):
    """Every dict whose keys are all digits becomes the list it indexes."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out

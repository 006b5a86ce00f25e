"""Sharding rules: parameter / batch / cache partition specs per mesh, and
their DTensor placements.

Port of ``repro.distributed.sharding``. The rules are the reference's,
name for name:

* **FSDP × TP**: every weight matrix shards its d_model-side dimension on
  ``data`` (FSDP) and its wide output dimension (heads / d_ff / vocab /
  experts) on ``model`` (tensor parallelism).
* **Batch** shards on ``("pod", "data")`` (pure DP across pods).
* **KV caches** shard batch on ``data`` and heads on ``model`` when the
  arch has ≥ model-axis KV heads; otherwise (MQA, batch-1 long-context)
  they shard the *sequence* dimension on ``model`` — the sequence-parallel
  decode path.

A spec is a ``P``: a tuple with one entry per tensor dimension, each a
mesh-axis name, a tuple of names, or None, so that it compares equal entry
by entry to the reference's ``PartitionSpec``. The reference stacks a
layer stack along a leading axis; the port holds it as a list of per-layer
dicts. "Stacked" is decided as the reference decides it, by the root key
(``_STACKED_ROOTS``), and the spec of a per-layer leaf is the reference's
spec of the stacked leaf with the leading ``None`` of the layer axis
dropped.

A mesh is anything with ``axis_names`` and ``devices.shape`` (the
reference's ``Mesh``, or a stand-in that names a production mesh without
its devices) or a ``torch.distributed.DeviceMesh``. ``placements`` turns a
spec into DTensor placements on a ``DeviceMesh``: ``Shard(dim)`` on every
mesh dimension that shards ``dim``, ``Replicate()`` elsewhere; a dimension
sharded over ``("pod", "data")`` takes ``Shard`` on both mesh dimensions,
pod major, as JAX orders them.

``constrain(x, *logical)`` is the reference's activation constraint:
inside ``activation_policy(mesh)`` and on a DTensor it redistributes ``x``
to the layout the logical axis names give (batch on ``("pod", "data")``,
heads / ff / vocab / experts on ``model``, each only where the dimension
divides); outside a policy, or on a plain tensor, it returns ``x``
untouched, so the one-card paths run unchanged. So do the other helpers
the models call under a policy: ``per_shard`` runs an op whose batch rows
and heads are independent (a scan, attention) on each rank's own shards,
where DTensor's rules for its reshapes and products differ between torch
releases; ``cache_zeros`` builds a prefill's cache in the
``cache_pspecs`` layout; ``reshape`` and ``pin`` bring a gradient into a
tensor's own layout where DTensor could not take it as it arrives.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class P(tuple):
    """A partition spec: one entry per tensor dimension (a mesh-axis name,
    a tuple of names, or None). A one-name tuple is stored as the name, as
    JAX's ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))


def _axis_sizes(mesh) -> dict:
    if hasattr(mesh, "mesh_dim_names"):              # DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_names(mesh) -> Tuple[str, ...]:
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def mesh_axis_size(mesh, name: str) -> int:
    return _axis_sizes(mesh).get(name, 1)


def dp_axes(mesh):
    """Batch data-parallel axes: ('pod','data') on multi-pod meshes."""
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


# ---------------------------------------------------------------------------
# Trees with paths (nested dicts and lists, as the models build them)
# ---------------------------------------------------------------------------


def tree_map_with_path(fn: Callable, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *leaves of rest)`` over nested dicts and lists; a
    path holds dict keys (str) and list indices (int)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _keys(path) -> list:
    return [p for p in path if isinstance(p, str)]


def _ndim(leaf) -> int:
    return leaf.dim() if isinstance(leaf, torch.Tensor) else \
        len(getattr(leaf, "shape", ()))


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# keys whose arrays are small / 1-D and stay replicated
_REPLICATED = {"weight", "bias", "mu", "cm_mu", "w0", "u", "gn_w", "gn_b",
               "A_log", "D", "dt_bias", "conv_b"}
# (d_model, wide) matrices: shard in-dim on data (FSDP), out-dim on model (TP)
_IN_DATA_OUT_MODEL = {"wq", "wk", "wv", "wi", "wg", "wr", "wd1",
                      "cm_k", "cm_r", "in_proj"}
# (wide, d_model): transpose of the above
_IN_MODEL_OUT_DATA = {"wo", "cm_v", "out_proj", "wd2"}


def _pspec_for(key: str, shape: Tuple[int, ...], stacked: bool) -> P:
    """PartitionSpec for a leaf named ``key``; ``stacked`` = leading layer
    axis present (the reference's scan-over-layers stacking)."""
    lead = (None,) if stacked else ()
    nd = len(shape) - len(lead)
    if key in _REPLICATED or nd <= 1:
        return P(*lead, *([None] * nd))
    if key == "tok" or key == "head":            # (V, d): vocab on model
        return P("model", "data")
    if key == "pos" or key == "enc_pos":         # (S, d)
        return P(None, "data")
    if key == "router":                          # (d, E)
        return P(*lead, "data", None)
    if key in ("wi", "wg", "wo") and nd == 3:    # MoE (E, d, f)/(E, f, d)
        return P(*lead, "model", "data", None) if key != "wo" else \
            P(*lead, "model", None, "data")
    if key == "conv_w":                          # (W, Ch)
        return P(*lead, None, "model")
    if key in _IN_DATA_OUT_MODEL:
        return P(*lead, "data", "model")
    if key in _IN_MODEL_OUT_DATA:
        return P(*lead, "model", "data")
    # default: replicate
    return P(*lead, *([None] * nd))


_STACKED_ROOTS = {"layers", "mamba", "encoder", "decoder"}


def param_pspecs(params, serving: bool = False):
    """Spec tree matching ``params``.

    ``serving=True`` strips the FSDP ('data') component: weights stay
    TP-sharded on 'model' but fully resident per data-parallel group, so a
    decode step does no weight gathers.
    """
    def spec(path, leaf):
        keys = _keys(path)
        stacked = bool(keys) and keys[0] in _STACKED_ROOTS
        per_layer = stacked and any(isinstance(p, int) for p in path)
        shape = tuple(leaf.shape)
        if per_layer:   # the reference's stacked leaf, less its layer axis
            ps = P(*_pspec_for(keys[-1], (1,) + shape, True)[1:])
        else:
            ps = _pspec_for(keys[-1], shape, stacked)
        if serving:
            ps = P(*[None if ax == "data" else ax for ax in ps])
        return ps

    return tree_map_with_path(spec, params)


def fit_pspecs(mesh, specs, tree):
    """Drop spec axes whose dimension is not divisible by the mesh axis,
    as the reference does for pjit's exact divisibility (e.g. whisper's
    vocab 51866 cannot shard 16-way and falls back to replicated)."""
    def fit(_path, spec, leaf):
        if not isinstance(spec, P):
            return spec
        out = []
        for dim, ax in enumerate(spec):
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = int(np.prod([mesh_axis_size(mesh, a) for a in axes]))
            out.append(ax if leaf.shape[dim] % size == 0 else None)
        return P(*out)

    return tree_map_with_path(fit, specs, tree)


# ---------------------------------------------------------------------------
# Batch / input rules
# ---------------------------------------------------------------------------


def batch_pspecs(mesh, batch):
    dp = dp_axes(mesh)

    dp_size = int(np.prod([mesh_axis_size(mesh, a) for a in dp]))

    def spec(path, leaf):
        keys = _keys(path)
        name = keys[-1] if keys else ""
        nd = _ndim(leaf)
        if name == "positions" and nd == 3:      # (3, B, S)
            b = leaf.shape[1]
            return P(None, dp if b % dp_size == 0 else None, None)
        if nd == 0:
            return P()
        rest = [None] * (nd - 1)
        if leaf.shape[0] % dp_size != 0:         # tiny batch: replicate
            return P(None, *rest)
        return P(dp, *rest)                      # batch-major inputs

    return tree_map_with_path(spec, batch)


# ---------------------------------------------------------------------------
# Cache rules (decode / serve_step)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def cache_pspecs(mesh, cfg: ModelConfig, cache):
    """Decode-cache specs. KV tensors are (L_or_G, B, S, Hkv, D). The
    cache's ``index`` (a host int when serving) takes ``P()``."""
    dp = dp_axes(mesh)
    model_size = mesh_axis_size(mesh, "model")
    batch = None
    for leaf in _leaves(cache):
        if _ndim(leaf) >= 2:
            batch = leaf.shape[1]
            break
    # heads need exact divisibility — 20 heads on a 16-way model axis
    # falls through to sequence sharding instead of replicating
    heads_shardable = (cfg.num_kv_heads >= model_size
                       and cfg.num_kv_heads % model_size == 0)
    batch_shardable = batch is None or batch >= int(np.prod(
        [mesh_axis_size(mesh, a) for a in dp]))

    def kv_spec():
        if heads_shardable and batch_shardable:
            return P(None, dp, None, "model", None)
        if heads_shardable:      # batch-1 long context: SP over data + TP heads
            return P(None, None, "data", "model", None)
        if batch_shardable:      # MQA: sequence-parallel over model
            return P(None, dp, "model", None, None)
        return P(None, None, ("data", "model"), None, None)

    def spec(path, leaf):
        keys = _keys(path)
        name = keys[-1] if keys else ""
        nd = _ndim(leaf)
        if name in ("k", "v", "sk", "sv", "ck", "cv") and nd == 5:
            return kv_spec()
        if name == "index" or nd == 0:
            return P()
        if name == "wkv" and nd == 5:            # (L, B, H, K, V)
            return P(None, dp if batch_shardable else None, "model", None,
                     None)
        if name == "ssm" and nd == 5:            # (L, B, H, N, P)
            return P(None, dp if batch_shardable else None, "model", None,
                     None)
        if name == "conv" and nd == 4:           # (L, B, W-1, Ch)
            return P(None, dp if batch_shardable else None, None, "model")
        if name in ("tm_last", "cm_last") and nd == 3:   # (L, B, d)
            return P(None, dp if batch_shardable else None, "model")
        rest = [None] * (nd - 1)
        return P(None, *rest)

    return tree_map_with_path(spec, cache)


def logits_pspec(mesh, batch_shardable: bool = True) -> P:
    dp = dp_axes(mesh)
    return P(dp if batch_shardable else None, None, "model")


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec: P) -> tuple:
    """DTensor placements on the DeviceMesh ``mesh`` for ``spec``: per mesh
    dimension ``Shard(d)`` where tensor dimension ``d`` names it, else
    ``Replicate()``. A dimension sharded over several mesh axes must name
    them in mesh order (major first), which is the order DTensor splits
    them in. A mesh dimension of size 1 is ``Replicate()`` (the same data
    on its one rank; DTensor's view rules refuse a size-1 tensor
    dimension sharded there)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    sizes = _axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are "
                             f"not in mesh order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def param_shardings(mesh, params, serving: bool = False):
    """Placements tree for ``params`` on ``mesh`` (specs fitted to the
    mesh's divisibility first, as the reference's)."""
    specs = fit_pspecs(mesh, param_pspecs(params, serving=serving), params)
    return tree_map_with_path(lambda _p, s: placements(mesh, s), specs)


def distribute(mesh, tree, specs):
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` by the matching
    spec, fitted to the mesh (``fit_pspecs``). Every rank holds the whole
    leaf and keeps its own shard; no data moves. Non-tensor leaves (a host
    ``index``) pass through."""
    from torch.distributed.tensor import distribute_tensor

    def one(_path, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, placements(mesh, spec),
                                 src_data_rank=None)

    return tree_map_with_path(one, tree, fit_pspecs(mesh, specs, tree))


def distribute_params(mesh, params, serving: bool = False):
    """``params`` placed on ``mesh`` by ``param_pspecs``."""
    return distribute(mesh, params, param_pspecs(params, serving=serving))


# ---------------------------------------------------------------------------
# Activation sharding constraints (logical axes)
# ---------------------------------------------------------------------------
#
# ``constrain(x, ...logical axes)`` pins the MaxText-style layout: batch on
# ('pod','data'), heads/ff/vocab/experts on 'model'. It is a no-op outside a
# policy context so model code runs unmodified on one device.

_POLICY: dict = {"mesh": None}

_LOGICAL = {
    "batch": "__dp__",       # resolved to ('pod','data') / ('data',)
    "heads": "model",
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "seq": None,
    "seq_model": "model",    # sequence-parallel attention (decode SP)
    "embed": None,
    None: None,
}


def set_activation_policy(mesh: Optional[Any]) -> None:
    _POLICY["mesh"] = mesh


def policy_mesh():
    """The mesh of the active activation policy, or None."""
    return _POLICY["mesh"]


class activation_policy:
    """Context manager: ``with activation_policy(mesh): ... run ...``"""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        set_activation_policy(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_activation_policy(None)
        return False


def logical_spec(mesh, shape, logical) -> P:
    """The spec the logical axis names give a tensor of ``shape`` on
    ``mesh``: batch on ``("pod", "data")``, heads / ff / vocab / experts
    on ``model``, each only where the dimension divides."""
    dp = dp_axes(mesh)
    dp_size = int(np.prod([mesh_axis_size(mesh, a) for a in dp]))
    assert len(logical) == len(shape), (logical, shape)
    spec = []
    for dim, name in enumerate(logical):
        ax = _LOGICAL.get(name)
        if ax == "__dp__":
            spec.append(dp if shape[dim] % dp_size == 0 else None)
        elif ax is not None and shape[dim] % mesh_axis_size(mesh, ax) == 0:
            spec.append(ax)
        else:
            spec.append(None)
    return P(*spec)


def constrain(x, *logical):
    """Redistribute a DTensor per the logical-axis names (or None) inside
    a policy; ``x`` itself otherwise."""
    mesh = _POLICY["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(
        mesh, logical_spec(mesh, x.shape, logical)))


def reshape(x, *shape):
    """``x.reshape(*shape)``. Inside a policy, a DTensor whose sharded
    dimension cannot be split evenly into the new shape (a projection of
    H·D columns sharded wider than H heads) is first replicated on the
    dimensions the reshape changes, the reshard GSPMD inserts by itself in
    the reference. The result's layout is pinned, so that its gradient
    comes back in that layout before the reshape's backward (a gradient
    sharded on H·D columns cannot be split into H heads either)."""
    if _POLICY["mesh"] is None:
        return x.reshape(*shape)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    try:
        out = x.reshape(*shape)
    except RuntimeError:
        keep = 0
        while keep < min(x.dim(), len(shape)) and \
                x.shape[keep] == shape[keep]:
            keep += 1
        pl = tuple(Replicate() if isinstance(p, Shard) and p.dim >= keep
                   else p for p in x.placements)
        out = x.redistribute(x.device_mesh, pl).reshape(*shape)
    return pin(out)


def pin(x):
    """Inside a policy, a DTensor with its layout pinned: ``x`` itself in
    forward, and in backward its gradient brought into ``x``'s layout
    (what arrives there may be sharded or a partial sum). Outside a
    policy, or on a plain tensor, ``x`` itself."""
    if _POLICY["mesh"] is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def reduce_partial(x):
    """Inside a policy, a DTensor's pending partial placements reduced to
    replicated; ``x`` itself otherwise. DTensor reduces a vocab-sharded
    gather lazily, with a mask of the gather's own rank, so the reduction
    must land before any view changes that rank."""
    if _POLICY["mesh"] is None:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor) or \
            not any(isinstance(p, Partial) for p in x.placements):
        return x
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)
    return x.redistribute(x.device_mesh, pl)


def policy_call(mesh, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside ``activation_policy(mesh)`` for a
    step whose inputs are all DTensors. The plain tensors it meets are the
    constants the step makes itself (masks, aranges, RoPE angles, the
    optimizer's step count and bias corrections); DTensor's
    ``implicit_replication`` takes those, and only those, as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    with activation_policy(mesh), implicit_replication():
        return fn(*args, **kwargs)


def take_rows(table, ids):
    """``table[ids]``. Inside a policy, on a DTensor table, the table is
    gathered whole (the FSDP gather of a weight) and each rank looks up
    its own rows of ``ids``; the rows keep ``ids``' layout, and in
    backward the table's gradient is a partial sum over the mesh
    dimensions that shard ``ids``, reduced onto the table's layout.
    DTensor's own rules for an index into a sharded table are not
    dependable across torch releases (a vocab-sharded lookup with sharded
    indices is refused or mis-masked by some)."""
    mesh = _POLICY["mesh"]
    if mesh is None:
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[ids]
    rep = (Replicate(),) * mesh.ndim
    if isinstance(ids, DTensor):
        ids = reduce_partial(ids)
        pl, local = ids.placements, ids.to_local()
    else:
        pl, local = rep, ids
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in pl)
    rows = table.redistribute(mesh, rep).to_local(grad_placements=grad)
    return DTensor.from_local(rows[local], mesh, pl, run_check=False)


def per_shard(fn, args, logical, out_logical):
    """Inside an activation policy, with a DTensor among ``args``:
    ``fn(*args)`` on each rank's own shards, as GSPMD partitions an op
    whose batch rows and heads are independent (a scan, attention); None
    outside a policy or without a DTensor.

    ``logical`` names each argument's dimensions as ``constrain`` does
    (None for an argument that is not a tensor); every tensor argument is
    placed by its names (a DTensor redistributed, a plain tensor cut to
    this rank's slice), so an argument named all None is whole on every
    rank. ``fn`` runs outside the policy, the one-device code on local
    tensors, and each of its outputs (one tensor, or a tuple) becomes a
    DTensor of the layout its names in ``out_logical`` give. The names
    must give the outputs the layout the computation leaves them in:
    ``fn`` is not told which shard it holds. DTensor's own rules for the
    reshapes and batched products inside such ops differ between torch
    releases (some refuse a flatten of two sharded dimensions)."""
    mesh = _POLICY["mesh"]
    if mesh is None:
        return None
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    if not any(isinstance(a, DTensor) for a in args):
        return None
    pls = [placements(mesh, logical_spec(mesh, a.shape, n))
           if n is not None and isinstance(a, torch.Tensor) else None
           for a, n in zip(args, logical)]
    # mesh dimensions the work is split over: an argument whole on one of
    # them sees only its rank's part of the work, so its gradient there is
    # a partial sum
    split = {i for pl in pls if pl for i, p in enumerate(pl)
             if isinstance(p, Shard)}

    def local(a, pl):
        if pl is None:
            return a
        if isinstance(a, DTensor):
            a = reduce_partial(a)
            grad = tuple(Partial() if i in split and isinstance(p, Replicate)
                         else p for i, p in enumerate(pl))
            return (a if a.placements == pl else
                    a.redistribute(mesh, pl)).to_local(grad_placements=grad)
        return distribute_tensor(a, mesh, pl, src_data_rank=None).to_local()

    loc = [local(a, pl) for a, pl in zip(args, pls)]
    set_activation_policy(None)
    try:
        out = fn(*loc)
    finally:
        set_activation_policy(mesh)
    single = isinstance(out, torch.Tensor)
    outs, names = ((out,), (out_logical,)) if single else (out, out_logical)
    sizes = {}
    for a, n in zip(args, logical):     # each logical name's global size
        if n is not None and isinstance(a, torch.Tensor):
            sizes.update({nm: a.shape[d] for d, nm in enumerate(n)
                          if nm is not None})
    wrapped = []
    for o, n in zip(outs, names):
        shape = [sizes.get(nm, o.shape[d]) if nm is not None else o.shape[d]
                 for d, nm in enumerate(n)]
        pl = placements(mesh, logical_spec(mesh, shape, n))
        wrapped.append(DTensor.from_local(o, mesh, pl, run_check=False))
    return wrapped[0] if single else tuple(wrapped)


def cache_zeros(cfg: ModelConfig, make: Callable, like):
    """``make(device)``: a model's zero cache or state on ``like``'s device.
    Inside a policy, with ``like`` a DTensor, the same zeros as DTensors on
    the policy's mesh in the ``cache_pspecs`` layout (fitted to the mesh),
    each rank allocating only its own shard: the layout the reference's
    sharded serving step gives its cache."""
    mesh = _POLICY["mesh"]
    from torch.distributed.tensor import DTensor, distribute_tensor
    if mesh is None or not isinstance(like, DTensor):
        return make(like.device)
    meta = make("meta")
    specs = fit_pspecs(mesh, cache_pspecs(mesh, cfg, meta), meta)

    def one(_path, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        pl = placements(mesh, spec)
        shard = distribute_tensor(leaf, mesh, pl, src_data_rank=None)
        z = torch.zeros(shard.to_local().shape, dtype=leaf.dtype,
                        device=like.device)
        return DTensor.from_local(z, mesh, pl, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return tree_map_with_path(one, meta, specs)

"""Parameter trees of both packages as {path: (shape, dtype)}, for
holding the port's ``init`` against the reference's ``jax.eval_shape``;
and the two packages' configs, field by field."""
import dataclasses

#: the port's ``ModelConfig`` fields the reference's lacks (Granite-4.0-H's
#: layer kinds, shared expert and multipliers), each at the value that
#: changes nothing
PORT_ONLY_FIELDS = {"layer_types": (), "shared_expert_ff": 0,
                    "embedding_multiplier": 1.0,
                    "attention_multiplier": None,
                    "residual_multiplier": 1.0, "logits_scaling": 1.0}


def config_fields(port_cfg, ref_cfg):
    """(the port's fields that the reference's config has, the port's
    own fields), each a dict of field values."""
    port, ref = dataclasses.asdict(port_cfg), dataclasses.asdict(ref_cfg)
    return ({k: v for k, v in port.items() if k in ref},
            {k: v for k, v in port.items() if k not in ref})


def param_shapes(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict of arrays (JAX
    ``ShapeDtypeStruct``s or torch tensors, on any device, ``meta``
    included); a list of per-layer dicts is read as the reference's
    leading layer axis."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(param_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        inner = param_shapes(tree[0], prefix)
        assert all(param_shapes(t, prefix) == inner for t in tree)
        return {k: ((len(tree),) + s, d) for k, (s, d) in inner.items()}
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).replace("torch.", ""))}

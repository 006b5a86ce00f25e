"""Parameter trees of both packages as {path: (shape, dtype)}, for
holding the port's ``init`` against the reference's ``jax.eval_shape``."""


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

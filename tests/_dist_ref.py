"""The reference's sharded functions on 8 host devices, for
``tests/test_torch_distributed.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/_dist_ref.py DIR

Reads ``DIR/inputs.npz`` and writes ``DIR/ref.npz``: tinyllama's sharded
train step, each other family's sharded train step and prefill logits,
the compressed all-reduce, the pipeline, the sequence-parallel combine
and the elastic layouts. Every mesh is made
with ``Auto`` axis types: jax 0.9's ``jax.make_mesh`` defaults to
``Explicit`` axes, under which the reference's gathers and
``with_sharding_constraint`` fail (its own four tests in
``tests/test_distributed.py``); under ``Auto`` axes the same functions run
unchanged.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config
from repro.configs.base import TrainConfig
from repro.distributed import sharding as sh
from repro.distributed.collectives import (compressed_psum,
                                           sequence_parallel_softmax_combine)
from repro.distributed.compat import shard_map_nocheck
from repro.distributed.elastic import surviving_mesh
from repro.distributed.pipeline import pipeline_shard_map
from repro.models.api import build_model
from repro.trainer import optimizer as opt
from repro.trainer.train_loop import make_train_step

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=64,
            activation_dtype="float32", param_dtype="float32")
LOST = ([0, 1, 2, 3], [1], [5, 6], [], [0, 1, 2, 3, 4])


def mesh(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def unflatten(flat, prefix):
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def flatten(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(p.key for p in path)] = np.asarray(leaf)
    return out


def train(inp, out):
    cfg = get_config("tinyllama-1.1b").reduced(**TINY)
    model = build_model(cfg)
    params = unflatten(inp, "params/")
    tok = jnp.asarray(inp["tokens"])
    batch = {"tokens": tok, "labels": tok}
    step = make_train_step(model, TrainConfig(warmup_steps=1, total_steps=2))
    p1, _, m1 = jax.jit(step)(params, opt.init(params), batch)
    out["single_loss"] = np.asarray(m1["loss"])
    out.update(flatten(p1, "single/"))
    m = mesh((2, 4), ("data", "model"))
    try:
        with m, sh.activation_policy(m):
            ps = sh.param_shardings(m, params)
            bs = jax.tree.map(lambda s: NamedSharding(m, s),
                              sh.batch_pspecs(m, batch))
            params_d = jax.device_put(params, ps)
            batch_d = jax.device_put(batch, bs)
            p2, _, m2 = jax.jit(step)(params_d, opt.init(params_d), batch_d)
        out["sharded_loss"] = np.asarray(m2["loss"])
        out.update(flatten(p2, "sharded/"))
    except Exception as e:  # recorded; the test then uses the single step
        out["sharded_error"] = np.asarray(f"{type(e).__name__}: {e}")


def families(inp, out):
    """Each family's reduced config (f32): the sharded train step and the
    sharded prefill's logits on the (2, 4) mesh, as ``train`` does for
    tinyllama; a failure is recorded per family."""
    m = mesh((2, 4), ("data", "model"))
    for arch in (str(a) for a in inp["families"]):
        pre = f"fam/{arch}/"
        cfg = get_config(arch).reduced(activation_dtype="float32",
                                       param_dtype="float32")
        model = build_model(cfg)
        params = unflatten(inp, pre + "params/")
        batch = unflatten(inp, pre + "batch/")
        inputs = unflatten(inp, pre + "prefill/")
        step = make_train_step(model, TrainConfig(warmup_steps=1,
                                                  total_steps=2))

        def put(m, tree):
            return jax.device_put(tree, jax.tree.map(
                lambda s: NamedSharding(m, s), sh.batch_pspecs(m, tree)))

        try:
            with m, sh.activation_policy(m):
                params_d = jax.device_put(params, sh.param_shardings(m,
                                                                     params))
                p2, _, m2 = jax.jit(step)(params_d, opt.init(params_d),
                                          put(m, batch))
                logits, _ = jax.jit(lambda p, i: model.prefill(p, **i))(
                    params_d, put(m, inputs))
            out[pre + "loss"] = np.asarray(m2["loss"])
            out.update(flatten(p2, pre + "p/"))
            out[pre + "logits"] = np.asarray(logits)
        except Exception as e:  # recorded; the test reports it
            out[pre + "error"] = np.asarray(f"{type(e).__name__}: {e}")


def compressed(inp, out):
    m = mesh((8,), ("data",))
    f = jax.jit(shard_map_nocheck(
        lambda g, r: compressed_psum(g, "data", r), mesh=m,
        in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data"))))
    g = jnp.asarray(inp["g"])
    r = jnp.zeros_like(g)
    outs, res = [], []
    for _ in range(30):
        o, r = f(g, r)
        outs.append(np.asarray(o))
        res.append(np.asarray(r))
    out["psum_out"] = np.stack(outs)
    out["psum_res"] = np.stack(res)


def pipeline(inp, out):
    m = mesh((4,), ("stage",))
    Ws = jnp.asarray(inp["pipe_w"])

    def stage_fn(stage, x):
        W = jax.lax.dynamic_index_in_dim(Ws, stage, 0, keepdims=False)
        return jnp.tanh(x @ W)

    out["pipe_y"] = np.asarray(pipeline_shard_map(
        stage_fn, m, n_microbatches=inp["pipe_x"].shape[0])(
            jnp.asarray(inp["pipe_x"])))


def sp_combine(inp, out):
    """Flash-decoding partials per sequence shard of the cache, merged."""
    m = mesh((4,), ("seq",))
    q, k, v = (jnp.asarray(inp[n]) for n in ("sp_q", "sp_k", "sp_v"))

    def local(q, k, v):
        # q (B,H,1,D); k, v (B,Sl,D): one MQA head
        s = jnp.einsum("bhqd,bkd->bhqk", q, k) / np.sqrt(q.shape[-1])
        mx = jnp.max(s, axis=-1, keepdims=True)
        p = jnp.exp(s - mx)
        return sequence_parallel_softmax_combine(
            mx, jnp.sum(p, axis=-1, keepdims=True),
            jnp.einsum("bhqk,bkd->bhqd", p, v), "seq")

    f = shard_map_nocheck(local, mesh=m,
                          in_specs=(P(), P(None, "seq"), P(None, "seq")),
                          out_specs=P())
    out["sp_o"] = np.asarray(jax.jit(f)(q, k, v))


def elastic(out):
    for i, lost in enumerate(LOST):
        try:
            em = surviving_mesh(("data", "model"), (2, 4), lost)
            out[f"elastic_{i}"] = np.vectorize(lambda d: d.id)(em.devices)
        except RuntimeError as e:
            out[f"elastic_{i}_error"] = np.asarray(str(e))
    em = surviving_mesh(("pod", "data", "model"), (2, 2, 2), [3])
    out["elastic_3d"] = np.vectorize(lambda d: d.id)(em.devices)


def main(d):
    inp = dict(np.load(f"{d}/inputs.npz"))
    out = {}
    train(inp, out)
    families(inp, out)
    compressed(inp, out)
    pipeline(inp, out)
    sp_combine(inp, out)
    elastic(out)
    np.savez(f"{d}/ref.npz", **out)


if __name__ == "__main__":
    main(sys.argv[1])

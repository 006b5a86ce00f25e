"""The port's distributed layer on 8 gloo ranks of the CPU, for
``tests/test_torch_distributed.py``.

    python tests/_dist_ranks.py DIR

Spawns 8 processes that join one gloo group through a file store in DIR,
read ``DIR/inputs.npz`` and each write ``DIR/rank<r>.npz``: the sharded
train step on a (2, 4) mesh beside the single-device step (tinyllama,
and one reduced config of each other family, with its sharded prefill's
logits), 30 rounds of
``compressed_psum`` over 8 ranks, ``pipeline_shard_map`` over 4 stages
(two replicas of the 4-stage ring), ``sequence_parallel_softmax_combine``
over 4 sequence shards, and ``reshard_params`` onto the 4 survivors of
the (2, 4) mesh.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8


def unflatten(flat, prefix):
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat_leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat_leaves(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def train(inp, out, rank):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import params_from_jax
    from repro_torch.trainer import optimizer as opt
    from repro_torch.trainer.train_loop import make_train_step

    cfg = get_config("tinyllama-1.1b").reduced(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=64, activation_dtype="float32",
        param_dtype="float32")
    model = build_model(cfg)
    params = params_from_jax(unflatten(inp, "params/"), device="cpu")
    tok = torch.as_tensor(inp["tokens"])
    batch = {"tokens": tok, "labels": tok}
    step = make_train_step(model, TrainConfig(warmup_steps=1, total_steps=2))
    p1, _, m1 = step(params, opt.init(params), batch)

    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 4),
                      mesh_dim_names=("data", "model"))
    params_d = sh.distribute_params(mesh, params)
    batch_d = sh.distribute(mesh, batch, sh.batch_pspecs(mesh, batch))
    p2, _, m2 = sh.policy_call(mesh, step, params_d, opt.init(params_d),
                               batch_d)
    out["single_loss"] = m1["loss"].numpy()
    out["sharded_loss"] = m2["loss"].full_tensor().numpy()
    for k, v in flat_leaves(p1).items():
        out["single/" + k] = v.numpy()
    for k, v in flat_leaves(p2).items():
        out["sharded/" + k] = v.full_tensor().numpy()
    for k, v in flat_leaves(params_d).items():   # this rank's shards
        out["shard/" + k] = v.to_local().numpy()

    # elastic: lose ranks 0-3, reshard the whole params onto the rest
    from repro_torch.distributed.elastic import reshard_params, \
        surviving_mesh
    new = surviving_mesh(("data", "model"), (2, 4), [0, 1, 2, 3],
                         device_type="cpu")
    resharded = reshard_params(params, new)
    if new.get_coordinate() is not None:
        out["elastic_mesh"] = new.mesh.numpy()
        full = flat_leaves(params)
        out["elastic_equal"] = np.asarray(all(
            torch.equal(v.full_tensor(), full[k])
            for k, v in flat_leaves(resharded).items()))
        z = torch.zeros((4, 8), dtype=torch.int32)
        zb = sh.distribute(new, {"tokens": z, "labels": z},
                           sh.batch_pspecs(new, {"tokens": z, "labels": z}))
        loss = sh.policy_call(new, model.loss_fn, resharded, zb)
        out["elastic_loss"] = loss.full_tensor().numpy()


def families(inp, out, rank):
    """Each family's reduced config (f32) on the (2, 4) mesh: the sharded
    train step (loss on every rank, parameters from rank 0, and rank 0's
    single-device step beside it) and the sharded prefill's logits; where
    the prefill builds its cache (RWKV6, Zamba2), whether every cache
    tensor holds the ``cache_pspecs`` layout."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import params_from_jax
    from repro_torch.trainer import optimizer as opt
    from repro_torch.trainer.train_loop import make_train_step

    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 4),
                      mesh_dim_names=("data", "model"))
    for arch in (str(a) for a in inp["families"]):
        pre = f"fam/{arch}/"
        cfg = get_config(arch).reduced(activation_dtype="float32",
                                       param_dtype="float32")
        model = build_model(cfg)
        params = params_from_jax(unflatten(inp, pre + "params/"),
                                 device="cpu")
        batch = {k: torch.as_tensor(v)
                 for k, v in unflatten(inp, pre + "batch/").items()}
        inputs = {k: torch.as_tensor(v)
                  for k, v in unflatten(inp, pre + "prefill/").items()}
        step = make_train_step(model, TrainConfig(warmup_steps=1,
                                                  total_steps=2))
        params_d = sh.distribute_params(mesh, params)
        p2, _, m2 = sh.policy_call(
            mesh, step, params_d, opt.init(params_d),
            sh.distribute(mesh, batch, sh.batch_pspecs(mesh, batch)))
        out[pre + "loss"] = m2["loss"].full_tensor().numpy()
        logits, cache = sh.policy_call(
            mesh, lambda p, i: model.prefill(p, **i), params_d,
            sh.distribute(mesh, inputs, sh.batch_pspecs(mesh, inputs)))
        out[pre + "logits"] = logits.full_tensor().numpy()
        if cfg.family in ("ssm", "hybrid"):
            specs = sh.fit_pspecs(mesh, sh.cache_pspecs(mesh, cfg, cache),
                                  cache)
            out[pre + "cache_layout"] = np.asarray(all(
                isinstance(t, DTensor) and
                t.placements == sh.placements(mesh, specs[k])
                for k, t in cache.items() if k != "index"))
        full = {k: v.full_tensor().numpy()       # a collective: every rank
                for k, v in flat_leaves(p2).items()}
        if rank == 0:
            out.update({pre + "p/" + k: v for k, v in full.items()})
            p1, _, m1 = step(params, opt.init(params), batch)
            out[pre + "single_loss"] = m1["loss"].numpy()
            for k, v in flat_leaves(p1).items():
                out[pre + "single/" + k] = v.detach().numpy()


def compressed(inp, out, rank):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.collectives import compressed_psum
    mesh = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("data",))
    group = mesh.get_group("data")
    g = torch.as_tensor(inp["g"][rank:rank + 1])
    r = torch.zeros_like(g)
    outs, res = [], []
    for _ in range(30):
        o, r = compressed_psum(g, group, r)
        outs.append(o.numpy())
        res.append(r.numpy())
    out["psum_out"] = np.stack(outs)
    out["psum_res"] = np.stack(res)
    single, _ = compressed_psum(g, group, torch.zeros_like(g))
    out["psum_single"] = single.numpy()


def pipeline_and_combine(inp, out, rank):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.collectives import \
        sequence_parallel_softmax_combine
    from repro_torch.distributed.pipeline import pipeline_shard_map
    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 4),
                      mesh_dim_names=("replica", "stage"))
    Ws = torch.as_tensor(inp["pipe_w"])
    x = torch.as_tensor(inp["pipe_x"])
    piped = pipeline_shard_map(lambda s, xb: torch.tanh(xb @ Ws[s]), mesh,
                               n_microbatches=x.shape[0])
    out["pipe_y"] = piped(x).numpy()

    # one sequence shard of an MQA decode per stage rank
    q, k, v = (torch.as_tensor(inp[n]) for n in ("sp_q", "sp_k", "sp_v"))
    s = mesh.get_local_rank("stage")
    n = k.shape[1] // 4
    kl, vl = k[:, s * n:(s + 1) * n], v[:, s * n:(s + 1) * n]
    sc = torch.einsum("bhqd,bkd->bhqk", q, kl) / float(np.sqrt(q.shape[-1]))
    mx = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - mx)
    out["sp_o"] = sequence_parallel_softmax_combine(
        mx, p.sum(dim=-1, keepdim=True), torch.einsum("bhqk,bkd->bhqd", p,
                                                      vl),
        mesh.get_group("stage")).numpy()


def rank_main(rank, d):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(d, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    try:
        train(inp, out, rank)
        families(inp, out, rank)
        compressed(inp, out, rank)
        pipeline_and_combine(inp, out, rank)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1],), nprocs=WORLD, join=True)

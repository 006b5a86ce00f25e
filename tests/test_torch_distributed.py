"""The port's distributed layer (``repro_torch.distributed``) held against
the reference's (``repro.distributed``).

* Spec rules, exactly: ``param_pspecs`` (training and serving layouts),
  ``fit_pspecs``, ``batch_pspecs``, ``cache_pspecs`` and ``logits_pspec``
  of all 11 configs at full width, on the (16, 16), (2, 16, 16) and (2, 4)
  meshes given to both sides as a stand-in with ``axis_names`` and
  ``devices.shape``; the reference's tree from ``jax.eval_shape`` of its
  ``init``, the port's on ``meta``. The port holds a layer stack as a list
  of per-layer dicts: each per-layer leaf's spec is compared with the
  reference's stacked spec less its leading layer axis.
* Multi-rank, against the reference's sharded functions: one spawned gloo
  group of 8 CPU ranks (``tests/_dist_ranks.py``) and one JAX subprocess
  on 8 host devices with ``Auto`` mesh axes (``tests/_dist_ref.py``) run
  side by side on the same numpy inputs: the sharded train step
  (tinyllama, and one reduced config of each other family: qwen3-moe,
  rwkv6, zamba2, whisper, qwen2-vl), each family's sharded prefill
  logits, 30 rounds of ``compressed_psum``, ``pipeline_shard_map``,
  ``sequence_parallel_softmax_combine`` and elastic resharding.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("starcoder2-7b", "tinyllama-1.1b", "granite-34b", "smollm-360m",
         "phi3.5-moe-42b-a6.6b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
         "zamba2-2.7b", "whisper-large-v3", "qwen2-vl-7b", "gpt2-large")
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16)),
          "small": (("data", "model"), (2, 4))}


class FakeMesh:
    """Axis names and sizes of a mesh, without its devices (the
    reference's ``tests/test_sharding_roofline.py`` stand-in)."""

    def __init__(self, axes, shape):
        self.axis_names = axes
        self.devices = np.zeros(shape)


def _both(arch):
    from repro.configs import get_config as jcfg
    from repro.models.api import build_model as jbuild
    from repro_torch.configs import get_config as tcfg
    from repro_torch.models.api import build_model as tbuild
    jm, tm = jbuild(jcfg(arch)), tbuild(tcfg(arch))
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    return jm, tm, jp, tm.init(None, "meta")


def _ref_leaves(tree, specs):
    """{path: (shape, spec)} of the reference's trees (dict keys only)."""
    out = {}
    flat_s = jax.tree_util.tree_leaves(specs,
                                       is_leaf=lambda x: isinstance(
                                           x, jax.sharding.PartitionSpec))
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_s) == len(flat_t)
    for (path, leaf), spec in zip(flat_t, flat_s):
        out[tuple(p.key for p in path)] = (tuple(leaf.shape), tuple(spec))
    return out


def _port_leaves(tree, specs):
    """{path: [(shape, spec), ...]} of the port's trees, list indices
    dropped from the path (one entry per layer)."""
    from repro_torch.distributed.sharding import P, tree_map_with_path
    out = {}

    def visit(path, leaf, spec):
        assert isinstance(spec, P)
        key = tuple(p for p in path if isinstance(p, str))
        out.setdefault(key, []).append(
            (tuple(leaf.shape) if hasattr(leaf, "shape") else (),
             tuple(spec)))
    tree_map_with_path(visit, tree, specs)
    return out


def _match(ref, port):
    """Every reference leaf against the port's: a stacked leaf's layer
    axis dropped for each per-layer leaf."""
    assert set(ref) == set(port), set(ref) ^ set(port)
    for key, (shape, spec) in ref.items():
        got = port[key]
        if len(got) == 1 and got[0][0] == shape:
            assert got[0][1] == spec, (key, got[0][1], spec)
            continue
        assert len(got) == shape[0], (key, len(got), shape)
        for s, sp in got:
            assert s == shape[1:], (key, s, shape)
            assert spec[0] is None and sp == spec[1:], (key, sp, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """``param_pspecs`` (training and serving layouts) and ``fit_pspecs``
    on the three meshes, leaf for leaf; the placements of every fitted
    spec shard each named dimension on its mesh dimensions."""
    from repro.distributed import sharding as jsh
    from repro_torch.distributed import sharding as tsh
    _, _, jp, tp = _both(arch)
    for serving in (False, True):
        js = jsh.param_pspecs(jp, serving=serving)
        ts = tsh.param_pspecs(tp, serving=serving)
        _match(_ref_leaves(jp, js), _port_leaves(tp, ts))
        for axes, shape in MESHES.values():
            fm = FakeMesh(axes, shape)
            _match(_ref_leaves(jp, jsh.fit_pspecs(fm, js, jp)),
                   _port_leaves(tp, tsh.fit_pspecs(fm, ts, tp)))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_logits_cache_specs_match_reference(arch):
    """``batch_pspecs`` of the train and prefill inputs, ``cache_pspecs``
    of the decode_32k cache, ``logits_pspec``; on the three meshes."""
    from repro.configs import get_shape
    from repro.distributed import sharding as jsh
    from repro_torch.distributed import sharding as tsh
    jm, tm, _, _ = _both(arch)
    for axes, shape in MESHES.values():
        fm = FakeMesh(axes, shape)
        for name in ("train_4k", "prefill_32k"):
            jb = jm.input_specs(get_shape(name))
            tb = tm.input_specs(get_shape(name))
            _match(_ref_leaves(jb, jsh.batch_pspecs(fm, jb)),
                   _port_leaves(tb, tsh.batch_pspecs(fm, tb)))
        _, jc = jm.input_specs(get_shape("decode_32k"))
        _, tc = tm.input_specs(get_shape("decode_32k"))
        _match(_ref_leaves(jc, jsh.cache_pspecs(fm, jm.cfg, jc)),
               _port_leaves(tc, tsh.cache_pspecs(fm, tm.cfg, tc)))
        for ok in (True, False):
            assert tuple(tsh.logits_pspec(fm, ok)) == \
                tuple(jsh.logits_pspec(fm, ok))


@pytest.mark.parametrize("arch,batch,seq,want_k", [
    # MQA: the sequence shards on model, the one KV head does not
    ("granite-34b", 128, 1024, (None, "data", "model", None, None)),
    # batch-1 long context: the sequence shards on data, heads on model
    ("zamba2-2.7b", 1, 4096, (None, None, "data", "model", None)),
    ("rwkv6-1.6b", 1, 524288, None),
])
def test_cache_specs_mqa_and_long_context(arch, batch, seq, want_k):
    """The reference's two cache cases (``test_sharding_roofline.py``) and
    batch-1 ``long_500k`` on zamba2 and rwkv6 (state on model, batch
    replicated), port against reference on the (16, 16) mesh."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.distributed import sharding as jsh
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.distributed import sharding as tsh
    jm, tm, _, _ = _both(arch)
    fm = FakeMesh(*MESHES["single"])
    _, jc = jm.input_specs(JShape("x", seq, batch, "decode"))
    _, tc = tm.input_specs(TShape("x", seq, batch, "decode"))
    ts = tsh.cache_pspecs(fm, tm.cfg, tc)
    _match(_ref_leaves(jc, jsh.cache_pspecs(fm, jm.cfg, jc)),
           _port_leaves(tc, ts))
    if want_k is not None:
        assert tuple(ts["k"]) == want_k
    else:
        assert tuple(ts["wkv"]) == (None, None, "model", None, None)


def test_constrain_is_identity_outside_a_policy():
    """Outside a policy (and on a plain tensor inside one) ``constrain``,
    ``reshape``'s reshard and ``reduce_partial`` leave tensors alone."""
    from repro_torch.distributed import sharding as tsh
    x = torch.randn(4, 6, 8)
    assert tsh.policy_mesh() is None
    assert tsh.constrain(x, "batch", "seq", "embed") is x
    assert tsh.reduce_partial(x) is x
    assert torch.equal(tsh.reshape(x, 4, 6, 2, 4), x.reshape(4, 6, 2, 4))
    with tsh.activation_policy(FakeMesh(*MESHES["small"])):
        assert tsh.constrain(x, "batch", "seq", "embed") is x
    assert tsh.policy_mesh() is None


def test_placements_of_nested_axes():
    """A dimension sharded over ("pod", "data") takes Shard on both mesh
    dimensions (pod major); axes out of mesh order are refused;
    ``param_shardings`` gives each leaf its fitted spec's placements (the
    serving layout without "data")."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import P, placements

    class DM:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    assert placements(DM, P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(DM, P(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(DM, P(("data", "pod"), None))
    from repro_torch.distributed.sharding import param_shardings
    tree = {"embed": {"tok": torch.empty(64, 32, device="meta")},
            "layers": [{"attn": {"wq": torch.empty(32, 48, device="meta")}}]}
    got = param_shardings(DM, tree)
    assert got["embed"]["tok"] == (Replicate(), Shard(1), Shard(0))
    assert got["layers"][0]["attn"]["wq"] == (Replicate(), Shard(0),
                                              Shard(1))
    serve = param_shardings(DM, tree, serving=True)
    assert serve["layers"][0]["attn"]["wq"] == (Replicate(), Replicate(),
                                                Shard(1))


# ---------------------------------------------------------------------------
# Multi-rank: 8 gloo ranks beside the reference on 8 host devices
# ---------------------------------------------------------------------------


def _inputs(d):
    """The numpy inputs both sides read: the reference's own tinyllama
    parameters (its test's cell, f32), tokens, the compressed all-reduce's
    gradients, the pipeline's stages and the sequence-split decode."""
    from repro.configs import get_config
    from repro.models.api import build_model
    cfg = get_config("tinyllama-1.1b").reduced(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=64, activation_dtype="float32",
        param_dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    out = {"params/" + "/".join(p.key for p in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    rng = np.random.default_rng(0)
    out["tokens"] = rng.integers(0, 64, (8, 16)).astype(np.int32)
    out["g"] = rng.standard_normal((8, 128)).astype(np.float32)
    out["pipe_w"] = (0.3 * rng.standard_normal((4, 16, 16))).astype(
        np.float32)
    out["pipe_x"] = rng.standard_normal((8, 4, 16)).astype(np.float32)
    # granite's reduced decode: 4 query heads on one KV head, D 16,
    # a 64-slot cache split over 4 ranks
    out["sp_q"] = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
    out["sp_k"] = rng.standard_normal((2, 64, 16)).astype(np.float32)
    out["sp_v"] = rng.standard_normal((2, 64, 16)).astype(np.float32)
    # one reduced config per family beyond the dense one: its reference
    # parameters, a train batch and prefill inputs
    out["families"] = np.asarray(FAMILIES)
    for arch in FAMILIES:
        cfg = get_config(arch).reduced(activation_dtype="float32",
                                       param_dtype="float32")
        pre = f"fam/{arch}/"
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[pre + "params/" + "/".join(p.key for p in path)] = \
                np.asarray(leaf)
        for k, v in _family_inputs(cfg, rng).items():
            out[pre + k] = v
    np.savez(d / "inputs.npz", **out)
    return out


#: one reduced config per family the sharded step is held for (besides
#: tinyllama's dense one): MoE, ssm, hybrid, audio, vlm
FAMILIES = ("qwen3-moe-30b-a3b", "rwkv6-1.6b", "zamba2-2.7b",
            "whisper-large-v3", "qwen2-vl-7b")


def _family_inputs(cfg, rng, B=8, S=16):
    """A train batch (``batch/``: tokens, labels; Whisper's stub frames,
    Qwen2-VL's stub patches 4 positions ahead of the text and its
    three-stream positions) and prefill inputs (``prefill/``) for
    ``cfg``."""
    V, d = cfg.vocab_size, cfg.d_model
    tok = rng.integers(1, V, (B, S)).astype(np.int32)
    b = {"batch/tokens": tok,
         "batch/labels": rng.integers(0, V, (B, S)).astype(np.int32),
         "prefill/tokens": rng.integers(1, V, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        for k in ("batch/frames", "prefill/frames"):
            b[k] = rng.standard_normal((B, S, d)).astype(np.float32)
    if cfg.family == "vlm":
        sv = 4
        pos = np.broadcast_to(np.arange(sv + S), (3, B, sv + S)).astype(
            np.int32).copy()
        b["batch/vision_embeds"] = (0.02 * rng.standard_normal(
            (B, sv, d))).astype(np.float32)
        b["batch/positions"] = pos
        b["prefill/prefix_embeds"] = (0.02 * rng.standard_normal(
            (B, sv, d))).astype(np.float32)
        b["prefill/positions"] = pos
    return b


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs(d)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                "_dist_ref.py"), str(d)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    port = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "_dist_ranks.py"), str(d)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    ref_out, _ = ref.communicate(timeout=300)
    assert port.returncode == 0, port.stdout + port.stderr
    assert ref.returncode == 0, ref_out
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(8)]
    return inp, dict(np.load(d / "ref.npz")), ranks


def _tree(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def test_sharded_train_step_matches_single_and_reference(runs):
    """The reference test's cell: tinyllama reduced, f32, one step on a
    (2, 4) mesh with the FSDP x TP rules and the activation constraints.
    The port's sharded step against its single-device step and against
    the reference's sharded step (JAX, ``Auto`` axes): loss rtol 1e-4,
    every parameter atol 2e-4 (the reference test's rule)."""
    _, ref, ranks = runs
    assert "sharded_error" not in ref, str(ref.get("sharded_error"))
    r0 = ranks[0]
    np.testing.assert_allclose(r0["sharded_loss"], r0["single_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(r0["sharded_loss"], ref["sharded_loss"],
                               rtol=1e-4)
    single, sharded = _tree(r0, "single/"), _tree(r0, "sharded/")
    jref = _tree(ref, "sharded/")
    assert len(sharded) == len(single) == 21
    for k, v in sharded.items():
        np.testing.assert_allclose(v, single[k], atol=2e-4, err_msg=k)
        # the port's per-layer leaf k = "layers/<i>/..." against the
        # reference's stacked "layers/..." at layer i
        parts = k.split("/")
        if parts[0] == "layers":
            want = jref["/".join(["layers"] + parts[2:])][int(parts[1])]
        else:
            want = jref[k]
        np.testing.assert_allclose(v, want, atol=2e-4, err_msg=k)
    for r in ranks[1:]:
        assert r["sharded_loss"] == r0["sharded_loss"]


_STACKED = ("layers", "mamba", "encoder", "decoder")


def _ref_leaf(jref, k):
    """The reference's leaf for the port's leaf ``k``: a per-layer leaf
    "<stack>/<i>/..." is layer i of the stacked "<stack>/..."."""
    parts = k.split("/")
    if parts[0] in _STACKED:
        return jref["/".join([parts[0]] + parts[2:])][int(parts[1])]
    return jref[k]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_sharded_train_step_matches_reference(runs, arch):
    """Each family's reduced config (MoE, RWKV6, Zamba2, Whisper,
    Qwen2-VL), f32, one step on the (2, 4) mesh under the activation
    policy: the port's sharded step against its single-device step and
    against the reference's sharded step (JAX, ``Auto`` axes), loss rtol
    1e-4 and every parameter atol 2e-4 (the tinyllama test's rule), the
    same loss on every rank."""
    _, ref, ranks = runs
    pre = f"fam/{arch}/"
    assert pre + "error" not in ref, str(ref.get(pre + "error"))
    r0 = ranks[0]
    np.testing.assert_allclose(r0[pre + "loss"], r0[pre + "single_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(r0[pre + "loss"], ref[pre + "loss"],
                               rtol=1e-4)
    sharded, single = _tree(r0, pre + "p/"), _tree(r0, pre + "single/")
    jref = _tree(ref, pre + "p/")
    assert set(sharded) == set(single)
    covered = {"/".join(k.split("/")[:1] + k.split("/")[2:])
               if k.split("/")[0] in _STACKED else k for k in sharded}
    assert covered == set(jref)
    for k, v in sharded.items():
        np.testing.assert_allclose(v, single[k], atol=2e-4, err_msg=k)
        np.testing.assert_allclose(v, _ref_leaf(jref, k), atol=2e-4,
                                   err_msg=k)
    for r in ranks[1:]:
        assert r[pre + "loss"] == r0[pre + "loss"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_sharded_prefill_matches_reference(runs, arch):
    """Each family's sharded prefill on the (2, 4) mesh: the last-token
    logits equal the reference's sharded prefill's within 1e-5 (f32) on
    every rank; RWKV6's and Zamba2's prefill caches are DTensors in the
    ``cache_pspecs`` layout."""
    _, ref, ranks = runs
    pre = f"fam/{arch}/"
    assert pre + "error" not in ref, str(ref.get(pre + "error"))
    want = ref[pre + "logits"]
    assert want.shape == (8, 1, 256)
    for r in ranks:
        np.testing.assert_allclose(r[pre + "logits"], want, rtol=0,
                                   atol=1e-5)
        if arch in ("rwkv6-1.6b", "zamba2-2.7b"):
            assert bool(r[pre + "cache_layout"])


def test_distributed_params_hold_their_shards(runs):
    """``distribute_params`` on the (2, 4) mesh: each rank's local shard
    of every leaf is the slice the spec names (data = rank // 4 on
    "data", rank % 4 on "model"), so the ("data", "model") placements
    land as JAX lays them out."""
    inp, _, ranks = runs
    from repro_torch.distributed import sharding as tsh
    full = {k[len("params/"):]: v for k, v in inp.items()
            if k.startswith("params/")}
    fm = FakeMesh(*MESHES["small"])
    checked = 0
    for r, out in enumerate(ranks):
        coord = {"data": r // 4, "model": r % 4}
        for k, local in _tree(out, "shard/").items():
            parts = k.split("/")
            whole = full["/".join(["layers"] + parts[2:])][int(parts[1])] \
                if parts[0] == "layers" else full[k]
            spec = tsh.fit_pspecs(
                fm, {"l": tsh._pspec_for(parts[-1], whole.shape, False)},
                {"l": whole})["l"]
            want = whole
            for dim, ax in enumerate(spec):
                if ax is None:
                    continue
                n = whole.shape[dim] // tsh.mesh_axis_size(fm, ax)
                want = np.take(want, range(coord[ax] * n,
                                           (coord[ax] + 1) * n), axis=dim)
            np.testing.assert_array_equal(local, want, err_msg=k)
            checked += 1
    assert checked == 8 * 21


def test_compressed_psum_matches_reference(runs):
    """30 rounds with error feedback on the reference test's inputs (8 x
    128): each round's output and residual equal the reference's within
    1e-6, and the reference test's gates hold: the accumulated error
    below 0.02, one round's below 0.2."""
    inp, ref, ranks = runs
    out = np.concatenate([r["psum_out"] for r in ranks], axis=1)
    res = np.concatenate([r["psum_res"] for r in ranks], axis=1)
    np.testing.assert_allclose(out, ref["psum_out"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(res, ref["psum_res"], atol=1e-6, rtol=0)
    want = inp["g"].mean(axis=0)
    acc = out[:, 0].sum(axis=0)
    rel = np.linalg.norm(acc - 30 * want) / np.linalg.norm(30 * want)
    assert rel < 0.02, rel
    one = ranks[0]["psum_single"][0]
    assert np.linalg.norm(one - want) / np.linalg.norm(want) < 0.2


def test_pipeline_matches_reference_and_sequential(runs):
    """``pipeline_shard_map``: S = 4 stages, M = 8 microbatches of b = 4,
    16-wide tanh stages, equal to the reference's output and to the
    stages applied in sequence within 1e-5, on both replicas."""
    inp, ref, ranks = runs
    seq = inp["pipe_x"]
    for s in range(4):
        seq = np.tanh(seq @ inp["pipe_w"][s])
    for r in ranks:
        np.testing.assert_allclose(r["pipe_y"], ref["pipe_y"], atol=1e-5)
        np.testing.assert_allclose(r["pipe_y"], seq, atol=1e-5)
    from repro.distributed.pipeline import pipeline_bubble_fraction as jb
    from repro_torch.distributed.pipeline import pipeline_bubble_fraction
    assert all(pipeline_bubble_fraction(s, m) == jb(s, m)
               for s in (1, 2, 4, 8) for m in (1, 4, 8, 32))


def test_sequence_parallel_combine_matches_reference(runs):
    """A granite-shaped MQA decode (4 query heads on one KV head) with its
    64-slot cache split over 4 ranks: the merged partials equal the
    reference's within 1e-6 and the unsplit attention (the port's
    ``attention_direct`` over the whole cache) within 1e-6."""
    inp, ref, ranks = runs
    from repro_torch.models.attention import attention_direct
    q = torch.as_tensor(inp["sp_q"]).permute(0, 2, 1, 3)      # B,1,H,D
    k = torch.as_tensor(inp["sp_k"])[:, :, None]              # B,S,1,D
    v = torch.as_tensor(inp["sp_v"])[:, :, None]
    whole = attention_direct(q, k, v, causal=False).permute(0, 2, 1, 3)
    for r in ranks:
        np.testing.assert_allclose(r["sp_o"], ref["sp_o"], atol=1e-6)
        np.testing.assert_allclose(r["sp_o"], whole.numpy(), atol=1e-6)


def test_elastic_layout_matches_reference(runs):
    """``surviving_layout`` against the reference's ``surviving_mesh``
    device ids (device ids are ranks) for several lost sets, a 3-axis
    mesh and the error below one model group; ``reshard_params`` onto the
    4 survivors of the (2, 4) mesh gives every parameter back bit-equal,
    and the loss on the resharded parameters is finite."""
    _, ref, ranks = runs
    from repro_torch.distributed.elastic import surviving_layout
    import _dist_ref
    for i, lost in enumerate(_dist_ref.LOST):
        if f"elastic_{i}_error" in ref:
            with pytest.raises(RuntimeError) as e:
                surviving_layout((2, 4), lost)
            assert str(e.value) == str(ref[f"elastic_{i}_error"])
        else:
            np.testing.assert_array_equal(surviving_layout((2, 4), lost),
                                          ref[f"elastic_{i}"])
    np.testing.assert_array_equal(surviving_layout((2, 2, 2), [3]),
                                  ref["elastic_3d"])
    for r, out in enumerate(ranks):
        if r < 4:
            assert "elastic_mesh" not in out
            continue
        np.testing.assert_array_equal(out["elastic_mesh"], ref["elastic_0"])
        assert bool(out["elastic_equal"])
        assert np.isfinite(out["elastic_loss"])

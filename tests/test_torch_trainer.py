"""The port's trainer (``repro_torch.trainer``, every family's ``loss_fn``,
``Model.input_specs``, the kernels' autograd refusal) held against the
reference.

The same parameters (the reference's ``init``, carried by
``params_from_jax``) and the same numpy-seeded batches go through
``repro.trainer.train_loop.make_train_step`` (jitted, on the CPU) and the
port's ``make_train_step`` (eager, on the CPU), for each family's
``.reduced()`` config in f32 activations, at ``microbatches`` 1 and 2:

* three steps run freely on both sides: loss, lr and grad_norm agree
  within 1e-5 relative at the first step and 1e-4 at the later ones
  (below: elements at the rounding floor have moved the parameters apart
  by then); after the first step every moment and parameter leaf is
  checked as below, after the third every parameter leaf;
* each of those three steps again from the reference's own state (its
  parameters and moments carried into the port before the step): every
  moment and parameter leaf is checked after each step. This holds the
  bias correction and the schedule at steps 2 and 3 to one step's
  tolerance (metrics within 1e-5), which a free run cannot: there an
  element moved differently (below) changes the next gradients by up to
  ~1%.

Moments agree within ``MOM_TOL`` x the leaf's largest reference value
(f32 sums in other orders; RWKV6's per-head group norm of the WKV output
amplifies their rounding to ~1e-5 of the leaf's scale). Parameters agree
within ``PARAM_TOL`` (2% of one step at ``LR``) except where Adam's
normalised step m̂/(√v̂ + eps) is set by rounding: elements whose
reference √v̂ fell below ``FLOOR`` x the leaf's RMS √v̂ at a step taken,
where a gradient at the rounding floor of its summands makes the step
anything in [-lr, lr]. Those stay within two full steps per step taken.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS, get_config as jget
from repro.configs.base import ShapeConfig, TrainConfig as JTrain
from repro.models.api import build_model as jbuild
from repro.trainer import optimizer as jopt
from repro.trainer.schedule import warmup_cosine as jcosine
from repro.trainer.train_loop import make_train_step as jmake_step
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.kernels import ops
from repro_torch.models.api import build_model as tbuild
from repro_torch.models.transformer import params_from_jax, params_to_numpy
from repro_torch.trainer import optimizer as topt
from repro_torch.trainer.schedule import warmup_cosine as tcosine
from repro_torch.trainer.train_loop import make_train_step as tmake_step

torch.set_num_threads(1)

LR = 1e-3
PARAM_TOL = 2e-5
FLOOR = 1e-2
MOM_TOL = 1e-4
#: one config per family: dense (learned positions, RoPE), MoE, vlm,
#: audio, ssm, hybrid
FAMILIES = ("gpt2-large", "smollm-360m", "qwen3-moe-30b-a3b", "qwen2-vl-7b",
            "whisper-large-v3", "rwkv6-1.6b", "zamba2-2.7b")


def _flat(tree, prefix=""):
    """{path: f32 numpy array} of a tree of dicts in the reference's
    layout."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _batch(cfg, B, S, rng):
    """A numpy batch for ``cfg``'s loss: tokens, labels, a mask with ~20%
    zeros; Whisper's stub frames, Qwen2-VL's stub patches (4 positions
    ahead of the text) and its three-stream positions."""
    b = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, 16, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        sv = 4
        b["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, sv, cfg.d_model))).astype(np.float32)
        b["positions"] = np.broadcast_to(np.arange(sv + S), (3, B, sv + S)
                                         ).astype(np.int32).copy()
    return b


def _configs(arch, **over):
    jc = dataclasses.replace(jget(arch).reduced(),
                             activation_dtype="float32", **over)
    tc = dataclasses.replace(tget(arch).reduced(),
                             activation_dtype="float32", **over)
    return jc, tc


class StepComparison:
    """Runs both packages' steps side by side and checks each step's
    metrics, moments and parameters (module docstring), keeping the
    elements at the rounding floor of Adam's normalised step."""

    def __init__(self, jc, tc, tcfg: dict):
        self.jm, self.tm = jbuild(jc), tbuild(tc)
        jp = self.jm.init(jax.random.PRNGKey(0))
        self.start = (jp, jopt.init(jp))
        self.jstep = jax.jit(jmake_step(self.jm, JTrain(**tcfg)))
        self.tstep = tmake_step(self.tm, TTrain(**tcfg))
        self.restart()

    def restart(self):
        """Both sides back at the reference's initial state."""
        self.j = self.start
        self.t = self._carried(self.j)
        self.floor = {}
        self.steps = 0

    @staticmethod
    def _carried(jstate):
        """The reference's (params, opt_state) as the port's."""
        jp, jo = jax.tree.map(np.asarray, jstate)
        return (params_from_jax(jp, device="cpu"),
                {"mu": params_from_jax(jo["mu"], device="cpu"),
                 "nu": params_from_jax(jo["nu"], device="cpu"),
                 "step": torch.tensor(int(jo["step"]), dtype=torch.int32)})

    def step(self, batch, forced: bool = False, rtol: float = 1e-5):
        """One step on both sides; ``forced`` starts the port's from the
        reference's state before the step (and forgets the floor); the
        metrics within ``rtol``."""
        if forced:
            self.t, self.floor, self.steps = self._carried(self.j), {}, 0
        jp, jo, jm = self.jstep(*self.j, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        tp, to, tm = self.tstep(*self.t, {k: torch.as_tensor(v)
                                          for k, v in batch.items()})
        self.j, self.t = (jp, jo), (tp, to)
        self.steps += 1
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rtol, err_msg=k)
        ref = _flat(jax.tree.map(np.asarray, {"p": jp, "mu": jo["mu"],
                                              "nu": jo["nu"]}))
        got = _flat({"p": params_to_numpy(tp),
                     "mu": params_to_numpy(to["mu"]),
                     "nu": params_to_numpy(to["nu"])})
        assert ref.keys() == got.keys()
        assert int(to["step"]) == int(jo["step"])
        for k, want in ref.items():
            if k.startswith("/nu/"):
                rms = np.sqrt(np.mean(want)) if want.size else 0.0
                low = (want > 0) & (np.sqrt(want) < FLOOR * rms)
                leaf = k[len("/nu/"):]
                self.floor[leaf] = self.floor.get(leaf, False) | low
        return ref, got

    def check_moments(self, ref, got):
        for k, want in ref.items():
            if k.startswith(("/mu/", "/nu/")):
                tol = MOM_TOL * max(float(np.abs(want).max(initial=0.0)),
                                    1e-30)
                np.testing.assert_allclose(got[k], want, rtol=0, atol=tol,
                                           err_msg=k)

    def check_params(self, ref, got):
        for k, want in ref.items():
            if not k.startswith("/p/"):
                continue
            diff = np.abs(got[k] - want)
            low = self.floor[k[len("/p/"):]]
            assert float(diff[~low].max(initial=0.0)) <= PARAM_TOL, k
            assert float(diff.max(initial=0.0)) <= 2 * LR * self.steps, k


@pytest.mark.parametrize("micro", (1, 2))
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch, micro):
    jc, tc = _configs(arch)
    tcfg = dict(learning_rate=LR, warmup_steps=1, total_steps=10,
                microbatches=micro)
    rng = np.random.default_rng(0)
    batches = [_batch(jc, 4, 16, rng) for _ in range(3)]
    cmp = StepComparison(jc, tc, tcfg)
    for i, b in enumerate(batches):
        ref, got = cmp.step(b, rtol=1e-5 if i == 0 else 1e-4)
        if i == 0:
            cmp.check_moments(ref, got)
    cmp.check_params(ref, got)
    cmp.restart()
    for b in batches:
        ref, got = cmp.step(b, forced=True)
        cmp.check_moments(ref, got)
        cmp.check_params(ref, got)


def test_remat_chunked_ce_and_chunked_attention_match_reference():
    """``remat`` (per layer), ``ce_impl="chunked"`` (per-chunk
    checkpointed CE) and ``attention_chunked`` with ``attn_chunk_remat``
    (S = 32 > threshold 16, chunk 16) give the reference's loss and step
    (one step, the tolerances above)."""
    over = dict(remat=True, ce_impl="chunked", ce_chunk=8,
                attn_chunk_threshold=16, attn_chunk_size=16,
                attn_chunk_remat=True)
    jc, tc = _configs("smollm-360m", **over)
    cmp = StepComparison(jc, tc, dict(learning_rate=LR, warmup_steps=1,
                                      total_steps=10, microbatches=2))
    ref, got = cmp.step(_batch(jc, 4, 32, np.random.default_rng(1)))
    cmp.check_moments(ref, got)
    cmp.check_params(ref, got)


def test_remat_changes_nothing_in_the_port():
    """Rematerialisation recomputes the forward in backward: the loss and
    every gradient are bit-equal with and without it, for each family
    whose module honours ``cfg.remat``."""
    from repro_torch.trainer.train_loop import value_and_grad
    for arch in ("smollm-360m", "whisper-large-v3", "rwkv6-1.6b",
                 "zamba2-2.7b"):
        _, tc = _configs(arch)
        params = tbuild(tc).init(torch.Generator().manual_seed(0), "cpu")
        b = {k: torch.as_tensor(v) for k, v in
             _batch(tc, 2, 16, np.random.default_rng(2)).items()}
        out = [value_and_grad(tbuild(dataclasses.replace(tc, remat=r))
                              .loss_fn, params, b) for r in (False, True)]
        assert torch.equal(out[0][0], out[1][0]), arch
        for a, c in zip(topt.tree_leaves(out[0][1]),
                        topt.tree_leaves(out[1][1])):
            assert torch.equal(a, c), arch


# ---------------------------------------------------------------------------
# Schedule and optimizer
# ---------------------------------------------------------------------------


def test_warmup_cosine_matches_reference_at_every_step():
    """Every step of a small schedule and past its end, within 2 ulp of
    the cosine term's f32 value near 1, scaled by lr (the two packages'
    cos may round differently, and 1 + cos cancels near the end)."""
    cfg = dict(learning_rate=3e-4, warmup_steps=5, total_steps=23)
    jlr, tlr = jcosine(JTrain(**cfg)), tcosine(TTrain(**cfg))
    for step in range(0, 27):
        want = float(jlr(jnp.int32(step)))
        got = tlr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=0,
                                          abs=cfg["learning_rate"] * 2 ** -22)


def _update_both(params_np, grads_np, tcfg, lr, stacked=()):
    """One reference update on numpy trees and one port update on the same
    trees (``stacked`` subtrees converted by ``params_from_jax``)."""
    jp = jax.tree.map(jnp.asarray, params_np)
    jg = jax.tree.map(jnp.asarray, grads_np)
    jnew, jst, jm = jax.jit(jopt.update, static_argnums=3)(
        jp, jg, jopt.init(jp), tcfg[0], jnp.float32(lr))
    tp = params_from_jax(params_np, device="cpu")
    tg = params_from_jax(grads_np, device="cpu")
    before = [t.clone() for t in topt.tree_leaves(tp)]
    tnew, tst, tm = topt.update(tp, tg, topt.init(tp), tcfg[1],
                                torch.tensor(lr, dtype=torch.float32))
    # functional: the inputs are untouched
    assert all(torch.equal(a, b)
               for a, b in zip(before, topt.tree_leaves(tp)))
    return (jnew, jst, jm), (tnew, tst, tm)


def test_update_matches_reference_on_flat_trees():
    rng = np.random.default_rng(3)
    params = {"m": rng.standard_normal((6, 5)).astype(np.float32),
              "v": rng.standard_normal((5,)).astype(np.float32),
              "t": rng.standard_normal((2, 3, 4)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    cfg = dict(weight_decay=0.1, grad_clip=1.0)
    (jnew, jst, jm), (tnew, tst, tm) = _update_both(
        params, grads, (JTrain(**cfg), TTrain(**cfg)), 1e-2)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    for k in params:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(tst["mu"][k].numpy(),
                                   np.asarray(jst["mu"][k]), rtol=1e-6)
        np.testing.assert_allclose(tst["nu"][k].numpy(),
                                   np.asarray(jst["nu"][k]), rtol=1e-6)
        assert tst["mu"][k].dtype == torch.float32
    assert tst["step"].dtype == torch.int32 and int(tst["step"]) == 1


@pytest.mark.parametrize("arch", ("smollm-360m", "gpt2-large",
                                  "zamba2-2.7b", "whisper-large-v3"))
def test_update_decays_as_the_reference_on_model_trees(arch):
    """Zero gradients: the update is the decoupled decay alone, so a leaf
    moves iff the reference decays it. The reference decays every leaf of
    rank >= 2 in its layout, so each per-layer norm scale and bias ((L, d)
    there, (d,) per layer here) is decayed; Zamba2's single ``shared``
    block is not stacked, so its norms are not, in either package; nor is
    ``final_norm``. Every leaf equals the reference's within 1e-7."""
    jc, _ = _configs(arch)
    jp = jax.tree.map(np.asarray, jbuild(jc).init(jax.random.PRNGKey(0)))
    zeros = jax.tree.map(np.zeros_like, jp)
    cfg = dict(weight_decay=0.1)
    (jnew, _, _), (tnew, _, _) = _update_both(
        jp, zeros, (JTrain(**cfg), TTrain(**cfg)), 1e-2)
    ref = _flat(jax.tree.map(np.asarray, jnew))
    got = _flat(params_to_numpy(tnew))
    old = _flat(jp)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-7,
                                   err_msg=k)
    norm_scales = [k for k in ref if re.search(r"norm\w*/weight$", k)]
    assert norm_scales
    for k in norm_scales:
        decayed = not np.array_equal(got[k], old[k])
        stacked = k.split("/")[1] in ("layers", "mamba", "encoder",
                                      "decoder")
        assert decayed == stacked, k
    if arch == "zamba2-2.7b":
        assert np.array_equal(got["/shared/norm1/weight"],
                              old["/shared/norm1/weight"])
        assert not np.array_equal(got["/mamba/norm/weight"],
                                  old["/mamba/norm/weight"])


def test_global_norm_and_clipping():
    g = {"w": torch.full((4,), 100.0), "l": [{"b": torch.full((2, 2), 1.0)}]}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(float(np.sqrt(4e4 + 4)))
    assert float(topt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)
    small = {"w": torch.full((4,), 0.1)}
    same, _ = topt.clip_by_global_norm(small, 1.0)
    assert torch.equal(same["w"], small["w"])
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((7, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 0.5)
    tc, tn = topt.clip_by_global_norm(
        {k: torch.as_tensor(v) for k, v in tree.items()}, 0.5)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for k in tree:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)


def test_moments_are_f32_and_param_shaped():
    params = {"w": torch.ones((3, 3), dtype=torch.bfloat16),
              "layers": [{"n": torch.ones(3)}]}
    st = topt.init(params)
    assert st["mu"]["w"].dtype == torch.float32
    assert st["mu"]["w"].shape == (3, 3)
    assert st["nu"]["layers"][0]["n"].shape == (3,)
    assert topt.reference_rank(params) == {"w": 2, "layers": [{"n": 2}]}


# ---------------------------------------------------------------------------
# Dry-run input specs
# ---------------------------------------------------------------------------


def _spec_tree(tree):
    """{path: (shape, dtype name)} of specs (JAX ShapeDtypeStructs or
    meta tensors)."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v
                for k, sub in tree.items()
                for p, v in _spec_tree(sub).items()}
    if isinstance(tree, tuple):
        return {f"{i}/{p}" if p else str(i): v
                for i, sub in enumerate(tree)
                for p, v in _spec_tree(sub).items()}
    assert not isinstance(tree, torch.Tensor) or tree.device.type == "meta"
    return {"": (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_match_reference_at_full_width(arch):
    """train, prefill and decode specs of every config at full width: the
    same shapes and dtypes as the reference's ShapeDtypeStructs, on
    ``meta`` (nothing allocated)."""
    jm, tm = jbuild(jget(arch)), tbuild(tget(arch))
    for shape in (ShapeConfig("t", 2048, 8, "train"),
                  ShapeConfig("p", 4096, 2, "prefill"),
                  ShapeConfig("d", 4096, 4, "decode")):
        assert _spec_tree(tm.input_specs(shape)) == \
            _spec_tree(jm.input_specs(shape)), (arch, shape.kind)


# ---------------------------------------------------------------------------
# The kernels' autograd refusal
# ---------------------------------------------------------------------------


def test_refuse_grad_raises_only_while_recording_a_grad():
    x = torch.ones(2, requires_grad=True)
    y = torch.ones(2)
    with pytest.raises(RuntimeError, match="no gradient.*attn_impl='xla'"):
        ops.refuse_grad("flash_attention", y, x)
    ops.refuse_grad("flash_attention", y, y)
    with torch.no_grad():
        ops.refuse_grad("flash_attention", x)
    with torch.inference_mode():
        ops.refuse_grad("flash_attention", x)


def test_cpu_dispatch_stays_differentiable():
    """On CPU tensors the dispatchers run the plain versions, which carry
    a gradient, as the reference's off-TPU fallback does."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 2, 16), generator=gen, requires_grad=True)
    k = torch.randn((1, 8, 1, 16), generator=gen)
    o = ops.flash_attention(q, k, k, causal=True)
    assert o.grad_fn is not None
    o.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.h100
def test_cuda_dispatchers_refuse_grad_on_h100():
    """On the card each float dispatcher (K3-K6) raises on an input that
    requires grad, instead of returning an output with no gradient."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernels have no "
                    "CPU mode")
    dev = "cuda"
    q = torch.randn((1, 8, 2, 64), device=dev, requires_grad=True)
    kv = torch.randn((1, 8, 1, 64), device=dev)
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, kv, kv),
        "decode_attention": lambda: ops.decode_attention(
            q[:, 0], kv, kv, torch.ones(1, dtype=torch.int32, device=dev)),
        "wkv6_chunked": lambda: ops.wkv6(
            *(torch.randn((1, 8, 1, 64), device=dev, requires_grad=True)
              for _ in range(4)), torch.randn((1, 64), device=dev),
            torch.zeros((1, 1, 64, 64), device=dev)),
        "ssd_chunked": lambda: ops.ssd(
            torch.randn((1, 8, 1, 64), device=dev, requires_grad=True),
            torch.rand((1, 8, 1), device=dev),
            -torch.rand((1, 8, 1), device=dev),
            torch.randn((1, 8, 64), device=dev),
            torch.randn((1, 8, 64), device=dev),
            torch.zeros((1, 1, 64, 64), device=dev)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no gradient"):
            call()

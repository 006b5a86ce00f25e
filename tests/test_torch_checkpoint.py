"""The port's checkpoints (``repro_torch.trainer.checkpoint``) and its
training launcher (``repro_torch.launch.train``).

The reference's own cases (``tests/test_checkpoint.py``) on the port:
round trip, async write, keep-N, latest and explicit steps, no ``.tmp``
left, a missing checkpoint raises, and a restart resumes identically
(4 steps straight against 2, a checkpoint, a restore and 2 more, within
the reference's 1e-5). Then the format the two packages share: a
checkpoint written by the reference restores in the port and the port's
in the reference, with identical arrays. bf16 leaves are stored as raw
2-byte ``|V2`` values by both; the reference's own ``restore`` cannot
cast ``|V2`` back to bf16 (numpy has no such cast, so it fails on its own
files too), so for them the port's file is held byte for byte against the
reference's, and the port restores the reference's bit for bit.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.api import build_model as jbuild
from repro.trainer import optimizer as jopt
from repro.trainer.checkpoint import CheckpointManager as JCheckpoints
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.models.api import build_model as tbuild
from repro_torch.models.transformer import params_to_numpy
from repro_torch.trainer import optimizer as opt
from repro_torch.trainer.checkpoint import CheckpointManager
from repro_torch.trainer.optimizer import tree_leaves
from repro_torch.trainer.train_loop import ResilientTrainer, make_train_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def state():
    gen = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn((8, 8), generator=gen),
                   "layers": [{"b": torch.arange(5.0)},
                              {"b": torch.arange(5.0) + 10}]},
        "opt_state": {"mu": {"w": torch.ones((8, 8)),
                             "layers": [{"b": torch.zeros(5)},
                                        {"b": torch.ones(5)}]},
                      "step": torch.tensor(7, dtype=torch.int32)},
    }


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_roundtrip(tmp_path, state):
    ck = CheckpointManager(str(tmp_path))
    ck.save(10, state)
    assert _equal(ck.restore(state), state)


def test_layers_are_stacked_on_disk(tmp_path, state):
    """The file holds the reference's layout: a list of per-layer dicts
    is one array with a leading layer axis."""
    CheckpointManager(str(tmp_path)).save(3, state)
    with np.load(tmp_path / "ckpt_00000003.npz") as z:
        assert sorted(z.files) == ["opt_state/mu/layers/b", "opt_state/mu/w",
                                   "opt_state/step", "params/layers/b",
                                   "params/w"]
        np.testing.assert_array_equal(
            z["params/layers/b"], np.stack([np.arange(5.0),
                                            np.arange(5.0) + 10]))
        assert z["opt_state/step"].dtype == np.int32


def test_async_write_then_restore(tmp_path, state):
    ck = CheckpointManager(str(tmp_path))
    ck.save(5, state, async_write=True)
    got = ck.restore(state)   # restore waits for in-flight write
    assert int(got["opt_state"]["step"]) == 7


def test_keep_n_gc(tmp_path, state):
    ck = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert ck.steps() == [3, 4]


def test_latest_and_explicit_step(tmp_path, state):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, state)
    state2 = opt.tree_map(lambda x: x + 1 if x.dtype != torch.int32 else x,
                          state)
    ck.save(2, state2)
    assert ck.latest_step() == 2
    old = ck.restore(state, step=1)
    new = ck.restore(state)
    assert _equal(old, state) and _equal(new, state2)


def test_no_tmp_left_behind(tmp_path, state):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, state)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_missing_checkpoint_raises(tmp_path, state):
    ck = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore(state)


def test_train_restart_resumes_identically(tmp_path):
    """Train 4 steps straight == train 2, checkpoint, restore, train 2
    (the reference test's config, data and bound)."""
    cfg = tget("smollm-360m").reduced(vocab_size=64, remat=False)
    model = tbuild(cfg)
    tcfg = TrainConfig(warmup_steps=1, total_steps=8)
    step = make_train_step(model, tcfg)
    data = SyntheticLMStream(DataConfig(cfg.vocab_size, 32, 4))

    def run(params, ostate, start, n):
        for b in data.batches(start, n):
            params, ostate, _ = step(params, ostate,
                                     {k: torch.as_tensor(v)
                                      for k, v in b.items()})
        return params, ostate

    p0 = model.init(torch.Generator().manual_seed(0), "cpu")
    o0 = opt.init(p0)
    pA, oA = run(p0, o0, 0, 4)

    pB, oB = run(p0, o0, 0, 2)
    ck = CheckpointManager(str(tmp_path))
    ck.save(2, {"params": pB, "opt_state": oB})
    got = ck.restore({"params": p0, "opt_state": o0})
    assert _equal(got, {"params": pB, "opt_state": oB})
    pB2, oB2 = run(got["params"], got["opt_state"], 2, 2)

    for a, b in zip(tree_leaves(pA), tree_leaves(pB2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-5)
    assert int(oB2["step"]) == int(oA["step"]) == 4


def test_resilient_trainer_checkpoints_and_recovers(tmp_path):
    """The outer loop checkpoints every ``checkpoint_every`` steps (async)
    and, on a failure, resumes from what ``on_failure`` restores, skipping
    the failed batch, as the reference's: a fault at the third batch is
    recovered from the step-2 checkpoint, and the loop ends at step 4 with
    checkpoints 2 and 4."""
    calls = []

    def step_fn(params, opt_state, batch):
        calls.append(batch)
        if batch == 3:
            raise RuntimeError("injected device loss")
        return ({"w": params["w"] + batch}, opt_state, {"loss": 0.0})

    ck = CheckpointManager(str(tmp_path), keep=5)
    trainer = ResilientTrainer(None, TrainConfig(checkpoint_every=2),
                               step_fn, ck)
    restored = []

    def on_failure(e, step_i):
        restored.append((str(e), step_i))
        st = ck.restore({"params": {"w": torch.zeros(2)},
                         "opt_state": {"step": torch.tensor(0)}})
        return st["params"], st["opt_state"]

    params, _, step_i = trainer.run({"w": torch.zeros(2)},
                                    {"step": torch.tensor(0)},
                                    [1, 2, 3, 4, 5], on_failure=on_failure)
    ck.wait()
    assert calls == [1, 2, 3, 4, 5] and step_i == 4
    assert restored == [("injected device loss", 2)]
    assert ck.steps() == [2, 4] and len(trainer.step_times) == 4
    assert torch.equal(params["w"], torch.full((2,), 1.0 + 2 + 4 + 5))
    with pytest.raises(RuntimeError, match="injected"):
        trainer.run({"w": torch.zeros(2)}, {}, [3])


# ---------------------------------------------------------------------------
# The format shared with the reference
# ---------------------------------------------------------------------------


def _bits(a: np.ndarray) -> np.ndarray:
    """An array's raw bytes as an unsigned view (bf16: 2 bytes)."""
    return np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")


def _reference_state(arch, param_dtype):
    cfg = jget(arch).reduced(param_dtype=param_dtype)
    jp = jbuild(cfg).init(jax.random.PRNGKey(0))
    jo = jopt.init(jp)
    jo["mu"] = jax.tree.map(lambda x: x + 0.5, jo["mu"])
    jo["step"] = jnp.int32(3)
    return {"params": jp, "opt_state": jo}


def _port_template(arch, param_dtype):
    cfg = tget(arch).reduced(param_dtype=param_dtype)
    params = tbuild(cfg).init(torch.Generator().manual_seed(1), "cpu")
    return {"params": params, "opt_state": opt.init(params)}


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("arch", ("smollm-360m", "zamba2-2.7b",
                                  "whisper-large-v3"))
@pytest.mark.parametrize("param_dtype", ("float32", "bfloat16"))
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch,
                                                   param_dtype):
    """The reference writes; the port restores every leaf bit for bit
    (bf16 from its ``|V2`` bytes), in its own layout; written back by the
    port, the file holds the reference's keys, dtypes and bytes."""
    ref_state = _reference_state(arch, param_dtype)
    JCheckpoints(str(tmp_path / "ref")).save(3, ref_state)
    got = CheckpointManager(str(tmp_path / "ref")).restore(
        _port_template(arch, param_dtype))
    assert isinstance(got["params"][
        "mamba" if arch == "zamba2-2.7b" else
        "decoder" if arch == "whisper-large-v3" else "layers"], list)
    CheckpointManager(str(tmp_path / "port")).save(3, got)
    ref = _load(tmp_path / "ref" / "ckpt_00000003.npz")
    mine = _load(tmp_path / "port" / "ckpt_00000003.npz")
    assert ref.keys() == mine.keys()
    for k in ref:
        assert ref[k].dtype == mine[k].dtype and \
            ref[k].shape == mine[k].shape, k
        assert np.array_equal(_bits(ref[k]), _bits(mine[k])), k
    if param_dtype == "bfloat16":
        assert ref["params/embed/tok"].dtype.str == "|V2"


@pytest.mark.parametrize("arch", ("smollm-360m", "rwkv6-1.6b"))
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    """The port writes (f32 parameters and moments, int32 step); the
    reference's ``restore`` gives back every array of the port's state, in
    its stacked layout."""
    state = _port_template(arch, "float32")
    state["opt_state"]["step"] = torch.tensor(5, dtype=torch.int32)
    CheckpointManager(str(tmp_path)).save(5, state)
    ref = JCheckpoints(str(tmp_path)).restore(_reference_state(arch,
                                                               "float32"))
    want = params_to_numpy(state)
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_ref.keys() == flat_want.keys()
    for k, v in flat_want.items():
        r = np.asarray(flat_ref[k])
        assert r.dtype == v.dtype and np.array_equal(r, v), k
    assert int(ref["opt_state"]["step"]) == 5


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


_STEP = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) lr (\d\.\d\de[-+]\d\d) "
                   r"gnorm (\d+\.\d{3}) \(\d+\.\d\ds/step\)$")


def _launch(module, tmp, *extra):
    tmp.mkdir(exist_ok=True)
    args = [sys.executable, "-m", module, "--arch", "smollm-360m",
            "--reduced", "--seq", "16", "--batch", "4", "--log-every", "2",
            "--ckpt-dir", str(tmp), *extra]
    if module.startswith("repro_torch"):
        args += ["--device", "cpu"]
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    res = subprocess.run(args, capture_output=True, text=True, timeout=240,
                         env=env, cwd=str(tmp))
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.splitlines()


def test_launcher_prints_the_reference_lines(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --reduced`` prints
    the reference launcher's lines (the same steps logged, the same
    formats, the same lr schedule; losses within 0.2 of each other, near
    ln(256): the random weights differ), writes its checkpoint, resumes
    from it, and raises the reference's device-count error for
    ``--mesh`` (one process is one device: the production meshes need 256
    and 512)."""
    ref = _launch("repro.launch.train", tmp_path / "ref", "--steps", "4")
    got = _launch("repro_torch.launch.train", tmp_path / "port",
                  "--steps", "4")
    assert len(got) == len(ref) == 3
    for a, b in zip(got[:-1], ref[:-1]):
        ma, mb = _STEP.match(a), _STEP.match(b)
        assert ma and mb, (a, b)
        assert ma.group(1) == mb.group(1) and ma.group(3) == mb.group(3)
        assert abs(float(ma.group(2)) - float(mb.group(2))) < 0.2
    assert re.fullmatch(r"done: 4 steps, final loss \d+\.\d{4}", got[-1])
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ["ckpt_00000004.npz"]
    resumed = _launch("repro_torch.launch.train", tmp_path / "port",
                      "--steps", "6", "--resume")
    assert resumed[0] == "resumed from step 4"
    assert _STEP.match(resumed[1]).group(1) == "6"
    from repro_torch.launch.train import main
    for mesh, want in (("single", r"mesh \(16, 16\) needs 256 devices, "
                                  r"have 1"),
                       ("multi", r"mesh \(2, 16, 16\) needs 512 devices, "
                                 r"have 1")):
        with pytest.raises(RuntimeError, match=want):
            main(["--mesh", mesh, "--device", "cpu"])

"""The port's launch tooling (``repro_torch.launch.{dryrun, roofline,
perf, mesh}``) held against the reference's.

* The reference tests' two reduced dry-run cells (tinyllama ``train_tiny``
  and granite's MQA ``decode_tiny``), and the train, prefill and decode
  cells of one reduced config per other family (qwen3-moe, rwkv6, zamba2,
  whisper, qwen2-vl), through the port's ``run_cell`` on a (2, 4) mesh,
  as ranks of an 8-rank process group that exchanges nothing: each runs,
  counts FLOPs, and a train cell issues collectives. (The dry-run on a 1 x 1 mesh against one plain step,
  argument bytes and FLOPs exactly, is phase 21's ``dryrun_vs_card``,
  rehearsed on the CPU in ``tests/test_torch_chip_rehearsal.py``.)
* The roofline's pure functions exactly against the reference's:
  ``model_flops``, ``attention_flops`` and ``model_flops_ext`` for all 11
  configs x 4 shapes, ``derive_from_parts`` (the same formulas; the H100
  constants in place of the v5e ones), ``collective_wire_bytes`` on HLO
  text.
* ``perf.CELLS`` equals the reference's (read from its source: importing
  ``repro.launch.perf`` would set ``XLA_FLAGS`` for this process), the
  dry-run CLI writes the reference's JSONL keys, and the production mesh
  raises the reference's device-count error.
"""
import ast
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SMALL = ((2, 4), ("data", "model"))


#: one reduced config of each family besides the dense one (MoE, ssm,
#: hybrid, audio, vlm): every kind of step on the small mesh
FAMILIES = ("qwen3-moe-30b-a3b", "rwkv6-1.6b", "zamba2-2.7b",
            "whisper-large-v3", "qwen2-vl-7b")
CASES = [(None, "train"), (None, "decode")] + \
    [(arch, kind) for arch in FAMILIES for kind in ("train", "prefill",
                                                    "decode")]


def _reduced_cell(arch, kind):
    """(arch, shape, overrides): the reference test's two cells (tinyllama
    ``train_tiny``, granite's MQA ``decode_tiny``) when ``arch`` is None,
    else ``arch``'s ``.reduced()`` config at 128 tokens of 8 sequences."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    if arch is not None:
        full = get_config(arch)
        red = full.reduced()
        ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
              if f.name != "name"
              and getattr(red, f.name) != getattr(full, f.name)}
        return arch, ShapeConfig(f"{kind}_tiny", 128, 8, kind), ov
    if kind == "train":
        return ("tinyllama-1.1b", ShapeConfig("train_tiny", 128, 8, "train"),
                {"num_layers": 2, "d_model": 64, "num_heads": 4,
                 "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                 "vocab_size": 256})
    return ("granite-34b", ShapeConfig("decode_tiny", 256, 8, "decode"),
            {"num_layers": 2, "d_model": 64, "num_heads": 4,
             "num_kv_heads": 1, "head_dim": 16, "d_ff": 128,
             "vocab_size": 256, "max_position": 512})


@pytest.mark.parametrize("arch,kind", CASES,
                         ids=[k if a is None else f"{a}-{k}"
                              for a, k in CASES])
def test_reduced_cells_run_on_small_mesh(arch, kind):
    """``tests/test_distributed.py``'s two small-mesh cells, and every
    kind of step of one reduced config per family, through the port's
    dry-run on a (2, 4) fake group: status ok, FLOPs per device > 0, a
    train cell's FSDP gathers and gradient reductions counted, memory
    recorded."""
    from repro_torch.launch.dryrun import run_cell
    arch, shape, ov = _reduced_cell(arch, kind)
    rec = run_cell(arch, shape, "test", overrides=ov, mesh_shape=SMALL,
                   cost_pass=True, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0
    assert rec["num_devices"] == 8
    assert rec["accounting"] == "eager_full_depth"
    mem = rec["memory"]
    assert mem["total_per_device"] == mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"] > 0
    if kind == "train":
        assert roof["collective_ops"] > 0
        assert rec["collectives"]["all-gather"] > 0
        assert rec["collectives"]["all-reduce"] > 0


@pytest.mark.parametrize("arch", [
    "starcoder2-7b", "tinyllama-1.1b", "granite-34b", "smollm-360m",
    "phi3.5-moe-42b-a6.6b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
    "zamba2-2.7b", "whisper-large-v3", "qwen2-vl-7b", "gpt2-large"])
def test_model_flops_match_reference(arch):
    """``model_flops``, ``attention_flops`` and ``model_flops_ext`` equal
    the reference's at every shape of the grid."""
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jcfg
    from repro.launch import roofline as jrl
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import roofline as rl
    assert list(SHAPES) == list(JSHAPES)
    for name, shape in SHAPES.items():
        for f in ("model_flops", "attention_flops", "model_flops_ext"):
            assert getattr(rl, f)(get_config(arch), shape) == \
                getattr(jrl, f)(jcfg(arch), JSHAPES[name]), (f, name)


def test_derive_from_parts_is_the_reference_formula(monkeypatch):
    """With the reference's v5e constants the port's roofline record is the
    reference's field for field; with its own, each term is the count
    over the H100's rate."""
    from repro.configs import get_config as jcfg
    from repro.configs import get_shape as jshape
    from repro.launch import roofline as jrl
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import roofline as rl
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12,
                                                       450e9)
    cases = [("smollm-360m", "prefill_32k", 2.7e14, 5.9e13,
              {"total": 2.5e10, "num_ops": 390}),
             ("granite-34b", "decode_32k", 1.1e11, 3.0e11,
              {"total": 7.0e10, "num_ops": 12}),
             ("starcoder2-7b", "train_4k", 1.3e15, 8.9e13, {})]
    for arch, shape, f, b, w in cases:
        got = rl.derive_from_parts(arch, get_shape(shape), "single", 256, f,
                                   b, w, get_config(arch)).as_dict()
        assert got["compute_s"] == f / 989e12
        assert got["memory_s"] == b / 3.35e12
        assert got["collective_s"] == w.get("total", 0.0) / 450e9
    monkeypatch.setattr(rl, "PEAK_FLOPS", jrl.PEAK_FLOPS)
    monkeypatch.setattr(rl, "HBM_BW", jrl.HBM_BW)
    monkeypatch.setattr(rl, "LINK_BW", jrl.ICI_BW)
    for arch, shape, f, b, w in cases:
        got = rl.derive_from_parts(arch, get_shape(shape), "single", 256, f,
                                   b, w, get_config(arch)).as_dict()
        want = jrl.derive_from_parts(arch, jshape(shape), "single", 256, f,
                                     b, w, jcfg(arch)).as_dict()
        assert got == want


HLO = """
  %ag = bf16[8,128]{1,0} all-gather(bf16[1,128]{1,0} %p0), dimensions={0}
  %ar = f32[256]{0} all-reduce(f32[256]{0} %x), to_apply=%add
  %rs = f32[32]{0} reduce-scatter(f32[256]{0} %y), dimensions={0}
  %cp = bf16[64,64]{1,0} collective-permute(bf16[64,64]{1,0} %z)
  %a2a = s32[16]{0} all-to-all(s32[16]{0} %w), dimensions={0}
  %t = (f32[4]{0}, f32[4]{0}) all-reduce(f32[4]{0} %a, f32[4]{0} %b)
  %s = (bf16[2,8]{1,0}, bf16[16,8]{1,0}) all-gather-start(bf16[2,8] %c)
"""


def test_collective_wire_bytes_match_reference():
    """The HLO parser (copied) on the reference test's text plus tuple and
    ``-start`` results; ``collective_wire_bytes_from_ops`` applies the
    same factors to recorded ops."""
    from repro.launch import roofline as jrl
    from repro_torch.launch import roofline as rl
    assert rl.collective_wire_bytes(HLO) == jrl.collective_wire_bytes(HLO)
    w = rl.collective_wire_bytes(HLO)
    assert w["num_ops"] == 7
    ops = [("all-gather", 8 * 128 * 2), ("all-reduce", 256 * 4),
           ("reduce-scatter", 32 * 4), ("collective-permute", 64 * 64 * 2),
           ("all-to-all", 16 * 4)]
    got = rl.collective_wire_bytes_from_ops(ops)
    want = jrl.collective_wire_bytes(HLO.split("\n  %t")[0])
    assert got == want


def test_perf_cells_equal_reference():
    """``perf.CELLS`` is the reference's, variant for variant."""
    from repro_torch.launch import perf
    tree = ast.parse((ROOT / "src/repro/launch/perf.py").read_text())
    cells = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "CELLS")
    assert perf.CELLS == cells


#: the keys the reference's dry-run writes for an ok single-mesh cell
#: (``repro/launch/dryrun.py``: ``run_cell``)
REF_KEYS = {"arch", "shape", "mesh", "num_devices", "compile_scan_s",
            "memory", "status", "accounting", "cost", "roofline",
            "collectives", "total_s"}
REF_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "total_per_device"}


def test_dryrun_cli_writes_reference_keys(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch ... --out`` appends one
    JSON line with the reference's keys (a full-size cell on the 256-rank
    single mesh) and exits 0."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    assert all(f'"{k}"' in src for k in REF_KEYS | REF_MEMORY)
    from repro_torch.launch.dryrun import main
    out = tmp_path / "dryrun.jsonl"
    with pytest.raises(SystemExit) as e:
        main(["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh",
              "single", "--out", str(out)])
    assert e.value.code == 0
    rec = json.loads(out.read_text().splitlines()[0])
    assert set(rec) == REF_KEYS
    assert set(rec["memory"]) == REF_MEMORY
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    assert rec["num_devices"] == 256 and rec["status"] == "ok"
    assert "[ok  ] smollm-360m" in capsys.readouterr().out


def test_production_mesh_needs_its_devices():
    """Without a process group of 256 / 512 ranks the production meshes
    raise the reference's error; no smaller mesh, no other device."""
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 "
                                           r"devices, have 1"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match=r"mesh \(2, 16, 16\) needs 512 "
                                           r"devices, have 1"):
        mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="need 256 devices, have 1"):
        mesh.make_mesh_from_config(MeshConfig())

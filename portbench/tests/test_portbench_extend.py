"""A later change adds a cell, a traffic mix, a configuration's limits, a
per-layer metric and a model architecture by adding files and
BENCHMARK.json entries only: the harness finds each by its name."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def _copy(tmp_path):
    """The benchmark's files copied under ``tmp_path``: BENCHMARK.json as
    a dict, the copied ``portbench/`` and every file's bytes as copied."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    return bench, pb, before


def _add_cell(bench, pb, name, config, traffic, like):
    """A workload ``name`` listed wherever ``like`` is, with ``like``'s
    limits."""
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": f"as {like}"})
    shutil.copy(pb / "limits" / f"{like}.json",
                pb / "limits" / f"{name}.json")


def _run(tmp_path, bench, before, code):
    """``code`` run in the copied tree; its last line of output, read as
    JSON. Every file that was copied is still as it was."""
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_cell_mix_and_metric_found_by_name(tmp_path):
    bench, pb, before = _copy(tmp_path)
    mix = json.loads((pb / "traffic" / "code.routed.json").read_text())
    mix.update(why="short distinct prompts", arrival_gap_s=60.0)
    (pb / "traffic" / "code.short.json").write_text(json.dumps(mix))
    (pb / "limits" / "sc2.short.routed.json").write_text(json.dumps(
        {"logit_gap": {"limit": 1.0}}))
    (pb / "metrics" / "tokens_per_stream.py").write_text(
        "def read(run):\n"
        "    n = len(run.record.streams)\n"
        "    return run.record.tokens / n if n else None\n")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sc2.code.routed" in m.get("workloads", ()):
            m["workloads"].append("sc2.short.routed")
    bench["workloads"].append({"name": "sc2.short.routed",
                               "config": "starcoder2-7b",
                               "traffic": "code.short", "chips": 1,
                               "why": "short prompts"})
    bench["per_layer"].append({"name": "tokens_per_stream",
                               "unit": "tokens", "better": "higher",
                               "source": "program_counter",
                               "layer": "window loop", "moves":
                               "tokens_per_s",
                               "workloads": ["sc2.short.routed"]})
    code = (
        "import json\n"
        "from portbench import harness\n"
        "from portbench.tests._cpu import rehearse\n"
        "r = rehearse('sc2.short.routed', seconds=0.5,\n"
        "             bench=harness.benchmark())\n"
        "print(json.dumps(sorted(r['metrics'])))\n")
    names = _run(tmp_path, bench, before, code)
    assert {"tokens_per_stream", "tokens_per_s", "route_ms"} <= set(names)


#: a model module that exists only in the copied tree: the decoder with
#: two leaves of its own, every matmul counted twice, attention in every
#: second layer, and logits it can be told to perturb
TOY = '''
import torch
from portbench.reference import decoder

CALLS = {"layout": 0, "served_logits": 0}
PERTURB = 0.0


def layout(cfg):
    CALLS["layout"] += 1
    yield from decoder.layout(cfg)
    yield ("probe", "scaled"), (3, 4), 2.0
    yield ("probe", "half"), (5,), 1.0, "bfloat16"


def served_logits(cfg, W, prompt, output, per_step_capacity, quant=None):
    CALLS["served_logits"] += 1
    out = decoder.served_logits(cfg, W, prompt, output, per_step_capacity,
                                quant)
    g = torch.Generator(device=out.device).manual_seed(0)
    noise = torch.randn(out.shape, generator=g, device=out.device)
    return out + PERTURB * out.std() * noise


def token_flops(cfg, position, head):
    return 2 * decoder.token_flops(cfg, position, head)


def span_flops(cfg, start, end, head_last):
    return 2 * decoder.span_flops(cfg, start, end, head_last)


def attention_layers(cfg, start, end):
    return sum(1 for i in range(start, end) if i % 2 == 1)
'''

TOY_RUN = '''
import json
import torch
from portbench import harness, weights
from portbench.reference import decoder
from portbench.tests import _cpu
from portbench.yardstick import BF16_FLOP_PER_S

torch.set_num_threads(1)
bench = harness.benchmark()
run = harness.prepare(
    bench, "toy.code.routed", 3, 1.5, False, "cpu", 0.0,
    overrides=_cpu.TINY, mix_patch=_cpu.SHORT, clock=_cpu.step_clock(),
    config_patch={"deployment": dict(_cpu.DEPLOYMENT["deployment"],
                                     layers_per_stage=2)})
run.profiler._prof = object()   # a slice held open: K3 shapes recorded
harness.run_cell(run)
rec, toy, cfg = run.record, run.model, run.cfg
flops = 0.0
for s in rec.streams:
    P0 = len(s.prompt)
    flops += decoder.span_flops(cfg, 0, s.prefill_tokens,
                                head_last=s.prefill_tokens == P0)
    flops += sum(decoder.token_flops(cfg, P0 + j - 1, True)
                 for j in range(1, len(s.output)))
mfu = harness.read_metrics(run, [m for m in bench["per_layer"]
                                 if m["name"] == "mfu"])["mfu"]["value"]
buf = run.params["embed"]["tok"]._base      # the seeded buffer
n = weights.count(cfg, decoder.layout)
sound = harness.compare(run)
toy.PERTURB = 1.0
perturbed = harness.compare(run)
print(json.dumps({
    "calls": toy.CALLS,
    "probe": {k: [list(v.shape), str(v.dtype)]
              for k, v in run.params["probe"].items()},
    "probe_values": bool(
        torch.equal(run.params["probe"]["scaled"],
                    2.0 * buf[n:n + 12].view(3, 4))
        and torch.equal(run.params["probe"]["half"],
                        buf[n + 12:n + 17].to(torch.bfloat16))),
    "buffer": [buf.numel(), n + 17],
    "flops": rec.flops, "decoder_flops": flops,
    "mfu": mfu, "mfu_want": 100 * rec.flops / (run.window.length
                                               * BF16_FLOP_PER_S),
    "k3_layers": sorted({x[3] for x in run.profiler.shapes
                         if x[0] == "k3"}),
    "sound": harness.is_correct(sound), "perturbed": harness.is_correct(
        perturbed), "perturbed_err": perturbed["logit_err"]["value"]}))
'''


def test_new_architecture_is_a_model_module_of_its_own(tmp_path):
    bench, pb, before = _copy(tmp_path)
    (pb / "reference" / "toy.py").write_text(TOY)
    config = json.loads((pb / "configs" / "starcoder2-7b.json").read_text())
    config["model"] = "toy"
    (pb / "configs" / "toy-sc2.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "toy-sc2", "source": "a test",
                             "file": "portbench/configs/toy-sc2.json",
                             "reduced": [], "why": "a test"})
    _add_cell(bench, pb, "toy.code.routed", "toy-sc2", "code.routed",
              "sc2.code.routed")
    got = _run(tmp_path, bench, before, TOY_RUN)
    # its layout made the run's weights: its own two leaves after the
    # decoder's matrices in the one seeded buffer, scaled and cast
    assert got["calls"]["layout"] >= 1
    assert got["probe"] == {"scaled": [[3, 4], "torch.float32"],
                            "half": [[5], "torch.bfloat16"]}
    assert got["probe_values"]
    assert got["buffer"][0] == got["buffer"][1]
    # its reference decided ``correct``: true as it is, false perturbed
    assert got["calls"]["served_logits"] > 0
    assert got["sound"] is True
    assert got["perturbed"] is False and got["perturbed_err"] > 0.3
    # its operation count reached mfu's record: twice the decoder's
    assert got["decoder_flops"] > 0
    assert got["flops"] == 2 * got["decoder_flops"]
    assert got["mfu"] == got["mfu_want"]
    # its attention layers reached the K3 records: one in each stage of
    # two layers, where the decoder counts two
    assert got["k3_layers"] == [1]


def test_gpt2_large_through_the_decoder_module(tmp_path):
    bench, pb, before = _copy(tmp_path)
    (pb / "configs" / "gpt2-large.json").write_text(json.dumps({
        "source": "https://huggingface.co/openai-community/gpt2-large",
        "port_config": "gpt2-large",
        "port_overrides": {"attn_impl": "flash",
                           "activation_dtype": "bfloat16",
                           "param_dtype": "float32"},
        "model": "decoder",
        "deployment": {"layers_per_stage": 1,
                       "replicas": {"honeypot": 2, "turtle": 2,
                                    "golden": 2}}}))
    bench["configs"].append({"name": "gpt2-large", "source": "a test",
                             "file": "portbench/configs/gpt2-large.json",
                             "reduced": [], "why": "a test"})
    _add_cell(bench, pb, "gpt2l.code.routed", "gpt2-large", "code.routed",
              "sc2.code.routed")
    code = (
        "import json\n"
        "from portbench.tests._cpu import rehearse\n"
        "r = rehearse('gpt2l.code.routed')\n"
        "run = r['run']\n"
        "print(json.dumps({'correct': r['line']['correct'],\n"
        "    'compared': r['compared'],\n"
        "    'checked': run.record.check['checked_tokens'],\n"
        "    'learned': run.cfg.pos_type, 'tied': run.cfg.tie_embeddings,\n"
        "    'embed': sorted(run.params['embed'])}))\n")
    got = _run(tmp_path, bench, before, code)
    assert got["learned"] == "learned" and got["tied"] is True
    assert got["embed"] == ["pos", "tok"]
    assert got["checked"] > 0
    assert got["correct"] is True, got["compared"]

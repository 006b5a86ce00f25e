"""The CPU rehearsals of ``chip_smoke.py`` phases 17 (``edge_control``),
18 (``model_zoo``) and 19 (``vlm_audio``, below).

The phase's hedge and worker-drill counts come from the simulation, which
draws nothing that depends on the model's width, so the phase runs here
at the full depth of 36 layers and a tiny width, on the kernels' plain
versions: its gates (tokens per stream, hedges fired against
``EDGE_HEDGES_FIRED``, the honest control-plane run, the composed digest
against the in-process twin, f32 kernel-vs-plain parity, the trace export
and TTFT identity, the worker drill's tokens against
``EDGE_CHAOS_TOKENS``, no worker left) must pass as they stand. Only the
kernel-launch gates are replaced: the CPU launches no kernel, so K3 is
counted as one launch per layer of every stage forward the phase ran.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rehearsal", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase17_rehearsal(monkeypatch, capsys):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    seen = {}

    def check_served(cfg, srv, done, counts, forwards):
        assert all(r.metrics.tokens == cs.NEW_TOKENS for r in done)
        seen["windows"] = srv.router.stats.windows

    orig = cs.check_edge_counts

    def check_edge_counts(cfg, srv, done, counts, forwards, tally):
        per_stage = cfg.num_layers // srv.partition.n_stages
        orig(cfg, srv, done, dict(counts, flash_attention=forwards
                                  * per_stage), forwards, tally)
        seen["tally"] = dict(tally)

    monkeypatch.setattr(cs, "check_served", check_served)
    monkeypatch.setattr(cs, "check_edge_counts", check_edge_counts)
    cfg = dataclasses.replace(get_config("gpt2-large").reduced(
        num_layers=36, d_model=32, d_ff=64, num_heads=2, num_kv_heads=1,
        head_dim=16), attn_impl="flash")
    params = init_params(cfg, torch.Generator().manual_seed(cs.SEED), "cpu")
    cs.phase_edge_control(cfg, params, 0.0)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            rows.update(json.loads(line))
    served = rows["hedged_serving"]
    assert served["hedges_fired"] == cs.EDGE_HEDGES_FIRED
    assert (served["windows"], served["dp_windows"]) == (34, 34)
    assert seen["tally"] == {"primary": served["primary_forwards"],
                             "hedge": served["hedge_forwards"]}
    assert served["health"]["rpc_timeouts"] == 0
    assert served["worker_start_method"] == "spawn"
    assert rows["trace_export"]["schema_errors"] == 0
    chaos = rows["worker_chaos"]
    assert tuple(chaos["tokens_per_stream"]) == cs.EDGE_CHAOS_TOKENS
    assert chaos["health"]["worker_restarts"] == 1
    assert rows["edge_control_step_ms"] and cs.shard_workers() == []


#: the tiny width phase 18 is rehearsed at (every arch at its own depth)
TINY = dict(d_model=32, num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
            vocab_size=128, max_position=4096)


def test_phase18_rehearsal(monkeypatch, capsys):
    """Phase 18 (``model_zoo``) at a tiny width and each model's full
    depth, on the kernels' plain versions (its kernel checks need the
    card): qwen3-moe through ``run_queue`` on the 48-layer topology serves
    16 tokens per stream in ``ZOO_WINDOWS`` windows, each running the DP
    once (K1), with ``ZOO_FORWARDS`` stage forwards (K3 = forwards x 2
    layers, K4 = 0); the f32 kernel-vs-plain run_queue and engine parities
    hold; every engine model runs one prefill per prompt group and 31
    decode steps per group, so K3 = layers x 2 and K4 = layers x 62. The
    engine's prompts are shortened (the counts do not depend on their
    length). The CPU launches no kernel, so the launch gates are replaced
    by the launches the path needs."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    orig = cs.zoo_config
    seen = {}

    def tiny(arch, dtype, layers=None):
        cfg = orig(arch, dtype, layers)
        return dataclasses.replace(
            cfg, num_experts=min(cfg.num_experts, 8),
            experts_per_token=min(cfg.experts_per_token, 2), **TINY)

    def check_served(cfg, srv, done, counts, forwards):
        per_stage = cfg.num_layers // srv.partition.n_stages
        seen["main"] = dict(
            windows=srv.router.stats.windows,
            k1=srv.router.stats.device_calls, k3=forwards * per_stage,
            k4=counts["decode_attention"],
            tokens=[r.metrics.tokens for r in done])

    def check_engine_launches(arch, cfg, eng, counts):
        seen[arch] = cs.expected_launches(cfg, eng.prefills,
                                          eng.decode_steps)

    monkeypatch.setattr(cs, "zoo_config", tiny)
    monkeypatch.setattr(cs, "check_served", check_served)
    monkeypatch.setattr(cs, "check_engine_launches", check_engine_launches)
    monkeypatch.setattr(cs, "zoo_profile", lambda cfg, params: None)
    monkeypatch.setattr(cs, "ZOO_ENGINE_GROUPS", ((8, 4), (24, 4)))
    monkeypatch.setattr(cs, "ZOO_PARITY_GROUPS", ((8, 2), (24, 2)))
    cs.phase_zoo_models(0.0)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            key = next(iter(obj))
            rows.setdefault(key, []).append(obj[key])
    assert seen["main"] == dict(windows=cs.ZOO_WINDOWS, k1=cs.ZOO_WINDOWS,
                                k3=2 * cs.ZOO_FORWARDS, k4=0,
                                tokens=[cs.NEW_TOKENS] * 4)
    assert (cs.ZOO_WINDOWS, cs.ZOO_FORWARDS) == (34, 1608)
    main = rows["zoo_main_path"][0]
    assert main["peers"] == 144 and main["layers"] == 48
    assert rows["zoo_f32_parity"][0]["equal"]
    layers = {"qwen3-moe-30b-a3b": 48, "smollm-360m": 32,
              "starcoder2-7b": 32, "granite-34b": 88,
              "phi3.5-moe-42b-a6.6b": 24}
    for arch, L in layers.items():
        assert seen[arch] == {"flash_attention": 2 * L,
                              "decode_attention": 62 * L,
                              "wkv6_chunked": 0, "ssd_chunked": 0}, arch
    engines = {r["arch"]: r for r in rows["zoo_engine"]}
    assert set(engines) == set(layers)
    assert engines["phi3.5-moe-42b-a6.6b"]["depth"].startswith("24 of 32")
    assert all(r["tokens"] == 8 * cs.ENGINE_TOKENS for r in engines.values())
    parity = {r["model"]: r for r in rows["engine_f32_parity"]}
    assert all(r["equal"] for r in parity.values()) and \
        set(parity) == set(layers)
    assert parity["qwen3-moe-30b-a3b"]["router_topk_sets_differing"] == 0


def _count_dispatches(monkeypatch):
    """Count K3's and K4's dispatches (``ops.flash_attention`` and
    ``ops.decode_attention``, whose plain versions run on CPU tensors) and
    serve them as the launch counters, so that a phase's launch gates run
    as they stand on the card."""
    from repro_torch.kernels import ops
    calls = dict.fromkeys(ops.CUDA_KERNELS, 0)
    for name in ("flash_attention", "decode_attention"):
        orig = getattr(ops, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    monkeypatch.setattr(ops, "launch_counts", lambda: dict(calls))
    monkeypatch.setattr(ops, "reset_launch_counts",
                        lambda: calls.update(dict.fromkeys(calls, 0)))


def test_phase19_rehearsal(monkeypatch, capsys):
    """Phase 19 (``vlm_audio``) at a tiny width and each model's full
    depth (Qwen2-VL 28 layers; Whisper 32 + 32), on the kernels' plain
    versions, with K3's and K4's dispatches counted as their launches:
    qwen2-vl through ``run_queue`` on the 28-layer topology (14 stages x 6
    replicas) serves 16 tokens per stream in ``VLM_WINDOWS`` windows, each
    running the DP once (K1), with ``VLM_FORWARDS`` stage forwards (K3 =
    forwards x 2 layers, K4 = 0); the f32 run_queue parity at 8 layers
    holds; the engine launches K3 = 2 x 28 and K4 = 62 x 28; the image
    path K3 = 28 and K4 = 28 per decode step, its f32 parity holds;
    Whisper launches K3 = 32 + 2 x 32 at prefill and 32 per decode step,
    K4 = 32 per decode step, its cache bytes and f32 parity hold. The
    prompts, the image and the frames are shortened (no count depends on
    their length). The CPU runs no K1 kernel (the router's ``auto``
    backend is the host DP here), so run_queue's K1 gate is replaced by
    the DP windows the router counts."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    _count_dispatches(monkeypatch)
    orig = cs.zoo_config
    seen = {}

    def tiny(arch, dtype, layers=None):
        cfg = orig(arch, dtype, layers)
        over = dict(TINY)
        if cfg.pos_type == "mrope":
            over["mrope_sections"] = (2, 3, 3)
        if cfg.family == "audio":
            over["num_kv_heads"] = 2
        return dataclasses.replace(cfg, **over)

    def check_served(cfg, srv, done, counts, forwards):
        per_stage = cfg.num_layers // srv.partition.n_stages
        assert counts["flash_attention"] == forwards * per_stage
        seen["main"] = dict(
            windows=srv.router.stats.windows,
            k1=srv.router.stats.device_calls, forwards=forwards,
            k3=counts["flash_attention"], k4=counts["decode_attention"],
            tokens=[r.metrics.tokens for r in done])

    monkeypatch.setattr(cs, "zoo_config", tiny)
    monkeypatch.setattr(cs, "check_served", check_served)
    monkeypatch.setattr(cs, "ZOO_ENGINE_GROUPS", ((8, 4), (24, 4)))
    monkeypatch.setattr(cs, "VLM_IMAGE", (4, (2, 4), 24))
    monkeypatch.setattr(cs, "AUDIO_RUN", (4, 64, 4, 32))
    out = cs.phase_vlm_audio(0.0)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            key = next(iter(obj))
            rows.setdefault(key, []).append(obj[key])
    assert seen["main"] == dict(
        windows=cs.VLM_WINDOWS, k1=cs.VLM_WINDOWS, forwards=cs.VLM_FORWARDS,
        k3=2 * cs.VLM_FORWARDS, k4=0, tokens=[cs.NEW_TOKENS] * 4)
    assert (cs.VLM_WINDOWS, cs.VLM_FORWARDS) == (34, 938)
    main = rows["vlm_main_path"][0]
    assert main["peers"] == 84 and main["layers"] == 28
    assert rows["vlm_f32_parity"][0]["equal"]
    eng = out["vlm"]
    assert eng["launches"]["flash_attention"] == 2 * 28
    assert eng["launches"]["decode_attention"] == 62 * 28
    image = rows["vlm_image"][0]
    assert image["launches"]["flash_attention"] == 28
    assert image["launches"]["decode_attention"] == 28 * cs.VLM_DECODE
    assert image["tokens"] == 4 * (cs.VLM_DECODE + 1)
    audio = rows["audio"][0]
    assert audio["launches"]["flash_attention"] == 96 + 32 * 31
    assert audio["launches"]["decode_attention"] == 32 * 31
    assert audio["layers"] == [32, 32]
    parity = {r["model"]: r for r in rows["vlm_audio_f32_parity"]}
    assert set(parity) == {"qwen2-vl-7b image path", "whisper-large-v3"}
    assert all(r["equal"] for r in parity.values())
    assert parity["qwen2-vl-7b image path"]["layers"] == 8


def test_phase20_rehearsal(monkeypatch, capsys, tmp_path):
    """Phase 20 (``train``) at a tiny width and smollm's full depth (32
    layers), on the plain PyTorch path, with K3's and K4's dispatches
    counted as their launches: the full-depth training run launches no
    kernel (its K1-K6 counts stay 0) and its loss falls; the checkpoint
    restores bit-equal; the restored parameters served through
    ``run_queue`` on the 32-layer topology (16 stages x 6 replicas) emit
    16 tokens per stream in ``TRAIN_WINDOWS`` windows, each running the DP
    once (K1), with ``TRAIN_FORWARDS`` stage forwards (K3 = forwards x 2
    layers, K4 = 0); resuming from a checkpoint equals the straight run
    bit for bit; every family's f32 steps hold (the CPU against itself
    here). The stream's rows are shortened to 64 tokens (no count depends
    on their length). The CPU runs no K1 kernel, so run_queue's K1 gate is
    replaced by the DP windows the router counts."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "TRAIN_SEQ", 64)
    monkeypatch.setattr(cs, "TRAIN_CKPT_DIR", tmp_path / "ckpt")
    _count_dispatches(monkeypatch)
    orig = cs.train_config
    seen = {}

    def tiny(layers=None):
        return dataclasses.replace(orig(layers), **TINY)

    def check_served(cfg, srv, done, counts, forwards):
        per_stage = cfg.num_layers // srv.partition.n_stages
        assert counts["flash_attention"] == forwards * per_stage
        seen["main"] = dict(
            windows=srv.router.stats.windows,
            k1=srv.router.stats.device_calls, forwards=forwards,
            k3=counts["flash_attention"], k4=counts["decode_attention"],
            tokens=[r.metrics.tokens for r in done])

    monkeypatch.setattr(cs, "train_config", tiny)
    monkeypatch.setattr(cs, "check_served", check_served)
    cs.phase_train(0.0)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            key = next(iter(obj))
            rows.setdefault(key, []).append(obj[key])
    main = rows["train_main"][0]
    assert main["layers"] == 32 and main["steps"] == cs.TRAIN_STEPS == 20
    assert set(main["launches"].values()) == {0}
    assert main["loss_last"] < main["loss_first"]
    assert rows["train_checkpoint"][0]["bit_equal"]
    assert seen["main"] == dict(
        windows=cs.TRAIN_WINDOWS, k1=cs.TRAIN_WINDOWS,
        forwards=cs.TRAIN_FORWARDS, k3=2 * cs.TRAIN_FORWARDS, k4=0,
        tokens=[cs.NEW_TOKENS] * 4)
    assert (cs.TRAIN_WINDOWS, cs.TRAIN_FORWARDS) == (34, 1072)
    served = rows["train_serve"][0]
    assert served["peers"] == 96 and served["layers"] == 32
    resume = rows["train_resume"][0]
    assert resume["bit_equal"] and resume["max_abs_diff"] == 0.0
    assert resume["layers"] == cs.TRAIN_RESUME_LAYERS
    parity = {r["model"]: r for r in rows["train_f32_parity"]}
    assert tuple(parity) == cs.TRAIN_FAMILIES
    assert all(len(r["free"]) == len(r["carried"]) == cs.TRAIN_PARITY_STEPS
               for r in parity.values())


def test_phase21_rehearsal(monkeypatch, capsys):
    """Phase 21 (``distributed``) at a tiny width on the CPU, with a
    one-rank gloo group where the card has a one-rank NCCL group: the
    DTensor train step on the (1, 1) mesh gives the plain step's metrics;
    the compressed all-reduce holds the reference test's gates on the
    gradient tree; the dry-run's four cells (``perf.CELLS`` A, B, C on the
    single mesh and B on the multi mesh, on their production meshes at a
    tiny width) run; the dry-run at the card's shape counts the plain
    step's argument bytes and ``FlopCounterMode``'s FLOPs exactly. No
    process group is left."""
    import torch.distributed as dist
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "TRAIN_SEQ", 64)
    orig = cs.train_config
    tiny = dict(TINY, num_layers=2)
    monkeypatch.setattr(cs, "train_config", lambda layers=None:
                        dataclasses.replace(orig(layers), **tiny))
    monkeypatch.setattr(cs, "DRYRUN_OVERRIDES", tiny)
    monkeypatch.setattr(cs, "DRYRUN_FAMILY_SCALE", _family_scale())
    cs.phase_distributed()
    assert not dist.is_initialized()
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            key = next(iter(obj))
            rows.setdefault(key, []).append(obj[key])
    train = rows["dist_train"][0]
    assert len(train["plain"]) == len(train["dtensor"]) == cs.DIST_STEPS
    assert max(train["max_rel_diff"].values()) <= cs.DIST_METRIC_RTOL
    comp = rows["dist_compressed_allreduce"][0]
    assert comp["rounds"] == 30
    assert comp["rel_err_accumulated"] < 0.02
    assert comp["rel_err_one_round"] < 0.2
    dry = rows["dryrun"]
    assert [(r["cell"], r["mesh"]) for r in dry] == list(cs.DRYRUN_CELLS)
    assert all(r["cost"]["flops"] > 0 for r in dry)
    vs = rows["dryrun_vs_card"][0]
    assert vs["argument_size_in_bytes"] == vs["card_argument_bytes"]
    assert vs["flops"] == vs["card_flops"] > 0
    fam = rows["dryrun_family"]
    assert [(r["arch"], r["shape"]) for r in fam] == \
        list(cs.DRYRUN_FAMILY_CELLS)
    assert all(r["mesh"] == "single" and r["dominant"] and
               r["cost"]["flops"] > 0 for r in fam)


def _family_scale():
    """Phase 21's family cells cut for the CPU: each arch at its
    ``.reduced()`` config, 128 tokens of 8 sequences."""
    from repro_torch.configs import get_config
    over = {}
    for arch in ("qwen3-moe-30b-a3b", "rwkv6-1.6b", "zamba2-2.7b",
                 "whisper-large-v3"):
        full = get_config(arch)
        red = full.reduced()
        over[arch] = {f.name: getattr(red, f.name)
                      for f in dataclasses.fields(red)
                      if f.name != "name"
                      and getattr(red, f.name) != getattr(full, f.name)}
    return {"overrides": over, "shape": [128, 8]}


def test_phase21_family_cells_and_phase22_repolint(monkeypatch, capsys):
    """The new parts of phases 21 and 22 alone: the family cells started
    in their own process (``--dryrun-cells``, as the script starts them
    after the build) and collected, each ok with its dominant term; the
    process is gone afterwards. Then phase 22: the port's linter over
    ``src/repro_torch`` gives 0 findings and ``REPOLINT_ALLOWED`` (26)
    allowed findings with every allow entry used, and a finding fails the
    phase."""
    import pytest
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DRYRUN_FAMILY_SCALE", _family_scale())
    handle = cs.start_family_dryrun()
    fam = cs.phase_family_dryrun(handle)
    assert handle["proc"].poll() == 0
    assert [(r["arch"], r["shape"]) for r in fam] == \
        list(cs.DRYRUN_FAMILY_CELLS)
    assert {r["dominant"] for r in fam} <= {"compute", "memory",
                                            "collective"}
    row = cs.phase_repolint()
    assert (row["findings"], row["allowed"], row["unused_allow"]) == \
        (0, cs.REPOLINT_ALLOWED, [])
    assert row["config"] == "repolint_torch.json" and row["files"] > 90
    monkeypatch.setattr(cs, "REPOLINT_ALLOWED", 25)
    with pytest.raises(AssertionError, match="repolint"):
        cs.phase_repolint()
    out = capsys.readouterr().out
    assert '{"repolint": ' in out and '{"dryrun_family": ' in out

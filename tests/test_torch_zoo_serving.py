"""The trust-routed pipeline server on RoPE and MoE models: the port
against the JAX reference.

``run_queue`` tokens and every ``ServeMetrics`` field must be identical to
the reference's (exact: the simulation's RNG draws failures, latencies and
samples in the same order only if routing, repair and token emission agree
step for step) on ``tinyllama-1.1b``, ``smollm-360m`` and
``qwen3-moe-30b-a3b``, each ``.reduced`` to 4 layers in 2 stages with the
reference's own parameters (``params_from_jax``), f32 activations,
disaggregated chunked prefill, the kernel router backend and
``attn_impl="flash"`` (whose plain versions run on CPU tensors). Each
stage computes its RoPE angles from positions 0..S-1, as the reference's.
The serve CLI at ``--mode gtrac`` runs for a RoPE and an MoE arch.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import GTRACConfig
from repro.distributed.pipeline import StagePartition
from repro.models.api import build_model as jbuild_model
from repro.serving.api import SubmitSpec as JSubmitSpec
from repro.serving.gtrac_serve import GTRACPipelineServer, make_stage_fns
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import GTRACConfig as TGTRACConfig
from repro_torch.launch import serve as tserve
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.gtrac_serve import \
    GTRACPipelineServer as TGTRACPipelineServer

torch.set_num_threads(1)

REDUCED = dict(num_layers=4, vocab_size=128, remat=False,
               activation_dtype="float32")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "smollm-360m",
                                  "qwen3-moe-30b-a3b"])
def test_run_queue_matches_reference(arch):
    """The pipeline server on a RoPE or MoE model: tokens and every
    ServeMetrics field identical to the reference's."""
    cfg = get_config(arch).reduced(**REDUCED)
    params = jbuild_model(cfg).init(jax.random.PRNGKey(7))
    tparams = params_from_jax(jax.tree.map(np.asarray, params),
                              device="cpu")
    gkw = dict(disaggregate=True, prefill_chunk_tokens=16)
    srv = GTRACPipelineServer(cfg, params, layers_per_stage=2,
                              gcfg=GTRACConfig(**gkw), seed=0)
    srv.stage_fns = make_stage_fns(cfg, params, StagePartition.uniform(4, 2))
    srv.router.backend = "jnp"
    tcfg = dataclasses.replace(tget_config(arch).reduced(**REDUCED),
                               attn_impl="flash")
    tsrv = TGTRACPipelineServer(tcfg, tparams, layers_per_stage=2,
                                gcfg=TGTRACConfig(**gkw), seed=0,
                                device="cpu", router_backend="kernel")
    rng = np.random.default_rng(0)
    for n in (8, 8, 40, 8):
        p = rng.integers(1, 128, size=n)
        srv.submit(JSubmitSpec(prompt=p, max_new_tokens=5))
        tsrv.submit(SubmitSpec(prompt=p, max_new_tokens=5))
    done, tdone = srv.run_queue(), tsrv.run_queue()
    assert [r.request_id for r in tdone] == [r.request_id for r in done]
    for a, b in zip(tdone, done):
        assert a.output == b.output, a.request_id
        assert dataclasses.asdict(a.metrics) == dataclasses.asdict(b.metrics)
    assert vars(tsrv.router.stats) == vars(srv.router.stats)
    assert sum(r.metrics.tokens for r in tdone) > 0
    assert sum(r.metrics.prefill_chunks for r in tdone) == 3


@pytest.mark.parametrize("arch", ["starcoder2-7b", "phi3.5-moe-42b-a6.6b"])
def test_serve_gtrac_mode_serves_rope_and_moe(arch, capsys):
    tserve.main(["--mode", "gtrac", "--device", "cpu", "--reduced",
                 "--arch", arch, "--windowed", "--tokens", "3",
                 "--requests", "2", "--attn-impl", "flash"])
    out = capsys.readouterr().out
    assert "SSR:" in out and "windows:" in out
    assert "flash_attention" in out

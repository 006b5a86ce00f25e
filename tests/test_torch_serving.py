"""Trust-routed serving end to end: the port against the JAX reference.

Both servers get the same GPT-2 parameters (the reference's ``model.init``
converted with ``params_from_jax``), the same seed and the same streams, in
f32 activations. Everything the simulation derives must then be IDENTICAL
(exact equality, no tolerance): the sim RNG draws failures and latencies in
the same order only if routing, repair and token emission agree step for
step. Compared: the emitted tokens, every ``ServeMetrics`` field
(tokens, failures, repairs, rerouted, infeasible, prefill chunks and
tokens, KV warm hits, TTFT, emission stamps) and ``latency_summary`` — for
``run_queue`` with disaggregation off and on (one long prompt prefilled in
chunks), and for per-token ``generate`` under every routing policy (G-TRAC
and the sp / mr / naive / larac baselines). The reference test of the same
path is ``tests/test_serving.py``'s routed-pipeline tests.

The router backends compared are the device DP (the reference's ``jnp``
against the port's ``auto``, which is the plain torch DP on the CPU) and
the host numpy DP on both sides.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import GTRACConfig
from repro.distributed.pipeline import StagePartition
from repro.models.api import build_model
from repro.serving.api import SubmitSpec
from repro.serving.gtrac_serve import (GTRACPipelineServer, latency_summary,
                                       make_stage_fns)
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import GTRACConfig as TGTRACConfig
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.api import SubmitSpec as TSubmitSpec
from repro_torch.serving.gtrac_serve import \
    GTRACPipelineServer as TGTRACPipelineServer
from repro_torch.serving.gtrac_serve import \
    latency_summary as tlatency_summary

torch.set_num_threads(1)

REDUCED = dict(num_layers=4, vocab_size=128, remat=False,
               activation_dtype="float32")


@pytest.fixture(scope="module")
def models():
    cfg = get_config("gpt2-large").reduced(**REDUCED)
    params = build_model(cfg).init(jax.random.PRNGKey(7))
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    # one set of jitted reference stage fns for every reference server in
    # this module, so each prefix shape compiles once
    stage_fns = make_stage_fns(cfg, params, StagePartition.uniform(4, 2))
    return cfg, params, tparams, stage_fns


def _servers(models, gcfg_kw, jax_backend, port_backend, impl="xla"):
    cfg, params, tparams, stage_fns = models
    srv = GTRACPipelineServer(cfg, params, layers_per_stage=2,
                              gcfg=GTRACConfig(**gcfg_kw), seed=0)
    srv.stage_fns = stage_fns
    srv.router.backend = jax_backend
    tcfg = dataclasses.replace(tget_config("gpt2-large").reduced(**REDUCED),
                               attn_impl=impl)
    tsrv = TGTRACPipelineServer(tcfg, tparams, layers_per_stage=2,
                                gcfg=TGTRACConfig(**gcfg_kw), seed=0,
                                device="cpu", router_backend=port_backend)
    return srv, tsrv


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 128, size=n) for n in (8, 8, 40, 8)]


def _assert_served_equal(tdone, done):
    assert [r.request_id for r in tdone] == [r.request_id for r in done]
    for a, b in zip(tdone, done):
        assert a.output == b.output, a.request_id
        assert dataclasses.asdict(a.metrics) == dataclasses.asdict(b.metrics)
    assert tlatency_summary(tdone) == latency_summary(done)


@pytest.mark.parametrize("disaggregate", [False, True])
@pytest.mark.parametrize("jax_backend,port_backend",
                         [("jnp", "auto"), ("numpy", "numpy")])
def test_run_queue_matches_reference(models, disaggregate, jax_backend,
                                     port_backend):
    kw = dict(disaggregate=disaggregate, prefill_chunk_tokens=16)
    srv, tsrv = _servers(models, kw, jax_backend, port_backend)
    for p in _prompts():
        srv.submit(SubmitSpec(prompt=p, max_new_tokens=5))
        tsrv.submit(TSubmitSpec(prompt=p, max_new_tokens=5))
    done, tdone = srv.run_queue(), tsrv.run_queue()
    _assert_served_equal(tdone, done)
    assert vars(tsrv.router.stats) == vars(srv.router.stats)
    # the run exercised what it claims to: failures, repairs, chunks
    assert sum(r.metrics.failures + r.metrics.repairs for r in tdone) > 0
    if disaggregate:
        assert sum(r.metrics.prefill_chunks for r in tdone) == 3


def test_run_queue_flash_matches_reference(models):
    """attn_impl="flash" (kernel K3's dispatch; its plain version on CPU)
    serves the same tokens as the reference's plain attention."""
    srv, tsrv = _servers(models, dict(disaggregate=True,
                                      prefill_chunk_tokens=16),
                         "jnp", "kernel", impl="flash")
    for p in _prompts():
        srv.submit(SubmitSpec(prompt=p, max_new_tokens=5))
        tsrv.submit(TSubmitSpec(prompt=p, max_new_tokens=5))
    _assert_served_equal(tsrv.run_queue(), srv.run_queue())


def test_generate_matches_reference(models):
    srv, tsrv = _servers(models, {}, "numpy", "auto")
    for rid, p in enumerate(_prompts()[:3]):
        out, met = srv.generate(p, max_new_tokens=4, request_id=rid)
        tout, tmet = tsrv.generate(p, max_new_tokens=4, request_id=rid)
        np.testing.assert_array_equal(tout, out)
        assert dataclasses.asdict(tmet) == dataclasses.asdict(met)


@pytest.mark.parametrize("algorithm", ["gtrac", "sp", "mr", "naive",
                                       "larac"])
def test_generate_algorithms_match_reference(models, algorithm):
    """``generate`` under each routing policy: the same tokens and every
    ServeMetrics field, three streams in a row on one server (trust moves
    between them)."""
    cfg, params, tparams, stage_fns = models
    srv = GTRACPipelineServer(cfg, params, layers_per_stage=2, seed=1,
                              algorithm=algorithm)
    srv.stage_fns = stage_fns
    tcfg = tget_config("gpt2-large").reduced(**REDUCED)
    tsrv = TGTRACPipelineServer(tcfg, tparams, layers_per_stage=2, seed=1,
                                algorithm=algorithm, device="cpu")
    mets = []
    for rid, p in enumerate(_prompts()[:3]):
        out, met = srv.generate(p, max_new_tokens=4, request_id=rid)
        tout, tmet = tsrv.generate(p, max_new_tokens=4, request_id=rid)
        np.testing.assert_array_equal(tout, out)
        assert dataclasses.asdict(tmet) == dataclasses.asdict(met)
        mets.append(tmet)
    assert sum(m.tokens for m in mets) > 0
    assert tsrv.bed.now == srv.bed.now


def test_sampled_generate_matches_reference(models):
    """Temperature sampling draws from the testbed RNG on both sides."""
    srv, tsrv = _servers(models, {}, "numpy", "auto")
    p = _prompts()[0]
    out, met = srv.generate(p, max_new_tokens=4, greedy=False,
                            temperature=4.0)
    tout, tmet = tsrv.generate(p, max_new_tokens=4, greedy=False,
                               temperature=4.0)
    np.testing.assert_array_equal(tout, out)
    assert dataclasses.asdict(tmet) == dataclasses.asdict(met)


def test_traced_run_queue_matches_reference(models):
    """With tracing on, both servers record the same spans (name, sim-clock
    interval, request id) in the same order."""
    srv, tsrv = _servers(models, dict(trace_enabled=True, disaggregate=True,
                                      prefill_chunk_tokens=16),
                         "jnp", "auto")
    for p in _prompts():
        srv.submit(SubmitSpec(prompt=p, max_new_tokens=3))
        tsrv.submit(TSubmitSpec(prompt=p, max_new_tokens=3))
    srv.run_queue()
    tsrv.run_queue()

    def spans(buf):
        return [(s.name, s.t0, s.t1, s.attrs.get("rid"))
                for s in buf.spans]

    assert len(tsrv.trace) > 0
    assert spans(tsrv.trace) == spans(srv.trace)


def test_later_slice_features_raise(models):
    tparams = models[2]
    tcfg = tget_config("gpt2-large").reduced(**REDUCED)
    for kw, algo in (({"anchor_shards": 2}, "gtrac"),
                     ({"gossip_enabled": True}, "gtrac"),
                     ({"hedge_enabled": True}, "gtrac"),
                     ({"control_plane": "procs"}, "gtrac")):
        with pytest.raises(NotImplementedError, match="later slice"):
            TGTRACPipelineServer(tcfg, tparams, layers_per_stage=2,
                                 gcfg=TGTRACConfig(**kw), algorithm=algo,
                                 device="cpu")

"""The routed entry: the paper's system, ``GTRACPipelineServer.submit``
and ``run_queue`` (window-batched K-best routing, chunked prefill
windows, one decode token per stream per window, stage forwards that
recompute every stream's prefix).

One server serves the whole window, so trust learns as in a deployment.
The harness installs its hooks on that server instance and nowhere else:

* ``router.route_window`` (once per routing window): the window's
  boundary, where the window closes (``WindowClosed`` ends ``run_queue``
  from outside); the streams in flight; the router's time on the
  critical path (``route_ms``: its wall time, less the wait for the
  stage work queued before it, which a CUDA event recorded at its call
  marks; nothing is synchronised for it); the table, floors and plans
  the comparison holds against the plain K-best reference;
* ``router.submit``: each request's trust floor;
* every stage function: a count of stage forwards, repairs included, and
  in the traced slice each forward's (B, S, layers) for K3's bound, the
  layers those of the stage that launch it (the model module's
  ``attention_layers``);
* ``_emit_token``: each token's wall time (inter-token gaps);
* ``_finish_stream``: which streams ended in the window.

Requests arrive open-loop in the simulation's clock; the server's
simulation seed is the run's seed. Set-up builds the kernels, makes the
server, and warms the shapes the cell uses: one whole chain forward at
the shortest and at the longest prefix the mix can reach, and one K-best
window on a router of its own.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import traffic
from portbench.harness import Run, Stream, WindowClosed, span

#: cycles of the mix submitted ahead; more follow if the queue drains
CYCLES_AHEAD = 8
#: kernels the routed path launches on the card
SOURCES = ("flash_attention.cu", "tropical_route.cu")


def serve(run: Run) -> None:
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.serving.api import SubmitSpec
    from repro_torch.serving.gtrac_serve import GTRACPipelineServer

    rec, cfg, mix, win = run.record, run.cfg, run.mix, run.window
    split = rec.setup_split
    cuda = torch.device(run.device).type == "cuda"
    if cuda:
        from repro_torch.kernels.build import build_all
        t = time.perf_counter()
        build_all(SOURCES)
        split["build_s"] = time.perf_counter() - t
    dep = run.config["deployment"]
    gcfg = GTRACConfig(**run.config.get("gtrac", {}))
    t = time.perf_counter()
    server = GTRACPipelineServer(
        cfg, run.params, layers_per_stage=int(dep["layers_per_stage"]),
        replicas=dict(dep["replicas"]), gcfg=gcfg, seed=int(mix["sim_seed"]),
        device=run.device, router_backend="auto")
    _warm(run, server, gcfg)
    run.profiler.warm()
    split["warmup_s"] = time.perf_counter() - t
    rec.check.update(per_step_capacity=True, plans=[],
                     gtrac={"timeout_ms": gcfg.request_timeout_ms,
                            "k_best": gcfg.k_best_routes})

    streams = {}
    layers_of = [run.model.attention_layers(cfg, s, e)
                 for s, e in (server.partition.segment(i) for i in
                              range(server.partition.n_stages))]

    def wrap_stage(i, fn):
        def stage(payload):
            rec.forwards += 1
            if run.profiler.active:
                B, S = payload[0].shape
                run.profiler.shapes.append(("k3", int(B), int(S),
                                            layers_of[i]))
            with span(run, "portbench.stage_forward"):
                out = fn(payload)
            if "identity_stage" in run.faults and i == 1:
                return payload[0], payload[1]      # a planted fault
            return out
        return stage

    server.stage_fns = [wrap_stage(i, f)
                        for i, f in enumerate(server.stage_fns)]
    taus = {}
    submit0 = server.router.submit

    def submit(request_id, tau=None, warm_ids=None):
        taus[request_id] = gcfg.trust_floor if tau is None else float(tau)
        submit0(request_id, tau, warm_ids)
    server.router.submit = submit
    route0 = server.router.route_window

    def route_window(table):
        win.boundary()
        rec.in_flight.append(sum(not streams[r].finished for r in admitted))
        t0 = time.perf_counter()
        if cuda:
            # completes when the stage work queued so far has run: prefill
            # chunks leave theirs queued, and the router's read-back waits
            # for it
            queued = torch.cuda.Event(enable_timing=True)
            queued.record()
        with span(run, "portbench.route_window"):
            plans = route0(table)
        took = time.perf_counter() - t0
        if cuda:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            done.synchronize()           # the router has read back: idle
            took = min(took, queued.elapsed_time(done) / 1e3)
        if "alter_plan" in run.faults:
            for p in plans.values():             # a planted fault
                if p.costs:
                    p.costs[0] += 1.0
        rec.route_s += took
        rec.route_calls += 1
        snap = {k: np.array(getattr(table, k)) for k in (
            "layer_start", "layer_end", "trust", "latency_ms", "alive")}
        rec.check["plans"].append((snap, [
            (taus[rid], [list(c) for c in p.chain_rows], list(p.costs))
            for rid, p in plans.items()]))
        return plans
    server.router.route_window = route_window
    emit0 = server._emit_token

    def emit(req, tok, t_emit):
        if "alter_token" in run.faults and len(req.output) == 3:
            tok = (int(tok) + 1) % cfg.vocab_size   # a planted fault
        emit0(req, tok, t_emit)
        s = streams[req.request_id]
        s.output.append(int(tok))
        s.emit_s.append(win.now())
        s.logits.append(last_logits.pop(req.request_id, None))
    server._emit_token = emit
    finish0 = server._finish_stream

    def finish(req):
        finish0(req)
        s = streams[req.request_id]
        s.finished = True
        m = req.metrics
        s.sim_failed = bool(m.failures or m.infeasible)
    server._finish_stream = finish
    next0 = server.admission.next_window

    admitted = []

    def next_window(capacity=None, now=None):
        got = next0(capacity=capacity, now=now)
        rec.attempted += len(got)
        admitted.extend(r.request_id for r in got)
        return got
    server.admission.next_window = next_window

    reqs = {}
    cycle = 0
    # the last stage's logits of each stream's latest successful chain:
    # a decode step's, or the final prefill chunk's for the first token
    last_logits = {}

    def capture(req):
        execute0 = req.executor.execute

        def execute(chain, table, payload=None, tau=None, plan=None):
            report, out = execute0(chain, table, payload=payload, tau=tau,
                                   plan=plan)
            if report.success:
                last_logits[req.request_id] = out[1]
            return report, out
        req.executor.execute = execute

    def submit_cycles():
        nonlocal cycle
        for _ in range(CYCLES_AHEAD):
            for it in traffic.routed_cycle(mix, run.seed, cycle,
                                           cfg.vocab_size, len(reqs)):
                req = server.submit(SubmitSpec(
                    prompt=it.prompt, max_new_tokens=it.max_new_tokens,
                    arrival_time=it.arrival_s))
                reqs[req.request_id] = req
                capture(req)
                streams[req.request_id] = Stream(it.prompt,
                                                 it.max_new_tokens)
            cycle += 1

    submit_cycles()
    win.open()
    run.setup_s = win.t_open - run.t_start
    try:
        while True:
            server.run_queue()
            submit_cycles()            # drained before the close
    except WindowClosed:
        pass
    except Exception:                 # the program raised: not correct
        import traceback
        rec.errors.append(traceback.format_exc())
        win.close_now()
    finally:
        server.close()
    for rid in admitted:
        req, s = reqs[rid], streams[rid]
        s.prefill_tokens = int(req.metrics.prefill_tokens)
        s.warm_hits = int(req.metrics.kv_warm_hits)
        s.cold_steps = int(req.metrics.kv_cold_steps)
        rec.streams.append(s)
        P0 = len(s.prompt)
        rec.flops += run.model.span_flops(cfg, 0, s.prefill_tokens,
                                          head_last=s.prefill_tokens == P0)
        rec.flops += sum(run.model.token_flops(cfg, P0 + j - 1, True)
                         for j in range(1, len(s.output)))
    del server
    if cuda:
        torch.cuda.synchronize()


def _warm(run: Run, server, gcfg) -> None:
    """Every shape the cell uses: a whole chain at the shortest and the
    longest prefix of the mix, and one K-best window (K1 on the card) on
    a router and planner of its own, so the server's caches stay cold."""
    from repro_torch.core.planner import RoutePlanner
    from repro_torch.serving.batch_router import BatchRouter
    mix, cfg = run.mix, run.cfg
    longest = int(mix["total_tokens"]["hi"])
    if not mix["total_tokens"].get("minus_output", False):
        longest += int(mix["output_tokens"]["hi"])
    gen = torch.Generator(device=run.device).manual_seed(1)
    for S in (int(gcfg.prefill_chunk_tokens), longest):
        toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                             device=run.device)
        payload = (toks, None)
        for fn in server.stage_fns:
            payload = fn(payload)
        int(torch.argmax(payload[1][:, -1, :], -1)[0])
    planner = RoutePlanner(cfg.num_layers, k_best=gcfg.k_best_routes)
    router = BatchRouter(planner=planner, cfg=gcfg,
                         total_layers=cfg.num_layers, backend="auto",
                         device=run.device)
    router.submit(-1, None)
    router.route_window(server.seeker.view())

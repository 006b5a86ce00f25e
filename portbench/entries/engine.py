"""The engine entry: the KV-cache engine, ``ServingEngine.submit`` and
``run_batch`` (static batches grouped by prompt length, one prefill with
kernel K3, then one decode step per token with kernel K4 through the
cache). It bypasses the router, the executor and the prefix recompute.

Requests come in a closed loop: a batch is submitted when the previous
one has been served. The harness installs its hooks on the engine
instance: ``_prefill`` and ``_decode`` are the window's boundaries (the
window closes at the first one at or after its length) and mark the
emission of the step before (the engine emits a step's tokens after
reading them back, just before it calls the next step); in the traced run
each decode step is timed to its end (``decode_step_ms``) and each
call's shape is recorded for the kernels' bounds, with the model's layers
that launch them (the model module's ``attention_layers``). Set-up builds
the kernels, makes the engine and warms one batch at the longest prompt
of the mix through its prefill and a few decode steps.
"""
from __future__ import annotations

import time

import torch

from portbench import traffic
from portbench.harness import Run, Stream, WindowClosed, span

SOURCES = ("flash_attention.cu", "decode_attention.cu")
WARM_DECODE_STEPS = 4


def serve(run: Run) -> None:
    from repro_torch.serving.api import SubmitSpec
    from repro_torch.serving.engine import ServingEngine

    rec, cfg, mix, win = run.record, run.cfg, run.mix, run.window
    split = rec.setup_split
    cuda = torch.device(run.device).type == "cuda"
    if cuda:
        from repro_torch.kernels.build import build_all
        t = time.perf_counter()
        build_all(SOURCES)
        split["build_s"] = time.perf_counter() - t
    batch = int(mix["batch"])
    t = time.perf_counter()
    engine = ServingEngine(cfg, run.params, max_batch=batch,
                           device=run.device)
    _warm(run, engine, batch)
    run.profiler.warm()
    split["warmup_s"] = time.perf_counter() - t

    attn_layers = run.model.attention_layers(cfg, 0, cfg.num_layers)
    marks = []                   # emission times of the batch's steps
    prefill0, decode0 = engine._prefill, engine._decode
    last = {}

    def prefill(params, toks, cap):
        win.boundary()
        if run.profiler.active:
            B, S = toks.shape
            run.profiler.shapes.append(("k3", int(B), int(S),
                                        attn_layers))
        with span(run, "portbench.prefill"):
            return prefill0(params, toks, cap)

    def decode(params, token, cache):
        marks.append(win.now())
        win.boundary()
        if "stuck_decode" in run.faults and "out" in last:
            return last["out"]                    # a planted fault
        index = int(cache["index"])
        if run.profiler.active:
            run.profiler.shapes.append(("k4", int(token.shape[0]),
                                        index + 1, attn_layers))
        t0 = time.perf_counter()
        with span(run, "portbench.decode_step"):
            out = decode0(params, token, cache)
        if run.trace:
            torch.cuda.synchronize()
            rec.decode_steps.append(time.perf_counter() - t0)
        last["out"] = out
        return out

    engine._prefill, engine._decode = prefill, decode
    win.open()
    run.setup_s = win.t_open - run.t_start
    cycle = 0
    try:
        while True:
            for items in traffic.engine_cycle(mix, run.seed, cycle,
                                              cfg.vocab_size):
                win.boundary()
                reqs = [engine.submit(SubmitSpec(
                    prompt=it.prompt, max_new_tokens=it.max_new_tokens))
                    for it in items]
                streams = [Stream(it.prompt, it.max_new_tokens)
                           for it in items]
                rec.attempted += len(reqs)
                rec.streams += streams
                marks.clear()
                last.clear()
                try:
                    engine.run_batch(engine.admission.next_window())
                    marks.append(win.now())
                finally:
                    _collect(run, reqs, streams, marks)
            cycle += 1
    except WindowClosed:
        pass
    except Exception:                 # the program raised: not correct
        import traceback
        rec.errors.append(traceback.format_exc())
        win.close_now()
    del engine
    if cuda:
        torch.cuda.synchronize()


def _collect(run: Run, reqs, streams, marks) -> None:
    """Each request's tokens, their emission times (step t's tokens at
    mark t) and the served work's operations."""
    cfg, rec, model = run.cfg, run.record, run.model
    served_prefill = bool(marks)
    for req, s in zip(reqs, streams):
        out = list(req.output)
        if "alter_token" in run.faults and len(out) > 3:
            out[3] = (out[3] + 1) % cfg.vocab_size   # a planted fault
        s.output = out[:len(marks)]
        s.emit_s = list(marks[:len(s.output)])
        s.finished = bool(req.done)
        P0 = len(s.prompt)
        if served_prefill:
            s.prefill_tokens = P0
            rec.flops += model.span_flops(cfg, 0, P0, head_last=True)
        decode = sum(model.token_flops(cfg, P0 + j - 1, True)
                     for j in range(1, len(s.output)))
        rec.flops += decode
        rec.decode_flops += decode


def _warm(run: Run, engine, batch: int) -> None:
    """One batch at the longest prompt of the mix through its prefill and
    a few decode steps, on the program's own model calls."""
    mix, cfg = run.mix, run.cfg
    longest = int(mix["total_tokens"]["hi"])
    if mix["total_tokens"].get("minus_output", False):
        longest -= int(mix["output_tokens"]["lo"])
    gen = torch.Generator(device=run.device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, longest), generator=gen,
                         device=run.device)
    with torch.inference_mode():
        logits, cache = engine.model.prefill(
            run.params, tokens=toks,
            capacity=longest + WARM_DECODE_STEPS + engine.margin)
        for _ in range(WARM_DECODE_STEPS):
            cur = torch.argmax(logits[:, -1], -1)[:, None]
            logits, cache = engine.model.decode_step(run.params, cur, cache)
        torch.argmax(logits[:, -1], -1).tolist()
    del logits, cache

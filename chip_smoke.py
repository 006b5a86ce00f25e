#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases, each of which fails the run (non-zero exit) when it fails:

1. build  — compiles the hand-written kernels from ``src/repro_torch/csrc``
   with nvcc for sm_90a, in parallel (one nvcc per source).
2. kernels — holds each kernel against its plain PyTorch version on the
   card: K1 ``tropical_route_kbest`` exactly (distK, pedge, prank equal bit
   for bit) at the serving shapes (P = 108, L = 36, K = 4, R in {1, 8, 64}),
   on tie-forcing integer costs, on all-INF rows and on the overlapping
   3/6/9-layer testbed topology; K2 ``tropical_route`` exactly (dist with
   +inf, and pred) on the serving topology and the scaling testbeds
   (N in {50, 200, 1000}) at R in {1, 64, 512}, on float, tie-forcing and
   all-INF costs, and on a topology where every peer ends at one boundary
   (the +inf case); K3 ``flash_attention`` within 2e-4 (f32) / 2e-2 (bf16)
   absolute at Hq = Hkv = 20, D = 64, S in {8, 100, 128, 300, 1024}, plus
   GQA and non-causal shapes. Each kernel is timed beside its plain version
   and its bound (and K3 beside ``scaled_dot_product_attention``, a
   yardstick the port never calls).
3. main path — full-width GPT-2 Large (36 layers, d_model 1280, vocab
   50257, random weights from a seed) served through
   ``GTRACPipelineServer.submit`` + ``run_queue`` with ``attn_impl="flash"``,
   two layers per stage (18 stages x 6 replicas = 108 peers), the router
   backend ``auto`` (the K1 kernel) and disaggregated prefill: three 8-token
   prompts and one 200-token prompt, 16 new tokens each. Fails unless every
   stream emits its 16 tokens, K1 launched once per window that ran the DP,
   and K3 once per layer of every stage forward.
4. f32 parity — the same run in float32 activations through the kernels,
   and through the plain path (``attn_impl="xla"``, router backend
   ``torch``) on the card: the tokens must be identical.
5. routing — wall time per window of the batched K-best DP for the kernel,
   the plain torch DP and the host numpy DP at R in {1, 8, 64}.
6. profile — ``torch.profiler`` over a short main-path run: the device's
   busy share of the wall time, the top kernels by device time, and the
   hand-written kernels' device-only time per launch.
7. decision time — the paper's Fig. 7 on this machine: median and p99 ms
   per routing decision against network size (scaling testbed, N in {50,
   100, 200, 500, 1000}) for G-TRAC (warm planner), sp, mr, larac, the
   heap-Dijkstra baseline and naive (2 s deadline, few repetitions); then
   ``route_batched`` per call and per request at R in {64, 512} through K2
   and through the plain torch DP. Fails unless K2 launched in that run and
   both give the same routes.
8. SSR — the paper's Fig. 3: ``run_workload`` for each of the five routing
   policies on the 336-peer paper testbed at 10, 20 and 50 tokens per
   request: SSR, its Wilson CI and the share of honeypot peers selected.
   Fails unless G-TRAC completes more requests than sp and naive.
9. generate per algorithm — full-width GPT-2 Large (bf16, K3 attention)
   through ``GTRACPipelineServer.generate`` under each policy: tokens,
   failures, repairs, infeasible, wall time and K3 launches (one per layer
   of every stage forward). In f32 the kernel path's tokens and
   ServeMetrics must equal the plain path's for every policy.

The last lines are the card's name and power limit (nvidia-smi), one JSON
line ``{"kernels": [...]}`` and the result line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate,
#: FP32 outside the tensor cores, bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

DEVICE = "cuda"
SEED = 0
NEW_TOKENS = 16
LONG_PROMPT = 200
SHORT_PROMPT = 8
N_SHORT = 3
ALGORITHMS = ("gtrac", "sp", "mr", "naive", "larac")
GEN_REQUESTS = 4
GEN_TOKENS = 4
#: the K2 timing row the kernels line reports: (topology, R)
K2_ROW = ("scaling1000", 64)


def sync() -> None:
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back calls
    (CUDA events around the whole run, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20):
    """Device-only time per launch of the kernel named ``kernel`` over
    ``iters`` calls of ``fn``, from ``torch.profiler``; None when the
    profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and f"{kernel}(" in e.key:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0)
            return t / 1e3 / e.count
    return None


def wall_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median host wall time of ``fn()`` in ms (fn must end synchronised)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(["tropical_route.cu", "flash_attention.cu"])
    secs = time.perf_counter() - t0
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"ptxas {src}: {line.strip()}")
    log({"phase": "build", "seconds": round(secs, 3),
         "sources": sorted(logs)})


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def serving_topology(L: int = 36, layers_per_stage: int = 2,
                     replicas: int = 6):
    """(starts, ends) of the main path's peers: one row per stage replica."""
    import numpy as np
    starts, ends = [], []
    for s in range(0, L, layers_per_stage):
        for _ in range(replicas):
            starts.append(s)
            ends.append(min(L, s + layers_per_stage))
    return np.array(starts, np.int32), np.array(ends, np.int32)


def testbed_topology(L: int = 36, segments=(3, 6, 9), replicas: int = 4):
    import numpy as np
    starts, ends = [], []
    for seg in segments:
        for s in range(0, L, seg):
            for _ in range(replicas):
                starts.append(s)
                ends.append(min(L, s + seg))
    return np.array(starts, np.int32), np.array(ends, np.int32)


def k1_inputs(starts, ends, R: int, kind: str, rng):
    import numpy as np
    import torch
    from repro_torch.kernels.tropical_route import INF
    P = len(starts)
    if kind == "float":
        costs = rng.uniform(10.0, 300.0, size=(R, P)).astype(np.float32)
        costs[rng.random((R, P)) < 0.3] = INF           # trust-pruned peers
    elif kind == "ties":
        costs = rng.integers(1, 4, size=(R, P)).astype(np.float32)
        costs[rng.random((R, P)) < 0.2] = INF
    else:                                                # all pruned
        costs = np.full((R, P), INF, np.float32)
    dev = torch.device(DEVICE)
    return (torch.as_tensor(starts, device=dev),
            torch.as_tensor(ends, device=dev),
            torch.as_tensor(costs, device=dev))


def k1_bound_ms(R: int, P: int, L: int, K: int, ends) -> tuple:
    """Least time for the DP on this card: every input read once and every
    output written once, against the f32 operations the K-round selection
    needs (one add per candidate, K compares per candidate)."""
    nbytes = 4 * (2 * P + R * P + 3 * R * (L + 1) * K)
    n_cand = R * K * sum(1 for e in ends if 1 <= e <= L)
    ops = n_cand + K * n_cand
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def phase_k1():
    import numpy as np
    import torch
    from repro_torch.kernels import tropical_route as tr
    L, K = 36, 4
    rng = np.random.default_rng(SEED)
    cases = [("serving", serving_topology(), R, kind)
             for R in (1, 8, 64) for kind in ("float", "ties")]
    cases += [("serving", serving_topology(), 4, "allinf"),
              ("testbed", testbed_topology(), 16, "float"),
              ("testbed", testbed_topology(), 16, "ties")]
    err = 0.0
    for topo, (starts, ends), R, kind in cases:
        s, e, c = k1_inputs(starts, ends, R, kind, rng)
        got = tr.tropical_route_kbest_cuda(s, e, c, total_layers=L, k_best=K)
        want = tr.tropical_route_kbest_plain(s, e, c, total_layers=L,
                                             k_best=K)
        for name, g, w in zip(("distK", "pedge", "prank"), got, want):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"K1 {topo} R={R} {kind}: {name} "
                                     f"differs in {bad} entries")
        err = max(err, float((got[0] - want[0]).abs().max()))
        feas = int((got[0][:, L, 0] < 1e38).sum())
        log(f"K1 exact: {topo} P={len(starts)} R={R} {kind} "
            f"(feasible rows {feas}/{R})")
    # timings at the serving shapes
    starts, ends = serving_topology()
    P = len(starts)
    rows = {}
    for R in (1, 8, 64):
        s, e, c = k1_inputs(starts, ends, R, "float", rng)
        ms = cuda_ms(lambda: tr.tropical_route_kbest_cuda(
            s, e, c, total_layers=L, k_best=K), iters=200)
        plain = cuda_ms(lambda: tr.tropical_route_kbest_plain(
            s, e, c, total_layers=L, k_best=K), iters=20)
        bound, by = k1_bound_ms(R, P, L, K, ends)
        rows[R] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                   "bound_by": by, "max_abs_err": err}
        log({"k1_time": {"R": R, "P": P, "L": L, "K": K, **rows[R]}})
    return rows


def k2_topologies():
    """(name, starts, ends) of K2's cases: the main path's serving
    topology, the scaling testbeds of the decision-time experiment, and a
    topology where every peer spans [1, 2) (boundary 1 unreachable, so
    all-INF costs give INF + INF = +inf at boundary 2)."""
    import numpy as np
    from repro_torch.sim.testbed import build_scaling_testbed
    out = [("serving", *serving_topology())]
    for n in (50, 200, 1000):
        t = build_scaling_testbed(n).anchor.snapshot(0.0)
        out.append((f"scaling{n}", t.layer_start.astype(np.int32),
                    t.layer_end.astype(np.int32)))
    out.append(("one-boundary", np.ones(64, np.int32),
                np.full(64, 2, np.int32)))
    return out


def k2_bound_ms(R: int, P: int, L: int, ends) -> tuple:
    """Least time for the single-best DP on this card: every input read
    once and every output written once, against one add and one compare
    per (row, peer ending inside [1, L]) at the FP32 rate."""
    nbytes = 4 * (2 * P + R * P + 2 * R * (L + 1))
    ops = 2 * R * sum(1 for e in ends if 1 <= e <= L)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def phase_k2():
    import numpy as np
    import torch
    from repro_torch.kernels import tropical_route as tr
    L = 36
    rng = np.random.default_rng(SEED + 2)
    n_inf = 0
    for topo, starts, ends in k2_topologies():
        for R in (1, 64, 512):
            for kind in ("float", "ties", "allinf"):
                s, e, c = k1_inputs(starts, ends, R, kind, rng)
                csr = tr.route_csr(s, e, L)
                got = tr.tropical_route_cuda(s, e, c, total_layers=L,
                                             csr=csr)
                want = tr.tropical_route_plain(s, e, c, total_layers=L)
                for name, g, w in zip(("dist", "pred"), got, want):
                    if not torch.equal(g, w):
                        bad = int((g != w).sum())
                        raise AssertionError(f"K2 {topo} R={R} {kind}: "
                                             f"{name} differs in {bad} "
                                             "entries")
                n_inf += int(torch.isinf(got[0]).sum())
                if topo == "one-boundary" and kind == "allinf" and \
                        not bool(torch.isinf(got[0][:, 2]).all()):
                    raise AssertionError("K2 one-boundary: the +inf case "
                                         "was not reached")
        log(f"K2 exact: {topo} P={len(starts)} R in (1, 64, 512) x "
            "(float, ties, allinf)")
    if n_inf == 0:
        raise AssertionError("K2: no +inf entry in any case")
    rows = {}
    for topo, starts, ends in k2_topologies()[:4]:
        P = len(starts)
        for R in (1, 64, 512):
            s, e, c = k1_inputs(starts, ends, R, "float", rng)
            csr = tr.route_csr(s, e, L)
            ms = cuda_ms(lambda: tr.tropical_route_cuda(
                s, e, c, total_layers=L, csr=csr), iters=200)
            plain = cuda_ms(lambda: tr.tropical_route_plain(
                s, e, c, total_layers=L), iters=10)
            bound, by = k2_bound_ms(R, P, L, ends)
            rows[(topo, R)] = {"ms": ms, "plain_ms": plain,
                               "bound_ms": bound, "bound_by": by,
                               "max_abs_err": 0.0, "library_ms": None}
            if R in (1, 512) and topo in ("serving", "scaling1000"):
                rows[(topo, R)]["device_ms_per_launch"] = device_ms(
                    lambda: tr.tropical_route_cuda(s, e, c, total_layers=L,
                                                   csr=csr),
                    "route_kernel")
            log({"k2_time": {"topology": topo, "R": R, "P": P, "L": L,
                             **rows[(topo, R)]}})
    return rows


def k3_bound_ms(B, S, Hq, Hkv, D, dtype, causal) -> tuple:
    """Least time for attention on this card: q, k, v read once and the
    output written once, against the multiply-adds of QK^T and PV over the
    visible (query, key) pairs at the peak rate of the input type."""
    import torch
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = size * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * Hq * D * pairs
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def phase_k3():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    shapes = [(1, S, 20, 20, 64, True)
              for S in (8, 100, 128, 200, 300, 1024)]
    shapes += [(2, 200, 8, 2, 128, True), (2, 96, 4, 2, 32, False),
               (1, 77, 6, 3, 16, True)]
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, Hq, Hkv, D, causal in shapes:
            q = torch.randn((B, S, Hq, D), generator=gen, device=DEVICE,
                            dtype=torch.float32).to(dtype)
            k = torch.randn((B, S, Hkv, D), generator=gen, device=DEVICE,
                            dtype=torch.float32).to(dtype)
            v = torch.randn((B, S, Hkv, D), generator=gen, device=DEVICE,
                            dtype=torch.float32).to(dtype)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            err = float((got.float() - want.float()).abs().max())
            name = str(dtype).replace("torch.", "")
            if not err <= tol[dtype]:
                raise AssertionError(
                    f"K3 {name} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                    f"causal={causal}: max abs err {err} > {tol[dtype]}")
            row = {"dtype": name, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv,
                   "D": D, "causal": causal, "max_abs_err": err}
            if Hq == Hkv == 20 and D == 64:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                row["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(
                    q, k, v, causal=causal), iters=50)
                row["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal), iters=20)
                row["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), iters=50)
                row["bound_ms"], row["bound_by"] = k3_bound_ms(
                    B, S, Hq, Hkv, D, dtype, causal)
                rows[(name, S)] = row
            log({"k3": row})
    return rows


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------


def workload(vocab: int):
    import numpy as np
    from repro_torch.serving.api import SubmitSpec
    rng = np.random.default_rng(SEED)
    lens = [SHORT_PROMPT] * N_SHORT + [LONG_PROMPT]
    return [SubmitSpec(prompt=rng.integers(1, vocab, size=n),
                       max_new_tokens=NEW_TOKENS) for n in lens]


def serve(cfg, params, specs, router_backend="auto"):
    """One server, every spec through submit + run_queue. Returns
    (server, served requests, wall seconds, stage forwards)."""
    import torch
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.serving.gtrac_serve import GTRACPipelineServer
    srv = GTRACPipelineServer(
        cfg, params, layers_per_stage=2,
        # golden replicas registered first: equal initial costs tie-break
        # toward them, so every stream completes; the honeypot and turtle
        # replicas stay in the routing table (P = 108)
        replicas={"golden": 2, "turtle": 2, "honeypot": 2},
        gcfg=GTRACConfig(disaggregate=True), seed=SEED, device=DEVICE,
        router_backend=router_backend)
    calls = [0]

    def counted(fn):
        def wrapped(payload):
            calls[0] += 1
            return fn(payload)
        return wrapped

    srv.stage_fns = [counted(f) for f in srv.stage_fns]
    for spec in specs:
        srv.submit(spec)
    sync()
    t0 = time.perf_counter()
    done = srv.run_queue()
    sync()
    return srv, done, time.perf_counter() - t0, calls[0]


def phase_main(cfg, params):
    from repro_torch.kernels import ops
    specs = workload(cfg.vocab_size)
    serve(cfg, params, workload(cfg.vocab_size)[:1])      # warm-up run
    ops.reset_launch_counts()
    srv, done, wall, forwards = serve(cfg, params, specs)
    counts = ops.launch_counts()
    toks = sum(r.metrics.tokens for r in done)
    for r in done:
        if r.metrics.tokens != NEW_TOKENS or len(r.output) != NEW_TOKENS:
            raise AssertionError(f"stream {r.request_id} emitted "
                                 f"{r.metrics.tokens}/{NEW_TOKENS} tokens "
                                 f"({r.metrics.failures} failures)")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"stream {r.request_id}: token out of "
                                 f"range in {r.output}")
    st = srv.router.stats
    per_stage = cfg.num_layers // srv.partition.n_stages
    want_k3 = forwards * per_stage
    if counts["tropical_route_kbest"] != st.device_calls or \
            st.device_calls < 1:
        raise AssertionError(f"K1 launched {counts['tropical_route_kbest']}"
                             f" times for {st.device_calls} routed windows")
    if counts["flash_attention"] != want_k3 or want_k3 < 1:
        raise AssertionError(f"K3 launched {counts['flash_attention']} "
                             f"times for {forwards} stage forwards x "
                             f"{per_stage} layers")
    log({"main_path": {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "activation_dtype": cfg.activation_dtype,
        "peers": len(srv.seeker.view()), "streams": len(done),
        "tokens": toks, "wall_s": wall, "tokens_per_s": toks / wall,
        "windows": st.windows, "dp_windows": st.device_calls,
        "stage_forwards": forwards,
        "prefill_chunks": sum(r.metrics.prefill_chunks for r in done),
        "launches": counts}})
    return srv, counts, toks / wall


def phase_f32_parity(cfg, params):
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    plain = dataclasses.replace(cfg32, attn_impl="xla")
    specs = workload(cfg.vocab_size)
    _, kdone, kwall, _ = serve(cfg32, params, specs)
    _, pdone, pwall, _ = serve(plain, params, workload(cfg.vocab_size),
                               router_backend="torch")
    for a, b in zip(kdone, pdone):
        if a.output != b.output or a.metrics.tokens != NEW_TOKENS:
            raise AssertionError(f"f32 tokens differ for stream "
                                 f"{a.request_id}: kernels {a.output} vs "
                                 f"plain {b.output}")
    log({"f32_parity": {"streams": len(kdone), "equal": True,
                        "kernel_path_s": kwall, "plain_path_s": pwall}})


def phase_routing(srv):
    import numpy as np
    from repro_torch.serving.batch_router import plan_batched
    table = srv.seeker.view()
    out = {}
    for R in (1, 8, 64):
        taus = np.linspace(0.5, 0.99, R)
        row = {}
        for backend in ("kernel", "torch", "numpy"):
            row[backend] = wall_ms(lambda: plan_batched(
                table, srv.cfg.num_layers, srv.gcfg, taus,
                planner=srv.planner, backend=backend, device=srv.device),
                iters=15 if backend == "torch" else 40)
        ref = plan_batched(table, srv.cfg.num_layers, srv.gcfg, taus,
                           planner=srv.planner, backend="numpy",
                           device=srv.device)
        got = plan_batched(table, srv.cfg.num_layers, srv.gcfg, taus,
                           planner=srv.planner, backend="kernel",
                           device=srv.device)
        for a, b in zip(ref, got):
            if a.chain_rows != b.chain_rows:
                raise AssertionError(f"R={R}: kernel plans differ from the "
                                     "numpy planner's")
        out[R] = row
        log({"routing_wall_ms_per_window": {"R": R, "P": len(table), **row}})
    return out


def phase_profile(cfg, params):
    """Device time by kernel over a short main-path run (two streams, the
    kernels as in phase 3) under ``torch.profiler``: the device's busy
    share of the wall time, the top kernels, and each hand-written
    kernel's device-only time per launch. Prints "not measured" when the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, done, wall, _ = serve(cfg, params, workload(cfg.vocab_size)[:2])
    kernels, ops = {}, {}       # name -> (device ms, calls)
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            # device events are kernels; host ops carry the device time of
            # the kernels they launched (the same time, counted once each)
            side = kernels if e.device_type == DeviceType.CUDA else ops
            side[e.key] = (t / 1e3, e.count)
    if not kernels:
        log({"profile": "not measured (no device activity recorded)"})
        return

    def top(d):
        return [[k[:60], t, n] for k, (t, n) in
                sorted(d.items(), key=lambda kv: -kv[1][0])[:8]]

    busy = sum(t for t, _ in kernels.values())
    ours = {k[:40]: {"device_ms_per_launch": t / n, "launches": n}
            for k, (t, n) in kernels.items()
            if "route_kbest_kernel" in k or "route_kernel(" in k
            or "flash_kernel" in k}
    log({"profile": {
        "wall_s": wall, "tokens": sum(r.metrics.tokens for r in done),
        "device_busy_ms": busy, "device_busy_share": busy / (wall * 1e3),
        "top_ops_ms_calls": top(ops), "top_kernels_ms_calls": top(kernels),
        "hand_kernels": ours}})


# ---------------------------------------------------------------------------
# Phases 7-9: the routing evaluation (decision time, SSR, generate per
# routing policy)
# ---------------------------------------------------------------------------


def wall_stats_ms(fn, iters: int, warmup: int = 1) -> tuple:
    """(median, p99) host wall time of ``fn()`` in ms over ``iters`` calls
    (fn returns host results, so it ends synchronised)."""
    import numpy as np
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), float(np.percentile(times, 99))


def phase_decision():
    """Routing decision time against network size (the paper's Fig. 7),
    and ``route_batched`` — K2's path — per call and per request."""
    import numpy as np
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.core.planner import RoutePlanner
    from repro_torch.core.routing import (gtrac_route, heap_dijkstra_route,
                                          larac_route, mr_route, naive_route,
                                          sp_route)
    from repro_torch.core.routing_torch import route_batched
    from repro_torch.kernels import ops
    from repro_torch.sim.testbed import build_scaling_testbed
    cfg = GTRACConfig()
    rng = np.random.default_rng(SEED)
    table_rows = []
    beds = {}
    for n in (50, 100, 200, 500, 1000):
        bed = build_scaling_testbed(n, cfg=cfg, seed=SEED)
        t = bed.anchor.snapshot(0.0)
        L = bed.total_layers
        planner = RoutePlanner(L, k_best=cfg.k_best_routes,
                               cache_size=cfg.planner_cache_size)
        beds[n] = (t, planner)
        algos = {
            "gtrac": lambda: gtrac_route(t, L, cfg, tau=0.8,
                                         planner=planner),
            "sp": lambda: sp_route(t, L, cfg, planner=planner),
            "mr": lambda: mr_route(t, L, cfg, planner=planner),
            "larac": lambda: larac_route(t, L, cfg, epsilon=0.2,
                                         planner=planner),
            "heap": lambda: heap_dijkstra_route(t, L, cfg, tau=0.8),
            # unbounded DFS with the paper's 2 s timeout (§VI-E)
            "naive": lambda: naive_route(t, L, cfg, rng=rng, limit=None,
                                         deadline_s=2.0),
        }
        row = {"N": n}
        for name, fn in algos.items():
            naive = name == "naive"
            med, p99 = wall_stats_ms(fn, iters=3 if naive else 200,
                                     warmup=0 if naive else 1)
            row[name] = {"median_ms": med, "p99_ms": p99}
        table_rows.append(row)
        log({"decision_ms": row})
    # route_batched through K2 and through the plain torch DP (the
    # launches counted here are K2's path)
    ops.reset_launch_counts()
    batched = []
    for n in (50, 200, 1000):
        t, planner = beds[n]
        for R in (64, 512):
            taus = rng.uniform(0.6, 0.9, R)
            res = {}
            row = {"N": n, "R": R}
            for name, kern in (("kernel", True), ("plain", False)):
                def call(kern=kern):
                    return route_batched(t, 36, cfg, taus, k_max=36,
                                         use_kernel=kern, planner=planner,
                                         device=DEVICE)
                res[name] = call()
                med, p99 = wall_stats_ms(call, iters=20 if kern else 5)
                row[name] = {"ms_per_call": med, "p99_ms": p99,
                             "ms_per_request": med / R}
            for a, b in zip(res["kernel"], res["plain"]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"route_batched N={n} R={R}: "
                                         "kernel and plain routes differ")
            # the host planner (f64 costs) agrees on row 0's feasibility
            # and, to f32 rounding, its cost
            host = gtrac_route(t, 36, cfg, tau=float(taus[0]),
                               planner=planner)
            c0 = float(res["kernel"][1][0])
            if host.feasible != (c0 < 1e38) or (host.feasible and abs(
                    c0 - host.total_cost) > 1e-5 * host.total_cost):
                raise AssertionError(f"route_batched N={n} R={R}: row 0 "
                                     f"cost {c0} vs host planner "
                                     f"{host.total_cost}")
            row["feasible"] = int((res["kernel"][1] < 1e38).sum())
            batched.append(row)
            log({"route_batched": row})
    counts = ops.launch_counts()
    if counts["tropical_route"] < 1:
        raise AssertionError("K2 was not launched by route_batched")
    log({"route_batched_launches": counts})
    return table_rows, batched, counts


def phase_ssr():
    """Completion rate per routing policy on the paper testbed (Fig. 3)."""
    from repro_torch.sim.testbed import build_paper_testbed
    from repro_torch.sim.workload import run_workload, selection_landscape
    out = {}
    for l_tok in (10, 20, 50):
        for algo in ALGORITHMS:
            bed = build_paper_testbed(seed=42)
            run_workload(bed, algo, 15, l_tok=5, epsilon=0.10)   # converge
            st = run_workload(bed, algo, 30, l_tok, epsilon=0.10,
                              request_id_base=1000)
            land = selection_landscape(bed, st)
            lo, hi = st.wilson_ci()
            if not (0.0 <= lo <= st.ssr <= hi <= 1.0):
                raise AssertionError(f"SSR {algo}: {st.ssr} outside its "
                                     f"Wilson CI ({lo}, {hi})")
            sel = land["profile"]
            out[(algo, l_tok)] = st.ssr
            log({"ssr": {"algorithm": algo, "l_tok": l_tok,
                         "requests": len(st.results), "ssr": st.ssr,
                         "wilson_ci": [lo, hi],
                         "honeypot_share": float((sel == "honeypot").mean())
                         if len(sel) else 0.0,
                         "repairs": sum(r.repairs for r in st.results)}})
        for base in ("sp", "naive"):
            if not out[("gtrac", l_tok)] > out[(base, l_tok)]:
                raise AssertionError(f"SSR at l_tok={l_tok}: gtrac "
                                     f"{out[('gtrac', l_tok)]} does not beat "
                                     f"{base} {out[(base, l_tok)]}")
    return out


def generate_run(cfg, params, algo):
    """``GEN_REQUESTS`` 8-token prompts through ``generate`` under ``algo``
    on the main path's server topology. Returns (outputs, metrics, wall s, forwards,
    launch counts)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.gtrac_serve import GTRACPipelineServer
    srv = GTRACPipelineServer(
        cfg, params, layers_per_stage=2,
        replicas={"golden": 2, "turtle": 2, "honeypot": 2}, seed=SEED,
        device=DEVICE, algorithm=algo)
    calls = [0]

    def counted(fn):
        def wrapped(payload):
            calls[0] += 1
            return fn(payload)
        return wrapped

    srv.stage_fns = [counted(f) for f in srv.stage_fns]
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=SHORT_PROMPT)
               for _ in range(GEN_REQUESTS)]
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs, mets = [], []
    for rid, p in enumerate(prompts):
        out, met = srv.generate(p, max_new_tokens=GEN_TOKENS, request_id=rid)
        outs.append(out.tolist())
        mets.append(met)
    sync()
    wall = time.perf_counter() - t0
    return outs, mets, wall, calls[0], ops.launch_counts()


def phase_generate_algorithms(cfg, params):
    """``generate`` under every routing policy at full width: bf16 through
    K3, then f32 parity of the kernel path against the plain path."""
    per_stage = 2
    out = {}
    for algo in ALGORITHMS:
        outs, mets, wall, fwd, counts = generate_run(cfg, params, algo)
        if counts["flash_attention"] != fwd * per_stage or fwd < 1:
            raise AssertionError(f"generate {algo}: K3 launched "
                                 f"{counts['flash_attention']} times for "
                                 f"{fwd} stage forwards x {per_stage} "
                                 "layers")
        for o in outs:
            if not all(0 <= t < cfg.vocab_size for t in o):
                raise AssertionError(f"generate {algo}: token out of range")
        row = {"algorithm": algo, "requests": len(mets),
               "tokens": sum(m.tokens for m in mets),
               "failures": sum(m.failures for m in mets),
               "repairs": sum(m.repairs for m in mets),
               "infeasible": sum(m.infeasible for m in mets),
               "wall_s": wall, "stage_forwards": fwd,
               "k3_launches": counts["flash_attention"]}
        out[algo] = row
        log({"generate": row})
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    plain = dataclasses.replace(cfg32, attn_impl="xla")
    for algo in ALGORITHMS:
        k_outs, k_mets, k_wall, _, _ = generate_run(cfg32, params, algo)
        p_outs, p_mets, p_wall, _, _ = generate_run(plain, params, algo)
        if k_outs != p_outs or [dataclasses.asdict(m) for m in k_mets] != \
                [dataclasses.asdict(m) for m in p_mets]:
            raise AssertionError(f"generate {algo} f32: kernel path "
                                 f"{k_outs} vs plain path {p_outs}")
        log({"generate_f32_parity": {"algorithm": algo, "equal": True,
                                     "tokens": sum(m.tokens
                                                   for m in k_mets),
                                     "kernel_path_s": k_wall,
                                     "plain_path_s": p_wall}})
    return out


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.models.common import strict_fp32_matmul
    from repro_torch.models.transformer import init_params

    strict_fp32_matmul()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    k3 = phase_k3()

    cfg = dataclasses.replace(get_config("gpt2-large"), attn_impl="flash",
                              remat=False)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg, gen, DEVICE)
    n_params = sum(t.numel() for t in
                   [params["embed"]["tok"], params["embed"]["pos"]]
                   + [w for lp in params["layers"] for d in lp.values()
                      for w in d.values()])
    log(f"gpt2-large: {n_params} parameters (f32) on "
        f"{DEVICE}")
    srv, counts, tps = phase_main(cfg, params)
    phase_f32_parity(cfg, params)
    phase_routing(srv)
    phase_profile(cfg, params)
    _, _, k2_counts = phase_decision()
    phase_ssr()
    phase_generate_algorithms(cfg, params)

    kern = [
        {"name": "tropical_route_kbest", "route": "cuda",
         "source": "src/repro_torch/csrc/tropical_route.cu",
         "replaces": "src/repro/kernels/tropical_route.py:168",
         "launches": counts["tropical_route_kbest"],
         "max_abs_err": k1[1]["max_abs_err"], "ms": k1[1]["ms"],
         "plain_ms": k1[1]["plain_ms"], "bound_ms": k1[1]["bound_ms"],
         "bound_by": k1[1]["bound_by"], "library_ms": None},
        {"name": "tropical_route", "route": "cuda",
         "source": "src/repro_torch/csrc/tropical_route.cu",
         "replaces": "src/repro/kernels/tropical_route.py:65",
         "launches": k2_counts["tropical_route"],
         "max_abs_err": k2[K2_ROW]["max_abs_err"], "ms": k2[K2_ROW]["ms"],
         "plain_ms": k2[K2_ROW]["plain_ms"],
         "bound_ms": k2[K2_ROW]["bound_ms"],
         "bound_by": k2[K2_ROW]["bound_by"], "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:75",
         "launches": counts["flash_attention"],
         "max_abs_err": k3[("bfloat16", 200)]["max_abs_err"],
         "ms": k3[("bfloat16", 200)]["ms"],
         "plain_ms": k3[("bfloat16", 200)]["plain_ms"],
         "bound_ms": k3[("bfloat16", 200)]["bound_ms"],
         "bound_by": k3[("bfloat16", 200)]["bound_by"],
         "library_ms": k3[("bfloat16", 200)]["library_ms"]},
    ]
    log(f"end-to-end: {tps} tokens/s; total {time.perf_counter() - t_start}"
        " s; kernel rows: K1 at R=1, K2 at R=64 on the N=1000 scaling "
        "testbed (its launches: route_batched), K3 at bf16 S=200 (B=1, "
        "H=20, D=64)")
    log(card_line())
    log({"kernels": kern})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

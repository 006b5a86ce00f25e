#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases, each of which fails the run (non-zero exit) when it fails (they
run in the order 1, 15, 14, 10, 2, 18's and 19's kernel checks, 11-13, 3,
4, 16, 17, 5-9, the rest of 18, the rest of 19, 20, 21, 22: the engine paths
first, so that a fault there shows before the long routing phases, and
the kernel checks early, where ``torch.profiler`` still records their
device time):

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
   (the +inf case); the fused window entries ``route_window_kbest`` and
   ``route_window`` (effective costs, DP and backtrack in one launch)
   exactly against their plain compositions on the serving topology, the
   3/6/9 testbed and scaling1000 (and the one-boundary +inf topology),
   R in {1, 8, 64, 512}, on float, tie and all-INF costs; K1's and K2's
   rows (kernel entry and window entry) timed per call and on the device
   beside an empty kernel's launch floor and a dependency-chain estimate;
   K3 ``flash_attention`` within 2e-4 (f32) / 2e-2 (bf16)
   absolute at Hq = Hkv = 20, D = 64, S in {8, 100, 128, 300, 1024}, plus
   GQA and non-causal shapes and the engine's prefill shapes (GPT-2 Large
   B = 4, S = 1024; TinyLlama B = 4, S = 2048, Hq = 32, Hkv = 4; Zamba2's
   shared block B = 4, S = 2048, Hq = Hkv = 32, D = 80; each timed per
   call and on the device). Each kernel is timed beside its plain version
   and its bound (and K3 beside ``scaled_dot_product_attention``, a
   yardstick the port never calls). Every K3 row names the kernel that
   served it (``flash_kernel``: bf16 at D = 64, 80, 128 on wgmma, at
   D = 16, 32 on mma.sync, f32 on FP32 FMAs), and each row timed on the
   device fails unless ``torch.profiler`` saw that kernel and no other K3
   kernel. The build logs ptxas's registers and spills of every kernel and
   each K3 / K4 instantiation's dynamic shared memory (``kernel_smem``).
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
   the plain torch DP and the host numpy DP at R in {1, 8, 64}, and the
   kernel backend's kernel launches and copies per window
   (``torch.profiler``, over 200 windows): fails if a window launches K1
   other than once (its counter), runs more than 2 kernels or more than
   one device-to-host copy, or plans other than the numpy backend.
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
10. K4 — ``decode_attention`` against its plain version on the card within
   2e-4 (f32) / 2e-2 (bf16) absolute: GPT-2 Large's decode shape (B = 4,
   Hq = Hkv = 20, D = 64, S = 1120, kv_len in {1, 37, 1056, 1120}),
   TinyLlama's (B = 4, Hq = 32, Hkv = 4, D = 64, S = 2144), Zamba2's
   (B = 4, Hq = Hkv = 32, D = 80, S = 2144, kv_len 2080), a ragged
   S = 1000 and small shapes; each timed beside its plain version, its
   bound and ``scaled_dot_product_attention`` with a live mask (a
   yardstick the port never calls), per call and on the device (the split
   and the combine kernel together), with its split plan; the four
   engine shapes again with kv_len = 1, on the first split boundary of
   each dtype's plan, = S and in the middle (``*-splits`` rows). Every
   row names its split kernel (``decode_plan``: the tensor-core kernel for
   bf16 at D = 64, 80, 128, else the FMA kernel), and a timed row fails
   unless the profiler saw it.
11. KV-cache engine — ``ServingEngine.run_batch`` at full width, bf16,
   ``attn_impl="flash"``: zamba2-2.7b (54 Mamba2 blocks and 9 applications
   of its shared block, 2,396,455,840 parameters, random weights from the
   seed) and rwkv6-1.6b (24 layers) with 4 prompts of 8 tokens and 4 of
   2048 each, gpt2-large with 4 of 8 and 4 of 1024, tinyllama-1.1b with 4
   of 2048, 32 new tokens each, after a warm-up run of the same requests.
   Fails unless every stream gets its tokens, the cache's bytes equal
   ``cache_bytes``, and for the dense models K4 launched once per layer of
   every decode step and K3 once per layer of every prefill (K5 and K6
   never), for RWKV6 K5 once per layer of every prefill (48) and no other
   kernel, for Zamba2 K6 once per Mamba2 block of every prefill (108), K3
   once per shared-block application of every prefill (18), K4 once per
   application of every decode step (558) and K5 never. Reports tokens/s,
   prefill ms, decode ms per step and peak device memory.
12. engine f32 parity — the same engine in float32 through the kernels
   and through the plain path (``attn_impl="xla"``) on the card, for a
   gpt2-large.reduced-sized model, full-width TinyLlama, an
   rwkv6-1.6b.reduced-sized model and full-width RWKV6 (two prompts of
   64 tokens and four of 100: across chunks, with a ragged tail), a
   zamba2-2.7b.reduced-sized model (two groups of two blocks) and
   full-width Zamba2 (prompts of 8 and 100 tokens), 8 new tokens: the
   greedy tokens must be identical (else the top-2 logit margin at the
   first differing step is printed and the run fails), and full-width
   RWKV6's prefills must have run both of K5's designs, Zamba2's K6's
   Hopper kernels (``ScanLog``).
13. engine profile — ``torch.profiler`` over one prefill of each model's
   longest prompts (4 x 2048; GPT-2 Large 4 x 1024) and over 8 decode
   steps after it: the device's busy share and K3's, K4's, K5's and K6's
   device time (K4's, K5's and K6's two kernels each together) against
   the weight casts and the matmuls.
14. K5 — ``wkv6_chunked`` against its plain version on the card: the
   engine's prefill shape (B = 4, S = 2048, H = 32, K = 64) on model-like
   inputs within 1e-4 x max|plain|, and within 5e-4 absolute on the
   reference test's distribution: B = 4 S = 8, a ragged S = 1000, a
   nonzero state0, lw = -20 and the three shapes of
   ``tests/test_kernels.py``; the engine's widths at B = 2 and 3, each side
   of ``WGMMA_MIN_BLOCKS``; y and the final state, each shape timed
   beside its plain version and its bound, per call and on the device
   (each of the call's kernels apart: ``wkv6_wgmma_kernel`` alone at
   K = 64, the mma.sync pre-pass and scan at K = 8, 16, 32; a row fails unless
   the profiler saw exactly the kernels ``scan_kernel`` names), with the
   scan's grid, blocks per SM and waves; then both designs at K = 64 and
   RWKV6's H = 32, B = 1 to 4 and S = 100, 512, 2048, each checked and
   timed on the device beside the one the wrapper picks there
   (``k5_dispatch``: where they cross sets ``WGMMA_MIN_BLOCKS``).
15. K6 — ``ssd_chunked`` against its plain version on the card: the
   Zamba2 engine's prefill shape (B = 4, S = 2048, H = 80, P = N = 64) on
   model-like inputs within 1e-4 x max|plain|, and on the reference test's
   distribution within 1e-5 x max|plain| at the engine's widths (B = 4
   S = 8, a ragged S = 1000, a nonzero h0, la = -20 dt) and 5e-4 absolute
   at the two shapes of ``tests/test_kernels.py``;
   y and the final state, each shape timed beside its plain version and
   its bound (with both the bytes and the operations figure), per call and
   on the device (the pre-pass and the scan together, and each apart:
   ``ssd_gram_kernel`` and ``ssd_wgmma_kernel`` at (64, 64), the mma.sync
   pre-pass and scan at the kernel test's shapes; a row fails unless the
   profiler saw exactly the kernels ``scan_kernel`` names), with the
   scan's grid, blocks per SM and waves.
16. hybrid trust — the paper's Hybrid Trust Architecture: phase 3's
   workload and weights served on a 4-shard anchor with the gossip sync
   plane and the relay plane over 8 seekers, so K1 plans every window on
   gossip seeker 0's ``routing_view``. Fails unless every stream emits its
   16 tokens, K1 launched once per window that ran the DP, K3 once per
   layer of every stage forward, the table holds 108 peers, at least one
   gossip round ran, the relay convicted nobody (no digest mismatch,
   quarantine or heartbeat rejection on this honest run) and seeker 0
   reaches the anchor's version vector; logs tokens/s beside phase 3's and
   the host ms per window of ``maybe_tick`` and ``routing_view``. A
   gossip-path window (report, sync tick, view, DP) must run one kernel
   and one copy each way (``torch.profiler``). The same run in float32
   through the kernels and through the plain path must give identical
   tokens and ServeMetrics. Then the sync plane at the paper's scale
   (scaling testbed, N = 1000, L = 36, 16 shards, 64 relay seekers,
   gossip and relay fanout 4): after a burst of churn every seeker
   converges within ceil(log2 64) + 2 rounds; a synced seeker's view
   planned by K1 equals K1's plans on the anchor's composed snapshot bit
   for bit, with the host numpy DP's chains and its costs within
   (L + 1) f32 roundings; ``simulate_partition`` from half the shards for
   5 windows converges; ``simulate_byzantine`` with 3 lying relays leaves
   every honest seeker at parity, nothing resurrected, the liars
   quarantined. Last, ``torch_apply_report`` on the card against the
   scalar trust rules on a 1000-peer column (1e-6).
17. edge control — phase 3's workload and weights served with hedging,
   the process-backed 4-shard anchor (one spawned worker process per
   shard behind the RPC control plane) and tracing. Fails unless every
   stream emits its 16 tokens, K1 launched once per DP window, K3 once
   per layer of every stage forward, primary and hedge forwards apart,
   the hedges fired equal the CPU rehearsal's count, the run had no RPC
   timeout, retry, degraded window or dropped write, and the composed
   state's digest (and each shard's) equals that of an in-process
   ``ShardedAnchorRegistry`` fed the composer's recorded writes; logs
   tokens/s beside phase 3's, RPCs and the composer's host ms per window,
   the workers' start method and start-up ms. The same run in float32
   through the kernels and through the plain path must give identical
   tokens and ServeMetrics (hedge and control-plane fields included). The
   run's trace, exported as JSONL and Chrome trace events to a temporary
   directory, must validate with no error, and each request's TTFT
   components must sum to its TTFT within 1e-6 ms. Last, a worker drill:
   one shard's worker killed mid-run with its peers
   (``crash_anchor_shard(kill_worker=True)``) and respawned; every stream
   ends with the rehearsed tokens, one restart, at least one degraded
   window, and the composer's mirrors equal the live workers' exports.
   Every server is closed and no shard worker outlives the phase.
18. model zoo — the rest of the reference's decoder-only configs. K3
   (B = 4, S = 2048, causal) and K4 (B = 4, 2144 cache rows; kv_len 1, 37,
   2080, 2144, and again on a split boundary) against their plain
   versions within 2e-4 (f32) / 2e-2 (bf16), timed beside SDPA and the
   bound, at each new model's head shape: smollm-360m 15/5 and qwen3-moe
   32/4 at D = 64, starcoder2-7b 36/4, phi3.5-moe 32/8 and granite-34b
   48/1 at D = 128. Then qwen3-moe-30b-a3b at full width (48 layers, 128
   experts top-8, bf16 parameters: 60.2 GB) serves phase 3's workload
   through ``run_queue`` (24 stages x 6 replicas = 144 peers). Fails
   unless every stream emits its 16 tokens, K1 launched once per DP
   window, K3 once per layer of every stage forward, K4 never, and the
   windows and stage forwards are the CPU rehearsal's (34 and 1608); logs
   tokens/s beside phase 3's. The same model cut to 8 of its 48 layers in
   f32 activations through the kernels and through the plain path must
   give identical tokens and ServeMetrics (the router's top-k sets that
   differ between the two runs are counted). A profile of its run_queue
   and of its engine prefill and decode windows follows. Last, the
   KV-cache engine runs phase 11's workload (4 prompts of 8 and 4 of
   2048, 32 new tokens) on smollm-360m and starcoder2-7b (f32
   parameters), qwen3-moe and granite-34b (bf16 parameters: 67.7 GB) and
   phi3.5-moe cut to 24 of its 32 layers (bf16, ~63 GB), each loaded
   after the previous one is freed, with phase 11's gates (MoE launches
   K3 and K4 as a dense model does) and phase 12's f32 kernel-vs-plain
   token parity (prompts of 16 and 320), with the MoE router's differing
   top-k sets counted.
19. vlm and audio — K3 in Whisper's non-causal and Sq != Sk modes and at
   Qwen2-VL's heads, K4 at their caches, against their plain versions;
   qwen2-vl-7b at full width through ``run_queue`` (the rehearsed 34
   windows and 938 forwards), the engine, and its image path (512 stub
   patches + 1536 text tokens, decode at continued M-RoPE positions);
   whisper-large-v3 through its model API (1500 stub frames); each with
   its exact launches and f32 kernel-vs-plain token parity.
20. train — smollm-360m at full width (f32 parameters, bf16 activations,
   ``attn_impl="xla"``) trained 20 steps by ``make_train_step`` on the
   seeded synthetic stream (8 x 1024 tokens in 2 microbatches). Fails
   unless every loss is finite, the last below the first, and no kernel
   launched (none has a gradient); one more step runs under
   ``torch.profiler`` (the device's busy share, the top ops). The state
   (~4.3 GB) is checkpointed
   with an async write and restored bit-equal into a fresh template; the
   restored parameters serve the main path's workload through
   ``run_queue`` with the kernels (the rehearsed 34 windows = K1, 1072
   forwards, K3 = 2144, K4 = 0, 16 tokens per stream). At 4 layers, 4
   steps straight equal 2 steps, a checkpoint, a restore and 2 more
   within 1e-5 (the differing gradient leaves named when not bit-equal).
   Every family's reduced config takes 3 f32 steps on the card and on the
   CPU from the same parameters and batches, within the rules of
   ``tests/test_torch_trainer.py``. On the card each of K3-K6's
   dispatchers raises on an input that requires grad.
21. distributed — the distributed layer (``repro_torch.distributed``) and
   the dry-run (``repro_torch.launch.dryrun``). On a one-rank NCCL
   ``DeviceMesh`` ("data", "model") of shape (1, 1): phase 20's workload
   (smollm-360m at full width) takes 3 plain steps and the same 3 steps
   with its parameters, optimizer state and batches as DTensors under the
   activation policy; loss, lr and grad norm must be the plain step's (the
   same bits, else within 1e-6 relative, printed). The int8 compressed
   all-reduce with error feedback runs 30 rounds over the group on the
   model's f32 gradient tree (361,820,160 elements): the accumulated
   relative error must stay below 0.02 and one round's below 0.2 (the
   reference test's gates). The dry-run of ``perf.py``'s baseline cells A,
   B and C on the (16, 16) mesh and B on the (2, 16, 16) mesh, on
   ``meta`` through a process group that exchanges nothing, must give
   status ok (each row's dominant term, roofline terms, collectives and
   memory per device printed). Last, the dry-run of smollm at the card's
   shape on a (1, 1) mesh: its argument bytes must equal the card's
   parameters, optimizer state and batch exactly, and its FLOPs
   ``FlopCounterMode``'s count of one real step on the card. One
   full-width single-mesh cell of each family whose sharded step the
   dry-run once failed (qwen3-moe-30b-a3b ``decode_32k``, rwkv6-1.6b
   ``long_500k``, zamba2-2.7b ``prefill_32k``, whisper-large-v3
   ``train_4k``) runs in a process of its own, started right after the
   build (host work on ``meta``, CUDA hidden from it), and must give
   status ok (each row's dominant term printed).
22. repolint — the port's AST linter (``python -m repro_torch.analysis``)
   over ``src/repro_torch`` under ``repolint_torch.json``: 0 findings, 26
   allowed (the reference's audited exceptions), no unused entry; files,
   findings and allowed printed.

The last lines are the card's name and power limit (nvidia-smi), one JSON
line ``{"kernels": [...]}`` and the result line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate,
#: FP32 outside the tensor cores, bf16 tensor cores; and the rate of a split
#: 3xTF32 product (K5's and K6's scans): three passes at the TF32 peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32X3_FLOP_PER_S = 495e12 / 3
#: a shared-memory load's latency in SM cycles, for the routing DPs'
#: dependency-chain estimate (an assumption, not a measurement)
SMEM_LOAD_CYCLES = 30

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
#: the KV-cache engine's runs: (arch, [(prompt length, requests), ...])
ENGINE_RUNS = (("zamba2-2.7b", ((8, 4), (2048, 4))),
               ("rwkv6-1.6b", ((8, 4), (2048, 4))),
               ("gpt2-large", ((8, 4), (1024, 4))),
               ("tinyllama-1.1b", ((2048, 4),)))
ENGINE_TOKENS = 32
PARITY_TOKENS = 8
#: zamba2-2.7b's parameters at full width, as the reference's
#: ``jax.eval_shape`` of its ``init`` counts them
ZAMBA2_PARAMETERS = 2_396_455_840


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


def profiled_ops(prof):
    """The profile's averaged events less the ``record_function`` ranges
    (the port's wall spans open them while a profiler records), whose
    device-side copies would read as kernels and whose host side would
    claim the launches of the hand-written kernels."""
    return [e for e in prof.key_averages()
            if not getattr(e, "is_user_annotation", False)]


def name_matches(key: str, kernel) -> bool:
    """Whether a profiler kernel name contains ``kernel`` (a substring, or
    any of a tuple of them); None matches every name."""
    if kernel is None:
        return True
    names = (kernel,) if isinstance(kernel, str) else kernel
    return any(n in key for n in names)


def device_times(fn, iters: int = 20) -> list:
    """[(profiler kernel name, device ms per call)] for every device
    kernel ``fn`` runs, from ``torch.profiler`` over ``iters`` calls (after
    one unprofiled call)."""
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
    out = []
    for e in profiled_ops(prof):
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0)
            out.append((e.key, t / 1e3 / iters))
    return out


def device_ms(fn, kernel, iters: int = 20):
    """Device-only time per call of ``fn``: the summed device time of every
    kernel whose profiler name matches ``kernel`` (a substring such as
    ``"route_kernel("``, or a tuple of them, so that a wrapper's two
    kernels count together; None for every kernel ``fn`` runs, as for a
    library call); None when the profiler records no matching device
    activity."""
    times = [t for k, t in device_times(fn, iters) if name_matches(k, kernel)]
    return sum(times) if times else None


def grid_fit(blocks: int, blocks_per_sm: int) -> dict:
    """A grid's fit on this card: blocks per SM (occupancy calculator) and
    waves, blocks / (blocks per SM x SMs)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"ctas": blocks, "blocks_per_sm": blocks_per_sm,
            "waves": blocks / (blocks_per_sm * sms)}


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
    logs = build.build_all(["tropical_route.cu", "flash_attention.cu",
                            "decode_attention.cu", "rwkv6_chunk.cu",
                            "ssd_chunk.cu"])
    secs = time.perf_counter() - t0
    for src, text in logs.items():
        for line in text.splitlines():
            # each kernel's entry line names it (mangled: the template
            # argument, e.g. the head dim, is in the name)
            if "registers" in line or "spill" in line.lower() or \
                    "Compiling entry function" in line or \
                    "Performance" in line:
                log(f"ptxas {src}: {line.strip()}")
    log({"phase": "build", "seconds": round(secs, 3),
         "sources": sorted(logs)})
    kernel_smem()


def kernel_smem() -> None:
    """Dynamic shared memory per block of each K3, K4, K5 and K6
    instantiation, in bytes (ptxas's lines above give each one's registers
    and spills): K3 per kernel and head dim; K4's tensor-core kernel with
    one tile per split and with more (two stages), its FMA kernel at groups
    1, 8 and 48 (bf16 only at D = 16, 32: the head dims it is built for);
    K5's and K6's scan kernel per instantiation, with its threads per
    block."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    k3 = {f"{n}<{D}>": fa.smem_bytes(n, D) for n in fa.KERNELS
          for D in fa.CUDA_HEAD_DIMS if fa.smem_bytes(n, D) >= 0}
    k4 = {}
    for D in da.MMA_HEAD_DIMS:
        for rows, stages in ((da.MMA_TILE_ROWS, 1),
                             (2 * da.MMA_TILE_ROWS, 2)):
            k4[f"decode_split_mma_kernel<{D}>, {stages} stage(s)"] = \
                da.smem_bytes("decode_split_mma_kernel", torch.bfloat16, D,
                              1, rows)
    for dtype in (torch.float32, torch.bfloat16):
        for D in da.CUDA_HEAD_DIMS:
            if da.decode_kernel(dtype, 1, D) != "decode_split_kernel":
                continue
            for G in (1, 8, 48):
                k4[f"decode_split_kernel<{str(dtype)[6:]}, {D}>, G {G}"] = \
                    da.smem_bytes("decode_split_kernel", dtype, D, G,
                                  da.TILE_ROWS)
    from repro_torch.kernels import rwkv6_chunk as wk
    from repro_torch.kernels import ssd_chunk as sk
    k5 = {}
    for K, wgmma in ([(K, False) for K in wk.CUDA_HEAD_DIMS]
                     + [(K, True) for K in wk.WGMMA_HEAD_DIMS]):
        nbytes, threads = wk.scan_smem(K, wgmma)
        name = "wkv6_wgmma_kernel" if wgmma else "wkv6_scan_kernel"
        k5[f"{name}<{K}>"] = {"smem_bytes": nbytes, "threads": threads}
    k6 = {}
    for P, N in sk.CUDA_SHAPES:
        nbytes, threads = sk.scan_smem(P, N)
        k6[f"{sk.scan_kernel(P, N)[-1]}<{P}, {N}>"] = {"smem_bytes": nbytes,
                                                      "threads": threads}
    log({"kernel_smem": {"k3": k3, "k4": k4, "k5": k5, "k6": k6}})


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


def window_bound_ms(R: int, P: int, L: int, K: int, k_max: int, ends,
                    kbest: bool) -> tuple:
    """Least time for a fused window entry (K = 1 single best) on this
    card: its own inputs read once — latency, trust, starts and the CSR's
    order and clamped starts (P each, 4 bytes), alive (P bytes), the
    offsets (L + 2) and tau (R) — and its outputs written once, hops
    (R, K, k_max) and costs (R, K); against the f32 operations of the
    effective costs (three per peer, one trust compare per row and peer)
    and of the DP (as ``k1_bound_ms`` / ``k2_bound_ms``)."""
    nbytes = 4 * (5 * P + L + 2 + R) + P + 4 * R * K * (k_max + 1)
    n_end = sum(1 for e in ends if 1 <= e <= L)
    dp_ops = R * K * n_end * (1 + K) if kbest else 2 * R * n_end
    ops = 3 * P + R * P + dp_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def launch_floor():
    """The launch floor the routing rows stand beside: an empty kernel's
    time per call (CUDA events over back-to-back launches) and on the
    device (profiler)."""
    import torch
    from repro_torch.kernels import tropical_route as tr
    dev = torch.device(DEVICE)
    ms = cuda_ms(lambda: tr.launch_floor_cuda(dev), iters=200)
    dev_ms = device_ms(lambda: tr.launch_floor_cuda(dev),
                       "route_launch_floor")
    log({"launch_floor": {"ms": ms, "device_ms": dev_ms}})
    return {"launch_floor_ms": ms, "launch_floor_device_ms": dev_ms}


def chain_ms(L: int) -> float:
    """The dependency-chain estimate of a routing DP: L boundary steps of
    one shared-memory load each, at SMEM_LOAD_CYCLES (an assumed latency,
    not measured) and the card's maximum SM clock (nvidia-smi)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    mhz = float(res.stdout.strip().splitlines()[0])
    return L * SMEM_LOAD_CYCLES / (mhz * 1e6) * 1e3


def phase_k1(floor):
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
    # timings at the serving shapes: the kernel entry on given costs, and
    # the fused window entry (costs, DP and backtrack) the main path runs
    starts, ends = serving_topology()
    P = len(starts)
    chain = chain_ms(L)
    rows = {}
    for R in (1, 8, 64):
        s, e, c = k1_inputs(starts, ends, R, "float", rng)
        csr = tr.route_csr(s, e, L)
        state, timeout = window_state(P, R, "float", rng)

        def kern():
            return tr.tropical_route_kbest_cuda(s, e, c, total_layers=L,
                                                k_best=K, csr=csr)

        def window():
            return tr.route_window_kbest_cuda(
                csr, s, *state, timeout_ms=timeout, total_layers=L,
                k_best=K, k_max=L)

        plain = cuda_ms(lambda: tr.tropical_route_kbest_plain(
            s, e, c, total_layers=L, k_best=K), iters=20)
        window_plain = cuda_ms(lambda: tr.route_window_kbest_plain(
            csr, s, *state, timeout_ms=timeout, total_layers=L, k_best=K,
            k_max=L), iters=20)
        bound, by = k1_bound_ms(R, P, L, K, ends)
        wbound, wby = window_bound_ms(R, P, L, K, L, ends, True)
        rows[R] = {"ms": cuda_ms(kern, iters=200),
                   "device_ms": device_ms(kern, "route_kbest_kernel"),
                   "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                   "window_ms": cuda_ms(window, iters=200),
                   "window_device_ms": device_ms(
                       window, "route_window_kbest_kernel"),
                   "window_plain_ms": window_plain,
                   "window_bound_ms": wbound, "window_bound_by": wby,
                   "chain_ms": chain, **floor, "max_abs_err": err}
        log({"k1_time": {"R": R, "P": P, "L": L, "K": K, **rows[R]}})
    return rows


def window_state(P: int, R: int, kind: str, rng):
    """A routing window's inputs on the card — (latency, trust, alive,
    tau) from one upload — and its timeout: "float" costs, "ties"
    (integer latencies, trust and floors in {0.5, 0.75, 1}, a 4 ms
    timeout: small integer costs) or "allinf" (every peer dead)."""
    import numpy as np
    from repro_torch.kernels import tropical_route as tr
    lat = rng.uniform(10.0, 300.0, P)
    trust = rng.uniform(0.3, 1.0, P)
    alive = rng.random(P) < 0.9
    tau = rng.uniform(0.3, 0.95, R)
    timeout = 25_000.0
    if kind == "ties":
        lat = rng.integers(1, 4, P).astype(np.float64)
        trust = rng.choice([0.5, 0.75, 1.0], P)
        tau = rng.choice([0.5, 0.75, 1.0], R)
        timeout = 4.0
    elif kind == "allinf":
        alive[:] = False
    return tr.upload_window_state(lat, trust, alive, tau, DEVICE), timeout


def phase_windows():
    """The fused window entries (effective costs, DP and backtrack in one
    launch) bit for bit against their plain compositions: the serving
    topology, the 3/6/9 testbed and scaling1000 at L = 36 (and, single
    best, the one-boundary topology at L = 2, whose all-INF rows cost
    +inf), R in {1, 8, 64, 512}, on float, tie and all-INF costs.
    Returns each entry's largest |kernel - plain| over its costs, for the
    ``kernels`` line (0 when bit-exact)."""
    import torch
    import numpy as np
    from repro_torch.kernels import tropical_route as tr
    rng = np.random.default_rng(SEED + 4)
    tops = [("serving", *serving_topology()),
            ("testbed", *testbed_topology())]
    tops += [t for t in k2_topologies() if t[0] in ("scaling1000",
                                                    "one-boundary")]
    dev = torch.device(DEVICE)
    err = {"K1 window": 0.0, "K2 window": 0.0}
    for topo, starts, ends in tops:
        # the one-boundary topology's +inf is dist[2]: routed with L = 2
        L = 2 if topo == "one-boundary" else 36
        s = torch.as_tensor(starts, device=dev)
        csr = tr.route_csr(s, torch.as_tensor(ends, device=dev), L)
        for R in (1, 8, 64, 512):
            for kind in ("float", "ties", "allinf"):
                state, timeout = window_state(len(starts), R, kind, rng)
                kw = dict(timeout_ms=timeout, total_layers=L, k_max=L)
                pairs = [("K2 window",
                          tr.route_window_cuda(csr, s, *state, **kw),
                          tr.route_window_plain(csr, s, *state, **kw))]
                if topo != "one-boundary":
                    pairs.append((
                        "K1 window",
                        tr.route_window_kbest_cuda(csr, s, *state, k_best=4,
                                                   **kw),
                        tr.route_window_kbest_plain(csr, s, *state,
                                                    k_best=4, **kw)))
                for what, got, want in pairs:
                    for name, g, w in zip(("hops", "costs"), got, want):
                        if not torch.equal(g, w):
                            raise AssertionError(
                                f"{what} {topo} R={R} {kind}: {name} "
                                f"differs in {int((g != w).sum())} entries")
                    # equal entries (INF and +inf too) differ by 0
                    diff = torch.where(got[1] == want[1], 0.0,
                                       (got[1] - want[1]).abs())
                    if diff.numel():
                        err[what] = max(err[what], float(diff.max()))
                if topo == "one-boundary" and kind == "allinf" and \
                        not bool(torch.isinf(pairs[0][1][1]).all()):
                    raise AssertionError("K2 window one-boundary: the +inf "
                                         "case was not reached")
        log(f"windows exact: {topo} P={len(starts)} L={L} R in (1, 8, 64, "
            f"512) x (float, ties, allinf), {', '.join(p[0] for p in pairs)}")
    return err


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


def phase_k2(floor):
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
    chain = chain_ms(L)
    for topo, starts, ends in k2_topologies()[:4]:
        P = len(starts)
        for R in (1, 64, 512):
            s, e, c = k1_inputs(starts, ends, R, "float", rng)
            csr = tr.route_csr(s, e, L)
            state, timeout = window_state(P, R, "float", rng)

            def kern():
                return tr.tropical_route_cuda(s, e, c, total_layers=L,
                                              csr=csr)

            def window():
                return tr.route_window_cuda(csr, s, *state,
                                            timeout_ms=timeout,
                                            total_layers=L, k_max=L)

            plain = cuda_ms(lambda: tr.tropical_route_plain(
                s, e, c, total_layers=L), iters=10)
            window_plain = cuda_ms(lambda: tr.route_window_plain(
                csr, s, *state, timeout_ms=timeout, total_layers=L,
                k_max=L), iters=10)
            bound, by = k2_bound_ms(R, P, L, ends)
            wbound, wby = window_bound_ms(R, P, L, 1, L, ends, False)
            rows[(topo, R)] = {
                "ms": cuda_ms(kern, iters=200),
                "device_ms": device_ms(kern, "route_kernel("),
                "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "window_ms": cuda_ms(window, iters=200),
                "window_device_ms": device_ms(window, "route_window_kernel("),
                "window_plain_ms": window_plain,
                "window_bound_ms": wbound, "window_bound_by": wby,
                "chain_ms": chain, **floor, "max_abs_err": 0.0,
                "library_ms": None}
            log({"k2_time": {"topology": topo, "R": R, "P": P, "L": L,
                             **rows[(topo, R)]}})
    return rows


def k3_bound_ms(B, S, Hq, Hkv, D, dtype, causal, Sk=None) -> tuple:
    """Least time for attention on this card: q, k, v read once and the
    output written once, against the multiply-adds of QK^T and PV over the
    visible (query, key) pairs at the peak rate of the input type. ``Sk``
    keys (default S) against S queries; causal pairs are key <= query,
    both counted from 0."""
    import torch
    Sk = Sk or S
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = size * (2 * B * S * Hq * D + 2 * B * Sk * Hkv * D)
    pairs = sum(min(i + 1, Sk) for i in range(S)) if causal else S * Sk
    flops = 4 * B * Hq * D * pairs
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


#: profiler names of K3's kernels (``flash_attention.KERNELS``): bf16 on
#: wgmma (D = 64, 80, 128) and on mma.sync (D = 16, 32), f32 on FMAs
K3_KERNELS = ("flash_bf16_wgmma_kernel<", "flash_bf16_mma_kernel<",
              "flash_f32_kernel<")
#: K3's timed engine shapes (B, S, Hq, Hkv, D), causal
K3_ENGINE_SHAPES = {(4, 1024, 20, 20, 64): "gpt2-large",
                    (4, 2048, 32, 4, 64): "tinyllama-1.1b",
                    (4, 2048, 32, 32, 80): "zamba2-2.7b"}
#: profiler names of K4's split kernels (FMA, tensor-core) and combine
K4_KERNELS = ("decode_split_kernel<", "decode_split_mma_kernel<",
              "decode_combine_kernel<")
#: profiler names of K5's and K6's kernels, both designs: the Hopper
#: kernels the engine runs (K6's with its C . B^T pre-pass) and the
#: mma.sync pre-pass and scan, kept for the kernel test's small shapes
#: (``scan_kernel`` of each wrapper names a call's)
K5_KERNELS = ("wkv6_wgmma_kernel", "wkv6_prep_kernel<", "wkv6_scan_kernel<")
K6_KERNELS = ("ssd_gram_kernel", "ssd_wgmma_kernel", "ssd_prep_kernel<",
              "ssd_scan_kernel<")
#: the ones the engine's prefills must run (phases 13-15 fail otherwise)
K5_ENGINE_KERNELS = ("wkv6_wgmma_kernel",)
K6_ENGINE_KERNELS = ("ssd_gram_kernel", "ssd_wgmma_kernel")


def scan_device_ms(fn, names, family, what: str, iters: int) -> dict:
    """Device time per call of each of a scan wrapper's kernels (``names``,
    the pre-pass first), from ``torch.profiler``; fails unless each of them
    ran and no other kernel of ``family`` (both designs' names) did. A
    profile that records no device activity at all is taken again, three
    tries in all."""
    for _ in range(3):
        ours = [(k, t) for k, t in device_times(fn, iters)
                if name_matches(k, family)]
        if ours:
            break
    stray = [k for k, _ in ours if not name_matches(k, names)]
    missing = [n for n in names if not any(n in k for k, _ in ours)]
    if stray or missing:
        raise AssertionError(f"{what}: ran {[k for k, _ in ours]}, want "
                             f"{list(names)}")
    return {n: sum(t for k, t in ours if n in k) for n in names}


def check_scan_names(what: str, kernels, family, want) -> None:
    """A profile's kernels (``{name: ...}``) of a scan's ``family`` must
    be ``want``'s, each of them seen."""
    ran = [k for k in kernels if name_matches(k, family)]
    stray = [k for k in ran if not name_matches(k, want)]
    missing = [n for n in want if not any(n in k for k in ran)]
    if stray or missing:
        raise AssertionError(f"{what}: ran {ran}, want {list(want)}")


def served_by(fn, want: str, names, what: str, companions=(),
              iters: int = 5) -> tuple:
    """Device time per call of ``fn``'s hand-written kernels (profiler
    names matching ``names``) and the full profiler name of ``want``, from
    ``torch.profiler``; fails unless ``want`` (a profiler name prefix,
    such as ``"flash_bf16_wgmma_kernel<"``) ran and no kernel of ``names``
    other than it and its ``companions`` (K4's combine) did. A profile
    that records no device activity at all (seen about once in 40 on the
    card) is taken again, three tries in all."""
    for _ in range(3):
        ours = [(k, t) for k, t in device_times(fn, iters)
                if name_matches(k, names)]
        if ours:
            break
    stray = [k for k, _ in ours
             if want not in k and not name_matches(k, companions)]
    if stray or not any(want in k for k, _ in ours):
        raise AssertionError(f"{what}: served by {[k for k, _ in ours]}, "
                             f"want {want}")
    return sum(t for _, t in ours), next(k for k, _ in ours if want in k)


def k3_case(gen, dtype, B, S, Hq, Hkv, D, causal, timed=False,
            shape=None, Sk=None) -> dict:
    """K3 against its plain version on one shape (random normal q, k, v
    from ``gen``; ``Sk`` keys, default S): fails beyond 2e-4 (f32) / 2e-2
    (bf16) absolute. The row names the kernel that served it
    (``flash_kernel``). With ``timed``, the kernel, its plain version and
    SDPA per call, and the bound; with ``shape`` (a model's name) also the
    kernel's and SDPA's device time, failing unless the profiler saw the
    named kernel and no other K3 kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    Sk = Sk or S
    q = torch.randn((B, S, Hq, D), generator=gen, device=DEVICE,
                    dtype=torch.float32).to(dtype)
    k = torch.randn((B, Sk, Hkv, D), generator=gen, device=DEVICE,
                    dtype=torch.float32).to(dtype)
    v = torch.randn((B, Sk, Hkv, D), generator=gen, device=DEVICE,
                    dtype=torch.float32).to(dtype)
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    name = str(dtype).replace("torch.", "")
    kernel = fa.flash_kernel(dtype, D, S)
    if not err <= tol[dtype]:
        raise AssertionError(
            f"K3 {name} B={B} S={S} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} "
            f"causal={causal} ({kernel}): max abs err {err} > {tol[dtype]}")
    # the largest |o| sets the bf16 step the error is read against
    nx, ny, nz = fa.flash_grid(B, S, Hq, kernel)
    row = {"dtype": name, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv,
           "D": D, "causal": causal, "kernel": kernel, "ctas": nx * ny * nz,
           "max_abs_err": err,
           "max_abs_out": float(want.float().abs().max())}
    if Sk != S:
        row["Sk"] = Sk
    if timed or shape:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal), iters=50)
        row["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal), iters=20)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv)
        row["library_ms"] = cuda_ms(sdpa, iters=50)
        row["bound_ms"], row["bound_by"] = k3_bound_ms(
            B, S, Hq, Hkv, D, dtype, causal, Sk)
        if shape:
            row["shape"] = shape
            row["device_ms_per_launch"], row["profiler_kernel"] = served_by(
                lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
                kernel.split("/")[0] + "<", K3_KERNELS,
                f"K3 {name} {shape}")
            row["library_device_ms"] = device_ms(sdpa, None, iters=5)
    log({"k3": row})
    return row


def phase_k3():
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shapes = [(1, S, 20, 20, 64, True)
              for S in (8, 100, 128, 200, 300, 1024)]
    shapes += [(2, 200, 8, 2, 128, True), (2, 96, 4, 2, 32, False),
               (1, 77, 6, 3, 16, True)]
    # the engine's prefill shapes: GPT-2 Large's 4 x 1024, TinyLlama's
    # 4 x 2048 at G = 8 and Zamba2's shared block, 4 x 2048 at D = 80
    shapes += [(4, 1024, 20, 20, 64, True), (4, 2048, 32, 4, 64, True),
               (4, 2048, 32, 32, 80, True), (2, 100, 4, 4, 80, False)]
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for B, S, Hq, Hkv, D, causal in shapes:
            engine = K3_ENGINE_SHAPES.get((B, S, Hq, Hkv, D)) \
                if causal else None
            timed = B == 1 and Hq == Hkv == 20 and D == 64
            row = k3_case(gen, dtype, B, S, Hq, Hkv, D, causal, timed,
                          engine)
            if engine:
                rows[(name, engine)] = row
            elif timed:
                rows[(name, S)] = row
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


def serve(cfg, params, specs, router_backend="auto", gcfg=None,
          prepare=None):
    """One server (``gcfg``: disaggregated prefill on the monolithic
    anchor unless given), every spec through submit + run_queue;
    ``prepare(server)`` runs before the specs are submitted. Returns
    (server, served requests, wall seconds, stage forwards)."""
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.serving.gtrac_serve import GTRACPipelineServer
    srv = GTRACPipelineServer(
        cfg, params, layers_per_stage=2,
        # golden replicas registered first: equal initial costs tie-break
        # toward them, so every stream completes; the honeypot and turtle
        # replicas stay in the routing table (P = 108)
        replicas={"golden": 2, "turtle": 2, "honeypot": 2},
        gcfg=gcfg or GTRACConfig(disaggregate=True), seed=SEED,
        device=DEVICE, router_backend=router_backend)
    calls = [0]

    def counted(fn):
        def wrapped(payload):
            calls[0] += 1
            return fn(payload)
        return wrapped

    srv.stage_fns = [counted(f) for f in srv.stage_fns]
    if prepare is not None:
        prepare(srv)
    for spec in specs:
        srv.submit(spec)
    sync()
    t0 = time.perf_counter()
    done = srv.run_queue()
    sync()
    return srv, done, time.perf_counter() - t0, calls[0]


def check_served(cfg, srv, done, counts, forwards):
    """Every stream emitted its tokens in range; K1 launched once per
    window that ran the DP and K3 once per layer of every stage forward."""
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


def phase_main(cfg, params):
    from repro_torch.kernels import ops
    specs = workload(cfg.vocab_size)
    serve(cfg, params, workload(cfg.vocab_size)[:1])      # warm-up run
    ops.reset_launch_counts()
    srv, done, wall, forwards = serve(cfg, params, specs)
    counts = ops.launch_counts()
    toks = sum(r.metrics.tokens for r in done)
    check_served(cfg, srv, done, counts, forwards)
    st = srv.router.stats
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


# ---------------------------------------------------------------------------
# Phase 16: the Hybrid Trust Architecture (sharded anchor, gossip + relay)
# ---------------------------------------------------------------------------

#: the served hybrid configuration: a 4-shard anchor, the gossip sync plane
#: and the relay plane over 8 seekers (routing reads seeker 0)
HYBRID = dict(disaggregate=True, anchor_shards=4, gossip_enabled=True,
              relay_enabled=True, gossip_seekers=8)
#: the sync plane at the paper's scale, as benchmarks/bench_sync.py's relay
#: lane sets it: N = 1000 peers (L = 36), 16 shards, 64 relay seekers,
#: gossip and relay fanout 4
SYNC_PEERS = 1000
SYNC_SHARDS = 16
SYNC_SEEKERS = 64
SYNC_FANOUT = 4


def timed_sync(srv, acc: dict) -> None:
    """Wrap the sync plane's two request-path calls (``maybe_tick`` and
    ``routing_view``) with host timers summing into ``acc``."""
    def timed(fn, key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t0
        return wrapped

    srv.gossip.maybe_tick = timed(srv.gossip.maybe_tick, "maybe_tick")
    srv.sync_seeker.routing_view = timed(srv.sync_seeker.routing_view,
                                         "routing_view")


def settle(sched, seeker, now: float, bound: int) -> tuple:
    """Gossip rounds until ``seeker`` mirrors the anchor (version vector
    and table); returns (rounds taken, clock). Fails past ``bound``."""
    for r in range(bound + 1):
        if sched.converged(seeker, now):
            return r, now
        now += sched.period_s
        sched.tick(now)
    raise AssertionError(f"seeker not converged after {bound} gossip rounds")


def gossip_window(srv, taus):
    """One routing window on the gossip path, as ``run_queue`` runs it
    (one trust report at the anchor, the sync tick, the seeker's
    ``routing_view``, the batched K-best DP), with the clock one gossip
    period on, so every call plans on a new view generation."""
    import numpy as np
    from repro_torch.serving.batch_router import plan_batched
    pids = sorted(srv.bed.anchor.peers)
    state = {"n": 0}

    def window():
        state["n"] += 1
        srv.bed.anchor.set_trust(pids[state["n"] % len(pids)],
                                 0.8 + 0.1 * np.sin(state["n"]))
        srv.bed.advance(srv.gcfg.gossip_period_s)
        srv.gossip.maybe_tick(srv.bed.now)
        view = srv.sync_seeker.routing_view(srv.bed.now)
        return plan_batched(view, srv.cfg.num_layers, srv.gcfg, taus,
                            planner=srv.planner, backend="kernel",
                            device=srv.device)
    return window


def phase_hybrid_serving(cfg, params, main_tps):
    """Full-width GPT-2 Large through ``run_queue`` on the hybrid trust
    architecture: K1 plans every window on gossip seeker 0's
    ``routing_view``."""
    import math

    import numpy as np
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.kernels import ops
    gcfg = GTRACConfig(**HYBRID)
    acc = {"maybe_tick": 0.0, "routing_view": 0.0}
    ops.reset_launch_counts()
    srv, done, wall, forwards = serve(
        cfg, params, workload(cfg.vocab_size), gcfg=gcfg,
        prepare=lambda s: timed_sync(s, acc))
    counts = ops.launch_counts()
    check_served(cfg, srv, done, counts, forwards)
    st, g, rs = srv.router.stats, srv.gossip.stats, srv.gossip.relay.stats
    anchor, seeker = srv.bed.anchor, srv.sync_seeker
    peers = len(anchor.snapshot(srv.bed.now))
    if peers != 108 or len(seeker.materialize(srv.bed.now)) != peers:
        raise AssertionError(f"routing table has {peers} peers, not 108")
    if g.rounds < 1:
        raise AssertionError("no gossip round ran on the serving path")
    honest = {"digest_mismatches": rs.digest_mismatches,
              "quarantines": rs.quarantines, "hb_rejected": rs.hb_rejected}
    if any(honest.values()):
        raise AssertionError(f"an honest relay run convicted: {honest}")
    at_end = seeker.version_vector == anchor.version_vector
    rounds, _ = settle(srv.gossip, seeker, srv.bed.now,
                       math.ceil(math.log2(gcfg.gossip_seekers)) + 2)
    if seeker.version_vector != anchor.version_vector:
        raise AssertionError(f"seeker 0 at {seeker.version_vector}, the "
                             f"anchor at {anchor.version_vector}")
    toks = sum(r.metrics.tokens for r in done)
    sync_ms = {k: v * 1e3 / st.windows for k, v in acc.items()}
    log({"hybrid_serving": {
        "model": cfg.name, "anchor_shards": anchor.n_shards,
        "seekers": gcfg.gossip_seekers, "peers": peers,
        "streams": len(done), "tokens": toks, "wall_s": wall,
        "tokens_per_s": toks / wall, "main_path_tokens_per_s": main_tps,
        "windows": st.windows, "dp_windows": st.device_calls,
        "window_cache_hits": st.window_cache_hits,
        "stage_forwards": forwards, "launches": counts,
        "sync_host_ms_per_window": sync_ms,
        "sync_host_share_of_wall": sum(acc.values()) / wall,
        "gossip": vars(g), "relay": vars(rs),
        "stale_rounds_max": max(r.metrics.stale_rounds_max for r in done),
        "vv_equal_at_end": at_end, "settle_rounds": rounds}})
    # the gossip path's window: one upload per view generation
    taus = np.linspace(0.5, 0.99, 8)
    work = None
    for iters in (200, 400, 800):
        work = window_device_work(gossip_window(srv, taus),
                                  "route_window_kbest_kernel", iters)
        if work is not None:
            break
    log({"hybrid_window_device": work})
    if work is None:
        raise AssertionError("the profiler recorded no gossip-path window "
                             "in 3 tries")
    if work["kernels"] > 2 or work["h2d"] >= 1.5 or work["d2h"] >= 1.5:
        raise AssertionError(f"a gossip-path window ran {work}: more than "
                             "2 kernels or 1 copy each way")


def phase_hybrid_parity(cfg, params):
    """The hybrid configuration in f32 through the kernels and through the
    plain path (``attn_impl="xla"``, the plain torch DP): identical tokens
    and ServeMetrics."""
    from repro_torch.configs.base import GTRACConfig
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    plain = dataclasses.replace(cfg32, attn_impl="xla")
    _, kdone, kwall, _ = serve(cfg32, params, workload(cfg.vocab_size),
                               gcfg=GTRACConfig(**HYBRID))
    _, pdone, pwall, _ = serve(plain, params, workload(cfg.vocab_size),
                               router_backend="torch",
                               gcfg=GTRACConfig(**HYBRID))
    for a, b in zip(kdone, pdone):
        if a.output != b.output or a.metrics.tokens != NEW_TOKENS:
            raise AssertionError(f"hybrid f32 tokens differ for stream "
                                 f"{a.request_id}: kernels {a.output} vs "
                                 f"plain {b.output}")
        if dataclasses.asdict(a.metrics) != dataclasses.asdict(b.metrics):
            raise AssertionError(f"hybrid f32 ServeMetrics differ for "
                                 f"stream {a.request_id}")
    log({"hybrid_f32_parity": {"streams": len(kdone), "equal": True,
                               "kernel_path_s": kwall,
                               "plain_path_s": pwall}})


def phase_sync_scale():
    """The sync plane at the paper's scale: parity of K1's plans on a
    synced seeker with the host DP on the anchor, partition convergence
    and Byzantine containment."""
    import math

    import numpy as np
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.core.planner import RoutePlanner
    from repro_torch.core.types import ExecReport, HopReport
    from repro_torch.serving.batch_router import BatchRouter
    from repro_torch.sim.testbed import (build_scaling_testbed,
                                         simulate_byzantine,
                                         simulate_partition)
    from repro_torch.sync.gossip import make_sync_plane
    cfg = GTRACConfig(gossip_fanout=SYNC_FANOUT, relay_enabled=True,
                      relay_fanout=SYNC_FANOUT)
    t0 = time.perf_counter()
    bed = build_scaling_testbed(SYNC_PEERS, cfg=cfg, seed=SEED,
                                shards=SYNC_SHARDS)
    pub, seekers, sched = make_sync_plane(bed.anchor, cfg,
                                          n_seekers=SYNC_SEEKERS,
                                          now=bed.now)
    boot_ms = (time.perf_counter() - t0) * 1e3
    # a burst of churn (bench_sync's relay lane): trust reports and joins
    rng = np.random.default_rng(SEED)
    pids = np.array(sorted(bed.peers), np.int64)
    for _ in range(8):
        chain = [int(p) for p in pids[rng.integers(0, len(pids), size=4)]]
        bed.anchor.apply_report(ExecReport(
            True, chain, [HopReport(p, 50.0, True) for p in chain]))
    for i in range(4):
        bed.anchor.register(int(pids.max()) + 1 + i, 0, 3, now=bed.now,
                            profile="golden")
        bed.anchor.heartbeat(int(pids.max()) + 1 + i, bed.now)
    bound = math.ceil(math.log2(SYNC_SEEKERS)) + 2
    bytes0, rounds, tick_ms = sched.stats.anchor_bytes(), 0, []
    while not sched.all_converged(bed.now):
        if rounds == bound:
            raise AssertionError(f"relay plane not converged after {bound} "
                                 "rounds")
        bed.advance(cfg.gossip_period_s)
        t0 = time.perf_counter()
        sched.tick(bed.now)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        rounds += 1
    anchor_bytes_per_round = (sched.stats.anchor_bytes() - bytes0) / \
        max(1, rounds)
    # parity: the last seeker's view through K1 on the card, against the
    # anchor's composed snapshot through K1 and through the host numpy DP
    seeker = seekers[-1]
    view = seeker.routing_view(bed.now)
    table = bed.anchor.snapshot(bed.now)
    taus = np.linspace(0.0, 0.95, 64)

    def plans(tbl, backend):
        r = BatchRouter(planner=RoutePlanner(bed.total_layers, k_best=4),
                        cfg=cfg, total_layers=bed.total_layers,
                        backend=backend, device=DEVICE)
        for i, tau in enumerate(taus):
            r.submit(i, float(tau))
        return r.route_window(tbl)

    t0 = time.perf_counter()
    k_view = plans(view, "kernel")
    plan_ms = (time.perf_counter() - t0) * 1e3
    k_anchor, n_anchor, n_view = (plans(table, "kernel"),
                                  plans(table, "numpy"),
                                  plans(view, "numpy"))
    # K1 sums f32 effective costs along chains of up to L hops, the host DP
    # f64 ones: the same chains, the costs within (L + 1) f32 roundings
    tol = (bed.total_layers + 1) * 2.0 ** -23
    worst = 0.0
    for i in range(len(taus)):
        if k_view[i].chain_rows != k_anchor[i].chain_rows or \
                k_view[i].costs != k_anchor[i].costs or \
                n_view[i].chain_rows != n_anchor[i].chain_rows or \
                n_view[i].costs != n_anchor[i].costs:
            raise AssertionError(f"floor {taus[i]}: the synced seeker's "
                                 "plans differ from the anchor's")
        if k_view[i].chain_rows != n_anchor[i].chain_rows:
            raise AssertionError(f"floor {taus[i]}: K1's chains differ "
                                 "from the host numpy DP's")
        for a, b in zip(k_view[i].costs, n_anchor[i].costs):
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    if worst > tol:
        raise AssertionError(f"K1's chain costs differ from the host DP's "
                             f"by {worst} relative (tolerance {tol})")
    log({"sync_parity": {
        "peers": len(table), "shards": SYNC_SHARDS, "seekers": SYNC_SEEKERS,
        "fanout": SYNC_FANOUT, "floors": len(taus), "boot_ms": boot_ms,
        "rounds_to_converge": rounds, "bound": bound,
        "tick_ms": tick_ms, "anchor_bytes_per_round": anchor_bytes_per_round,
        "k1_window_ms": plan_ms, "feasible": sum(p.feasible
                                                 for p in k_view.values()),
        "chains_equal": True, "costs_max_rel_diff_vs_numpy": worst,
        "costs_tolerance": tol}})
    # partition: the first seeker cut off from half the shards, 5 windows
    t0 = time.perf_counter()
    part = simulate_partition(bed, sched, seekers[0],
                              list(range(SYNC_SHARDS // 2)),
                              partition_windows=5, window_s=2.0)
    part_ms = (time.perf_counter() - t0) * 1e3
    log({"sync_partition": {**dataclasses.asdict(part), "wall_ms": part_ms}})
    if not part.converged:
        raise AssertionError(f"partitioned seeker did not converge: {part}")
    # Byzantine: F = relay_fanout - 1 lying relays
    t0 = time.perf_counter()
    bz = simulate_byzantine(bed, sched, seekers, n_liars=SYNC_FANOUT - 1,
                            churn_windows=5)
    bz_ms = (time.perf_counter() - t0) * 1e3
    log({"sync_byzantine": {**dataclasses.asdict(bz), "wall_ms": bz_ms}})
    if not bz.honest_converged or bz.poisoned_mirrors or \
            bz.resurrected_seen or not bz.quarantines or \
            not (bz.fabricated_summaries + bz.fabricated_msgs):
        raise AssertionError(f"Byzantine relays not contained: {bz}")


def phase_trust_twin():
    """``torch_apply_report`` on the card against the scalar trust rules
    on a 1000-peer column: trust within 1e-6 absolute, latency within
    1e-6 relative (f32 arithmetic on values up to 500 ms)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.core import trust as T
    cfg = GTRACConfig()
    rng = np.random.default_rng(SEED)
    P = SYNC_PEERS
    trust = rng.uniform(0.0, 1.0, P).astype(np.float32)
    trust[:2] = [cfg.min_trust, cfg.max_trust]
    latency = rng.uniform(5.0, 500.0, P).astype(np.float32)
    chain = rng.uniform(size=P) < 0.05
    chain[:2] = True
    observed = np.where(chain & (rng.uniform(size=P) < 0.9),
                        rng.uniform(1.0, 400.0, P), 0.0).astype(np.float32)
    row = {}
    for success in (True, False):
        failed = np.zeros(P, bool)
        if not success:
            failed[np.flatnonzero(chain)[1]] = True
        t, lat = T.torch_apply_report(trust, latency, chain, failed,
                                      observed, success, cfg, device=DEVICE)
        if {t.device.type, lat.device.type} != {torch.device(DEVICE).type}:
            raise AssertionError("torch_apply_report left the card")
        want_t = np.array([
            T.reward(float(x), cfg) if success and c
            else T.penalize(float(x), cfg) if not success and f else float(x)
            for x, c, f in zip(trust, chain, failed)])
        want_l = np.array([
            T.ewma_latency(float(x), float(o), cfg.ewma_beta)
            if c and o > 0 else float(x)
            for x, o, c in zip(latency, observed, chain)])
        err_t = float(np.abs(t.cpu().numpy() - want_t).max())
        err_l = float((np.abs(lat.cpu().numpy() - want_l) / want_l).max())
        row["success" if success else "failure"] = {
            "trust_max_abs_err": err_t, "latency_max_rel_err": err_l}
        if err_t > 1e-6 or err_l > 1e-6:
            raise AssertionError(f"torch_apply_report off the rules: {row}")
    log({"trust_twin": {"peers": P, **row}})


def phase_hybrid_trust(cfg, params, main_tps):
    """Phase 16: serving on the hybrid trust architecture, its f32 parity,
    the sync plane at the paper's scale and the trust twin."""
    steps = {}
    for name, fn in (("serving", lambda: phase_hybrid_serving(cfg, params,
                                                              main_tps)),
                     ("f32_parity", lambda: phase_hybrid_parity(cfg,
                                                                params)),
                     ("sync_scale", phase_sync_scale),
                     ("trust_twin", phase_trust_twin)):
        t0 = time.perf_counter()
        fn()
        steps[name] = (time.perf_counter() - t0) * 1e3
    log({"hybrid_trust_step_ms": steps})


# ---------------------------------------------------------------------------
# Phase 17: hedged serving, the process-backed control plane, trace export
# ---------------------------------------------------------------------------

#: the served configuration: hedged executors, a 4-shard anchor of worker
#: processes behind the RPC control plane, and tracing
EDGE = dict(disaggregate=True, anchor_shards=4, control_plane="procs",
            hedge_enabled=True, trace_enabled=True)
#: hedges fired on phase 17's run, from the CPU rehearsal of the phase at a
#: tiny width (the simulation draws no value that depends on the width)
EDGE_HEDGES_FIRED = 140
#: the worker drill: the shard whose worker is killed, at which window
#: (all four streams decoding), and the tokens each stream emits through
#: it, from the same rehearsal: ``crash_anchor_shard`` crashes the shard's
#: peers with its worker, both golden replicas of stage 16 among them, so
#: the three short streams lose their chain there (primary and repair
#: dead) and end after 7 tokens, as the reference's one-shot repair rules
EDGE_CHAOS_SHARD = 1
EDGE_CHAOS_WINDOW = 8
EDGE_CHAOS_TOKENS = (7, 7, 7, 16)
#: the composer's public methods: the writes (replayed on the in-process
#: twin) and the reads, timed together as the composer's host time
CP_WRITES = ("register", "deregister", "heartbeat", "heartbeat_all",
             "apply_report", "sweep", "set_trust", "reset_trust")
CP_READS = ("snapshot", "sync", "routing_view")


class ComposerProbe:
    """For one serving run, wraps ``ProcessShardedRegistry``'s public
    methods and ``RpcChannel.post`` at class level: each composer keeps the
    script of its writes in call order (``probe_script``, what the twin
    replays), and while ``timing`` is on the host seconds spent in its
    outermost public calls (``probe_s``) and the RPCs posted (``rpcs``)
    are summed. Restores the classes on exit."""

    def __init__(self):
        from repro_torch.control_plane.registry import ProcessShardedRegistry
        from repro_torch.control_plane.rpc import RpcChannel
        self.cls, self.channel = ProcessShardedRegistry, RpcChannel
        self.timing = False
        self.rpcs = 0
        self.saved = {}

    def __enter__(self):
        probe = self

        def wrap(name, fn):
            def probed(reg, *a, **kw):
                if name in CP_WRITES:
                    reg.__dict__.setdefault("probe_script", []).append(
                        (name, a, kw))
                outer = not reg.__dict__.get("probe_depth")
                reg.probe_depth = reg.__dict__.get("probe_depth", 0) + 1
                t0 = time.perf_counter()
                try:
                    return fn(reg, *a, **kw)
                finally:
                    reg.probe_depth -= 1
                    if outer and probe.timing:
                        reg.probe_s = (reg.__dict__.get("probe_s", 0.0)
                                       + time.perf_counter() - t0)
            return probed

        def counted_post(fn):
            def post(ch, *a, **kw):
                probe.rpcs += probe.timing
                return fn(ch, *a, **kw)
            return post

        for name in CP_WRITES + CP_READS:
            self.saved[(self.cls, name)] = getattr(self.cls, name)
            setattr(self.cls, name, wrap(name, getattr(self.cls, name)))
        self.saved[(self.channel, "post")] = self.channel.post
        self.channel.post = counted_post(self.channel.post)
        return self

    def __exit__(self, *exc):
        for (cls, name), fn in self.saved.items():
            setattr(cls, name, fn)


def shard_workers() -> list:
    import multiprocessing as mp
    return [p for p in mp.active_children()
            if p.name.startswith("anchor-shard-")]


def close_servers(servers) -> None:
    """Close every server (its shard workers) and fail if a worker
    outlives the close."""
    for srv in servers:
        srv.close()
    for p in shard_workers():
        p.join(timeout=10)
    left = shard_workers()
    if left:
        raise AssertionError(f"shard workers left running: {left}")


def tally_forwards(srv, tally: dict) -> None:
    """Count the stage forwards of every submitted stream's executor by
    kind: a hop call made while the executor's hop count has not moved is
    the hedge of the call before it; a call that does not fail runs one
    real stage forward."""
    submit = srv.submit

    def submitted(spec):
        req = submit(spec)
        ex, last = req.executor, [-1]
        hop = ex.hop_fn

        def counted(pid, k, payload):
            hedge = ex.stats.hops == last[0]
            last[0] = ex.stats.hops
            out = hop(pid, k, payload)
            tally["hedge" if hedge else "primary"] += int(bool(out[2]))
            return out
        ex.hop_fn = counted
        return req
    srv.submit = submitted


def twin_digests(cp):
    """Replay the composer's recorded writes on an in-process
    ``ShardedAnchorRegistry``; return its per-shard digests and the
    digest of its composed state."""
    from repro_torch.core.digest import state_digest
    from repro_torch.core.sharding import ShardedAnchorRegistry
    twin = ShardedAnchorRegistry(cp.cfg, n_shards=cp.n_shards,
                                 shard_by=cp.shard_by)
    for name, a, kw in cp.probe_script:
        getattr(twin, name)(*a, **kw)
    return twin.digest_vector(), state_digest(twin.export_state(),
                                              cp.cfg.sync_digest_seed)


def composed_digest(cp) -> int:
    """Digest of the composer's composed state (every shard mirror's rows
    with their global seq), as the twin's ``export_state`` is digested:
    the XOR of the shard mirrors' row hashes."""
    from repro_torch.core import digest as D
    seed = cp.cfg.sync_digest_seed
    out = D.empty_digest(seed)
    for s in range(cp.n_shards):
        out ^= D.xor_rows(cp.export_shard_state(s), seed)
    return out


def check_edge_counts(cfg, srv, done, counts, forwards, tally):
    """Phase 3's gates on the hedged path: every stream's tokens, K1 once
    per DP window, K3 once per layer of every stage forward, primary and
    hedge forwards together (the hedges fired as rehearsed on the CPU)."""
    check_served(cfg, srv, done, counts, forwards)
    per_stage = cfg.num_layers // srv.partition.n_stages
    if tally["primary"] + tally["hedge"] != forwards or \
            counts["flash_attention"] != (tally["primary"]
                                          + tally["hedge"]) * per_stage:
        raise AssertionError(f"K3 launched {counts['flash_attention']} "
                             f"times for {tally} forwards x {per_stage}")
    fired = sum(r.metrics.hedges_fired for r in done)
    if EDGE_HEDGES_FIRED is not None and fired != EDGE_HEDGES_FIRED:
        raise AssertionError(f"{fired} hedges fired, the rehearsal fired "
                             f"{EDGE_HEDGES_FIRED}")
    if not tally["hedge"]:
        raise AssertionError("no hedge ran a stage forward")


def phase_hedged_serving(cfg, params, main_tps, servers):
    """Full-width GPT-2 Large through ``run_queue`` with hedging, the
    process-backed 4-shard anchor and tracing: K1 and K3 on the card,
    every shard a spawned worker behind the RPC control plane."""
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.kernels import ops
    tally = {"primary": 0, "hedge": 0}

    def prepare(s):
        servers.append(s)
        tally_forwards(s, tally)
        probe.timing = True

    with ComposerProbe() as probe:
        ops.reset_launch_counts()
        srv, done, wall, forwards = serve(
            cfg, params, workload(cfg.vocab_size),
            gcfg=GTRACConfig(**EDGE), prepare=prepare)
        counts = ops.launch_counts()
        probe.timing = False
    cp, st = srv._cp, srv.router.stats
    check_edge_counts(cfg, srv, done, counts, forwards, tally)
    h = cp.health
    if h.rpc_timeouts or h.degraded_windows or h.dropped_writes or \
            h.rpc_retries or any(r.metrics.shard_timeouts for r in done):
        raise AssertionError(f"an honest control-plane run: {h}")
    cp.sync(srv.bed.now)
    twin_vec, twin_all = twin_digests(cp)
    mine = composed_digest(cp)
    if cp.digest_vector() != twin_vec or mine != twin_all:
        raise AssertionError(f"composed digest {mine:#x} (shards "
                             f"{cp.digest_vector()}), in-process twin "
                             f"{twin_all:#x} ({twin_vec})")
    toks = sum(r.metrics.tokens for r in done)
    starts = [ch.transport.startup_ms for ch in cp.channels]
    log({"hedged_serving": {
        "model": cfg.name, "anchor_shards": cp.n_shards,
        "streams": len(done), "tokens": toks, "wall_s": wall,
        "tokens_per_s": toks / wall, "main_path_tokens_per_s": main_tps,
        "windows": st.windows, "dp_windows": st.device_calls,
        "stage_forwards": forwards, "primary_forwards": tally["primary"],
        "hedge_forwards": tally["hedge"],
        "hedges_fired": sum(r.metrics.hedges_fired for r in done),
        "hedges_won": sum(r.metrics.hedges_won for r in done),
        "launches": counts, "rpcs": probe.rpcs,
        "rpcs_per_window": probe.rpcs / st.windows,
        "composer_host_ms_per_window": cp.probe_s * 1e3 / st.windows,
        "composer_share_of_wall": cp.probe_s / wall,
        "worker_start_method": cp.channels[0].transport.start_method,
        "worker_startup_ms": starts, "health": dataclasses.asdict(h),
        "composed_digest": f"{mine:#018x}", "twin_digest_equal": True}})
    return srv, done


def phase_hedged_parity(cfg, params, servers):
    """The phase's configuration in f32 through the kernels and through
    the plain path: identical tokens and ServeMetrics, the hedge and
    control-plane fields included."""
    from repro_torch.configs.base import GTRACConfig
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    plain = dataclasses.replace(cfg32, attn_impl="xla")
    _, kdone, kwall, _ = serve(cfg32, params, workload(cfg.vocab_size),
                               gcfg=GTRACConfig(**EDGE),
                               prepare=servers.append)
    _, pdone, pwall, _ = serve(plain, params, workload(cfg.vocab_size),
                               router_backend="torch",
                               gcfg=GTRACConfig(**EDGE),
                               prepare=servers.append)
    for a, b in zip(kdone, pdone):
        if a.output != b.output or a.metrics.tokens != NEW_TOKENS:
            raise AssertionError(f"hedged f32 tokens differ for stream "
                                 f"{a.request_id}: kernels {a.output} vs "
                                 f"plain {b.output}")
        if dataclasses.asdict(a.metrics) != dataclasses.asdict(b.metrics):
            raise AssertionError(f"hedged f32 ServeMetrics differ for "
                                 f"stream {a.request_id}")
    log({"hedged_f32_parity": {
        "streams": len(kdone), "equal": True,
        "hedges_fired": sum(r.metrics.hedges_fired for r in kdone),
        "kernel_path_s": kwall, "plain_path_s": pwall}})


def phase_trace_export(srv, done):
    """The hedged run's trace, exported as JSONL and Chrome trace events
    into a temporary directory: the schema check finds no error, and each
    request's TTFT components sum to its measured TTFT within 1e-6 ms."""
    import tempfile
    from pathlib import Path as P

    from repro_torch.obs.export import (export_chrome, export_jsonl,
                                        validate_jsonl)
    from repro_torch.obs.report import format_report, ttft_breakdown
    with tempfile.TemporaryDirectory() as tmp:
        jpath, cpath = str(P(tmp) / "trace.jsonl"), str(P(tmp) / "trace.json")
        n = export_jsonl(srv.trace, jpath)
        nc = export_chrome(srv.trace, cpath)
        count, errors = validate_jsonl(jpath)
        events = len(json.loads(P(cpath).read_text())["traceEvents"])
        sizes = {"jsonl_bytes": P(jpath).stat().st_size,
                 "chrome_bytes": P(cpath).stat().st_size}
    if errors or count != n or nc != n or n != len(srv.trace):
        raise AssertionError(f"trace export: {count} of {n} spans, "
                             f"errors {errors[:5]}")
    rows = ttft_breakdown(srv.trace)
    worst = max(abs(r["ttft_sum_ms"] - r["measured_ttft_ms"]) for r in rows)
    by_rid = {r.request_id: r.metrics.ttft_ms for r in done}
    if len(rows) != len(done) or worst > 1e-6 or \
            any(r["measured_ttft_ms"] != by_rid[r["rid"]] for r in rows):
        raise AssertionError(f"TTFT identity off by {worst} ms: {rows}")
    domains = {}
    for sp in srv.trace.spans:
        domains[sp.domain] = domains.get(sp.domain, 0) + 1
    log({"trace_export": {"spans": n, "dropped": srv.trace.dropped,
                          "by_domain": domains, "chrome_events": events,
                          **sizes, "schema_errors": 0,
                          "ttft_identity_max_err_ms": worst}})
    log(format_report(srv.trace))


def phase_worker_chaos(cfg, params, servers):
    """The phase's configuration served while one shard's worker is
    SIGKILLed mid-run (``crash_anchor_shard(kill_worker=True)``, which also
    crashes the peers homed there) and respawned once a sync has degraded
    the shard: every stream ends, its first token emitted, with the
    tokens the rehearsal gave (``EDGE_CHAOS_TOKENS``), and after the
    restore the composer's shard mirrors equal the live workers'
    exports."""
    import numpy as np
    from repro_torch.configs.base import GTRACConfig
    drill = {"window": 0, "killed": None, "restart_ms": None}

    def prepare(s):
        servers.append(s)
        view = s._sync_and_view

        def drilled():
            drill["window"] += 1
            if drill["window"] == EDGE_CHAOS_WINDOW:
                drill["killed"] = s.bed.crash_anchor_shard(
                    EDGE_CHAOS_SHARD, kill_worker=True)
            table = view()
            if drill["killed"] is not None and drill["restart_ms"] is None \
                    and s._cp.health.degraded_windows:
                t0 = time.perf_counter()
                s._cp.restart_worker(EDGE_CHAOS_SHARD)
                drill["restart_ms"] = (time.perf_counter() - t0) * 1e3
                drill["restart_window"] = drill["window"]
            return table
        s._sync_and_view = drilled

    srv, done, wall, _ = serve(cfg, params, workload(cfg.vocab_size),
                               gcfg=GTRACConfig(**EDGE), prepare=prepare)
    cp = srv._cp
    h = cp.health
    tokens = tuple(r.metrics.tokens for r in done)
    if tokens != EDGE_CHAOS_TOKENS or not all(
            r.done and r.metrics.ttft_ms >= 0 for r in done):
        raise AssertionError(f"streams through the worker drill emitted "
                             f"{tokens} tokens, the rehearsal "
                             f"{EDGE_CHAOS_TOKENS}")
    if h.worker_restarts != 1 or h.degraded_windows < 1 or \
            drill["restart_ms"] is None:
        raise AssertionError(f"worker drill: {h}, {drill}")
    cp.sync(srv.bed.now)
    for s in range(cp.n_shards):
        mirror, live = (cp.export_shard_state(s),
                        cp.channels[s].request("export"))
        for f in dataclasses.fields(live):
            a, b = getattr(mirror, f.name), getattr(live, f.name)
            same = (a == b) if isinstance(b, list) else \
                np.array_equal(np.asarray(a), np.asarray(b))
            if not same:
                raise AssertionError(f"shard {s}: mirror {f.name} differs "
                                     "from the live worker's export")
    log({"worker_chaos": {
        "shard": EDGE_CHAOS_SHARD, "killed_at_window": EDGE_CHAOS_WINDOW,
        "restarted_at_window": drill["restart_window"],
        "crashed_peers": len(drill["killed"]),
        "restart_ms": drill["restart_ms"],
        "new_worker_startup_ms":
            cp.channels[EDGE_CHAOS_SHARD].transport.startup_ms,
        "streams": len(done), "tokens_per_stream": tokens,
        "wall_s": wall, "failures": sum(r.metrics.failures for r in done),
        "health": dataclasses.asdict(h), "mirrors_equal_workers": True}})


def phase_edge_control(cfg, params, main_tps):
    """Phase 17: hedged serving on the process-backed anchor with tracing,
    its f32 parity, the trace export and the worker drill. Every server
    is closed, and no shard worker outlives the phase."""
    steps, servers = {}, []
    t0 = time.perf_counter()
    try:
        srv, done = phase_hedged_serving(cfg, params, main_tps, servers)
        steps["hedged_serving"] = (time.perf_counter() - t0) * 1e3
        for name, fn in (("f32_parity",
                          lambda: phase_hedged_parity(cfg, params, servers)),
                         ("trace_export",
                          lambda: phase_trace_export(srv, done)),
                         ("worker_chaos",
                          lambda: phase_worker_chaos(cfg, params, servers))):
            t0 = time.perf_counter()
            fn()
            steps[name] = (time.perf_counter() - t0) * 1e3
    finally:
        close_servers(servers)
    log({"edge_control_step_ms": steps, "shard_workers_left": 0})


def window_device_work(fn, marker: str, iters: int = 200):
    """What one call of ``fn`` runs on the card, from ``torch.profiler``
    over ``iters`` calls (after one unprofiled call): its kernel launches
    and its copies each way (the device-to-host copy is the synchronising
    one), per recorded launch of ``marker``, a kernel that ``fn`` launches
    once per call. Per recorded launch, because after a long profiled
    window earlier in the process the profiler drops the first calls of a
    short one (all of a single call); None when it records no launch."""
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
    calls = {e.key: e.count for e in profiled_ops(prof)
             if e.device_type == DeviceType.CUDA}
    n = sum(c for k, c in calls.items() if marker in k)
    if not n:
        return None
    kernels = {k: c for k, c in calls.items()
               if not k.startswith(("Memcpy", "Memset"))}
    return {"kernels": sum(kernels.values()) / n,
            "kernel_names": sorted(k[:40] for k in kernels),
            "h2d": sum(c for k, c in calls.items() if "HtoD" in k) / n,
            "d2h": sum(c for k, c in calls.items() if "DtoH" in k) / n,
            "windows_recorded": n, "windows_run": iters}


def phase_routing(srv):
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.batch_router import plan_batched
    table = srv.seeker.view()
    out = {}
    for R in (1, 8, 64):
        taus = np.linspace(0.5, 0.99, R)
        row = {}

        def plan(backend):
            return plan_batched(table, srv.cfg.num_layers, srv.gcfg, taus,
                                planner=srv.planner, backend=backend,
                                device=srv.device)

        for backend in ("kernel", "torch", "numpy"):
            row[backend] = wall_ms(lambda: plan(backend),
                                   iters=15 if backend == "torch" else 40)
        for a, b in zip(plan("numpy"), plan("kernel")):
            if a.chain_rows != b.chain_rows:
                raise AssertionError(f"R={R}: kernel plans differ from the "
                                     "numpy planner's")
        ops.reset_launch_counts()
        plan("kernel")
        counts = ops.launch_counts()
        # the profiler can record no window at all right after a long
        # profiled run: a fresh profiler over more windows, up to 3 times
        work = None
        for iters in (200, 400, 800):
            work = window_device_work(lambda: plan("kernel"),
                                      "route_window_kbest_kernel", iters)
            if work is not None:
                break
        out[R] = row
        log({"routing_wall_ms_per_window": {
            "R": R, "P": len(table), **row, "hand_launches": counts,
            "kernel_window_device": work}})
        if counts["tropical_route_kbest"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"R={R}: a kernel-backend window launched "
                                 f"{counts}, not K1 once")
        if work is None:
            raise AssertionError(f"R={R}: the profiler recorded no "
                                 "kernel-backend window in 3 tries")
        # (a copy recorded at the edge of the profiled run, whose window's
        # kernel was dropped, can lift the copy ratio a little above 1)
        if work["kernels"] > 2 or work["h2d"] >= 1.5 or work["d2h"] >= 1.5:
            raise AssertionError(f"R={R}: the kernel backend's window ran "
                                 f"{work}: more than 2 kernels or 1 copy "
                                 "each way")
    return out


def phase_profile(cfg, params, key: str = "profile"):
    """Device time by kernel over a short main-path run (two streams, the
    kernels as in phase 3) under ``torch.profiler``: the device's busy
    share of the wall time, the top kernels, and each hand-written
    kernel's device-only time per launch, printed under ``key``. Prints
    "not measured" when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, done, wall, _ = serve(cfg, params, workload(cfg.vocab_size)[:2])
    kernels, ops = {}, {}       # name -> (device ms, calls)
    for e in profiled_ops(prof):
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            # device events are kernels; host ops carry the device time of
            # the kernels they launched (the same time, counted once each)
            side = kernels if e.device_type == DeviceType.CUDA else ops
            side[e.key] = (t / 1e3, e.count)
    if not kernels:
        log({key: "not measured (no device activity recorded)"})
        return

    def top(d):
        return [[k[:60], t, n] for k, (t, n) in
                sorted(d.items(), key=lambda kv: -kv[1][0])[:8]]

    busy = sum(t for t, _ in kernels.values())
    ours = {k[:40]: {"device_ms_per_launch": t / n, "launches": n}
            for k, (t, n) in kernels.items()
            if name_matches(k, ("route_kbest_kernel", "route_kernel(",
                                "route_window_kbest_kernel",
                                *K3_KERNELS))}
    log({key: {
        "model": cfg.name,
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


# ---------------------------------------------------------------------------
# Phases 10-14: kernels K4 and K5 and the KV-cache engine
# ---------------------------------------------------------------------------


def k4_bound_ms(B, Hq, Hkv, D, kv_len, dtype) -> tuple:
    """Least time for decode attention on this card: the live K and V rows,
    q and kv_len read once and the output written once, against the
    multiply-adds of QK^T and PV over the live rows at the peak rate of the
    input type."""
    import torch
    size = 2 if dtype == torch.bfloat16 else 4
    live = int(sum(kv_len))
    nbytes = size * (2 * live * Hkv * D + 2 * B * Hq * D) + 4 * B
    flops = 4 * Hq * D * live
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def k4_case(gen, dtype, name, B, S, Hq, Hkv, D, lens, timed,
            sms) -> dict:
    """K4 against its plain version on one shape (random normal q and
    cache from ``gen``, live rows ``lens``): fails beyond 2e-4 (f32) /
    2e-2 (bf16) absolute. The row names the split kernel that served it
    (``decode_plan``). With ``timed``, the kernel per call and on the
    device (split and combine together; failing unless the profiler saw
    the named split kernel), its plain version, SDPA with a live mask and
    the bound, with the split plan."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    name_t = str(dtype).replace("torch.", "")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.float32).to(dtype)
    q, k, v = randn(B, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    kernel, splits, _ = da.decode_plan(S, B, Hq, Hkv, D, dtype, sms)
    got = da.decode_attention_cuda(q, k, v, kv_len)
    want = da.decode_attention_plain(q, k, v, kv_len)
    sync()
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol[dtype]:
        raise AssertionError(
            f"K4 {name_t} {name} B={B} S={S} Hq={Hq} Hkv={Hkv} "
            f"D={D} kv_len={lens} ({kernel}): max abs err {err} > "
            f"{tol[dtype]}")
    row = {"dtype": name_t, "shape": name, "B": B, "S": S, "Hq": Hq,
           "Hkv": Hkv, "D": D, "kv_len": list(lens), "kernel": kernel,
           "max_abs_err": err}
    if timed:
        qt = q[:, :, None, :]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        live = (torch.arange(S, device=DEVICE)[None, :]
                < kv_len[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=live, enable_gqa=True)
        row["sdpa_max_abs_err"] = float(
            (sdpa()[:, :, 0].float() - want.float()).abs().max())
        row["ms"] = cuda_ms(lambda: da.decode_attention_cuda(
            q, k, v, kv_len), iters=200)
        row["device_ms_per_launch"], row["profiler_kernel"] = served_by(
            lambda: da.decode_attention_cuda(q, k, v, kv_len), kernel + "<",
            K4_KERNELS, f"K4 {name_t} {name}",
            companions=("decode_combine_kernel<",), iters=20)
        row["plain_ms"] = cuda_ms(lambda: da.decode_attention_plain(
            q, k, v, kv_len), iters=20)
        row["library_ms"] = cuda_ms(sdpa, iters=100)
        # every kernel of the SDPA call, mask handling included
        row["library_device_ms"] = device_ms(sdpa, None)
        row["bound_ms"], row["bound_by"] = k4_bound_ms(
            B, Hq, Hkv, D, lens, dtype)
        row["splits"] = splits
        row["ctas"] = splits * Hkv * B
    log({"k4": row})
    return row


def k4_split_rows(shapes, sms, dtype) -> list:
    """Each timed shape again with kv_len = 1 (every split past the first
    empty), on the first split boundary of the plan at ``dtype`` (S when
    one split holds every row), = S and in the middle."""
    from repro_torch.kernels import decode_attention as da
    out = []
    for name, B, S, Hq, Hkv, D, _, _ in shapes:
        _, _, bound = da.decode_plan(S, B, Hq, Hkv, D, dtype, sms)
        out.append((name + "-splits", B, S, Hq, Hkv, D,
                    (1, min(bound, S), S, S // 2 + 3)[:B], False))
    return out


def phase_k4():
    """K4 against its plain version at the engine's decode shapes, a ragged
    capacity and small shapes; timed beside its plain version, its bound
    and SDPA with a live mask, per call and on the device."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    # (name, B, S, Hq, Hkv, D, kv_len, timed)
    shapes = [("gpt2-large", 4, 1120, 20, 20, 64, (1, 37, 1056, 1120), True),
              ("tinyllama-1.1b", 4, 2144, 32, 4, 64, (1, 37, 2080, 2144),
               True),
              ("zamba2-2.7b", 4, 2144, 32, 32, 80, (2080,) * 4, True),
              ("ragged", 3, 1000, 16, 2, 128, (1, 129, 1000), True),
              ("small-d80", 2, 77, 8, 2, 80, (1, 77), False),
              ("small-gqa", 2, 64, 4, 2, 32, (1, 64), False),
              ("small-mha", 1, 128, 5, 5, 16, (77,), False),
              ("small-mqa", 2, 200, 8, 1, 64, (200, 3), False)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes + k4_split_rows(shapes[:4], sms, dtype):
            row = k4_case(gen, dtype, *shape, sms)
            if shape[-1]:
                rows[(row["dtype"], shape[0])] = row
    return rows


def k5_bound_ms(B, S, H, K) -> tuple:
    """Least time for the WKV scan on this card: r, k, v, lw read once and
    y written once (f32), u and state0 read and the final state written
    once, against the recurrence's 4 K^2 FLOP per token and head (the
    state product and the state update, 2 K^2 multiply-adds) at the rate
    of the kernel's split 3xTF32 products."""
    nbytes = 4 * (5 * B * S * H * K + H * K + 2 * B * H * K * K)
    flops = 4 * K * K * B * S * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TF32X3_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def k5_inputs(B, S, H, K, dist, gen, state=False, lw=None):
    """r, k, v, lw, u, state0 on the card. ``dist="ref"``: the reference
    test's distribution (normal r, k, v; lw = -exp(N - 2) or the constant
    ``lw``; u = 0.3 N). ``dist="model"``: what the engine's prefill gives
    at init (r, k, v of unit scale, lw = -exp(-6 + 0.1 N) from the base
    decay w0 = -6 and a small data-dependent part, u = 0.1)."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.float32)
    r, k, v = randn(B, S, H, K), randn(B, S, H, K), randn(B, S, H, K)
    if dist == "model":
        lwv = -torch.exp(-6.0 + 0.1 * randn(B, S, H, K))
        u = torch.full((H, K), 0.1, device=DEVICE)
    else:
        lwv = -torch.exp(randn(B, S, H, K) - 2.0) if lw is None else \
            torch.full((B, S, H, K), float(lw), device=DEVICE)
        u = 0.3 * randn(H, K)
    s0 = randn(B, H, K, K) if state else \
        torch.zeros((B, H, K, K), device=DEVICE)
    return r, k, v, lwv, u, s0


def phase_k5():
    """K5 against its plain version: the engine's prefill shape on
    model-like inputs (1e-4 x max|plain|), and the reference test's
    distribution (5e-4 absolute) at a short, a ragged, a nonzero-state,
    a strong-decay shape and the reference test's three shapes, and the
    engine's widths at two and three batch rows (64 and 96 (head, batch
    row) blocks, each side of ``WGMMA_MIN_BLOCKS``); y and the final
    state. Every shape timed beside its plain version and bound; then
    ``k5_dispatch``."""
    import torch
    from repro_torch.kernels import rwkv6_chunk as wk
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    # (name, B, S, H, K, dist, nonzero state0, constant lw)
    shapes = [("full-width", 4, 2048, 32, 64, "model", False, None),
              ("short", 4, 8, 32, 64, "ref", False, None),
              ("ragged", 4, 1000, 32, 64, "ref", False, None),
              ("state0", 4, 256, 32, 64, "ref", True, None),
              ("strong-decay", 2, 100, 4, 64, "ref", False, -20.0),
              ("strong-decay-wide", 4, 100, 32, 64, "ref", True, -20.0),
              ("batch-2", 2, 2048, 32, 64, "model", False, None),
              ("batch-3", 3, 2048, 32, 64, "model", False, None),
              ("kernels-test-1", 2, 64, 2, 16, "ref", False, None),
              ("kernels-test-2", 1, 128, 4, 32, "ref", False, None),
              ("kernels-test-3", 2, 96, 3, 8, "ref", False, None)]
    rows = {}
    for name, B, S, H, K, dist, state, lw in shapes:
        args = k5_inputs(B, S, H, K, dist, gen, state, lw)
        y, st = wk.wkv6_chunked_cuda(*args)
        py, pst = wk.wkv6_chunked_plain(*args)
        sync()
        finite = bool(torch.isfinite(y).all()) and \
            bool(torch.isfinite(st).all())
        err_y = float((y - py).abs().max())
        err_s = float((st - pst).abs().max())
        if dist == "model":
            tol_y = 1e-4 * float(py.abs().max())
            tol_s = 1e-4 * float(pst.abs().max())
        else:
            tol_y = tol_s = 5e-4
        if not (finite and err_y <= tol_y and err_s <= tol_s):
            raise AssertionError(
                f"K5 {name} B={B} S={S} H={H} K={K}: finite={finite}, max "
                f"abs err y {err_y} (tol {tol_y}), state {err_s} (tol "
                f"{tol_s})")
        row = {"shape": name, "B": B, "S": S, "H": H, "K": K,
               "inputs": dist, "max_abs_err": max(err_y, err_s),
               "max_abs_err_y": err_y, "max_abs_err_state": err_s,
               "tol_y": tol_y, "tol_state": tol_s,
               "max_abs_y_plain": float(py.abs().max())}
        big = B * S * H * K > 1 << 22
        names = wk.scan_kernel(K, B, H)
        if name == "full-width" and names != K5_ENGINE_KERNELS:
            raise AssertionError(f"K5 at the engine's shape: {names}")
        row["kernels"] = list(names)
        row["ms"] = cuda_ms(lambda: wk.wkv6_chunked_cuda(*args),
                            iters=20 if big else 100)
        each = scan_device_ms(lambda: wk.wkv6_chunked_cuda(*args), names,
                              K5_KERNELS, f"K5 {name}",
                              iters=10 if big else 20)
        # the mma.sync design: pre-pass and scan; the Hopper kernel: one
        row["prep_device_ms"] = each[names[0]] if len(names) > 1 else None
        row["scan_device_ms"] = each[names[-1]]
        row["device_ms_per_launch"] = sum(each.values())
        row["plain_ms"] = cuda_ms(lambda: wk.wkv6_chunked_plain(*args),
                                  iters=5 if big else 20, warmup=1)
        row["bound_ms"], row["bound_by"] = k5_bound_ms(B, S, H, K)
        per_sm, _ = wk.scan_occupancy(K, wk.uses_wgmma(K, B, H))
        grid = wk.scan_plan(B, S, H, K)["grid"]
        row["grid"] = list(grid)
        row.update(grid_fit(math.prod(grid), per_sm))
        row["prep_ctas"] = (-(-S // wk.CUDA_CHUNK) * H * B if len(names) > 1
                            else None)
        rows[name] = row
        log({"k5": row})
    k5_dispatch(gen)
    return rows


def k5_dispatch(gen) -> None:
    """Both K5 designs at RWKV6's H = 32, K = 64 on model-like inputs, at
    B = 1 to 4 (32 to 128 (head, batch row) blocks) and S = 100, 512,
    2048: each checked against the plain version (1e-4 x max|plain|) and
    timed on the device, beside the one ``scan_kernel`` picks there. The
    choice is forced by setting ``WGMMA_MIN_BLOCKS`` for the call."""
    import torch
    from repro_torch.kernels import rwkv6_chunk as wk
    picked = wk.WGMMA_MIN_BLOCKS
    H, K = 32, 64
    for S in (100, 512, 2048):
        for B in (1, 2, 3, 4):
            args = k5_inputs(B, S, H, K, "model", gen)
            py, pst = wk.wkv6_chunked_plain(*args)
            row = {"B": B, "S": S, "H": H, "K": K, "blocks": B * H,
                   "picked": "wgmma" if wk.uses_wgmma(K, B, H)
                   else "mma_sync"}
            try:
                for tag, least in (("wgmma", 0), ("mma_sync", 1 << 30)):
                    wk.WGMMA_MIN_BLOCKS = least
                    y, st = wk.wkv6_chunked_cuda(*args)
                    err = max(float((y - py).abs().max())
                              / float(py.abs().max()),
                              float((st - pst).abs().max())
                              / float(pst.abs().max()))
                    if not err <= 1e-4:
                        raise AssertionError(
                            f"K5 dispatch {tag} B={B} S={S}: max abs err "
                            f"{err} x max|plain| (tol 1e-4)")
                    names = wk.scan_kernel(K, B, H)
                    each = scan_device_ms(
                        lambda: wk.wkv6_chunked_cuda(*args), names,
                        K5_KERNELS, f"K5 dispatch {tag} B={B} S={S}",
                        iters=10)
                    row[f"{tag}_device_ms"] = sum(each.values())
                    row[f"{tag}_rel_err"] = err
            finally:
                wk.WGMMA_MIN_BLOCKS = picked
            row["faster"] = ("wgmma" if row["wgmma_device_ms"]
                             <= row["mma_sync_device_ms"] else "mma_sync")
            log({"k5_dispatch": row})
            del args, py, pst
    sync()


def k6_bound_ms(B, S, H, P, N) -> tuple:
    """Least time for the SSD scan on this card: x read and y written once,
    dt, la, Bm, Cm, h0 read and the final state written once (f32), against
    the operations the function needs. Per token and head 2 N P for the
    state update and 2 N P for the inter-chunk output; per chunk of c
    tokens (C = 64, the last one ragged) and head the lower triangle s <= t
    of the intra-chunk product, c (c + 1) / 2 entries of 2 P: those at the
    rate of the scan's split 3xTF32 products; and per chunk and batch row
    that triangle of C . B^T (shared by the heads), c (c + 1) / 2 entries
    of 2 N, at the FP32 peak (the pre-pass's FMAs). The upper triangle,
    which a chunked kernel may compute and mask, carries no data."""
    C = 64
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * H + 2 * B * S * N
                  + 2 * B * H * N * P)
    tri = (S // C) * C * (C + 1) + (S % C) * (S % C + 1)  # sum of c (c + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (B * H * (4 * N * P * S + P * tri) / TF32X3_FLOP_PER_S
             + B * N * tri / FP32_FLOP_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", t_bytes, t_ops)


def k6_inputs(B, S, H, P, N, dist, gen, state=False, decay=None):
    """x, dt, la, Bm, Cm, h0 on the card. ``dist="ref"``: the reference
    test's distribution (normal x, Bm, Cm; dt = softplus(N); la =
    -exp(N - 1) dt, or ``decay`` dt). ``dist="model"``: what the engine's
    prefill gives at init (x, Bm, Cm = silu of the depthwise conv of a
    unit-scale projection, ~silu(0.2 N); dt = softplus(N) from dt_bias = 0;
    la = -dt from A_log = 0)."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.float32)
    dt = F.softplus(randn(B, S, H))
    if dist == "model":
        x, Bm, Cm = (F.silu(0.2 * randn(*shape)) for shape in
                     ((B, S, H, P), (B, S, N), (B, S, N)))
        la = -dt
    else:
        x, Bm, Cm = randn(B, S, H, P), randn(B, S, N), randn(B, S, N)
        la = (-torch.exp(randn(B, S, H) - 1.0) if decay is None
              else torch.full_like(dt, float(decay))) * dt
    h0 = randn(B, H, N, P) if state else \
        torch.zeros((B, H, N, P), device=DEVICE)
    return x, dt, la, Bm, Cm, h0


def phase_k6():
    """K6 against its plain version: the engine's prefill shape on
    model-like inputs (1e-4 x max|plain|), and the reference test's
    distribution at a short, a ragged, a nonzero-state and a strong-decay
    shape (1e-5 x max|plain|) and at the reference test's two shapes (5e-4
    absolute); y and the final state. Every shape timed beside its plain
    version and its bound."""
    import torch
    from repro_torch.kernels import ssd_chunk as sk
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    # (name, B, S, H, P, N, dist, nonzero h0, constant decay)
    shapes = [("full-width", 4, 2048, 80, 64, 64, "model", False, None),
              ("short", 4, 8, 80, 64, 64, "ref", False, None),
              ("ragged", 4, 1000, 80, 64, 64, "ref", False, None),
              ("state0", 4, 256, 80, 64, 64, "ref", True, None),
              ("strong-decay", 2, 100, 8, 64, 64, "ref", True, -20.0),
              ("kernels-test-1", 2, 64, 2, 16, 8, "ref", False, None),
              ("kernels-test-2", 1, 128, 4, 32, 16, "ref", False, None)]
    rows = {}
    for name, B, S, H, P, N, dist, state, decay in shapes:
        args = k6_inputs(B, S, H, P, N, dist, gen, state, decay)
        y, h = sk.ssd_chunked_cuda(*args)
        py, ph = sk.ssd_chunked_plain(*args)
        sync()
        finite = bool(torch.isfinite(y).all()) and \
            bool(torch.isfinite(h).all())
        err_y = float((y - py).abs().max())
        err_h = float((h - ph).abs().max())
        # the reference test's 5e-4 at its own shapes (|y| <= ~50, so
        # ~1e-5 of scale); 1e-5 of scale for its distribution at the
        # engine's widths (N = 64: |y| up to ~200); 1e-4 of scale at the
        # engine's shape on model-like inputs
        rel = 1e-4 if dist == "model" else 1e-5
        tol_y = rel * float(py.abs().max())
        tol_h = rel * float(ph.abs().max())
        if name.startswith("kernels-test"):
            tol_y = tol_h = 5e-4
        if not (finite and err_y <= tol_y and err_h <= tol_h):
            raise AssertionError(
                f"K6 {name} B={B} S={S} H={H} P={P} N={N}: finite={finite}, "
                f"max abs err y {err_y} (tol {tol_y}), state {err_h} (tol "
                f"{tol_h})")
        row = {"shape": name, "B": B, "S": S, "H": H, "P": P, "N": N,
               "inputs": dist, "max_abs_err": max(err_y, err_h),
               "max_abs_err_y": err_y, "max_abs_err_state": err_h,
               "tol_y": tol_y, "tol_state": tol_h,
               "max_abs_y_plain": float(py.abs().max())}
        big = B * S * H * P > 1 << 22
        names = sk.scan_kernel(P, N)
        if name == "full-width" and names != K6_ENGINE_KERNELS:
            raise AssertionError(f"K6 at the engine's shape: {names}")
        row["kernels"] = list(names)
        row["ms"] = cuda_ms(lambda: sk.ssd_chunked_cuda(*args),
                            iters=20 if big else 100)
        each = scan_device_ms(lambda: sk.ssd_chunked_cuda(*args), names,
                              K6_KERNELS, f"K6 {name}",
                              iters=10 if big else 20)
        row["prep_device_ms"], row["scan_device_ms"] = (each[names[0]],
                                                        each[names[1]])
        row["device_ms_per_launch"] = sum(each.values())
        row["plain_ms"] = cuda_ms(lambda: sk.ssd_chunked_plain(*args),
                                  iters=5 if big else 20, warmup=1)
        (row["bound_ms"], row["bound_by"], row["bytes_ms"],
         row["operations_ms"]) = k6_bound_ms(B, S, H, P, N)
        per_sm, _ = sk.scan_occupancy(P, N)
        grid = sk.scan_plan(B, S, H, P, N)["grid"]
        row["grid"] = list(grid)
        row.update(grid_fit(math.prod(grid), per_sm))
        row["prep_ctas"] = (-(-S // sk.WGMMA_STEP) * B
                            if (P, N) in sk.WGMMA_SHAPES
                            else -(-S // sk.CHUNK) * 4 * B)
        rows[name] = row
        log({"k6": row})
    return rows


def engine_requests(eng, vocab: int, groups, new_tokens: int):
    """Submit ``groups`` of (prompt length, count) requests, prompts drawn
    from the seed."""
    import numpy as np
    from repro_torch.serving.api import SubmitSpec
    rng = np.random.default_rng(SEED)
    return [eng.submit(SubmitSpec(prompt=rng.integers(1, vocab, size=n),
                                  max_new_tokens=new_tokens))
            for n, count in groups for _ in range(count)]


def cache_nbytes(cache) -> int:
    """Bytes of a serving cache as allocated: every tensor, plus the
    index counted as the reference's int32 scalar."""
    import torch
    return sum(t.numel() * t.element_size() for t in cache.values()
               if isinstance(t, torch.Tensor)) + 4


def timed_engine(cfg, params):
    """A ``ServingEngine`` whose prefill and decode calls are timed (each
    ends synchronised) and whose caches are measured."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, device=DEVICE)
    eng.prefill_s, eng.decode_s, eng.cache_bytes_seen = [], [], []
    prefill, decode = eng._prefill, eng._decode

    def timed_prefill(p, toks, cap):
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(p, toks, cap)
        sync()
        eng.prefill_s.append(time.perf_counter() - t0)
        eng.cache_bytes_seen.append((tuple(toks.shape), cap,
                                     cache_nbytes(cache)))
        return logits, cache

    def timed_decode(p, token, cache):
        sync()
        t0 = time.perf_counter()
        out = decode(p, token, cache)
        sync()
        eng.decode_s.append(time.perf_counter() - t0)
        return out

    eng._prefill, eng._decode = timed_prefill, timed_decode
    return eng


def engine_params(arch, gpt2_params):
    """Full-width parameters: the main path's GPT-2 Large ones, or the
    arch's made from the seed with its family's ``init``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash",
                              remat=False)
    if arch == "gpt2-large":
        return cfg, gpt2_params
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    return cfg, build_model(cfg).init(gen, DEVICE)


def n_parameters(params) -> int:
    import torch
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(n_parameters(p) for p in items)


def expected_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """The engine's kernel launches: a dense or MoE model runs K3 once per
    layer of every prefill and K4 once per layer of every decode step; RWKV6
    runs K5 once per layer of every prefill and no attention kernel;
    Zamba2 runs K6 once per Mamba2 block of every prefill, and K3 (prefill)
    and K4 (decode step) once per application of its shared block."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return {"wkv6_chunked": L * prefills, "flash_attention": 0,
                "decode_attention": 0, "ssd_chunked": 0}
    if cfg.family == "hybrid":
        groups = L // cfg.attn_every
        return {"ssd_chunked": L * prefills,
                "flash_attention": groups * prefills,
                "decode_attention": groups * decode_steps,
                "wkv6_chunked": 0}
    return {"flash_attention": L * prefills,
            "decode_attention": L * decode_steps, "wkv6_chunked": 0,
            "ssd_chunked": 0}


def check_launches(tag, counts, want) -> None:
    """Every kernel in ``want`` launched exactly as often as the path
    needs."""
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{tag}: {name} launched {counts[name]} "
                                 f"times, the path needs {n}")


def check_engine_launches(arch, cfg, eng, counts) -> None:
    """Every kernel launched exactly as the engine's path needs
    (``expected_launches``)."""
    check_launches(f"engine {arch} ({eng.prefills} prefills, "
                   f"{eng.decode_steps} decode steps, {cfg.num_layers} "
                   "layers)", counts,
                   expected_launches(cfg, eng.prefills, eng.decode_steps))


def run_engine(arch, cfg, params, groups) -> dict:
    """The KV-cache engine on ``groups`` of requests, ENGINE_TOKENS new
    tokens each, after a warm-up run of the same requests: fails unless
    every stream gets its tokens, the engine runs one prefill per group
    and ENGINE_TOKENS - 1 decode steps per group, every kernel launches as
    the path needs and every cache's bytes equal ``cache_bytes``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.kv_cache import cache_bytes
    # warm-up run with the timed run's requests: every prefill and
    # decode shape of the timed window is seen once before it
    warm = timed_engine(cfg, params)
    engine_requests(warm, cfg.vocab_size, groups, ENGINE_TOKENS)
    warm.run_batch()
    sync()
    eng = timed_engine(cfg, params)
    reqs = engine_requests(eng, cfg.vocab_size, groups, ENGINE_TOKENS)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    done = eng.run_batch()
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    for r in done:
        if len(r.output) != ENGINE_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"engine {arch}: request "
                                 f"{r.request_id} gave {r.output}")
    if len(done) != len(reqs):
        raise AssertionError(f"engine {arch}: {len(done)} of "
                             f"{len(reqs)} requests served")
    if eng.prefills != len(groups) or \
            eng.decode_steps != len(groups) * (ENGINE_TOKENS - 1):
        raise AssertionError(
            f"engine {arch}: {eng.prefills} prefills and "
            f"{eng.decode_steps} decode steps for {len(groups)} groups "
            f"of {ENGINE_TOKENS} tokens")
    check_engine_launches(arch, cfg, eng, counts)
    for shape, cap, nbytes in eng.cache_bytes_seen:
        if nbytes != cache_bytes(cfg, shape[0], cap):
            raise AssertionError(f"engine {arch}: cache of {nbytes} "
                                 f"bytes, cache_bytes says "
                                 f"{cache_bytes(cfg, shape[0], cap)}")
    tokens = sum(len(r.output) for r in done)
    return {"arch": arch, "family": cfg.family,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "vocab": cfg.vocab_size, "parameters": n_parameters(params),
            "param_dtype": cfg.param_dtype,
            "activation_dtype": cfg.activation_dtype,
            "groups": [list(g) for g in groups],
            "new_tokens": ENGINE_TOKENS, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "prefill_ms": [t * 1e3 for t in eng.prefill_s],
            "decode_ms_per_step_median": sorted(eng.decode_s)[
                len(eng.decode_s) // 2] * 1e3,
            "decode_steps": eng.decode_steps, "prefills": eng.prefills,
            "launches": counts,
            "cache_bytes": [[list(s), c, b] for s, c, b in
                            eng.cache_bytes_seen],
            "max_memory_allocated": peak}


def phase_engine(gpt2_params):
    """The KV-cache engine at full width, bf16, through the kernels."""
    out = {}
    for arch, groups in ENGINE_RUNS:
        cfg, params = engine_params(arch, gpt2_params)
        row = run_engine(arch, cfg, params, groups)
        if arch == "zamba2-2.7b" and row["parameters"] != ZAMBA2_PARAMETERS:
            raise AssertionError(f"engine {arch}: {row['parameters']} "
                                 f"parameters, the reference has "
                                 f"{ZAMBA2_PARAMETERS}")
        out[arch] = row
        log({"engine": row})
        # the engines hold the parameters too, inside reference cycles
        # (their timed closures): drop and collect them, so the next
        # model's peak memory is its own
        del params
        gc.collect()
    return out


def engine_tokens(cfg, params, groups, new_tokens):
    eng = timed_engine(cfg, params)
    reqs = engine_requests(eng, cfg.vocab_size, groups, new_tokens)
    prompts = [r.prompt for r in reqs]
    sync()
    t0 = time.perf_counter()
    done = eng.run_batch()
    sync()
    return [r.output for r in done], prompts, time.perf_counter() - t0


def top2_margin(cfg, params, prompt, prefix) -> float:
    """The gap between the two largest logits of the plain path at the
    step that follows ``prompt`` + ``prefix`` (one stream)."""
    import torch
    from repro_torch.models.api import build_model
    toks = torch.as_tensor([list(prompt) + list(prefix)], dtype=torch.int64,
                           device=DEVICE)
    with torch.inference_mode():
        logits, _ = build_model(cfg).prefill(params, tokens=toks,
                                             capacity=toks.shape[1] + 1)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_engine_parity(gpt2_params):
    """f32: the kernel path and the plain path (attn_impl="xla") give the
    same greedy tokens, on gpt2-large.reduced-, rwkv6-1.6b.reduced- and
    zamba2-2.7b.reduced-sized models and on full-width TinyLlama, RWKV6
    and Zamba2 (each model's parameters made when its case runs)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)

    def reduced(arch, **over):
        cfg = dataclasses.replace(get_config(arch).reduced(**over),
                                  attn_impl="flash")
        return lambda: (cfg, build_model(cfg).init(gen, DEVICE))

    def full(arch):
        return lambda: engine_params(arch, gpt2_params)

    # RWKV6: at full width (H = 32) two prompts on the mma.sync kernels
    # and four, with a ragged tail, on wkv6_wgmma_kernel
    rwkv_groups = ((64, 2), (100, 4))
    # prompts across chunks of 64 with a ragged tail (100), and within one
    zamba_groups = ((8, 2), (100, 2))
    cases = [("zamba2-2.7b.reduced",
              reduced("zamba2-2.7b", num_layers=4, attn_every=2),
              zamba_groups),
             ("zamba2-2.7b", full("zamba2-2.7b"), zamba_groups,
              K6_ENGINE_KERNELS),
             ("gpt2-large.reduced", reduced("gpt2-large", num_layers=4),
              ((8, 3), (200, 2))),
             ("tinyllama-1.1b", full("tinyllama-1.1b"), ((16, 2), (320, 2))),
             ("rwkv6-1.6b.reduced", reduced("rwkv6-1.6b", num_layers=4),
              rwkv_groups),
             ("rwkv6-1.6b", full("rwkv6-1.6b"), rwkv_groups,
              K5_ENGINE_KERNELS + ("wkv6_prep_kernel", "wkv6_scan_kernel"))]
    for name, make, groups, *scans in cases:
        cfg, params = make()
        engine_parity(name, cfg, params, groups, *scans)
        del params


class RouterLog:
    """Records every MoE routing decision while active: each call's
    selected expert sets (``route_topk``'s idx, sorted per token)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.sets, self._orig = [], moe.route_topk

        def recorded(cfg, p, xf):
            gates, idx, probs = self._orig(cfg, p, xf)
            self.sets.append(idx.sort(dim=-1).values)
            return gates, idx, probs

        moe.route_topk = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route_topk = self._orig


def router_flips(a: RouterLog, b: RouterLog) -> int:
    """Tokens whose selected expert set differs between two runs, over
    their routing calls in order, as far as the calls align (same count
    of tokens)."""
    flips = 0
    for x, y in zip(a.sets, b.sets):
        if x.shape != y.shape:
            break
        flips += int((x != y).any(dim=-1).sum())
    return flips


class ScanLog:
    """Records the K5 and K6 kernels that run while active: each call of
    their wrappers through ``ops`` adds the names its wrapper's
    ``scan_kernel`` gives at the call's shape, the choice the wrapper
    itself makes."""

    def __enter__(self):
        from repro_torch.kernels import ops, rwkv6_chunk as wk, \
            ssd_chunk as sk
        self.kernels = set()
        self._orig = (ops.wkv6_chunked_cuda, ops.ssd_chunked_cuda)
        wkv6, ssd = self._orig

        def wkv6_logged(r, *rest):
            B, _, H, K = r.shape
            self.kernels.update(wk.scan_kernel(K, B, H))
            return wkv6(r, *rest)

        def ssd_logged(x, *rest):
            self.kernels.update(sk.scan_kernel(x.shape[-1],
                                               rest[2].shape[-1]))
            return ssd(x, *rest)

        ops.wkv6_chunked_cuda, ops.ssd_chunked_cuda = wkv6_logged, ssd_logged
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.wkv6_chunked_cuda, ops.ssd_chunked_cuda = self._orig


def engine_parity(name, cfg, params, groups, scans=()) -> dict:
    """f32 greedy tokens of the kernel path equal the plain path's
    (``attn_impl="xla"``) on ``groups`` of requests, PARITY_TOKENS new
    tokens each; on a mismatch the plain path's top-2 logit margin at the
    first differing step is printed, and for MoE models the router's
    top-k sets that differ between the two runs are counted either way.
    Fails unless the kernel path's prefills ran every K5 / K6 kernel named
    in ``scans`` (``ScanLog``)."""
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    plain32 = dataclasses.replace(cfg32, attn_impl="xla")
    with RouterLog() as k_log, ScanLog() as scan_log:
        k_out, prompts, k_s = engine_tokens(cfg32, params, groups,
                                            PARITY_TOKENS)
    missing = [n for n in scans if n not in scan_log.kernels]
    if missing:
        raise AssertionError(f"engine f32 {name}: the kernel path ran "
                             f"{sorted(scan_log.kernels)}, not {missing}")
    with RouterLog() as p_log:
        p_out, _, p_s = engine_tokens(plain32, params, groups,
                                      PARITY_TOKENS)
    row = {"model": name, "requests": len(k_out), "kernel_path_s": k_s,
           "plain_path_s": p_s, "scan_kernels": sorted(scan_log.kernels)}
    if cfg.family == "moe":
        row["router_calls"] = len(k_log.sets)
        row["router_topk_sets_differing"] = router_flips(k_log, p_log)
    if k_out != p_out or any(len(o) != PARITY_TOKENS for o in k_out):
        for i, (ko, po) in enumerate(zip(k_out, p_out)):
            if ko != po:
                t = next((t for t, (a, b) in enumerate(zip(ko, po))
                          if a != b), min(len(ko), len(po)))
                log({"engine_f32_divergence": {
                    **row, "request": i, "step": t,
                    "kernel_token": ko[t] if t < len(ko) else None,
                    "plain_token": po[t] if t < len(po) else None,
                    "top2_logit_margin": top2_margin(
                        plain32, params, prompts[i], po[:t])}})
                break
        raise AssertionError(f"engine f32 {name}: kernel path {k_out} "
                             f"vs plain path {p_out}")
    row["equal"] = True
    log({"engine_f32_parity": row})
    return row


def profile_window(fn):
    """Run ``fn`` (ending synchronised) under ``torch.profiler``; returns
    (wall s, {device kernel: (ms, calls)}, {host op: (device ms, calls)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kernels, ops_ms = {}, {}
    for e in profiled_ops(prof):
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            side = kernels if e.device_type == DeviceType.CUDA else ops_ms
            side[e.key] = (t / 1e3, e.count)
    return wall, kernels, ops_ms


def profile_summary(wall, kernels, ops_ms, hand):
    """The device's busy share, each hand-written kernel's device time
    (``hand``: [(tag, profiler names)], the kernels whose names match)
    against the weight casts (``aten::copy_``) and the matmuls
    (``aten::mm``), and the top items."""
    busy = sum(t for t, _ in kernels.values())
    out = {"wall_s": wall, "device_busy_ms": busy,
           "device_busy_share": busy / (wall * 1e3)}
    for tag, names in hand:
        mine = [(t, n) for k, (t, n) in kernels.items()
                if name_matches(k, names)]
        mine_ms = sum(t for t, _ in mine)
        out.update({f"{tag}_ms": mine_ms,
                    f"{tag}_kernel_launches": sum(n for _, n in mine),
                    f"{tag}_share_of_busy": mine_ms / busy})
    return {**out,
            "copy_ms": ops_ms.get("aten::copy_", (0.0, 0))[0],
            "mm_ms": ops_ms.get("aten::mm", (0.0, 0))[0],
            "top_ops_ms_calls": [[k[:60], t, n] for k, (t, n) in sorted(
                ops_ms.items(), key=lambda kv: -kv[1][0])[:8]],
            "top_kernels_ms_calls": [[k[:60], t, n] for k, (t, n) in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])[:8]]}


def engine_profile(arch, cfg, params, S: int, steps: int = 8) -> None:
    """Device time by kernel over one prefill of 4 prompts of ``S`` tokens
    and over ``steps`` decode steps after it: the device's busy share and
    the hand-written kernels' shares (K3 in the attention prefills, K5 in
    RWKV6's, K6 and K3 in Zamba2's, K4 in decode; K4's split and combine
    kernels, K6's pre-pass and scan, each pair together, its
    ``*_kernel_launches`` counting both) against the weight casts and the
    matmuls. RWKV6's and Zamba2's prefills fail unless K5 and K6 ran as
    the Hopper kernels (``K5_ENGINE_KERNELS``, ``K6_ENGINE_KERNELS``)."""
    import torch
    from repro_torch.models.api import build_model
    model = build_model(cfg)
    toks = torch.randint(1, cfg.vocab_size, (4, S), device=DEVICE,
                         generator=torch.Generator(device=DEVICE)
                         .manual_seed(SEED))
    state = {}

    def prefill():
        state["logits"], state["cache"] = model.prefill(
            params, tokens=toks, capacity=S + steps + 1)

    def decode():
        for _ in range(steps):
            cur = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
            state["logits"], state["cache"] = model.decode_step(
                params, cur, state["cache"])

    windows = []
    with torch.inference_mode():
        prefill()
        cur = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        model.decode_step(params, cur, state["cache"])      # warm
        sync()
        k3 = ("k3", K3_KERNELS)
        if cfg.family == "ssm":
            hand = [("k5", K5_KERNELS)]
        elif cfg.family == "hybrid":
            hand = [("k6", K6_KERNELS), k3]
        else:
            hand = [k3]
        windows.append(("prefill", hand, profile_window(prefill)))
        windows.append(("decode", [] if cfg.family == "ssm" else
                        [("k4", K4_KERNELS)], profile_window(decode)))
    for window, hand, (wall, kernels, ops_ms) in windows:
        head = {"arch": arch, "window": window, "batch": 4, "prompt": S}
        if window == "decode":
            head["decode_steps"] = steps
        if not kernels:
            log({"engine_profile": {**head, "profile": "not measured "
                                    "(no device activity recorded)"}})
            continue
        if window == "prefill" and cfg.family == "ssm":
            check_scan_names(f"{arch} prefill", kernels, K5_KERNELS,
                             K5_ENGINE_KERNELS)
        elif window == "prefill" and cfg.family == "hybrid":
            check_scan_names(f"{arch} prefill", kernels, K6_KERNELS,
                             K6_ENGINE_KERNELS)
        log({"engine_profile": {**head, **profile_summary(
            wall, kernels, ops_ms, hand)}})


def phase_engine_profile(gpt2_params):
    """``engine_profile`` of each engine model at its longest prompts."""
    for arch, groups in ENGINE_RUNS:
        cfg, params = engine_params(arch, gpt2_params)
        engine_profile(arch, cfg, params, groups[-1][0])
        del params


# ---------------------------------------------------------------------------
# Phase 18: the rest of the decoder zoo (RoPE and MoE models)
# ---------------------------------------------------------------------------


#: K3's and K4's head shapes of the new models: (arch, Hq, Hkv, D)
ZOO_HEADS = (("smollm-360m", 15, 5, 64), ("qwen3-moe-30b-a3b", 32, 4, 64),
             ("starcoder2-7b", 36, 4, 128),
             ("phi3.5-moe-42b-a6.6b", 32, 8, 128),
             ("granite-34b", 48, 1, 128))
#: K3's batch and prompt (the engine's longest prefill)
ZOO_K3 = (4, 2048)
#: the model served through run_queue at full width
ZOO_MAIN = "qwen3-moe-30b-a3b"
#: layers kept (of 48) in the f32 kernel-vs-plain run_queue comparison
ZOO_PARITY_LAYERS = 8
#: the engine's models: (arch, parameter dtype, layers kept, None = all).
#: In f32, granite-34b (134.6 GB), qwen3-moe (120.3 GB) and phi3.5-moe
#: (167.5 GB) exceed one 80 GB card; phi3.5-moe's 83.7 GB in bf16 too, so
#: its depth is cut to 24 of 32 layers (~63 GB)
ZOO_ENGINE = (("qwen3-moe-30b-a3b", "bfloat16", None),
              ("smollm-360m", "float32", None),
              ("starcoder2-7b", "float32", None),
              ("granite-34b", "bfloat16", None),
              ("phi3.5-moe-42b-a6.6b", "bfloat16", 24))
#: the engine's workload (phase 11's): 4 prompts of 8 and 4 of 2048
ZOO_ENGINE_GROUPS = ((8, 4), (2048, 4))
#: the f32 kernel-vs-plain engine comparison's requests
ZOO_PARITY_GROUPS = ((16, 2), (320, 2))
#: run_queue's windows (each runs the DP) and stage forwards for the main
#: workload on the 48-layer topology (24 stages x 6 replicas), from the
#: CPU rehearsal of this phase: the simulation draws nothing that depends
#: on the model's width
ZOO_WINDOWS = 34
ZOO_FORWARDS = 1608


def phase_zoo_kernels():
    """K3 (B = 4, S = 2048, causal) and K4 (B = 4 at the engine's decode
    capacity, 2144 rows) against their plain versions at each new model's
    head shape, bf16 and f32, timed beside SDPA and the bound; K4 also
    with kv_len on a split boundary (``*-splits`` rows)."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, S = ZOO_K3
    cap = S + ENGINE_TOKENS + 64              # ServingEngine's capacity
    k4_shapes = [(arch, B, cap, Hq, Hkv, D, (1, 37, S + ENGINE_TOKENS, cap),
                  True) for arch, Hq, Hkv, D in ZOO_HEADS]
    k3, k4 = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for arch, Hq, Hkv, D in ZOO_HEADS:
            k3[(name, arch)] = k3_case(gen, dtype, B, S, Hq, Hkv, D, True,
                                       shape=arch)
        for shape in k4_shapes + k4_split_rows(k4_shapes, sms, dtype):
            row = k4_case(gen, dtype, *shape, sms)
            if shape[-1]:
                k4[(name, shape[0])] = row
    return k3, k4


def zoo_config(arch, param_dtype, layers=None):
    """``arch`` at full width on the kernel path, its parameters in
    ``param_dtype``, its depth cut to ``layers`` when given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, attn_impl="flash", remat=False,
                               param_dtype=param_dtype,
                               num_layers=layers or cfg.num_layers)


def zoo_params(cfg):
    """Random weights from the seed, made on the device after the previous
    model's memory is returned; (params, seconds)."""
    import torch
    from repro_torch.models.api import build_model
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    sync()
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    sync()
    return params, time.perf_counter() - t0


def phase_zoo_main(cfg, params, main_tps, want=(ZOO_WINDOWS, ZOO_FORWARDS),
                   key="zoo_main_path"):
    """The main path's workload served by ``cfg`` through run_queue (K1
    routing, K3 in every stage forward): fails unless every stream emits
    its 16 tokens, K1 launched once per DP window, K3 once per layer of
    every stage forward, K4 never, and the windows and forwards are the
    rehearsal's (``want``); logged under ``key``."""
    from repro_torch.kernels import ops
    serve(cfg, params, workload(cfg.vocab_size)[:1])      # warm-up run
    ops.reset_launch_counts()
    srv, done, wall, forwards = serve(cfg, params, workload(cfg.vocab_size))
    counts = ops.launch_counts()
    check_served(cfg, srv, done, counts, forwards)
    st = srv.router.stats
    if counts["decode_attention"] != 0:
        raise AssertionError(f"{cfg.name} run_queue launched K4 "
                             f"{counts['decode_attention']} times")
    if (st.windows, forwards) != tuple(want):
        raise AssertionError(
            f"{cfg.name} run_queue: {st.windows} windows and {forwards} "
            f"stage forwards, the rehearsal's {want[0]} and {want[1]}")
    toks = sum(r.metrics.tokens for r in done)
    log({key: {
        "model": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "experts": [cfg.num_experts,
                                            cfg.experts_per_token],
        "param_dtype": cfg.param_dtype,
        "activation_dtype": cfg.activation_dtype,
        "parameters": n_parameters(params),
        "peers": len(srv.seeker.view()), "streams": len(done),
        "tokens_per_stream": [r.metrics.tokens for r in done],
        "tokens": toks, "wall_s": wall, "tokens_per_s": toks / wall,
        "gpt2_main_path_tokens_per_s": main_tps,
        "windows": st.windows, "dp_windows": st.device_calls,
        "stage_forwards": forwards,
        "prefill_chunks": sum(r.metrics.prefill_chunks for r in done),
        "launches": counts}})


def phase_zoo_parity(cfg, params, key="zoo_f32_parity"):
    """``cfg`` cut to ZOO_PARITY_LAYERS layers, in f32 activations, served
    through the kernels and through the plain path (``attn_impl="xla"``,
    router backend ``torch``): tokens and every ServeMetrics field equal;
    the router's top-k sets that differ between the two runs counted
    (MoE); logged under ``key``."""
    cut = dataclasses.replace(cfg, num_layers=ZOO_PARITY_LAYERS,
                              activation_dtype="float32")
    cut_params = dict(params, layers=params["layers"][:ZOO_PARITY_LAYERS])
    plain = dataclasses.replace(cut, attn_impl="xla")
    with RouterLog() as k_log:
        _, kdone, kwall, _ = serve(cut, cut_params, workload(cfg.vocab_size))
    with RouterLog() as p_log:
        _, pdone, pwall, _ = serve(plain, cut_params,
                                   workload(cfg.vocab_size),
                                   router_backend="torch")
    row = {"model": cfg.name, "layers": ZOO_PARITY_LAYERS,
           "of_layers": cfg.num_layers, "streams": len(kdone),
           "kernel_path_s": kwall, "plain_path_s": pwall,
           "router_calls": len(k_log.sets),
           "router_topk_sets_differing": router_flips(k_log, p_log)}
    for a, b in zip(kdone, pdone):
        if a.output != b.output or a.metrics != b.metrics or \
                a.metrics.tokens != NEW_TOKENS:
            log({"f32_divergence": {**row, "request": a.request_id,
                                    "kernel": a.output,
                                    "plain": b.output}})
            raise AssertionError(f"{cfg.name} f32 run_queue differs for "
                                 f"stream {a.request_id}: kernels "
                                 f"{a.output} vs plain {b.output}")
    log({key: {**row, "equal": True}})


def zoo_profile(cfg, params):
    """Where the time goes for ``cfg``: a short run_queue under the
    profiler (``zoo_profile``) and the engine's prefill and decode
    windows (``engine_profile``)."""
    phase_profile(cfg, params, key="zoo_profile")
    engine_profile(cfg.name, cfg, params, ZOO_ENGINE_GROUPS[-1][0])


def phase_zoo_models(main_tps) -> dict:
    """Each ZOO_ENGINE model loaded in turn (the previous one freed first):
    ZOO_MAIN through run_queue at full width, its f32 parity and its
    profile; then every model through the KV-cache engine (phase 11's
    gates) and its f32 kernel-vs-plain engine parity."""
    out = {}
    for arch, dtype, layers in ZOO_ENGINE:
        cfg = zoo_config(arch, dtype, layers)
        params, init_s = zoo_params(cfg)
        if arch == ZOO_MAIN:
            phase_zoo_main(cfg, params, main_tps)
            phase_zoo_parity(cfg, params)
            zoo_profile(cfg, params)
        row = run_engine(arch, cfg, params, ZOO_ENGINE_GROUPS)
        full = zoo_config(arch, dtype).num_layers
        row.update(init_s=init_s, depth=f"{cfg.num_layers} of {full} layers"
                   + (" (cut to fit the card)" if cfg.num_layers < full
                      else ""))
        log({"zoo_engine": row})
        row["f32_parity"] = engine_parity(arch, cfg, params,
                                          ZOO_PARITY_GROUPS)
        out[arch] = row
        del params
    gc.collect()
    return out


# ---------------------------------------------------------------------------
# Phase 19: the last two model families (Qwen2-VL and Whisper)
# ---------------------------------------------------------------------------


VLM = "qwen2-vl-7b"
AUDIO = "whisper-large-v3"
#: K3 at the new modes: (name, B, Sq, Sk, Hq, Hkv, D, causal): Whisper's
#: non-causal encoder, its cross-attention at prefill (the 4-token prompt)
#: and at a decode step (one query row), Qwen2-VL's 2048-token prefill
VA_K3 = (("whisper-encoder", 4, 1500, 1500, 20, 20, 64, False),
         ("whisper-cross", 4, 4, 1500, 20, 20, 64, False),
         ("whisper-decode-cross", 4, 1, 1500, 20, 20, 64, False),
         ("qwen2-vl-7b", 4, 2048, 2048, 28, 4, 128, True))
#: Qwen2-VL's image path: batch, the merged patch grid (H, W) of one image
#: (Sv = H x W = min(1024, S // 4) at S = 2048, as ``prefill_specs``) and
#: the text tokens after it; greedy decode steps after the prefill
VLM_IMAGE = (4, (16, 32), 1536)
VLM_DECODE = 32
#: Whisper: batch, stub frames, prompt tokens, new tokens (the first from
#: the prefill, then one per decode step)
AUDIO_RUN = (4, 1500, 4, 32)
#: layers kept (of 28) in Qwen2-VL's f32 kernel-vs-plain comparisons
VLM_PARITY_LAYERS = 8
#: run_queue's windows and stage forwards for the main workload on the
#: 28-layer topology (14 stages x 6 replicas), from the CPU rehearsal of
#: this phase
VLM_WINDOWS = 34
VLM_FORWARDS = 938


def phase_vlm_audio_kernels():
    """K3 in Whisper's modes (non-causal; Sq = 4 and 1 against 1500 keys)
    and at Qwen2-VL's prefill (G = 7, D = 128), K4 at Qwen2-VL's engine
    cache (2144 rows) and at Whisper's decode cache (prompt + new tokens
    rows), against their plain versions, bf16 and f32, each timed beside
    SDPA and the bound; K4 also with kv_len on a split boundary."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, _, prompt, new = AUDIO_RUN
    cap = 2048 + ENGINE_TOKENS + 64           # ServingEngine's capacity
    k4_shapes = [(VLM, 4, cap, 28, 4, 128, (1, 37, 2048 + ENGINE_TOKENS,
                                            cap), True),
                 (AUDIO, B, prompt + new, 20, 20, 64,
                  (prompt + 1, prompt + new // 2, prompt + new - 1,
                   prompt + new), True)]
    k3, k4 = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for tag, b, sq, sk, hq, hkv, d, causal in VA_K3:
            k3[(name, tag)] = k3_case(gen, dtype, b, sq, hq, hkv, d, causal,
                                      shape=tag, Sk=sk)
        for shape in k4_shapes + k4_split_rows(k4_shapes, sms, dtype):
            row = k4_case(gen, dtype, *shape, sms)
            if shape[-1]:
                k4[(name, shape[0])] = row
    return k3, k4


def image_positions(B, grid, text):
    """(3, B, Sv + text) M-RoPE positions by Qwen2-VL's rope-index rule
    for one image of ``grid`` = (H, W) merged patches (t = 0, h = i // W,
    w = i % W) followed by ``text`` tokens at max + 1 + j on every
    stream."""
    import torch
    H, W = grid
    i = torch.arange(H * W, device=DEVICE)
    img = torch.stack([torch.zeros_like(i), i // W, i % W])
    txt = (img.max() + 1 + torch.arange(text, device=DEVICE)).expand(3, text)
    return torch.cat([img, txt], dim=1)[:, None].expand(3, B, H * W + text)


def vlm_image_run(cfg, params, steps: int) -> dict:
    """Qwen2-VL's image path through the model API: VLM_IMAGE's stub patch
    embeddings (normal x 0.02, the token embeddings' scale) and text
    tokens from the seed, ``prefill`` with the three-stream positions,
    then ``steps`` greedy ``decode_step``s of the module at continued
    positions. Returns the tokens (the prefill's, then one per step) and
    the times."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.models.common import adtype
    B, grid, text = VLM_IMAGE
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    toks = torch.randint(1, cfg.vocab_size, (B, text), generator=gen,
                         device=DEVICE)
    patches = (0.02 * torch.randn((B, grid[0] * grid[1], cfg.d_model),
                                  generator=gen, device=DEVICE)
               ).to(adtype(cfg))
    pos = image_positions(B, grid, text)
    S = pos.shape[-1]
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, cache = build_model(cfg).prefill(
            params, tokens=toks, prefix_embeds=patches, positions=pos,
            capacity=S + steps)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        sync()
        prefill_s = time.perf_counter() - t0
        out, step_s = [cur], []
        nxt = int(pos.max()) + 1
        for t in range(steps):
            p3 = torch.full((3, B, 1), nxt + t, device=DEVICE)
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(cfg, params, cur, cache,
                                                    positions=p3)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
            sync()
            step_s.append(time.perf_counter() - t0)
            out.append(cur)
    return {"tokens": torch.cat(out, dim=1).tolist(),
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step_median": sorted(step_s)[steps // 2] * 1e3,
            "wall_s": prefill_s + sum(step_s), "index": cache["index"],
            "S_total": S}


def audio_run(cfg, params) -> dict:
    """Whisper through the model API: AUDIO_RUN's stub frames (standard
    normal) and prompt from the seed, ``prefill(tokens, frames,
    capacity)``, then greedy ``decode_step``s to the new-token count.
    Returns the tokens, the times and the prefill cache's bytes."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.models.common import adtype
    B, S_enc, prompt, new = AUDIO_RUN
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    frames = torch.randn((B, S_enc, cfg.d_model), generator=gen,
                         device=DEVICE).to(adtype(cfg))
    toks = torch.randint(1, cfg.vocab_size, (B, prompt), generator=gen,
                         device=DEVICE)
    model = build_model(cfg)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, tokens=toks, frames=frames,
                                      capacity=prompt + new)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        sync()
        prefill_s = time.perf_counter() - t0
        nbytes = cache_nbytes(cache)
        out, step_s = [cur], []
        for _ in range(new - 1):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cur, cache)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
            sync()
            step_s.append(time.perf_counter() - t0)
            out.append(cur)
    return {"tokens": torch.cat(out, dim=1).tolist(),
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step_median": sorted(step_s)[len(step_s) // 2]
            * 1e3, "wall_s": prefill_s + sum(step_s),
            "decode_steps": len(step_s), "cache_bytes": nbytes}


def f32_token_parity(tag, cfg, params, run) -> dict:
    """``run(cfg, params)`` in f32 activations through the kernels and
    through the plain path (``attn_impl="xla"``): the tokens must be
    equal."""
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    k = run(cfg32, params)
    p = run(dataclasses.replace(cfg32, attn_impl="xla"), params)
    if k["tokens"] != p["tokens"]:
        raise AssertionError(f"{tag} f32 tokens differ: kernels "
                             f"{k['tokens']} vs plain {p['tokens']}")
    row = {"model": tag, "layers": cfg.num_layers,
           "streams": len(k["tokens"]), "tokens": len(k["tokens"][0]),
           "equal": True}
    log({"vlm_audio_f32_parity": row})
    return row


def phase_vlm(main_tps) -> dict:
    """Qwen2-VL at full width (f32 parameters): phase 3's workload through
    run_queue (text: each stage builds M-RoPE angles from one stream) and
    its f32 kernel-vs-plain parity at VLM_PARITY_LAYERS layers; the engine
    on phase 11's workload (phase 11's gates); the image path through the
    model API (K3 once per layer at prefill, K4 once per layer of every
    decode step, K1 never) and its f32 parity at VLM_PARITY_LAYERS
    layers."""
    from repro_torch.kernels import ops
    cfg = zoo_config(VLM, "float32")
    params, init_s = zoo_params(cfg)
    phase_zoo_main(cfg, params, main_tps, want=(VLM_WINDOWS, VLM_FORWARDS),
                   key="vlm_main_path")
    phase_zoo_parity(cfg, params, key="vlm_f32_parity")
    row = run_engine(VLM, cfg, params, ZOO_ENGINE_GROUPS)
    row["init_s"] = init_s
    log({"vlm_engine": row})
    vlm_image_run(cfg, params, 2)                      # warm-up
    ops.reset_launch_counts()
    image = vlm_image_run(cfg, params, VLM_DECODE)
    counts = ops.launch_counts()
    L = cfg.num_layers
    check_launches(f"{VLM} image path", counts,
                   {"flash_attention": L, "decode_attention": L * VLM_DECODE,
                    "tropical_route_kbest": 0})
    B, grid, text = VLM_IMAGE
    if image["index"] != image["S_total"] + VLM_DECODE or \
            any(len(t) != VLM_DECODE + 1 for t in image["tokens"]):
        raise AssertionError(f"{VLM} image path: index {image['index']}, "
                             f"tokens {image['tokens']}")
    tokens = B * (VLM_DECODE + 1)
    log({"vlm_image": {
        "model": VLM, "batch": B, "patches": grid[0] * grid[1],
        "grid": list(grid), "text": text, "S_total": image["S_total"],
        "decode_steps": VLM_DECODE, "prefill_ms": image["prefill_ms"],
        "decode_ms_per_step_median": image["decode_ms_per_step_median"],
        "tokens": tokens, "tokens_per_s": tokens / image["wall_s"],
        "launches": counts}})
    cut = dataclasses.replace(cfg, num_layers=VLM_PARITY_LAYERS)
    cut_params = dict(params, layers=params["layers"][:VLM_PARITY_LAYERS])
    f32_token_parity(f"{VLM} image path", cut, cut_params,
                     lambda c, p: vlm_image_run(c, p, VLM_DECODE))
    del params
    return row


def phase_audio() -> dict:
    """Whisper at full width (f32 parameters, 1.53 B): AUDIO_RUN through
    ``prefill`` and ``decode_step``. Fails unless K3 launched 3 x layers
    at prefill (encoder, decoder, cross) and once per layer of every
    decode step (cross), K4 once per layer of every decode step, the
    prefill cache holds exactly its four tensors (self K/V at the
    capacity, cross K/V at the frames), every stream gets its tokens, and
    the f32 tokens of the kernel and plain paths are equal."""
    from repro_torch.kernels import ops
    cfg = zoo_config(AUDIO, "float32")
    params, init_s = zoo_params(cfg)
    B, S_enc, prompt, new = AUDIO_RUN
    audio_run(cfg, params)                             # warm-up
    ops.reset_launch_counts()
    run = audio_run(cfg, params)
    counts = ops.launch_counts()
    L, steps = cfg.num_layers, run["decode_steps"]
    check_launches(f"{AUDIO} prefill + {steps} decode steps", counts,
                   {"flash_attention": (cfg.enc_layers + 2 * L) + L * steps,
                    "decode_attention": L * steps,
                    "tropical_route_kbest": 0})
    size = 2 if cfg.activation_dtype == "bfloat16" else 4
    want = 2 * L * B * (prompt + new + S_enc) * cfg.num_kv_heads * \
        cfg.head_dim * size + 4
    if run["cache_bytes"] != want:
        raise AssertionError(f"{AUDIO}: cache of {run['cache_bytes']} "
                             f"bytes, its layout holds {want}")
    if any(len(t) != new or not all(0 <= x < cfg.vocab_size for x in t)
           for t in run["tokens"]):
        raise AssertionError(f"{AUDIO}: tokens {run['tokens']}")
    row = {"model": AUDIO, "layers": [cfg.enc_layers, L],
           "d_model": cfg.d_model, "parameters": n_parameters(params),
           "init_s": init_s, "batch": B, "frames": S_enc, "prompt": prompt,
           "new_tokens": new, "prefill_ms": run["prefill_ms"],
           "decode_ms_per_step_median": run["decode_ms_per_step_median"],
           "tokens_per_s": B * new / run["wall_s"],
           "cache_bytes": run["cache_bytes"], "launches": counts}
    log({"audio": row})
    f32_token_parity(AUDIO, cfg, params, audio_run)
    del params
    return row


def phase_vlm_audio(main_tps) -> dict:
    """Phase 19's models, each loaded after the previous one is freed."""
    t0 = time.perf_counter()
    out = {"vlm": phase_vlm(main_tps), "audio": phase_audio()}
    gc.collect()
    log({"vlm_audio_s": time.perf_counter() - t0})
    return out



# ---------------------------------------------------------------------------
# Phase 20: training (trainer, AdamW, checkpoints, the data stream)
# ---------------------------------------------------------------------------


TRAIN_ARCH = "smollm-360m"
#: the data stream (sequence length, global batch) and the step count
TRAIN_SEQ = 1024
TRAIN_BATCH = 8
TRAIN_STEPS = 20
TRAIN_TCFG = dict(learning_rate=3e-4, warmup_steps=2, total_steps=20,
                  microbatches=2)
#: where the checkpoints are written (the build directory is ignored by
#: git) and removed again
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"
#: layers of the resume check (smollm's width)
TRAIN_RESUME_LAYERS = 4
#: each family's reduced config for the card-vs-CPU f32 steps, and their
#: batch (B, S; Whisper's frames S, Qwen2-VL's patches PATCHES)
TRAIN_FAMILIES = ("gpt2-large", "smollm-360m", "qwen3-moe-30b-a3b",
                  "qwen2-vl-7b", "whisper-large-v3", "rwkv6-1.6b",
                  "zamba2-2.7b")
TRAIN_PARITY_BATCH = (4, 64)
TRAIN_PARITY_PATCHES = 8
TRAIN_PARITY_STEPS = 3
#: the f32 comparison's tolerances (``tests/test_torch_trainer.py``, where
#: the port is held against the reference with the same rules): lr, the
#: parameters' tolerance (2% of one step), the rounding floor of Adam's
#: normalised step (elements whose √v̂ falls below FLOOR x the leaf's RMS
#: √v̂ move anything in [-lr, lr] and are held to 2 lr per step), the
#: moments' tolerance (x the leaf's largest value), the metrics' (relative;
#: the looser one after a free run's first step, whose floor elements have
#: moved the parameters apart by up to 2 lr)
TRAIN_PARITY_LR = 1e-3
TRAIN_PARAM_TOL = 2e-5
TRAIN_FLOOR = 1e-2
TRAIN_MOM_TOL = 1e-4
TRAIN_METRIC_RTOL = (1e-5, 1e-4)
#: run_queue's windows and stage forwards for the main workload on the
#: 32-layer topology (16 stages x 6 replicas), from the CPU rehearsal of
#: this phase
TRAIN_WINDOWS = 34
TRAIN_FORWARDS = 1072


def train_config(layers=None):
    """smollm-360m at full width as the reference launcher trains it: f32
    parameters, bf16 activations, ``attn_impl="xla"`` (no kernel has a
    gradient), ``remat=False``; its depth cut to ``layers`` when given."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    return dataclasses.replace(cfg, attn_impl="xla", remat=False,
                               num_layers=layers or cfg.num_layers)


def train_batches(vocab: int, start: int, n: int):
    """Batches ``start`` .. ``start + n - 1`` of the seeded synthetic
    stream (TRAIN_SEQ x TRAIN_BATCH), as tensors on the device."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    data = SyntheticLMStream(DataConfig(vocab_size=vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=SEED))
    for b in data.batches(start, n):
        yield {k: torch.as_tensor(v, device=DEVICE) for k, v in b.items()}


def train_run(cfg, params, opt_state, start: int, n: int, tcfg=None):
    """``n`` steps of ``make_train_step`` from batch ``start``: (params,
    opt_state, per-step rows of ms, loss, lr and grad_norm)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.api import build_model
    from repro_torch.trainer.train_loop import make_train_step
    step = make_train_step(build_model(cfg),
                           TrainConfig(**(tcfg or TRAIN_TCFG)))
    rows = []
    for batch in train_batches(cfg.vocab_size, start, n):
        sync()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        sync()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     **{k: float(v) for k, v in m.items()}})
    return params, opt_state, rows


def tree_bytes(tree) -> int:
    from repro_torch.trainer.optimizer import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def trees_equal(a, b) -> bool:
    """Every leaf of the same dtype, shape and bits."""
    import torch
    from repro_torch.trainer.optimizer import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def phase_train_main():
    """smollm-360m at full width, TRAIN_STEPS steps on the seeded stream.
    Fails unless every loss is finite, the last below the first, and no
    kernel launched. Returns (cfg, params, opt_state)."""
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.trainer import optimizer as opt
    cfg = train_config()
    params, init_s = zoo_params(cfg)
    opt_state = opt.init(params)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, opt_state, rows = train_run(cfg, params, opt_state, 0,
                                        TRAIN_STEPS)
    counts = ops.launch_counts()
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{TRAIN_ARCH} training losses {losses}")
    if any(counts.values()):
        raise AssertionError(f"training launched kernels: {counts}")
    ms = sorted(r["ms"] for r in rows)
    median = ms[len(ms) // 2]
    tokens = TRAIN_SEQ * TRAIN_BATCH
    log({"train_main": {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "parameters": n_parameters(params),
        "param_dtype": cfg.param_dtype,
        "activation_dtype": cfg.activation_dtype, "attn_impl": cfg.attn_impl,
        "init_s": init_s, "steps": TRAIN_STEPS,
        "tokens_per_step": tokens, **TRAIN_TCFG,
        "step_ms_first": rows[0]["ms"], "step_ms_median": median,
        "tokens_per_s": tokens / (median / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses, "grad_norms": [r["grad_norm"] for r in rows],
        "lrs": [r["lr"] for r in rows],
        "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                              if DEVICE == "cuda" else None),
        "state_bytes": tree_bytes(params) + tree_bytes(opt_state),
        "launches": counts}})
    return cfg, params, opt_state


def train_profile(cfg, params, opt_state) -> dict:
    """Where a training step's time goes: one more step (batch
    TRAIN_STEPS, its result discarded) under ``torch.profiler``: the
    device's busy share, the casts and matmuls, the top ops and kernels."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.api import build_model
    from repro_torch.trainer.train_loop import make_train_step
    step = make_train_step(build_model(cfg), TrainConfig(**TRAIN_TCFG))
    batch = next(train_batches(cfg.vocab_size, TRAIN_STEPS, 1))
    row = profile_summary(*profile_window(
        lambda: step(params, opt_state, batch)), [])
    log({"train_profile": row})
    return row


def phase_train_checkpoint(cfg, params, opt_state):
    """The trained state saved at step TRAIN_STEPS with an async write
    (the loop's stall and the write timed apart), restored into a fresh
    template; fails unless the restored tree is bit-equal. Returns the
    restored parameters."""
    import shutil
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.trainer import optimizer as opt
    from repro_torch.trainer.checkpoint import CheckpointManager
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    ck = CheckpointManager(str(TRAIN_CKPT_DIR), keep=1)
    state = {"params": params, "opt_state": opt_state}
    sync()
    t0 = time.perf_counter()
    ck.save(TRAIN_STEPS, state, async_write=True)
    stall = time.perf_counter() - t0
    ck.wait()
    written = time.perf_counter() - t0
    path = TRAIN_CKPT_DIR / f"ckpt_{TRAIN_STEPS:08d}.npz"
    nbytes = path.stat().st_size
    fresh = build_model(cfg).init(
        torch.Generator(device=DEVICE).manual_seed(SEED + 1), DEVICE)
    template = {"params": fresh, "opt_state": opt.init(fresh)}
    sync()
    t0 = time.perf_counter()
    got = ck.restore(template)
    sync()
    restore_s = time.perf_counter() - t0
    del template, fresh
    if not trees_equal(got, state):
        raise AssertionError("restored checkpoint differs from the saved "
                             "state")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    log({"train_checkpoint": {
        "step": TRAIN_STEPS, "file_bytes": nbytes,
        "state_bytes": tree_bytes(state), "stall_s": stall,
        "write_s": written, "restore_s": restore_s, "bit_equal": True}})
    return got["params"]


def phase_train_serve(cfg, params, main_tps):
    """The restored parameters served through run_queue on the main
    path's workload with the kernels (``attn_impl="flash"``): phase 18's
    gates with this phase's rehearsed windows and forwards."""
    phase_zoo_main(dataclasses.replace(cfg, attn_impl="flash"), params,
                   main_tps, want=(TRAIN_WINDOWS, TRAIN_FORWARDS),
                   key="train_serve")


def leaf_paths(tree, prefix=""):
    """The ``/``-joined path of every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def nondeterministic_grad_leaves(cfg, params) -> list:
    """The parameter leaves whose gradient differs between two backward
    passes of the same loss on the same batch."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.trainer.optimizer import tree_leaves
    from repro_torch.trainer.train_loop import value_and_grad
    batch = next(train_batches(cfg.vocab_size, 0, 1))
    loss_fn = build_model(cfg).loss_fn
    g1, g2 = (tree_leaves(value_and_grad(loss_fn, params, batch)[1])
              for _ in range(2))
    return [p for p, a, b in zip(leaf_paths(params), g1, g2)
            if not torch.equal(a, b)]


def phase_train_resume():
    """smollm's width at TRAIN_RESUME_LAYERS layers: 4 steps straight
    against 2 steps, a checkpoint, a restore and 2 more. Fails beyond the
    reference test's 1e-5; when not bit-equal, names the parameter leaves
    whose gradient differs between two identical backward passes."""
    import shutil
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.trainer import optimizer as opt
    from repro_torch.trainer.checkpoint import CheckpointManager
    from repro_torch.trainer.optimizer import tree_leaves
    cfg = train_config(TRAIN_RESUME_LAYERS)
    tcfg = dict(TRAIN_TCFG, total_steps=8)
    p0 = build_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(
        SEED), DEVICE)
    o0 = opt.init(p0)
    pA, _, _ = train_run(cfg, p0, o0, 0, 4, tcfg)
    pB, oB, _ = train_run(cfg, p0, o0, 0, 2, tcfg)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    ck = CheckpointManager(str(TRAIN_CKPT_DIR), keep=1)
    ck.save(2, {"params": pB, "opt_state": oB})
    got = ck.restore({"params": p0, "opt_state": o0})
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    pB2, _, _ = train_run(cfg, got["params"], got["opt_state"], 2, 2, tcfg)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(pA), tree_leaves(pB2)))
    bit_equal = trees_equal(pA, pB2)
    row = {"model": cfg.name, "layers": cfg.num_layers,
           "max_abs_diff": diff, "bit_equal": bit_equal,
           "restore_bit_equal": trees_equal(got, {"params": pB,
                                                  "opt_state": oB})}
    if not bit_equal:
        row["nondeterministic_grad_leaves"] = nondeterministic_grad_leaves(
            cfg, p0)
    log({"train_resume": row})
    if diff > 1e-5 or not row["restore_bit_equal"]:
        raise AssertionError(f"resume differs from the straight run: {row}")


def train_parity_batch(cfg, rng):
    """A numpy batch for ``cfg``'s loss (TRAIN_PARITY_BATCH): tokens,
    labels, a mask with ~20% zeros; Whisper's frames, Qwen2-VL's patches
    and three-stream positions."""
    import numpy as np
    B, S = TRAIN_PARITY_BATCH
    b = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        sv = TRAIN_PARITY_PATCHES
        b["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, sv, cfg.d_model))).astype(np.float32)
        b["positions"] = np.broadcast_to(np.arange(sv + S), (3, B, sv + S)
                                         ).astype(np.int32).copy()
    return b


def compare_train_states(tag, ref, got, floor, steps,
                         moments=True) -> dict:
    """The CPU's state ``ref`` against the card's ``got`` (each (params,
    opt_state) in the reference's layout as numpy): with ``moments`` every
    moment within TRAIN_MOM_TOL x the leaf's largest value; every
    parameter within
    TRAIN_PARAM_TOL except at the rounding floor (``floor``, updated
    here), there within 2 lr per step. Returns the largest differences."""
    import numpy as np

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: np.asarray(tree, np.float32)}

    r = flat({"p": ref[0], "mu": ref[1]["mu"], "nu": ref[1]["nu"]})
    g = flat({"p": got[0], "mu": got[1]["mu"], "nu": got[1]["nu"]})
    out = {"param": 0.0, "param_off_floor": 0.0, "moment_rel": 0.0,
           "floor_elements": 0}
    for k, want in r.items():
        if k.startswith("/nu/"):
            rms = np.sqrt(np.mean(want)) if want.size else 0.0
            low = (want > 0) & (np.sqrt(want) < TRAIN_FLOOR * rms)
            floor[k[4:]] = floor.get(k[4:], False) | low
    for k, want in r.items():
        d = np.abs(g[k] - want)
        if k.startswith("/p/"):
            low = floor[k[3:]]
            off = float(d[~low].max(initial=0.0))
            out["param"] = max(out["param"], float(d.max(initial=0.0)))
            out["param_off_floor"] = max(out["param_off_floor"], off)
            out["floor_elements"] += int(low.sum())
            if off > TRAIN_PARAM_TOL or \
                    float(d.max(initial=0.0)) > 2 * TRAIN_PARITY_LR * steps:
                raise AssertionError(f"{tag} {k}: {off} off the floor, "
                                     f"{float(d.max(initial=0.0))} in all")
        elif moments:
            scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
            rel = float(d.max(initial=0.0)) / scale
            out["moment_rel"] = max(out["moment_rel"], rel)
            if rel > TRAIN_MOM_TOL:
                raise AssertionError(f"{tag} {k}: moment {rel} of its scale")
    return out


def train_parity(arch) -> dict:
    """``arch``'s reduced config in f32 activations: the same parameters
    and batches through TRAIN_PARITY_STEPS steps (microbatches 2) on the
    card and on the CPU, run freely, then each step again from the CPU's
    state carried onto the card (``compare_train_states``; the free run's
    moments after its first step only: an element moved differently at
    the rounding floor changes the next gradients by up to ~1%).
    Metrics within TRAIN_METRIC_RTOL at every step (the looser one after
    the free run's first step)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import params_to_numpy
    from repro_torch.trainer import optimizer as opt
    from repro_torch.trainer.train_loop import make_train_step
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              activation_dtype="float32")
    model = build_model(cfg)
    step = make_train_step(model, TrainConfig(
        learning_rate=TRAIN_PARITY_LR, warmup_steps=1, total_steps=10,
        microbatches=2))
    rng = np.random.default_rng(SEED)
    batches = [train_parity_batch(cfg, rng)
               for _ in range(TRAIN_PARITY_STEPS)]
    p_cpu = model.init(torch.Generator().manual_seed(SEED), "cpu")

    def on(tree, dev):
        return opt.tree_map(lambda t: t.to(dev), tree)

    def host(state):
        return params_to_numpy(state[0]), params_to_numpy(state[1])

    row = {"model": arch, "steps": TRAIN_PARITY_STEPS, "free": [],
           "carried": []}
    for mode in ("free", "carried"):
        cpu = [p_cpu, opt.init(p_cpu)]
        card = on(cpu, DEVICE)
        floor = {}
        for i, b in enumerate(batches):
            if mode == "carried":
                card, floor = on(cpu, DEVICE), {}
            tb = {k: torch.as_tensor(v) for k, v in b.items()}
            *cpu, mc = step(*cpu, tb)
            *card, mg = step(*card, on(tb, DEVICE))
            rtol = TRAIN_METRIC_RTOL[mode == "free" and i > 0]
            for k in ("loss", "lr", "grad_norm"):
                a, c = float(mc[k]), float(mg[k])
                if abs(a - c) > rtol * abs(a):
                    raise AssertionError(f"{arch} {mode} step {i + 1} {k}: "
                                         f"cpu {a} card {c}")
            free = mode == "free"
            d = compare_train_states(f"{arch} {mode} step {i + 1}",
                                     host(cpu), host(card), floor,
                                     i + 1 if free else 1,
                                     moments=not free or i == 0)
            row[mode].append({"loss_cpu": float(mc["loss"]),
                              "loss_card": float(mg["loss"]), **d})
    return row


def phase_train_f32_parity() -> list:
    rows = [train_parity(arch) for arch in TRAIN_FAMILIES]
    for row in rows:
        log({"train_f32_parity": row})
    return rows


def phase_train_grad_refusal() -> dict:
    """On the card each float dispatcher (K3-K6) raises on an input that
    requires grad, and launches nothing."""
    import torch
    from repro_torch.kernels import ops
    dev = DEVICE
    req = dict(device=dev, requires_grad=True)
    q = torch.randn((1, 8, 2, 64), **req)
    kv = torch.randn((1, 8, 1, 64), device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    st = torch.zeros((1, 1, 64, 64), device=dev)
    x = torch.randn((1, 8, 1, 64), **req)
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, kv, kv),
        "decode_attention": lambda: ops.decode_attention(q[:, 0], kv, kv,
                                                         one),
        "wkv6_chunked": lambda: ops.wkv6(x, x, x, -x.abs(),
                                         torch.randn((1, 64), device=dev),
                                         st),
        "ssd_chunked": lambda: ops.ssd(
            x, torch.rand((1, 8, 1), device=dev),
            -torch.rand((1, 8, 1), device=dev),
            torch.randn((1, 8, 64), device=dev),
            torch.randn((1, 8, 64), device=dev), st),
    }
    ops.reset_launch_counts()
    out = {}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no gradient" not in str(e):
                raise
            out[name] = "raised"
        else:
            raise AssertionError(f"{name} returned an output for an input "
                                 "that requires grad")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"refused calls launched: "
                             f"{ops.launch_counts()}")
    log({"train_grad_refusal": out})
    return out


def phase_train(main_tps) -> dict:
    """Phase 20: train, checkpoint, serve the restored parameters, resume,
    the families' f32 card-vs-CPU steps and the kernels' refusal."""
    import torch
    t0 = time.perf_counter()
    cfg, params, opt_state = phase_train_main()
    if DEVICE == "cuda":
        train_profile(cfg, params, opt_state)
    served = phase_train_checkpoint(cfg, params, opt_state)
    del params, opt_state
    phase_train_serve(cfg, served, main_tps)
    del served
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    phase_train_resume()
    phase_train_f32_parity()
    if DEVICE == "cuda":
        phase_train_grad_refusal()
    secs = time.perf_counter() - t0
    log({"train_s": secs})
    return {"seconds": secs}


# ---------------------------------------------------------------------------
# Phase 21: the distributed layer and the dry-run
# ---------------------------------------------------------------------------

#: steps of the DTensor train step on the one-rank (1, 1) mesh
DIST_STEPS = 3
#: rounds of the compressed all-reduce, and the reference test's gates on
#: the accumulated and the one-round relative error
DIST_ROUNDS = 30
DIST_ACC_GATE = 0.02
DIST_ONE_GATE = 0.2
#: the tolerance of the DTensor step's metrics against the plain step's
#: when they are not the same bits: inside the activation policy the
#: attention takes the reference's sharded layout (KV heads repeated to
#: the query heads, ``models/attention._repeat_kv``), so its products run
#: as matmuls of another shape
DIST_METRIC_RTOL = 1e-6
#: the dry-run cells: ``perf.CELLS``' baselines on the single mesh, cell B
#: also on the multi mesh; overrides on top of each (none on the card)
DRYRUN_CELLS = (("A", "single"), ("B", "single"), ("C", "single"),
                ("B", "multi"))
DRYRUN_OVERRIDES: dict = {}
#: one full-width single-mesh cell of each family whose sharded step the
#: dry-run once failed (MoE, ssm, hybrid, audio): run from the start of the
#: script in a process of their own (``--dryrun-cells``: host work on
#: ``meta``, beside the card's phases), gated in phase 21
DRYRUN_FAMILY_CELLS = (("qwen3-moe-30b-a3b", "decode_32k"),
                       ("rwkv6-1.6b", "long_500k"),
                       ("zamba2-2.7b", "prefill_32k"),
                       ("whisper-large-v3", "train_4k"))
#: a cut of those cells for a rehearsal: "overrides" {arch: config
#: overrides} and "shape" (seq_len, global_batch); none on the card
DRYRUN_FAMILY_SCALE: dict = {}
#: how long phase 21 waits for those cells to finish, seconds
DRYRUN_FAMILY_TIMEOUT = 600
#: one card's memory, the dry-run's per-device memory is printed against it
CARD_BYTES = 80e9
#: the port linter's allowed findings under ``repolint_torch.json`` (the
#: reference's 26 audited exceptions, moved to ``src/repro_torch``)
REPOLINT_ALLOWED = 26


def _dist_group():
    """The one-rank default process group of this device (NCCL on the
    card, gloo on the CPU) and its (1, 1) ("data", "model") mesh."""
    from repro_torch.launch.mesh import init_process_group, make_test_mesh
    init_process_group(DEVICE)
    return make_test_mesh((1, 1), ("data", "model"), device_type=DEVICE)


def _scalar(t) -> float:
    from torch.distributed.tensor import DTensor
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def dist_train(mesh):
    """smollm-360m at full width, phase 20's workload: DIST_STEPS steps of
    the plain train step, then the same steps with the parameters, the
    optimizer state and the batch placed as DTensors on the (1, 1) mesh
    under the activation policy. Fails unless loss, lr and grad norm are
    the plain step's at every step (the same bits, else within
    DIST_METRIC_RTOL, printed). Returns (cfg, params, batch 0)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.dryrun import opt_state_pspecs
    from repro_torch.models.api import build_model
    from repro_torch.trainer import optimizer as opt
    from repro_torch.trainer.train_loop import make_train_step
    cfg = train_config()
    params, _ = zoo_params(cfg)
    step = make_train_step(build_model(cfg), TrainConfig(**TRAIN_TCFG))
    batches = list(train_batches(cfg.vocab_size, 0, DIST_STEPS))
    rows = {"plain": [], "dtensor": []}
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    p, o = params, opt.init(params)
    for b in batches:
        sync()
        t0 = time.perf_counter()
        p, o, m = step(p, o, b)
        sync()
        rows["plain"].append({"ms": (time.perf_counter() - t0) * 1e3,
                              **{k: _scalar(v) for k, v in m.items()}})
    del p, o
    plain_peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" \
        else None
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    p = sh.distribute_params(mesh, params)
    o = sh.distribute(mesh, opt.init(params), opt_state_pspecs(params))
    for b in batches:
        bd = sh.distribute(mesh, b, sh.batch_pspecs(mesh, b))
        sync()
        t0 = time.perf_counter()
        p, o, m = sh.policy_call(mesh, step, p, o, bd)
        sync()
        rows["dtensor"].append({"ms": (time.perf_counter() - t0) * 1e3,
                                **{k: _scalar(v) for k, v in m.items()}})
    del p, o
    diff = {k: max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-30)
                   for a, b in zip(rows["plain"], rows["dtensor"]))
            for k in ("loss", "lr", "grad_norm")}
    same = all(v == 0.0 for v in diff.values())
    med = {k: sorted(r["ms"] for r in v)[len(v) // 2]
           for k, v in rows.items()}
    log({"dist_train": {
        "model": cfg.name, "layers": cfg.num_layers, "mesh": [1, 1],
        "steps": DIST_STEPS, "microbatches": TRAIN_TCFG["microbatches"],
        "plain": rows["plain"], "dtensor": rows["dtensor"],
        "step_ms_median": med["plain"],
        "dtensor_step_ms_median": med["dtensor"],
        "dtensor_overhead_ms": med["dtensor"] - med["plain"],
        "same_bits": same, "max_rel_diff": diff,
        "peak_memory_bytes": plain_peak,
        "dtensor_peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                      if DEVICE == "cuda" else None)}})
    if not same and max(diff.values()) > DIST_METRIC_RTOL:
        raise AssertionError(f"DTensor step differs from the plain step: "
                             f"{diff}")
    return cfg, params, batches[0]


def dist_compressed_allreduce(mesh, cfg, params, batch) -> dict:
    """``make_compressed_grad_allreduce`` over the mesh's "data" group on
    smollm-360m's f32 gradient tree of one batch, DIST_ROUNDS rounds with
    error feedback. Fails unless the accumulated relative error is below
    DIST_ACC_GATE and one round's below DIST_ONE_GATE (the reference
    test's gates; errors over the whole tree)."""
    import torch
    from repro_torch.distributed.collectives import \
        make_compressed_grad_allreduce
    from repro_torch.models.api import build_model
    from repro_torch.trainer.optimizer import tree_leaves, tree_map
    from repro_torch.trainer.train_loop import value_and_grad
    _, grads = value_and_grad(build_model(cfg).loss_fn, params, batch)
    allreduce = make_compressed_grad_allreduce(mesh, "data")
    g = tree_leaves(grads)
    n = sum(t.numel() for t in g)
    res = tree_map(torch.zeros_like, grads)
    acc = [torch.zeros_like(t) for t in g]
    one = None
    ms = []
    for i in range(DIST_ROUNDS):
        sync()
        t0 = time.perf_counter()
        out, res = allreduce(grads, res)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        for a, t in zip(acc, tree_leaves(out)):
            a.add_(t)
        if i == 0:
            one = [t.clone() for t in tree_leaves(out)]

    def rel(got, scale):
        num = sum(float(torch.sum((x - scale * y) ** 2)) for x, y in
                  zip(got, g))
        den = sum(float(torch.sum((scale * y) ** 2)) for y in g)
        return (num / den) ** 0.5
    rel_acc, rel_one = rel(acc, DIST_ROUNDS), rel(one, 1)
    row = {"elements": n, "bytes": sum(t.numel() * t.element_size()
                                       for t in g),
           "rounds": DIST_ROUNDS, "ms_per_round": sum(ms) / len(ms),
           "ms_per_round_median": sorted(ms)[len(ms) // 2],
           "rel_err_accumulated": rel_acc, "rel_err_one_round": rel_one}
    log({"dist_compressed_allreduce": row})
    if not (rel_acc < DIST_ACC_GATE and rel_one < DIST_ONE_GATE):
        raise AssertionError(f"compressed all-reduce errors {row}")
    return row


def phase_dryrun() -> list:
    """The baseline variant of ``perf.CELLS`` A, B and C on the single
    (16, 16) mesh and B on the multi (2, 16, 16) mesh, on ``meta`` through
    a 256 / 512-rank process group that exchanges nothing. Fails unless
    every cell's status is ok."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.perf import CELLS
    rows = []
    for cell, mesh_name in DRYRUN_CELLS:
        arch, shape, variants = CELLS[cell]
        name, ov, serving = variants[0]
        rec = run_cell(arch, shape, mesh_name, cost_pass=True,
                       overrides=dict(ov, **DRYRUN_OVERRIDES) or None,
                       serving_layout=serving, tag=f"{cell}/{name}",
                       verbose=False)
        if rec["status"] != "ok":
            log(rec.get("traceback", ""))
            raise AssertionError(f"dry-run {cell} {mesh_name}: "
                                 f"{rec.get('error')}")
        r, mem = rec["roofline"], rec["memory"]
        row = {"cell": cell, "arch": arch, "shape": shape,
               "mesh": mesh_name, "dominant": r["dominant"],
               "compute_s": r["compute_s"], "memory_s": r["memory_s"],
               "collective_s": r["collective_s"],
               "useful_ratio": r["useful_ratio"],
               "collective_ops": r["collective_ops"],
               "collectives": rec["collectives"], "cost": rec["cost"],
               "memory": mem,
               "memory_per_device_of_card": mem["total_per_device"]
               / CARD_BYTES, "seconds": rec["total_s"]}
        log({"dryrun": row})
        rows.append(row)
    return rows


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def start_family_dryrun() -> dict:
    """Starts ``DRYRUN_FAMILY_CELLS`` in a process of this script
    (``--dryrun-cells``), with CUDA hidden from it, and returns its handle
    for ``phase_family_dryrun``. The process is killed if the script ends
    first."""
    arg = json.dumps({"cells": DRYRUN_FAMILY_CELLS,
                      "scale": DRYRUN_FAMILY_SCALE})
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    err = tempfile.TemporaryFile()
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--dryrun-cells", arg], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    atexit.register(_stop, proc)
    return {"proc": proc, "err": err, "t0": time.perf_counter()}


def dryrun_cells(arg: str) -> int:
    """The body of ``--dryrun-cells``: each cell of the JSON argument on
    the single mesh, one JSON record per line on stdout."""
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.configs import get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell
    torch.set_num_threads(1)
    spec = json.loads(arg)
    scale = spec["scale"]
    for arch, shape_name in spec["cells"]:
        shape = get_shape(shape_name)
        if scale.get("shape"):
            shape = ShapeConfig(shape.name, *scale["shape"], shape.kind)
        rec = run_cell(arch, shape, "single", cost_pass=True,
                       overrides=scale.get("overrides", {}).get(arch),
                       verbose=False)
        print(json.dumps(rec), flush=True)
    return 0


def phase_family_dryrun(family=None) -> list:
    """Collects ``DRYRUN_FAMILY_CELLS`` (``family``, the handle of the
    process started after the build, else one started now): fails unless
    each cell's status is ok; prints each row's dominant term, roofline
    terms, collectives, memory per device and host seconds, and how long
    the phase waited."""
    family = family or start_family_dryrun()
    t0 = time.perf_counter()
    proc, err = family["proc"], family["err"]
    try:
        out, _ = proc.communicate(timeout=DRYRUN_FAMILY_TIMEOUT)
    finally:
        _stop(proc)
    err.seek(0)
    tail = err.read().decode(errors="replace")[-4000:]
    err.close()
    if proc.returncode != 0:
        log(tail)
        raise AssertionError(f"dry-run cells: exit {proc.returncode}")
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    if [(r["arch"], r["shape"]) for r in recs] != \
            [tuple(c) for c in DRYRUN_FAMILY_CELLS]:
        log(tail)
        raise AssertionError("dry-run cells: "
                             f"{[(r['arch'], r['shape']) for r in recs]}")
    rows = []
    for rec in recs:
        if rec["status"] != "ok":
            log(rec.get("traceback", ""))
            raise AssertionError(f"dry-run {rec['arch']} {rec['shape']}: "
                                 f"{rec.get('error')}")
        r, mem = rec["roofline"], rec["memory"]
        row = {"arch": rec["arch"], "shape": rec["shape"],
               "mesh": rec["mesh"], "dominant": r["dominant"],
               "compute_s": r["compute_s"], "memory_s": r["memory_s"],
               "collective_s": r["collective_s"],
               "useful_ratio": r["useful_ratio"],
               "collective_ops": r["collective_ops"],
               "collectives": rec["collectives"], "cost": rec["cost"],
               "memory": mem,
               "memory_per_device_of_card": mem["total_per_device"]
               / CARD_BYTES, "seconds": rec["total_s"]}
        log({"dryrun_family": row})
        rows.append(row)
    log({"dryrun_family_s": {
        "process": time.perf_counter() - family["t0"],
        "waited": time.perf_counter() - t0,
        "cells": sum(r["seconds"] for r in rows)}})
    return rows


def phase_repolint() -> dict:
    """Phase 22: the port's linter (``repro_torch.analysis``) over
    ``src/repro_torch`` under ``repolint_torch.json``, from the root of
    the checkout. Fails unless it reports no finding, every allow-list
    entry is used, and ``REPOLINT_ALLOWED`` findings are allowed."""
    from repro_torch.analysis import (ALL_RULES, analyze_paths,
                                      build_rules, find_config, load_config)
    t0 = time.perf_counter()
    path = find_config(str(ROOT))
    cfg = load_config(path, [r.rule_id for r in ALL_RULES])
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        run = analyze_paths(["src/repro_torch"], build_rules(cfg.options),
                            cfg)
    finally:
        os.chdir(cwd)
    unused = [f"{e.rule} {e.path} {e.symbol}" for e in cfg.allow
              if e.hits == 0]
    row = {"config": os.path.relpath(path, ROOT), "files": run.files,
           "findings": len(run.findings), "allowed": len(run.allowed),
           "unused_allow": unused, "seconds": time.perf_counter() - t0}
    log({"repolint": row})
    if run.findings or unused or len(run.allowed) != REPOLINT_ALLOWED:
        for f in run.findings:
            log(f.render())
        raise AssertionError(f"repolint: {row}")
    return row


def dryrun_vs_card(cfg, params, batch) -> dict:
    """The dry-run of smollm-360m at dist_train's shape (8 x 1024, train,
    2 microbatches) on a (1, 1) mesh against one real step on the card.
    Fails unless the dry-run's argument bytes equal those of the
    parameters, the optimizer state and the batch on the card, and its
    FLOPs equal ``FlopCounterMode``'s count of the real step. The batch is
    the dry-run's contract (``Model.input_specs``): tokens and labels, no
    mask."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.api import build_model
    from repro_torch.trainer import optimizer as opt
    from repro_torch.trainer.train_loop import make_train_step
    shape = ShapeConfig("dist_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ov = {k: getattr(cfg, k) for k in ("attn_impl", "remat", "num_layers",
                                       "d_model", "num_heads",
                                       "num_kv_heads", "head_dim", "d_ff",
                                       "vocab_size")}
    ov["__microbatches__"] = TRAIN_TCFG["microbatches"]
    rec = run_cell(cfg.name, shape, "card",
                   mesh_shape=((1, 1), ("data", "model")), overrides=ov,
                   cost_pass=True, verbose=False)
    if rec["status"] != "ok":
        log(rec.get("traceback", ""))
        raise AssertionError(f"dry-run at the card's shape: {rec['error']}")
    batch = {k: batch[k] for k in ("tokens", "labels")}
    state = opt.init(params)
    args = tree_bytes([params, state, batch])
    step = make_train_step(build_model(cfg), TrainConfig(**TRAIN_TCFG))
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    with FlopCounterMode(display=False) as fc:
        out = step(params, state, batch)
    sync()
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    del out
    mem = rec["memory"]
    row = {"model": cfg.name, "shape": [TRAIN_BATCH, TRAIN_SEQ],
           "argument_size_in_bytes": mem["argument_size_in_bytes"],
           "card_argument_bytes": args,
           "flops": rec["cost"]["flops"],
           "card_flops": fc.get_total_flops(),
           "temp_size_in_bytes": mem["temp_size_in_bytes"],
           "card_peak_less_arguments": (peak - base) if peak is not None
           else None,
           "bytes_accessed": rec["cost"]["bytes accessed"],
           "seconds": rec["total_s"]}
    log({"dryrun_vs_card": row})
    if row["argument_size_in_bytes"] != args or \
            row["flops"] != row["card_flops"]:
        raise AssertionError(f"dry-run against the card: {row}")
    return row


def phase_distributed(family=None) -> dict:
    """Phase 21: the DTensor train step on a one-rank mesh against the
    plain step, the compressed all-reduce on the real gradient tree, the
    dry-run of the perf cells and of the repaired families' cells
    (``family``: ``start_family_dryrun``'s handle, or None to start them
    here), and the dry-run against the card."""
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    mesh = _dist_group()
    try:
        cfg, params, batch = dist_train(mesh)
        dist_compressed_allreduce(mesh, cfg, params, batch)
    finally:
        dist.destroy_process_group()
    t1 = time.perf_counter()
    dry = phase_dryrun()
    family = phase_family_dryrun(family)
    t2 = time.perf_counter()
    vs = dryrun_vs_card(cfg, params, batch)
    del params
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    secs = {"total": time.perf_counter() - t0, "card": t1 - t0,
            "dryrun_host": t2 - t1, "dryrun_vs_card": time.perf_counter() - t2}
    log({"distributed_s": secs})
    return {"seconds": secs, "dryrun": dry, "dryrun_family": family,
            "dryrun_vs_card": vs}


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if sys.argv[1:2] == ["--dryrun-cells"]:
        return dryrun_cells(sys.argv[2])
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
    family = start_family_dryrun()
    k6 = phase_k6()
    k5 = phase_k5()
    k4 = phase_k4()
    floor = launch_floor()
    k1 = phase_k1(floor)
    k2 = phase_k2(floor)
    windows_err = phase_windows()
    k3 = phase_k3()
    t0 = time.perf_counter()
    phase_zoo_kernels()
    zoo_kernels_s = time.perf_counter() - t0
    phase_vlm_audio_kernels()

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
    engine = phase_engine(params)
    phase_engine_parity(params)
    phase_engine_profile(params)
    srv, counts, tps = phase_main(cfg, params)
    phase_f32_parity(cfg, params)
    phase_hybrid_trust(cfg, params, tps)
    phase_edge_control(cfg, params, tps)
    phase_routing(srv)
    phase_profile(cfg, params)
    _, _, k2_counts = phase_decision()
    phase_ssr()
    phase_generate_algorithms(cfg, params)
    t0 = time.perf_counter()
    phase_zoo_models(tps)
    log({"model_zoo_s": {"kernels": zoo_kernels_s,
                         "models": time.perf_counter() - t0}})
    phase_vlm_audio(tps)
    phase_train(tps)
    phase_distributed(family)
    phase_repolint()
    k4_row = k4[("bfloat16", "gpt2-large")]
    k5_row = k5["full-width"]
    k6_row = k6["full-width"]

    kern = [
        {"name": "tropical_route_kbest", "route": "cuda",
         "source": "src/repro_torch/csrc/tropical_route.cu",
         "replaces": "src/repro/kernels/tropical_route.py:168",
         "launches": counts["tropical_route_kbest"],
         "max_abs_err": max(k1[1]["max_abs_err"], windows_err["K1 window"]),
         "ms": k1[1]["window_ms"], "plain_ms": k1[1]["window_plain_ms"],
         "bound_ms": k1[1]["window_bound_ms"],
         "bound_by": k1[1]["window_bound_by"], "library_ms": None},
        {"name": "tropical_route", "route": "cuda",
         "source": "src/repro_torch/csrc/tropical_route.cu",
         "replaces": "src/repro/kernels/tropical_route.py:65",
         "launches": k2_counts["tropical_route"],
         "max_abs_err": max(k2[K2_ROW]["max_abs_err"],
                            windows_err["K2 window"]),
         "ms": k2[K2_ROW]["window_ms"],
         "plain_ms": k2[K2_ROW]["window_plain_ms"],
         "bound_ms": k2[K2_ROW]["window_bound_ms"],
         "bound_by": k2[K2_ROW]["window_bound_by"], "library_ms": None},
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
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:65",
         "launches": sum(r["launches"]["decode_attention"]
                         for r in engine.values()),
         "max_abs_err": k4_row["max_abs_err"], "ms": k4_row["ms"],
         "plain_ms": k4_row["plain_ms"], "bound_ms": k4_row["bound_ms"],
         "bound_by": k4_row["bound_by"],
         "library_ms": k4_row["library_ms"]},
        {"name": "wkv6_chunked", "route": "cuda",
         "source": "src/repro_torch/csrc/rwkv6_chunk.cu",
         "replaces": "src/repro/kernels/rwkv6_chunk.py:81",
         "launches": engine["rwkv6-1.6b"]["launches"]["wkv6_chunked"],
         "max_abs_err": k5_row["max_abs_err"], "ms": k5_row["ms"],
         "plain_ms": k5_row["plain_ms"], "bound_ms": k5_row["bound_ms"],
         "bound_by": k5_row["bound_by"], "library_ms": None},
        {"name": "ssd_chunked", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk.py:62",
         "launches": engine["zamba2-2.7b"]["launches"]["ssd_chunked"],
         "max_abs_err": k6_row["max_abs_err"], "ms": k6_row["ms"],
         "plain_ms": k6_row["plain_ms"], "bound_ms": k6_row["bound_ms"],
         "bound_by": k6_row["bound_by"], "library_ms": None},
    ]
    log(f"end-to-end: {tps} tokens/s; total {time.perf_counter() - t_start}"
        " s; kernel rows: K1 and K2 are the fused window entries the "
        "main path launches (route_window_kbest_cuda at the serving "
        "topology, R=1; route_window_cuda at R=64 on the N=1000 scaling "
        "testbed, its launches: route_batched), each against its plain "
        "composition and its own bound; K3 at bf16 S=200 (B=1, "
        "H=20, D=64), K4 at bf16 on GPT-2 Large's decode shape (B=4, "
        "H=20, D=64, S=1120, kv_len 1/37/1056/1120; its launches: the "
        "engine runs), K5 at the RWKV6 engine's prefill shape (B=4, "
        "S=2048, H=32, K=64, model-like inputs; its launches: the RWKV6 "
        "engine run), K6 at the Zamba2 engine's prefill shape (B=4, "
        "S=2048, H=80, P=N=64, model-like inputs; its launches: the Zamba2 "
        "engine run)")
    log(card_line())
    log({"kernels": kern})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

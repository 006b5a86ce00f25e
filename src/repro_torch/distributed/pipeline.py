"""Pipeline parallelism: GPipe-style microbatched stage execution.

Port of ``repro.distributed.pipeline``. A served model is split into
contiguous layer *stages*; each stage replica lives on a device group.

* ``StagePartition`` — layer-range slicing of a full param tree so the
  serving engine can place and execute stage shards independently (copied
  verbatim); ``slice_stage_params`` and ``stage_forward`` over the port's
  per-layer lists.
* ``pipeline_shard_map`` — the SPMD pipeline over a ``stage`` mesh
  dimension, one process per stage: every stage holds its layer shard and
  microbatch activations move one stage per tick over a ring of
  point-to-point sends (``dist.batch_isend_irecv``, the analogue of the
  reference's ``ppermute``). Bubble fraction = (S-1)/(M+S-1) for S stages
  and M microbatches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig


# ---------------------------------------------------------------------------
# Stage partitioning of a layer-stacked param tree
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StagePartition:
    """Contiguous layer segments [start, end) covering the model."""

    boundaries: Tuple[int, ...]          # len = n_stages + 1; [0, ..., L]

    @property
    def n_stages(self) -> int:
        return len(self.boundaries) - 1

    def segment(self, i: int) -> Tuple[int, int]:
        return self.boundaries[i], self.boundaries[i + 1]

    @staticmethod
    def uniform(num_layers: int, layers_per_stage: int) -> "StagePartition":
        bs = list(range(0, num_layers, layers_per_stage)) + [num_layers]
        return StagePartition(tuple(dict.fromkeys(bs)))


def slice_stage_params(params, start: int, end: int, stacked_key="layers"):
    """A stage's slice of the per-layer list (+ shared refs)."""
    out = dict(params)
    out[stacked_key] = params[stacked_key][start:end]
    return out


def stage_forward(cfg: ModelConfig, stage_params, x, angles=None):
    """Run a contiguous block-stack segment on hidden states (B, S, d)."""
    from repro_torch.models.transformer import block_forward

    for lp in stage_params["layers"]:
        x, _ = block_forward(cfg, lp, x, angles)
    return x


# ---------------------------------------------------------------------------
# SPMD pipeline (ring of point-to-point sends)
# ---------------------------------------------------------------------------


def pipeline_shard_map(stage_fn: Callable, mesh, n_microbatches: int,
                       stage_axis: str = "stage"):
    """Build a pipelined forward: x (M, b, ...) -> y (M, b, ...), called by
    every rank of ``mesh`` with the same (replicated) microbatches.

    ``stage_fn(stage_id, x_mb)`` applies one stage's compute. GPipe
    schedule, the reference's tick for tick: in M + S - 1 ticks stage 0
    injects microbatch ``clip(t, 0, M - 1)``, the others take what arrived
    from the stage before; stage s finishes microbatch ``t - (S - 1)`` and
    only the last stage writes it; activations move one stage per tick
    over the ring. At the end an all-reduce SUM over the stage group
    replicates the outputs (the other stages hold zeros).
    """
    group = mesh.get_group(stage_axis)
    S = mesh.size(mesh.mesh_dim_names.index(stage_axis))

    def pipelined(x):
        stage = dist.get_rank(group)
        M = x.shape[0]
        n_ticks = M + S - 1
        nxt = dist.get_global_rank(group, (stage + 1) % S)
        prv = dist.get_global_rank(group, (stage - 1) % S)
        buf = torch.zeros_like(x[0])
        out = torch.zeros_like(x)
        for t in range(n_ticks):
            inject = x[min(max(t, 0), M - 1)]
            cur = inject if stage == 0 else buf
            y = stage_fn(stage, cur)
            done_idx = t - (S - 1)
            if stage == S - 1 and done_idx >= 0:
                out[min(max(done_idx, 0), M - 1)] = y
            y = y.contiguous()
            if S == 1:
                buf = y
                continue
            buf = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)])
            for r in reqs:
                r.wait()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    return pipelined


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)

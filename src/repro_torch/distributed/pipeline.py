"""Stage partitioning of a served model into contiguous layer segments.

Port of ``repro.distributed.pipeline`` (``StagePartition`` only, copied
verbatim). The SPMD ``pipeline_shard_map`` of the reference belongs to the
distributed slice of the port and is not here yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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

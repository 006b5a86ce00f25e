"""Deterministic synthetic LM data pipeline.

Per-host sharded, resumable (cursor = step index), document-packed token
stream: documents of geometric length are concatenated with EOS separators
into fixed-length rows — the standard packing scheme, so the loss masks and
shapes match a real corpus pipeline. Deterministic in (seed, host, step) so
checkpoint-restart reproduces the exact stream.

Port of ``repro.data.pipeline``, copied verbatim: it holds no JAX (numpy
only), and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

EOS = 0


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 256
    num_hosts: int = 1
    host_id: int = 0


class SyntheticLMStream:
    """Markov-ish synthetic token stream (zipf unigram + local structure)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, self.cfg.host_id, step))

    def _sample_doc(self, rng, max_len: int) -> np.ndarray:
        n = min(max_len, 1 + rng.geometric(1.0 / self.cfg.mean_doc_len))
        base = rng.zipf(1.5, size=n) % (self.cfg.vocab_size - 1) + 1
        # local structure: short-range repeats make the LM task learnable
        for i in range(2, n):
            if rng.random() < 0.3:
                base[i] = base[i - 2]
        return base.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """tokens/labels (local_batch, seq_len) + loss mask."""
        cfg = self.cfg
        rng = self._rng(step)
        S = cfg.seq_len + 1
        rows = np.full((self.local_batch, S), EOS, np.int32)
        for b in range(self.local_batch):
            pos = 0
            while pos < S:
                doc = self._sample_doc(rng, S - pos)
                rows[b, pos:pos + len(doc)] = doc
                pos += len(doc) + 1              # +1 EOS separator
        return {
            "tokens": rows[:, :-1],
            "labels": rows[:, 1:],
            "mask": (rows[:, 1:] != EOS).astype(np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def batches(self, start_step: int, n: int):
        for s in range(start_step, start_step + n):
            yield self.batch(s)

"""Unified serving submission API.

Port of ``repro.serving.api``, copied verbatim: it holds no JAX, and the
port keeps its own copy rather than importing the reference.

Three submission surfaces drifted apart across PRs 1-7:
``ServingEngine.submit(prompt, ...)``, ``GTRACPipelineServer.submit(prompt,
tau=..., ...)``, and hand-built ``engine.Request`` objects pushed straight
into an ``AdmissionQueue``. ``SubmitSpec`` is the one canonical surface:
both engines accept it directly (``engine.submit(SubmitSpec(...))``), the
old keyword forms survive as thin shims that forward here and emit
``DeprecationWarning``, and request ids are allocated by the admission
queue's monotonic counter unless the caller pins one explicitly.

Stream kinds
------------
``kind`` classifies the stream for the disaggregated serving pipeline
(serving/gtrac_serve.py):

* ``"auto"``    — the admission queue decides by prompt length: prompts
  longer than one prefill chunk become dedicated prefill streams, the
  rest decode inline (their whole prompt fits one window's token budget).
* ``"prefill"`` — force chunked prefill windows even for a short prompt.
* ``"decode"``  — force inline (single-shot) prefill inside the stream's
  first decode step, the pre-disaggregation behavior.

``arrival_time`` is the stream's sim-clock arrival (seconds): admission
holds the stream until the serving clock reaches it, which is how bursty
arrival traces (sim/workload.py) drive the window scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

STREAM_KINDS = ("auto", "prefill", "decode")


@dataclass
class SubmitSpec:
    """One generation stream, as submitted to either serving engine."""

    prompt: np.ndarray                  # (S,) int token prompt
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # per-request trust floor for trust-routed serving; None -> the
    # router's configured floor. The plain batched engine ignores it.
    tau: Optional[float] = None
    # sim-clock arrival (seconds); admission defers the stream until then
    arrival_time: float = 0.0
    kind: str = "auto"                  # auto | prefill | decode
    # explicit request id; None -> the admission queue's monotonic counter
    request_id: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.kind not in STREAM_KINDS:
            raise ValueError(
                f"kind {self.kind!r} not in {STREAM_KINDS}")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

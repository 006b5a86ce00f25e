"""Serving workload generator: mixed-length ``SubmitSpec`` streams.

Port of ``repro.sim.workload`` (``serving_workload`` only, copied
verbatim). The reference's routing-workload runners join the port with
the routing baselines (``core/routing.py``).
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.serving.api import SubmitSpec


def serving_workload(rng: np.random.Generator, n_requests: int, *,
                     vocab_size: int, short_len: int = 8,
                     long_len: int = 96, long_fraction: float = 0.25,
                     max_new_tokens: int = 8, burst_every_s: float = 0.0,
                     burst_size: int = 4) -> List[SubmitSpec]:
    """Mixed-length serving workload as ``SubmitSpec`` streams.

    ``long_fraction`` of the requests carry a ``long_len``-token prompt
    (the prefill-heavy tail that motivates disaggregation); the rest are
    ``short_len`` interactive streams. With ``burst_every_s`` > 0 the
    requests arrive in bursts of ``burst_size`` spaced that many sim
    seconds apart (admission defers them via ``SubmitSpec.arrival_time``);
    0 keeps the classic everything-already-queued open loop."""
    specs: List[SubmitSpec] = []
    for i in range(n_requests):
        n = long_len if rng.random() < long_fraction else short_len
        arrival = ((i // max(1, burst_size)) * burst_every_s
                   if burst_every_s > 0 else 0.0)
        specs.append(SubmitSpec(
            prompt=rng.integers(1, vocab_size, size=n),
            max_new_tokens=max_new_tokens, arrival_time=arrival))
    return specs

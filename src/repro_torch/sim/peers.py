"""Simulated edge peers with the paper's adversarial profiles (§V-A).

Port of ``repro.sim.peers``, copied verbatim: it holds no JAX, and the
port keeps its own copy rather than importing the reference.

Failure model is the paper's: each peer i fails independently *per request*
according to X_i ~ Bernoulli(p_fail,i) (draws are memoised per request id so
a peer is consistently up/down within one request). A failure stalls the
request at that hop (detected after a timeout fraction), which is what the
Bounded One-Shot Repair then handles.

Profiles (Table in §V-A):
  * honeypot — Risky–Fast: ~1 ms added delay, p_fail ∈ [0.20, 0.35]
  * turtle   — Safe–Slow: p_fail ≈ 0.1 %, 150–300 ms added delay
  * golden   — Guaranteed–Safe: p_fail = 0, 20–40 ms added delay
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class PeerProfile:
    name: str
    p_fail_range: Tuple[float, float]
    net_delay_ms_range: Tuple[float, float]
    compute_scale: float = 1.0      # multiplier on per-layer compute time


HONEYPOT = PeerProfile("honeypot", (0.20, 0.35), (0.5, 1.5))
TURTLE = PeerProfile("turtle", (0.001, 0.001), (150.0, 300.0))
GOLDEN = PeerProfile("golden", (0.0, 0.0), (20.0, 40.0))

PROFILES = {p.name: p for p in (HONEYPOT, TURTLE, GOLDEN)}

#: per-layer compute time for GPT-2-Large class models on commodity edge
#: hardware (Appendix B: ~2.2 s per token over 4 hops of 9 layers
#: → ~55 ms/layer + per-hop serialisation/dispatch overhead)
PER_LAYER_COMPUTE_MS = 55.0
PER_HOP_OVERHEAD_MS = 25.0
#: detection share of T_timeout charged when a hop fails
FAILURE_DETECT_FRACTION = 0.25


@dataclass
class SimPeer:
    peer_id: int
    layer_start: int
    layer_end: int
    profile: PeerProfile
    p_fail: float
    net_delay_ms: float
    jitter: float = 0.10             # multiplicative latency jitter sigma
    alive: bool = True               # heartbeats stop when False (crash sim)
    _request_draws: Dict[int, bool] = field(default_factory=dict)

    @property
    def num_layers(self) -> int:
        return self.layer_end - self.layer_start

    def compute_ms(self, tokens: int = 1) -> float:
        """Stage compute time for ``tokens`` freshly processed tokens.

        A hop that holds the stream's warm KV only processes the tokens
        appended since (usually 1 in decode); a cold hop recomputes the
        whole prefix. Per-layer compute scales with the token count; the
        per-hop serialisation/dispatch overhead is paid once."""
        return (max(1, int(tokens)) * self.num_layers * PER_LAYER_COMPUTE_MS
                * self.profile.compute_scale + PER_HOP_OVERHEAD_MS)

    def fails_in_request(self, request_id: int, rng: np.random.Generator)\
            -> bool:
        """Memoised per-request Bernoulli failure draw (paper §V-A)."""
        if request_id not in self._request_draws:
            self._request_draws[request_id] = bool(rng.random() < self.p_fail)
        return self._request_draws[request_id]

    def hop_latency_ms(self, rng: np.random.Generator,
                       tokens: int = 1) -> float:
        """One hop's wall latency: compute for ``tokens`` new tokens plus
        network delay, under multiplicative lognormal jitter. The default
        ``tokens=1`` is the classic decode-step charge, so existing
        per-token call sites are bit-identical."""
        base = self.compute_ms(tokens) + self.net_delay_ms
        return float(base * rng.lognormal(0.0, self.jitter))

    def forget_request(self, request_id: int) -> None:
        self._request_draws.pop(request_id, None)


def make_peer(peer_id: int, layer_start: int, layer_end: int,
              profile: PeerProfile, rng: np.random.Generator) -> SimPeer:
    lo, hi = profile.p_fail_range
    p_fail = float(rng.uniform(lo, hi)) if hi > lo else lo
    dlo, dhi = profile.net_delay_ms_range
    return SimPeer(peer_id, layer_start, layer_end, profile, p_fail,
                   float(rng.uniform(dlo, dhi)))

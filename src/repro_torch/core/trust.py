"""Trust and latency estimation (paper §III-C, §III-D, §IV-C).

Port of ``repro.core.trust``: the scalar rules and their numpy twins,
copied verbatim. The reference's device-side twin ``jax_apply_report``
waits for a later slice of the port.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import GTRACConfig


# ---------------------------------------------------------------------------
# Scalar rules (reference semantics)
# ---------------------------------------------------------------------------


def ewma_latency(prev_ms: float, observed_ms: float, beta: float) -> float:
    """Eq. (3): l̂_p(t) = (1-β) l̂_p(t-1) + β l_obs."""
    return (1.0 - beta) * prev_ms + beta * observed_ms


def effective_cost(latency_ms: float, trust: float,
                   timeout_ms: float) -> float:
    """Eq. (4): C_p = l̂_p + (1 - r_p) · T_timeout."""
    return latency_ms + (1.0 - trust) * timeout_ms


def reward(trust: float, cfg: GTRACConfig) -> float:
    """Success: every chain peer earns Δr⁺ (targeted attribution, §IV-C)."""
    return min(cfg.max_trust, trust + cfg.trust_reward)


def penalize(trust: float, cfg: GTRACConfig) -> float:
    """Failure: ONLY the failing hop loses Δr⁻."""
    return max(cfg.min_trust, trust - cfg.trust_penalty)


# ---------------------------------------------------------------------------
# Vectorised twins (numpy; used on PeerTable snapshots)
# ---------------------------------------------------------------------------


def effective_cost_vec(latency_ms: np.ndarray, trust: np.ndarray,
                       timeout_ms: float) -> np.ndarray:
    return latency_ms + (1.0 - trust) * timeout_ms


def liveness_vec(last_heartbeat: np.ndarray, now: float,
                 ttl_s: float) -> np.ndarray:
    return (now - last_heartbeat) <= ttl_s

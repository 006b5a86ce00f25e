"""Trust and latency estimation (paper §III-C, §III-D, §IV-C).

Port of ``repro.core.trust``: the scalar rules and their numpy twins,
copied verbatim, and ``torch_apply_report``, the twin of the reference's
device-side ``jax_apply_report`` on tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
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


# ---------------------------------------------------------------------------
# Torch twin (device-resident trust state)
# ---------------------------------------------------------------------------


def torch_apply_report(trust, latency, chain_mask, failed_onehot,
                       observed_ms, success, cfg: GTRACConfig, device=None):
    """Apply one ExecReport to device-side (trust, latency) tensors.

    trust, latency: (P,) float32; chain_mask: (P,) bool — peers on the chain;
    failed_onehot: (P,) bool — the failing hop (all-False on success);
    observed_ms: (P,) per-hop observed latency (0 where not on chain);
    success: scalar bool. Arrays and tensors are moved to ``device``
    (``cuda`` unless the caller passes another); returns the new
    (trust, latency) there.
    """
    dev = resolve_device(device)

    def on(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    trust = on(trust, torch.float32)
    latency = on(latency, torch.float32)
    chain_mask = on(chain_mask, torch.bool)
    failed_onehot = on(failed_onehot, torch.bool)
    observed_ms = on(observed_ms, torch.float32)
    success = on(success, torch.bool)
    hop_executed = chain_mask & (observed_ms > 0)
    new_lat = torch.where(
        hop_executed,
        (1.0 - cfg.ewma_beta) * latency + cfg.ewma_beta * observed_ms,
        latency)
    rewarded = torch.clamp(trust + cfg.trust_reward, cfg.min_trust,
                           cfg.max_trust)
    penalized = torch.clamp(trust - cfg.trust_penalty, cfg.min_trust,
                            cfg.max_trust)
    new_trust = torch.where(success & chain_mask, rewarded, trust)
    new_trust = torch.where((~success) & failed_onehot, penalized, new_trust)
    return new_trust, new_lat

"""Risk model and trust-floor configuration (paper §III-C, §IV-B, App. A).

Port of ``repro.core.risk``, copied verbatim: it holds no JAX, and the
port keeps its own copy rather than importing the reference.
"""
from __future__ import annotations

import math
from typing import Sequence



def chain_reliability(trusts: Sequence[float]) -> float:
    """Eq. (1): Rel(π) = Π r_p (conditional-independence baseline model)."""
    out = 1.0
    for r in trusts:
        out *= r
    return out


def chain_risk(trusts: Sequence[float]) -> float:
    """Eq. (2): Risk(π) = 1 - Rel(π)."""
    return 1.0 - chain_reliability(trusts)


def k_max(total_layers: int, min_layers_per_peer: int) -> int:
    """Design guarantee: K_max = ceil(L / l_min)."""
    return math.ceil(total_layers / max(1, min_layers_per_peer))


def trust_floor_for(epsilon: float, kmax: int) -> float:
    """Design guarantee: τ = (1 - ε)^(1/K_max). Any chain from the pruned
    graph then satisfies Π r_p ≥ 1 - ε (Appendix A)."""
    if not (0.0 < epsilon < 1.0):
        raise ValueError(f"epsilon must be in (0,1), got {epsilon}")
    return (1.0 - epsilon) ** (1.0 / max(1, kmax))


def risk_bound(tau: float, k: int) -> float:
    """Lemma 1: Risk(π) ≤ 1 - τ^K for any chain of length K with r_p ≥ τ."""
    return 1.0 - tau ** k


def verify_design_guarantee(trusts: Sequence[float], epsilon: float,
                            kmax: int) -> bool:
    """Check the end-to-end constraint for a selected chain (test helper)."""
    tau = trust_floor_for(epsilon, kmax)
    if any(r < tau - 1e-12 for r in trusts):
        return False  # chain was not drawn from the pruned graph
    return chain_reliability(trusts) >= (1.0 - epsilon) - 1e-12

"""Feedback-driven chain execution with Bounded One-Shot Repair (Alg. 1).

Port of ``repro.core.executor``, copied verbatim: it holds no JAX, and the
port keeps its own copy rather than importing the reference.

``ChainExecutor`` is generic over the hop function so the same Alg. 1
semantics drive both the simulator (Bernoulli peer failures, §V-A) and real
stage execution (serving/gtrac_serve.py):

    hop_fn(peer_id, stage_index, payload) -> (payload', latency_ms, ok)

On hop failure with repair enabled, the executor first consults the
request's precomputed ``RoutePlan`` (core/planner.py) when one is supplied:
the plan's K-best alternates yield a full replacement *suffix* from the
failed hop's start boundary with zero additional graph search. If no
alternate avoids the failed peer (or no plan was provided), it falls back
to querying the trusted set for the minimum-latency replacement hosting
the SAME layer segment (line 10). Either way the failed hop is retried
exactly once; intermediate progress x_{k-1} is never discarded. Unbounded
retries are deliberately not offered (§IV-C: bounded corrective action
preserves failure attribution and risk semantics).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.types import ExecReport, HopReport, PeerTable
from repro_torch.obs.trace import NOOP_TRACER

HopFn = Callable[[int, int, object], Tuple[object, float, bool]]


def try_plan_splice(plan, table: PeerTable, failed_idx: Optional[int],
                    exclude: set) -> Optional[List[int]]:
    """Precomputed-failover helper shared by both executors: the cheapest
    RoutePlan alternate suffix through the failed hop's start boundary
    avoiding ``exclude`` (peer ids), or None."""
    if plan is None or failed_idx is None:
        return None
    boundary = int(table.layer_start[failed_idx])
    return plan.resume_suffix(boundary, exclude=exclude)


def find_replacement(table: PeerTable, failed_idx: int, tau: float,
                     exclude: Optional[set] = None) -> Optional[int]:
    """Line 10: argmin_{p∈V'} { l̂_p | p != p_fail ∧ LAYERS(p) = LAYERS(p_fail) }."""
    seg = (table.layer_start[failed_idx], table.layer_end[failed_idx])
    mask = (table.alive
            & (table.trust >= tau)
            & (table.layer_start == seg[0])
            & (table.layer_end == seg[1]))
    mask[failed_idx] = False
    if exclude:
        for i in exclude:
            mask[i] = False
    cand = np.nonzero(mask)[0]
    if len(cand) == 0:
        return None
    return int(cand[np.argmin(table.latency_ms[cand])])


class ChainExecutor:
    #: sim-domain tracer; failover splices emit zero-duration markers
    #: that nest under whatever span the serving layer has open
    tracer = NOOP_TRACER

    def __init__(self, cfg: GTRACConfig, hop_fn: HopFn):
        self.cfg = cfg
        self.hop_fn = hop_fn
        self.plan_repairs = 0      # repairs served from a RoutePlan alternate

    def execute(self, chain: List[int], table: PeerTable,
                payload: object = None,
                tau: Optional[float] = None,
                plan=None) -> Tuple[ExecReport, object]:
        """Run the chain; Alg. 1 lines 7–15. Returns (report, final payload).

        ``plan`` (a planner.RoutePlan over the same ``table``) supplies
        K-best alternate chains; on failure the cheapest alternate suffix
        through the failed hop's boundary is spliced in without any fresh
        route search."""
        tau = self.cfg.trust_floor if tau is None else tau
        hops: List[HopReport] = []
        total_ms = 0.0
        repaired = False
        repair_peer = None
        exec_chain = list(chain)

        k = 0
        while k < len(exec_chain):
            pid = exec_chain[k]
            payload_out, lat_ms, ok = self.hop_fn(pid, k, payload)
            hops.append(HopReport(pid, lat_ms, ok))
            total_ms += lat_ms
            if ok:
                payload = payload_out
                k += 1
                continue
            # ---- hop failure ----
            if repaired or not self.cfg.repair_enabled:
                return ExecReport(False, exec_chain, hops, failed_peer=pid,
                                  repaired=repaired, repair_peer=repair_peer,
                                  total_latency_ms=total_ms), payload
            try:
                fidx = table.index_of(pid)
            except KeyError:
                fidx = None
            suffix = try_plan_splice(plan, table, fidx, exclude={pid})
            if suffix is not None:
                # precomputed failover: splice the alternate suffix onto
                # the executed prefix — no fresh search
                repaired = True
                repair_peer = suffix[0]
                exec_chain[k:] = suffix
                self.plan_repairs += 1
                if self.tracer.enabled:
                    self.tracer.event("failover.splice", cat="failover",
                                      via="plan", stage=k, failed_peer=pid,
                                      repair_peer=repair_peer)
                continue
            ridx = (find_replacement(table, fidx, tau)
                    if fidx is not None else None)
            if ridx is None:
                return ExecReport(False, exec_chain, hops, failed_peer=pid,
                                  total_latency_ms=total_ms), payload
            # SWAPNODE + one-shot retry of the SAME step (progress kept)
            repaired = True
            repair_peer = int(table.peer_ids[ridx])
            exec_chain[k] = repair_peer
            if self.tracer.enabled:
                self.tracer.event("failover.splice", cat="failover",
                                  via="search", stage=k, failed_peer=pid,
                                  repair_peer=repair_peer)
            # loop continues at the same k with the swapped peer

        return ExecReport(True, exec_chain, hops,
                          repaired=repaired, repair_peer=repair_peer,
                          total_latency_ms=total_ms), payload


def split_reports(report: ExecReport) -> List[ExecReport]:
    """Decompose an execution trace into per-outcome reports for the Anchor.

    Repair semantics (§IV-C): the ORIGINAL failing hop is penalised even when
    the one-shot repair subsequently rescues the request; successful chains
    reward exactly the peers that ran.
    """
    out: List[ExecReport] = []
    failed_hops = [h for h in report.hops if not h.success]
    for h in failed_hops:
        out.append(ExecReport(False, report.chain, [h], failed_peer=h.peer_id))
    if report.success:
        ok_peers = [h.peer_id for h in report.hops if h.success]
        out.append(ExecReport(True, ok_peers,
                              [h for h in report.hops if h.success]))
    return out

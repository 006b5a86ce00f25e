"""Hedged hop execution — "The Tail at Scale" applied to G-TRAC chains.

The paper bounds tail latency with a fixed T_timeout penalty in C_p (Eq. 4)
and a one-shot repair AFTER failure detection. Hedging attacks the tail
*before* detection: when a hop's latency exceeds the peer's P-quantile
estimate (hedge_after = quantile_factor × l̂_p), a backup request is issued
to the best trusted replacement, and the earlier completion wins. Costs one
duplicate hop of work in the slow tail only; bounded to one hedge per hop so
failure attribution stays meaningful (the same argument as §IV-C's bounded
repair).

In the simulator the race is resolved analytically: the hedge fires iff the
primary's drawn latency exceeds the trigger, and the winner is
min(primary_latency, trigger + backup_latency).

Port of ``repro.core.hedging``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.executor import find_replacement, try_plan_splice
from repro_torch.core.types import ExecReport, HopReport, PeerTable
from repro_torch.obs.trace import NOOP_TRACER


@dataclass
class HedgeStats:
    hops: int = 0
    hedges_fired: int = 0
    hedges_won: int = 0
    latency_saved_ms: float = 0.0


class HedgedChainExecutor:
    """ChainExecutor variant with latency hedging (simulation-oriented).

    hop_fn(peer_id, stage, payload) -> (payload', latency_ms, ok) as usual;
    the executor additionally consults the peer table's latency estimates to
    set per-hop hedge triggers.
    """

    #: sim-domain tracer (same marker convention as ChainExecutor)
    tracer = NOOP_TRACER

    def __init__(self, cfg: GTRACConfig, hop_fn, quantile_factor: float = 2.0):
        self.cfg = cfg
        self.hop_fn = hop_fn
        self.quantile_factor = quantile_factor
        self.stats = HedgeStats()
        self.plan_repairs = 0      # repairs served from a RoutePlan alternate

    def _hedge_trigger_ms(self, table: PeerTable, pid: int) -> float:
        try:
            est = float(table.latency_ms[table.index_of(pid)])
        except KeyError:
            est = self.cfg.init_latency_ms
        return self.quantile_factor * est

    def execute(self, chain: List[int], table: PeerTable,
                payload: object = None,
                tau: Optional[float] = None,
                plan=None) -> Tuple[ExecReport, object]:
        """``plan`` (planner.RoutePlan over the same table) lets the
        post-hedge repair splice a precomputed K-best alternate suffix
        instead of searching for a same-segment replacement."""
        tau = self.cfg.trust_floor if tau is None else tau
        hops: List[HopReport] = []
        total_ms = 0.0
        repaired = False
        repair_peer = None
        exec_chain = list(chain)

        k = 0
        while k < len(exec_chain):
            pid = exec_chain[k]
            self.stats.hops += 1
            out, lat, ok = self.hop_fn(pid, k, payload)
            trigger = self._hedge_trigger_ms(table, pid)

            if ok and lat <= trigger:
                hops.append(HopReport(pid, lat, True))
                total_ms += lat
                payload = out
                k += 1
                continue

            # primary is slow (or failed): fire the hedge
            fidx = table.index_of(pid)
            hidx = find_replacement(table, fidx, tau)
            failed_hedge = None
            if hidx is not None:
                self.stats.hedges_fired += 1
                hpid = int(table.peer_ids[hidx])
                if self.tracer.enabled:
                    self.tracer.event("hedge.fired", cat="hedge", stage=k,
                                      peer=pid, hedge_peer=hpid,
                                      trigger_ms=trigger)
                hout, hlat, hok = self.hop_fn(hpid, k, payload)
                if not hok:
                    failed_hedge = hpid
                hedge_total = trigger + hlat     # issued at the trigger time
                if hok and (not ok or hedge_total < lat):
                    # hedge wins the race
                    self.stats.hedges_won += 1
                    if ok:
                        self.stats.latency_saved_ms += lat - hedge_total
                    if self.tracer.enabled:
                        self.tracer.event(
                            "hedge.won", cat="hedge", stage=k, peer=pid,
                            hedge_peer=hpid,
                            saved_ms=(lat - hedge_total if ok else 0.0))
                    hops.append(HopReport(hpid, hedge_total, True))
                    total_ms += hedge_total
                    payload = hout
                    exec_chain[k] = hpid
                    k += 1
                    continue
            if ok:   # slow primary still completes; no better hedge
                hops.append(HopReport(pid, lat, True))
                total_ms += lat
                payload = out
                k += 1
                continue

            # primary failed and the hedge didn't save it -> one-shot repair
            hops.append(HopReport(pid, lat, False))
            total_ms += lat
            if repaired or not self.cfg.repair_enabled:
                return ExecReport(False, exec_chain, hops, failed_peer=pid,
                                  repaired=repaired, repair_peer=repair_peer,
                                  total_latency_ms=total_ms), payload
            # exclude the hedge peer too when it just failed, so the splice
            # cannot hand back the peer that lost this very hop
            exclude = {pid} if failed_hedge is None else {pid, failed_hedge}
            suffix = try_plan_splice(plan, table, fidx, exclude=exclude)
            if suffix is not None:
                repaired = True
                repair_peer = suffix[0]
                exec_chain[k:] = suffix
                self.plan_repairs += 1
                if self.tracer.enabled:
                    self.tracer.event("failover.splice", cat="failover",
                                      via="plan", stage=k, failed_peer=pid,
                                      repair_peer=repair_peer)
                continue
            ridx = find_replacement(table, fidx, tau)
            if ridx is None:
                return ExecReport(False, exec_chain, hops, failed_peer=pid,
                                  total_latency_ms=total_ms), payload
            repaired = True
            repair_peer = int(table.peer_ids[ridx])
            exec_chain[k] = repair_peer
            if self.tracer.enabled:
                self.tracer.event("failover.splice", cat="failover",
                                  via="search", stage=k, failed_peer=pid,
                                  repair_peer=repair_peer)

        return ExecReport(True, exec_chain, hops, repaired=repaired,
                          repair_peer=repair_peer,
                          total_latency_ms=total_ms), payload

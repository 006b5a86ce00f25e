"""Hedged execution: the port's ``core/hedging.py`` against the JAX
package's reference module, and hedged window serving end to end.

Both packages run the same hop scripts on the same registry tables, and
everything the hedged executor derives is compared with EXACT equality (no
tolerance): the ``ExecReport`` (chain, hops with their latencies, repair
fields, total latency), the returned payload, ``HedgeStats`` (hops, hedges
fired and won, latency saved) and ``plan_repairs``. The scenarios are the
reference's ``TestHedging`` (``tests/test_failover_hedging.py``) and the
hedged plan-splice cases of ``tests/test_planner.py``. The slice as a whole
is ``run_queue`` with ``hedge_enabled`` on gpt2-large.reduced: a fired
hedge runs the hedge peer's real stage forward, and the served tokens,
every ``ServeMetrics`` field (``hedges_fired`` and ``hedges_won``
included) and each stream's ``HedgeStats`` equal the reference server's.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs.base import GTRACConfig
from repro.core import executor as jexecutor
from repro.core.executor import ChainExecutor
from repro.core.hedging import HedgedChainExecutor
from repro.core.planner import RoutePlanner, plan_route
from repro.core.registry import AnchorRegistry
from repro.serving.api import SubmitSpec
from repro_torch.configs.base import GTRACConfig as TGTRACConfig
from repro_torch.core import executor as texecutor
from repro_torch.core.executor import ChainExecutor as TChainExecutor
from repro_torch.core.hedging import \
    HedgedChainExecutor as THedgedChainExecutor
from repro_torch.core.planner import RoutePlanner as TRoutePlanner
from repro_torch.core.planner import plan_route as tplan_route
from repro_torch.core.registry import AnchorRegistry as TAnchorRegistry
from repro_torch.serving.api import SubmitSpec as TSubmitSpec

from test_torch_serving import (_assert_served_equal, _prompts,  # noqa: F401
                                _servers, models)

torch.set_num_threads(1)

REF = SimpleNamespace(cfg=GTRACConfig, anchor=AnchorRegistry,
                      hedged=HedgedChainExecutor, plain=ChainExecutor,
                      planner=RoutePlanner, plan_route=plan_route,
                      executor=jexecutor)
PORT = SimpleNamespace(cfg=TGTRACConfig, anchor=TAnchorRegistry,
                       hedged=THedgedChainExecutor, plain=TChainExecutor,
                       planner=TRoutePlanner, plan_route=tplan_route,
                       executor=texecutor)
SIDES = (("ref", REF), ("port", PORT))


def _stage_table(pkg, latencies):
    """The reference test's table: peers 0.. on layers [0, 3) with the
    given latency estimates, peer 99 on [3, 6)."""
    a = pkg.anchor(pkg.cfg())
    for pid, lat in enumerate(latencies):
        a.register(pid, 0, 3, now=0.0, latency_ms=lat)
        a.heartbeat(pid, 0.0)
    a.register(99, 3, 6, now=0.0, latency_ms=50.0)
    a.heartbeat(99, 0.0)
    return a.snapshot(0.0)


def _layered_anchor(pkg, replicas):
    """``build_layered_anchor(L=6, segments=(3,), replicas, seed=0,
    trust_range=(0.95, 1.0))`` of the reference's conftest, on ``pkg``'s
    registry: the same draws in the same order."""
    rng = np.random.default_rng(0)
    anchor = pkg.anchor(pkg.cfg())
    pid = 0
    for s in range(0, 6, 3):
        for _ in range(replicas):
            anchor.register(pid, s, s + 3, now=0.0,
                            trust=float(rng.uniform(0.95, 1.0)),
                            latency_ms=float(rng.uniform(10, 300)))
            anchor.heartbeat(pid, 0.0)
            pid += 1
    return anchor


def _straggler_hop(pkg):
    lat = {0: 1000.0, 1: 80.0, 99: 50.0}       # peer 0 straggles hard
    return lambda pid, k, payload: (payload, lat[pid], True)


def _fast_hop(pkg):
    return lambda pid, k, payload: (payload, 90.0, True)


def _failing_hop(pkg):
    def hop(pid, k, payload):
        if pid == 0:
            return payload, 150.0, False       # fail (slow detect)
        return payload, 60.0, True
    return hop


def _payload_hop(pkg):
    """Each hop appends (stage, peer) to the payload, so the returned
    payload records which replica's output won every hop."""
    lat = {0: 1000.0, 1: 80.0, 99: 50.0}
    return lambda pid, k, payload: (payload + ((k, pid),), lat[pid], True)


SCENARIOS = {
    # name: (latency estimates, hop factory, quantile factor)
    "hedge_wins_against_straggler": ([100.0, 100.0], _straggler_hop, 2.0),
    "no_hedge_when_fast": ([100.0, 100.0], _fast_hop, 2.0),
    "hedge_rescues_failure_without_repair": ([100.0, 100.0], _failing_hop,
                                             2.0),
    "payload_follows_winner": ([100.0, 100.0], _payload_hop, 2.0),
}


def _run(pkg, name):
    lats, make_hop, q = SCENARIOS[name]
    ex = pkg.hedged(pkg.cfg(), make_hop(pkg), quantile_factor=q)
    report, payload = ex.execute([0, 99], _stage_table(pkg, lats),
                                 payload=())
    return ex, report, payload


def _assert_exec_equal(got, want):
    (ex_p, rep_p, pay_p), (ex_r, rep_r, pay_r) = got, want
    assert dataclasses.asdict(rep_p) == dataclasses.asdict(rep_r)
    assert pay_p == pay_r
    assert vars(ex_p.stats) == vars(ex_r.stats)
    assert ex_p.plan_repairs == ex_r.plan_repairs


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hedging_scenarios_match_reference(name):
    """The reference's ``TestHedging`` scenarios: the same report, payload
    and hedge counters; and the reference test's own claims hold."""
    got = {side: _run(pkg, name) for side, pkg in SIDES}
    _assert_exec_equal(got["port"], got["ref"])
    ex, report, payload = got["port"]
    assert report.success
    if name == "hedge_wins_against_straggler":
        assert ex.stats.hedges_fired == 1 and ex.stats.hedges_won == 1
        # winner: trigger (200) + backup (80) = 280 < 1000
        assert report.hops[0].latency_ms == pytest.approx(280.0)
        assert report.chain[0] == 1               # backup took over
        assert ex.stats.latency_saved_ms == pytest.approx(720.0)
    elif name == "no_hedge_when_fast":
        assert ex.stats.hedges_fired == 0
    elif name == "hedge_rescues_failure_without_repair":
        assert not report.repaired and ex.stats.hedges_won == 1
    else:
        assert payload == ((0, 1), (1, 99))       # the backup's output won


def test_tail_latency_matches_reference():
    """The reference's lognormal straggler pool, 300 chains: every hedged
    and unhedged total latency equals the reference's, and hedging cuts
    the p99 without a mean regression (the reference test's claim)."""
    out = {}
    for side, pkg in SIDES:
        t = _stage_table(pkg, [100.0] * 4)

        def make_hop(seed):
            r = np.random.default_rng(seed)

            def hop(pid, k, payload):
                base = 100.0 if pid != 99 else 50.0
                return payload, base * float(r.lognormal(0, 1.0)), True
            return hop

        plain, hedged, stats = [], [], []
        for i in range(300):
            r1, _ = pkg.plain(pkg.cfg(), make_hop(i)).execute([0, 99], t)
            plain.append(r1.total_latency_ms)
            ex = pkg.hedged(pkg.cfg(), make_hop(i), quantile_factor=2.0)
            r2, _ = ex.execute([0, 99], t)
            hedged.append(r2.total_latency_ms)
            stats.append(vars(ex.stats))
        out[side] = (plain, hedged, stats)
    assert out["port"] == out["ref"]
    plain, hedged, _ = out["port"]
    assert np.percentile(hedged, 99) < np.percentile(plain, 99)
    assert np.mean(hedged) <= np.mean(plain) * 1.05


@pytest.mark.parametrize("case", ["recovers_from_plan",
                                  "splice_excludes_failed_hedge_peer",
                                  "midchain_failure_hedged"])
def test_hedged_plan_splice_matches_reference(case):
    """The hedged splice cases of ``tests/test_planner.py``: the same
    ``RoutePlan`` chain, ``ExecReport``, ``HedgeStats``, ``plan_repairs``
    and planner counters (no fresh search) as the reference's."""
    got = {}
    for side, pkg in SIDES:
        replicas = 3 if case == "recovers_from_plan" else 4
        t = _layered_anchor(pkg, replicas).snapshot(0.0)
        planner = pkg.planner(6, k_best=6 if replicas == 3 else 8)
        r, plan = pkg.plan_route(t, 6, pkg.cfg(), tau=0.0, planner=planner)
        solves = planner.stats["solves"]
        if case == "recovers_from_plan":
            dead = {r.chain[0]}
        elif case == "splice_excludes_failed_hedge_peer":
            # the primary and the peer find_replacement would hedge with
            hidx = pkg.executor.find_replacement(
                t, t.index_of(r.chain[0]), 0.0)
            dead = {r.chain[0], int(t.peer_ids[hidx])}
        else:
            dead = {r.chain[1]}

        def hop(pid, k, payload, dead=dead):
            return payload, 10.0, pid not in dead

        ex = pkg.hedged(pkg.cfg(), hop, quantile_factor=1e9)
        report, _ = ex.execute(r.chain, t, tau=0.0, plan=plan)
        got[side] = (list(r.chain), dataclasses.asdict(report),
                     vars(ex.stats), ex.plan_repairs,
                     planner.stats["solves"] - solves, dead)
    assert got["port"] == got["ref"]
    chain, report, stats, plan_repairs, new_solves, dead = got["port"]
    assert report["success"] and new_solves == 0
    assert not dead.intersection(report["chain"])
    if case == "splice_excludes_failed_hedge_peer":
        assert plan_repairs == 1 and stats["hedges_fired"] == 1


# ---------------------------------------------------------------------------
# The slice as a whole: hedged window serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_backend,port_backend,factor,disaggregate",
                         [("jnp", "kernel", 2.0, True),
                          ("numpy", "numpy", 2.0, False),
                          ("jnp", "torch", 0.05, True)])
def test_run_queue_hedged_matches_reference(models, jax_backend,
                                            port_backend, factor,
                                            disaggregate):
    """``run_queue`` with ``hedge_enabled``: the same tokens, every
    ``ServeMetrics`` field, router counters and per-stream ``HedgeStats``
    as the reference server's. Factor 0.05 puts every hop over its trigger
    (the reference's ``test_hedged_window_serving``), so a hedge fires on
    every hop with a same-segment replacement; 2.0 is the default."""
    kw = dict(hedge_enabled=True, hedge_quantile_factor=factor,
              disaggregate=disaggregate, prefill_chunk_tokens=16)
    srv, tsrv = _servers(models, kw, jax_backend, port_backend)
    forwards, outcomes = [0], []
    fns, hop_fn = tsrv.stage_fns, tsrv._hop_fn

    def counted(fn):
        def wrapped(payload):
            forwards[0] += 1
            return fn(payload)
        return wrapped

    def recorded_hop_fn(rid, kv_tracked=False):
        hop = hop_fn(rid, kv_tracked)

        def recorded(pid, k, payload):
            out = hop(pid, k, payload)
            outcomes.append(out[2])
            return out
        return recorded

    tsrv.stage_fns = [counted(f) for f in fns]
    tsrv._hop_fn = recorded_hop_fn
    for p in _prompts():
        srv.submit(SubmitSpec(prompt=p, max_new_tokens=5))
        tsrv.submit(TSubmitSpec(prompt=p, max_new_tokens=5))
    done, tdone = srv.run_queue(), tsrv.run_queue()
    _assert_served_equal(tdone, done)
    assert vars(tsrv.router.stats) == vars(srv.router.stats)
    for a, b in zip(tdone, done):
        assert isinstance(a.executor, THedgedChainExecutor)
        assert vars(a.executor.stats) == vars(b.executor.stats)
        assert a.executor.plan_repairs == b.executor.plan_repairs
        assert a.metrics.hedges_fired == a.executor.stats.hedges_fired
        assert a.metrics.hedges_won <= a.metrics.hedges_fired
    fired = sum(r.metrics.hedges_fired for r in tdone)
    assert fired > 0
    # every hop call is a primary or a hedge, and each one that does not
    # fail runs one real stage forward (so K3 counts hedge forwards too)
    assert len(outcomes) == sum(r.executor.stats.hops for r in tdone) + fired
    assert forwards[0] == sum(outcomes)

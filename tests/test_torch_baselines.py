"""The paper's routing evaluation: the port (``repro_torch``) against the JAX
reference.

The routing policies (``core/routing.py``: G-TRAC, the four baselines, the
heap-Dijkstra and brute-force oracles), the risk algebra
(``core/risk.py``), the testbed builders and churn driver
(``sim/testbed.py``) and the routing-workload runner (``sim/workload.py``)
are host numpy in both packages, copied into the port. Held against the
reference on the same seeds, everything must be IDENTICAL (exact
equality): chains, costs, hop counts, feasibility and reliability of every
decision (not its wall-clock ``decision_time_ms``), testbed snapshots and
peers, ``ChurnStats``, and every ``WorkloadStats`` field — SSR, Wilson CI,
chains, repairs and token latencies — which agree only if every routing
decision and every RNG draw of the simulation agree in order.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import GTRACConfig
from repro.core import risk as jrisk
from repro.core import routing as jrouting
from repro.sim import testbed as jtestbed
from repro.sim import workload as jworkload
from repro_torch.configs.base import GTRACConfig as TGTRACConfig
from repro_torch.core import risk as trisk
from repro_torch.core import routing as trouting
from repro_torch.core.registry import AnchorRegistry as TAnchorRegistry
from repro_torch.core.sharding import make_registry
from repro_torch.sim import testbed as ttestbed
from repro_torch.sim import workload as tworkload

from conftest import build_layered_anchor
from test_torch_routing import _port_layered_anchor

ALGOS = ("gtrac", "sp", "mr", "naive", "larac")


def _table_equal(a, b):
    for col in ("peer_ids", "layer_start", "layer_end", "trust",
                "latency_ms", "alive"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                      err_msg=col)


def _route_equal(got, want):
    assert got.chain == want.chain
    assert got.total_cost == want.total_cost
    assert got.hops == want.hops
    assert got.feasible == want.feasible
    assert got.reliability == want.reliability
    assert got.algorithm == want.algorithm


def _route_both(name, t_port, t_ref, L, **kw):
    """One decision of policy ``name`` on each side; naive gets equal
    seeded RNGs."""
    cfg, tcfg = GTRACConfig(), TGTRACConfig()
    fn = {"heap": "heap_dijkstra_route",
          "brute": "brute_force_route"}.get(name)
    if fn is None:
        tfn, jfn = trouting.ALGORITHMS[name], jrouting.ALGORITHMS[name]
    else:
        tfn, jfn = getattr(trouting, fn), getattr(jrouting, fn)
    kw = dict(kw)
    seed = kw.pop("seed", None)
    tkw, jkw = dict(kw), dict(kw)
    if name == "naive":
        tkw["rng"] = np.random.default_rng(seed)
        jkw["rng"] = np.random.default_rng(seed)
    return tfn(t_port, L, tcfg, **tkw), jfn(t_ref, L, cfg, **jkw)


@pytest.mark.parametrize("name,kw", [
    ("gtrac", {}), ("gtrac", {"tau": 0.9}), ("sp", {}), ("mr", {}),
    ("naive", {"seed": 0}), ("naive", {"seed": 5}),
    ("larac", {}), ("larac", {"epsilon": 0.3}), ("heap", {}),
])
def test_policies_match_reference_on_paper_testbed(name, kw):
    """The 336-peer paper testbed, before and after trust has moved (a
    short G-TRAC workload on each side first)."""
    bed, tbed = (jtestbed.build_paper_testbed(seed=1),
                 ttestbed.build_paper_testbed(seed=1))
    for step in range(2):
        t_ref, t_port = bed.anchor.snapshot(bed.now), \
            tbed.anchor.snapshot(tbed.now)
        _table_equal(t_port, t_ref)
        got, want = _route_both(name, t_port, t_ref, 36, **kw)
        _route_equal(got, want)
        assert want.feasible
        if step == 0:
            jworkload.run_workload(bed, "gtrac", 4, l_tok=3)
            tworkload.run_workload(tbed, "gtrac", 4, l_tok=3)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,kw", [
    ("gtrac", {"tau": 0.0}), ("gtrac", {"tau": 0.7}),
    ("gtrac", {"tau": 0.95}), ("heap", {"tau": 0.7}), ("sp", {}),
    ("mr", {}), ("naive", {"seed": 3}), ("larac", {"epsilon": 0.05}),
    ("larac", {"epsilon": 0.2}), ("larac", {"epsilon": 0.5}),
    ("brute", {"epsilon": 0.3}),
])
def test_policies_match_reference_on_layered_tables(seed, name, kw):
    """Random layered tables (L = 12, 3- and 6-layer segments) at several
    trust floors, risk tolerances and seeds, infeasible floors included."""
    t_ref = build_layered_anchor(GTRACConfig(), L=12, replicas=3,
                                 seed=seed).snapshot(0.0)
    t_port = _port_layered_anchor(TGTRACConfig(), L=12, replicas=3,
                                  seed=seed).snapshot(0.0)
    _table_equal(t_port, t_ref)
    got, want = _route_both(name, t_port, t_ref, 12, **kw)
    _route_equal(got, want)


def test_risk_functions_match_reference():
    trusts = [0.99, 0.95, 0.9, 0.97]
    assert trisk.chain_reliability(trusts) == jrisk.chain_reliability(trusts)
    assert trisk.chain_risk(trusts) == jrisk.chain_risk(trusts)
    for L, lmin in ((36, 3), (36, 9), (12, 0)):
        assert trisk.k_max(L, lmin) == jrisk.k_max(L, lmin)
    for eps, kmax in ((0.1, 12), (0.3, 4), (0.01, 1)):
        assert trisk.trust_floor_for(eps, kmax) == \
            jrisk.trust_floor_for(eps, kmax)
        assert trisk.verify_design_guarantee(trusts, eps, kmax) == \
            jrisk.verify_design_guarantee(trusts, eps, kmax)
    for tau, k in ((0.9, 4), (0.99, 12)):
        assert trisk.risk_bound(tau, k) == jrisk.risk_bound(tau, k)
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError):
            trisk.trust_floor_for(bad, 4)


@pytest.mark.parametrize("build,args", [
    ("build_paper_testbed", {"seed": 0}),
    ("build_paper_testbed", {"seed": 3, "replicas_per_slot":
                             {"honeypot": 2, "golden": 3}}),
    ("build_scaling_testbed", {"n_peers": 50, "seed": 0}),
    ("build_scaling_testbed", {"n_peers": 200, "seed": 7}),
])
def test_testbeds_match_reference(build, args):
    bed = getattr(jtestbed, build)(**args)
    tbed = getattr(ttestbed, build)(**args)
    _table_equal(tbed.anchor.snapshot(0.0), bed.anchor.snapshot(0.0))
    assert list(tbed.peers) == list(bed.peers)
    for pid, p in bed.peers.items():
        assert dataclasses.asdict(tbed.peers[pid]) == dataclasses.asdict(p)
    assert tbed.total_layers == bed.total_layers == 36
    # the sim RNG streams continue in lockstep
    assert tbed.rng.random() == bed.rng.random()


def test_run_churn_matches_reference():
    bed = jtestbed.build_scaling_testbed(96, seed=0)
    tbed = ttestbed.build_scaling_testbed(96, seed=0)
    kw = dict(windows=8, window_s=10.0, joins_per_window=3,
              crashes_per_window=4)
    stats = jtestbed.run_churn(bed, **kw)
    tstats = ttestbed.run_churn(tbed, **kw)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(stats)
    assert stats.expired > 0 and stats.joined == 24
    _table_equal(tbed.anchor.snapshot(tbed.now), bed.anchor.snapshot(bed.now))


def _stats_equal(got, want):
    assert got.algorithm == want.algorithm and got.l_tok == want.l_tok
    assert [dataclasses.asdict(r) for r in got.results] == \
        [dataclasses.asdict(r) for r in want.results]
    assert got.ssr == want.ssr
    assert got.wilson_ci() == want.wilson_ci()
    np.testing.assert_array_equal(got.token_latencies(),
                                  want.token_latencies())
    np.testing.assert_array_equal(got.chain_lengths(), want.chain_lengths())


@pytest.mark.parametrize("algorithm", ALGOS)
def test_run_workload_matches_reference(algorithm):
    """Seed 0 on the paper testbed: a converging run, then the measured
    one (as examples/edge_sim.py drives it), and the selection landscape."""
    bed = jtestbed.build_paper_testbed(seed=0)
    tbed = ttestbed.build_paper_testbed(seed=0)
    for n, l_tok, base in ((6, 3, 0), (8, 6, 1000)):
        want = jworkload.run_workload(bed, algorithm, n, l_tok,
                                      epsilon=0.10, request_id_base=base)
        got = tworkload.run_workload(tbed, algorithm, n, l_tok,
                                     epsilon=0.10, request_id_base=base)
        _stats_equal(got, want)
    assert bed.now == tbed.now
    land = jworkload.selection_landscape(bed, want)
    tland = tworkload.selection_landscape(tbed, got)
    assert sorted(tland) == sorted(land)
    for k in land:
        np.testing.assert_array_equal(tland[k], land[k])


def test_wilson_ci_edges():
    empty = tworkload.WorkloadStats(algorithm="sp", l_tok=1)
    assert empty.ssr == 0.0 and empty.wilson_ci() == (0.0, 0.0)
    ok = tworkload.RequestResult(success=True, tokens_done=1,
                                 token_latencies_ms=[1.0], chains=[[0]])
    full = tworkload.WorkloadStats(algorithm="sp", l_tok=1, results=[ok] * 9)
    want = jworkload.WorkloadStats(algorithm="sp", l_tok=1, results=[
        jworkload.RequestResult(success=True, tokens_done=1,
                                token_latencies_ms=[1.0], chains=[[0]])] * 9)
    assert full.ssr == 1.0 and full.wilson_ci() == want.wilson_ci()


def test_make_registry_monolithic_only():
    cfg = TGTRACConfig()
    assert isinstance(make_registry(cfg), TAnchorRegistry)
    assert isinstance(make_registry(cfg, shards=1, backend="inproc"),
                      TAnchorRegistry)
    for kw in ({"shards": 4}, {"backend": "procs"}):
        with pytest.raises(NotImplementedError, match="later slice"):
            make_registry(cfg, **kw)
    with pytest.raises(ValueError):
        make_registry(cfg, backend="grpc")
    with pytest.raises(NotImplementedError):
        ttestbed.build_scaling_testbed(16, shards=4)

"""The sync plane of the Hybrid Trust Architecture, and the slice as a
whole: the port against the JAX package's reference modules.

Both packages run the same seeded registry churn, and everything the sync
plane derives is compared with EXACT equality: delta messages and their
wire bytes, every ``GossipStats`` / ``RelayStats`` / seeker counter, the
seekers' version vectors and mirror digests, the staleness-bounded
``routing_view`` tables column for column, and the ``PartitionStats`` /
``ByzantineStats`` of the partition and Byzantine scenarios. The slice as a
whole is ``GTRACPipelineServer.run_queue`` on gpt2-large.reduced at
``anchor_shards=4`` with gossip and the relay plane (8 seekers): the same
tokens and every ``ServeMetrics`` field as the reference server's, as
``tests/test_torch_serving.py`` holds the monolithic anchor.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.sharding import ShardedAnchorRegistry
from repro.serving.api import SubmitSpec
from repro.sim import testbed as jtestbed
from repro.sync import delta as jdelta
from repro.sync.gossip import make_sync_plane
from repro_torch.core.sharding import \
    ShardedAnchorRegistry as TShardedAnchorRegistry
from repro_torch.launch import serve as tserve
from repro_torch.serving.api import SubmitSpec as TSubmitSpec
from repro_torch.sim import testbed as ttestbed
from repro_torch.sync import delta as tdelta
from repro_torch.sync.gossip import make_sync_plane as tmake_sync_plane

from test_torch_serving import (_assert_served_equal, _prompts,  # noqa: F401
                                _servers, models)
from test_torch_sharding import (PORT, REF, _apply, _script,
                                 assert_states_equal, assert_tables_equal,
                                 populate)

torch.set_num_threads(1)

SIDES = (("ref", REF, ShardedAnchorRegistry, make_sync_plane, jtestbed),
         ("port", PORT, TShardedAnchorRegistry, tmake_sync_plane, ttestbed))


def _assert_deltas_equal(d_port, d_ref):
    assert (d_port.shard, d_port.base_version, d_port.new_version,
            d_port.is_full, d_port.is_empty) == \
        (d_ref.shard, d_ref.base_version, d_ref.new_version, d_ref.is_full,
         d_ref.is_empty)
    assert np.array_equal(d_port.removed_ids, d_ref.removed_ids)
    for a, b in ((d_port.rows, d_ref.rows), (d_port.full, d_ref.full)):
        assert (a is None) == (b is None)
        if b is not None:
            assert_states_equal(a, b)
    assert d_port.wire_bytes() == d_ref.wire_bytes()


@pytest.mark.parametrize("include_heartbeats", [False, True])
def test_delta_encoding_matches_reference(include_heartbeats):
    """``make_delta`` / ``apply_delta`` / ``wire_bytes`` /
    ``state_wire_bytes`` over one shard's state before and after seeded
    churn, for small and large changes (the full-snapshot fallback)."""
    regs, states = {}, {}
    for name, pkg, cls, _, _ in SIDES:
        regs[name] = populate(cls(pkg.cfg(), n_shards=2), n=40)
        states[name] = {"next_pid": 1000, "saved": {}}
    ops = _script(seed=21, n_ops=60)
    now = 0.0
    for n_ops in (1, 4, 30):
        base = {k: (r.export_shard_state(0), r.shards[0].version)
                for k, r in regs.items()}
        for op in ops[:n_ops]:
            now += 0.5
            op = (op[0] % 10,) + op[1:]   # keep both shards' states alive
            for name, pkg, _, _, _ in SIDES:
                _apply(pkg, regs[name], op, now, states[name])
        got = {}
        for name, mod in (("ref", jdelta), ("port", tdelta)):
            (st0, v0), reg = base[name], regs[name]
            st1 = reg.export_shard_state(0)
            d = mod.make_delta(st0, st1, shard=0, base_version=v0,
                               new_version=reg.shards[0].version,
                               include_heartbeats=include_heartbeats)
            got[name] = (d, mod.apply_delta(st0, d), mod.state_wire_bytes(st1),
                         mod.full_delta(st1, shard=0, new_version=9))
        _assert_deltas_equal(got["port"][0], got["ref"][0])
        assert_states_equal(got["port"][1], got["ref"][1])
        assert got["port"][2] == got["ref"][2]
        _assert_deltas_equal(got["port"][3], got["ref"][3])
    empty = tdelta.empty_state()
    assert tdelta.state_wire_bytes(empty) == \
        jdelta.state_wire_bytes(jdelta.empty_state())


def _plane_pair(cfg_kw, n=60, shards=6, n_seekers=10, seed=1):
    out = {}
    for name, pkg, cls, plane, _ in SIDES:
        cfg = pkg.cfg(**cfg_kw)
        reg = populate(cls(cfg, n_shards=shards), n=n, seed=seed)
        pub, seekers, sched = plane(reg, cfg, n_seekers=n_seekers, now=0.0)
        out[name] = (cfg, reg, pub, seekers, sched)
    return out


def _assert_planes_equal(planes, now):
    (_, reg_p, pub_p, sk_p, sch_p), (_, reg_r, pub_r, sk_r, sch_r) = \
        planes["port"], planes["ref"]
    assert vars(sch_p.stats) == vars(sch_r.stats)
    assert (sch_p.relay is None) == (sch_r.relay is None)
    if sch_r.relay is not None:
        assert vars(sch_p.relay.stats) == vars(sch_r.relay.stats)
    assert pub_p.digest_vector() == pub_r.digest_vector()
    for a, b in zip(sk_p, sk_r):
        assert a.version_vector == b.version_vector
        assert [a.shard_digest(s) for s in range(a.n_shards)] == \
            [b.shard_digest(s) for s in range(b.n_shards)]
        assert vars(a.stats) == vars(b.stats)
        assert np.array_equal(a.staleness(now), b.staleness(now))
    assert [sch_p.converged(s, now) for s in sk_p] == \
        [sch_r.converged(s, now) for s in sk_r]


@pytest.mark.parametrize("plane", ["gossip", "relay", "relay_blind"])
def test_gossip_and_relay_rounds_match_reference(plane):
    """Gossip rounds under churn with the pull fanout capped at one shard
    and shallow histories (anti-entropy full syncs once a delta chain is
    evicted), with and without the relay plane and its handshake: every
    counter, version vector and mirror digest equals the reference's after
    every round."""
    kw = dict(gossip_fanout=1, gossip_history=2,
              gossip_hb_refresh_frac=0.5)
    n_seekers = 3
    if plane != "gossip":
        kw.update(relay_enabled=True, relay_fanout=2, relay_history=2,
                  relay_handshake=plane == "relay")
        n_seekers = 10
    planes = _plane_pair(kw, n_seekers=n_seekers)
    states = {k: {"next_pid": 1000, "saved": {}} for k in planes}
    ops = iter(_script(seed=5, n_ops=200))
    now = 0.0
    for rnd in range(14):
        now += 2.0
        for _ in range(1 + rnd % 4):
            op = next(ops)
            op = (op[0] % 10,) + op[1:]
            for name, pkg, _, _, _ in SIDES:
                _apply(pkg, planes[name][1], op, now, states[name])
        for name, (_, reg, _, _, sched) in planes.items():
            reg.heartbeat_all(sorted(reg.peers)[rnd % 3::2], now)
            sched.tick(now)
        _assert_planes_equal(planes, now)
    # the run exercised the caps and the anti-entropy it claims to
    st = planes["port"][4].stats
    assert st.deltas > 0 and st.full_syncs > 0
    if plane == "gossip":
        assert st.deferred > 0
    else:
        rs = planes["port"][4].relay.stats
        assert rs.deltas_applied > 0 and rs.gaps > 0


def test_routing_view_matches_reference():
    """``routing_view`` with the stale-round margin and the per-second
    decay on, through partitions and heals: the same tables column for
    column (and the same view generations) as the reference's."""
    kw = dict(gossip_stale_margin=0.03, gossip_stale_margin_max=0.2,
              gossip_stale_decay=0.02)
    planes = _plane_pair(kw, n=48, shards=4, n_seekers=2)
    rng = np.random.default_rng(8)
    now, adjusted = 0.0, 0
    for w in range(16):
        cut = [int(s) for s in np.flatnonzero(rng.uniform(size=4) < 0.5)]
        now += float(rng.uniform(0.5, 3.0))
        views = {}
        for name, (_, reg, _, seekers, sched) in planes.items():
            if w % 4 == 0:
                sched.partition(seekers[0], cut)
            elif w % 4 == 3:
                sched.heal(seekers[0], range(4))
            reg.set_trust(w % 48, 0.5 + 0.02 * w)
            reg.heartbeat_all(range(48), now)
            sched.maybe_tick(now)
            views[name] = seekers[0].routing_view(now)
            assert seekers[0].routing_view(now) is views[name]
        assert_tables_equal(views["port"], views["ref"])
        sk_p, sk_r = planes["port"][3][0], planes["ref"][3][0]
        assert np.array_equal(sk_p.staleness_rounds(now),
                              sk_r.staleness_rounds(now))
        adjusted += views["port"] is not sk_p.materialize(now)
    assert adjusted > 0


@pytest.mark.parametrize("relay", [False, True])
def test_simulate_partition_matches_reference(relay):
    """A seeker cut off from half the shards under churn, then healed: the
    same ``PartitionStats`` (rounds, staleness, bytes on both legs) and the
    same final tables as the reference's."""
    kw = dict(gossip_fanout=2, gossip_stale_margin=0.02)
    if relay:
        kw.update(relay_enabled=True, relay_fanout=3,
                  gossip_hb_refresh_frac=0.5)
    got = {}
    for name, pkg, _, plane, bed_mod in SIDES:
        cfg = pkg.cfg(**kw)
        bed = bed_mod.build_scaling_testbed(120, cfg=cfg, seed=3, shards=4)
        _, seekers, sched = plane(bed.anchor, cfg,
                                  n_seekers=6 if relay else 1, now=bed.now)
        pids = sorted(bed.peers)

        def churn(b, pkg=pkg, pids=pids):
            chain = [int(p) for p in pids[:3]]
            b.anchor.apply_report(pkg.report(
                True, chain, [pkg.hop(p, 60.0, True) for p in chain]))

        stats = bed_mod.simulate_partition(bed, sched, seekers[0], [0, 1],
                                           partition_windows=5,
                                           window_s=2.0, mutate=churn)
        got[name] = (stats, bed, seekers[0])
    (sp, bed_p, sk_p), (sr, bed_r, sk_r) = got["port"], got["ref"]
    assert dataclasses.asdict(sp) == dataclasses.asdict(sr)
    assert sp.converged and (sp.relay_bytes > 0) == relay
    # cut off from the anchor, the seeker goes stale alone; with the relay
    # its neighbors keep it converged through the partition
    if relay:
        assert sp.converged_during_partition
    else:
        assert sp.max_stale_rounds >= 3
    assert_tables_equal(sk_p.materialize(bed_p.now),
                        sk_r.materialize(bed_r.now))


@pytest.mark.parametrize("handshake", [True, False])
def test_simulate_byzantine_matches_reference(handshake):
    """F = 3 lying relays push fabricated chains resurrecting a dead peer:
    the same ``ByzantineStats`` as the reference's, and the honest seekers
    reach parity."""
    got = {}
    for name, pkg, _, plane, bed_mod in SIDES:
        cfg = pkg.cfg(relay_enabled=True, relay_fanout=4, gossip_fanout=2,
                      relay_handshake=handshake,
                      gossip_hb_refresh_frac=0.5)
        bed = bed_mod.build_scaling_testbed(96, cfg=cfg, seed=3, shards=4)
        _, seekers, sched = plane(bed.anchor, cfg, n_seekers=12, now=0.0)
        for _ in range(3):
            bed.advance(2.0)
            bed.anchor.sweep(bed.now)
            sched.tick(bed.now)
        rng = np.random.default_rng(9)
        next_pid = [max(bed.peers) + 1]

        def mutate(b, rng=rng, next_pid=next_pid):
            pids = [p for p, pr in b.peers.items() if pr.alive]
            b.anchor.set_trust(pids[int(rng.integers(len(pids)))],
                               float(rng.uniform(0.3, 1.0)))
            pid = next_pid[0]
            next_pid[0] += 1
            b.anchor.register(pid, 0, 3, now=b.now, profile="golden")
            b.anchor.heartbeat(pid, b.now)

        got[name] = bed_mod.simulate_byzantine(bed, sched, seekers,
                                               n_liars=3, churn_windows=5,
                                               mutate=mutate)
    assert dataclasses.asdict(got["port"]) == dataclasses.asdict(got["ref"])
    bz = got["port"]
    assert bz.honest_converged and bz.poisoned_mirrors == 0
    assert bz.resurrected_seen == 0 and bz.quarantines > 0
    assert bz.fabricated_summaries + bz.fabricated_msgs > 0


# ---------------------------------------------------------------------------
# The slice as a whole: routed serving on the hybrid trust architecture
# ---------------------------------------------------------------------------

HYBRID = dict(disaggregate=True, prefill_chunk_tokens=16, anchor_shards=4,
              gossip_enabled=True, relay_enabled=True, gossip_seekers=8)


@pytest.mark.parametrize("jax_backend,port_backend,mode",
                         [("jnp", "kernel", ""), ("jnp", "torch", ""),
                          ("numpy", "numpy", ""), ("jnp", "kernel", "stale"),
                          ("jnp", "torch", "traced")])
def test_run_queue_hybrid_trust_matches_reference(models, jax_backend,
                                                  port_backend, mode):
    """``run_queue`` at ``anchor_shards=4`` with gossip and the relay plane
    (8 seekers): the same tokens, ``ServeMetrics``, router, gossip and
    relay counters as the reference server's. ``stale``: the routing views
    are trust-discounted every window; ``traced``: both servers record the
    same spans, the gossip and relay planes' included."""
    kw = dict(HYBRID)
    if mode == "stale":
        kw.update(gossip_stale_margin=0.02, gossip_stale_decay=0.01)
    if mode == "traced":
        kw.update(trace_enabled=True)
    srv, tsrv = _servers(models, kw, jax_backend, port_backend)
    for p in _prompts():
        srv.submit(SubmitSpec(prompt=p, max_new_tokens=5))
        tsrv.submit(TSubmitSpec(prompt=p, max_new_tokens=5))
    done, tdone = srv.run_queue(), tsrv.run_queue()
    _assert_served_equal(tdone, done)
    assert vars(tsrv.router.stats) == vars(srv.router.stats)
    assert vars(tsrv.gossip.stats) == vars(srv.gossip.stats)
    assert vars(tsrv.gossip.relay.stats) == vars(srv.gossip.relay.stats)
    assert tsrv.obs.snapshot() == srv.obs.snapshot()
    assert tsrv.sync_seeker.version_vector == srv.sync_seeker.version_vector
    # the run exercised what it claims to
    assert len(tsrv.bed.anchor.shards) == 4
    assert tsrv.gossip.stats.rounds >= 1
    assert sum(r.metrics.relay_msgs for r in tdone) > 0
    assert sum(r.metrics.failures + r.metrics.repairs for r in tdone) > 0
    if mode == "stale":   # a fresh discounted view, so a fresh DP, per window
        assert tsrv.router.stats.window_cache_hits == 0
    if mode == "traced":
        def spans(buf):
            return [(sp.name, sp.t0, sp.t1, sp.attrs.get("rid"))
                    for sp in buf.spans]

        assert spans(tsrv.trace) == spans(srv.trace)
        names = {sp.name.split(".")[0] for sp in tsrv.trace.spans}
        assert {"gossip", "relay"} <= names, names


def test_serve_cli_hybrid_trust(capsys):
    """The serve CLI with ``--shards 4 --gossip --relay`` prints the
    reference's gossip, relay and hardening lines; an honest run has no
    mismatch, quarantine or heartbeat rejection."""
    tserve.main(["--device", "cpu", "--reduced", "--windowed",
                 "--shards", "4", "--gossip", "--relay", "--tokens", "3",
                 "--requests", "3"])
    out = capsys.readouterr().out
    assert "anchor shards: 4" in out
    assert "\ngossip: " in out and "\nrelay: 8 seekers, " in out
    assert ("relay hardening: 0 digest mismatches, 0 rejected chains, "
            "0 quarantines (0 drops), 0 hb rejections") in out
    for argv, msg in ((["--relay"], "--relay rides on the gossip"),
                      (["--gossip", "--algorithm", "sp"], "--gossip serves")):
        with pytest.raises(SystemExit):
            tserve.main(["--device", "cpu", "--reduced"] + argv)
        assert msg in capsys.readouterr().err

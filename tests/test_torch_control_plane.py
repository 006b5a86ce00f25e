"""The process-backed anchor control plane: the port's
``repro_torch.control_plane`` against the JAX package's reference modules.

Both packages drive their composer (``ProcessShardedRegistry``) through
the same operation scripts over ``LoopbackTransport`` (the exact pickled
wire surface, no scheduling nondeterminism) on ``FakeClock``, and
everything the control plane derives is compared with EXACT equality: the
composed snapshots column for column (and against the in-process
``ShardedAnchorRegistry`` twin), version and digest vectors, the merged
``peers`` view, the RPC schedule (backoff sleeps, deadline expiries,
retries, stale replies, remote errors, dedup hits) and every
``ControlPlaneHealth`` counter through degradation and recovery, under
blackholed, duplicated and scrambled reply delivery (seeded, and drawn by
hypothesis after ``tests/test_control_plane_properties.py``). Real worker
processes (the port spawns them) are checked in a kill / restart drill,
under ``ReplicatedAnchor`` and ``Testbed.crash_anchor_shard``; the slice
as a whole is ``run_queue`` at ``control_plane="procs"``,
``anchor_shards=4`` with the same tokens and ``ServeMetrics`` as the
reference server's.
"""
import dataclasses
import multiprocessing as mp
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from _hyp import given, settings, st  # noqa: E402

from repro import control_plane as jcp  # noqa: E402
from repro.configs.base import GTRACConfig  # noqa: E402
from repro.control_plane import registry as jcp_registry  # noqa: E402
from repro.core.failover import ReplicatedAnchor  # noqa: E402
from repro.core.sharding import ShardedAnchorRegistry  # noqa: E402
from repro.core.types import ExecReport, HopReport  # noqa: E402
from repro.serving.api import SubmitSpec  # noqa: E402
from repro.sim import testbed as jtestbed  # noqa: E402
from repro_torch import control_plane as tcp  # noqa: E402
from repro_torch.configs.base import GTRACConfig as TGTRACConfig  # noqa: E402
from repro_torch.control_plane import worker as tworker  # noqa: E402
from repro_torch.core.failover import \
    ReplicatedAnchor as TReplicatedAnchor  # noqa: E402
from repro_torch.core.sharding import \
    ShardedAnchorRegistry as TShardedAnchorRegistry  # noqa: E402
from repro_torch.core.types import ExecReport as TExecReport  # noqa: E402
from repro_torch.core.types import HopReport as THopReport  # noqa: E402
from repro_torch.serving.api import SubmitSpec as TSubmitSpec  # noqa: E402
from repro_torch.sim import testbed as ttestbed  # noqa: E402

from test_torch_serving import (_assert_served_equal, _prompts,  # noqa: E402,F401
                                _servers, models)
from test_torch_sharding import assert_tables_equal  # noqa: E402

torch.set_num_threads(1)

REF = SimpleNamespace(cp=jcp, cfg=GTRACConfig, twin=ShardedAnchorRegistry,
                      report=ExecReport, hop=HopReport,
                      replicated=ReplicatedAnchor, testbed=jtestbed)
PORT = SimpleNamespace(cp=tcp, cfg=TGTRACConfig, twin=TShardedAnchorRegistry,
                       report=TExecReport, hop=THopReport,
                       replicated=TReplicatedAnchor, testbed=ttestbed)
SIDES = (("ref", REF), ("port", PORT))
POL = dict(timeout_s=1.0, retries=2, backoff_base_s=0.05,
           backoff_factor=2.0)


def loopback_registry(pkg, cfg, S, **kw):
    return pkg.cp.ProcessShardedRegistry(
        cfg, n_shards=S,
        transport_factory=lambda s: pkg.cp.LoopbackTransport(
            pkg.cp.ShardHost(cfg, s)),
        **kw)


def drive_ops(pkg, reg, n=30, now0=0.0):
    """``tests/test_control_plane.py``'s op sequence: every mutating
    control-plane verb, on ``pkg``'s report types."""
    for pid in range(n):
        reg.register(pid, (pid % 4) * 2, (pid % 4) * 2 + 2,
                     now=now0 + pid * 0.1, profile=f"p{pid % 3}",
                     trust=0.5 + 0.01 * pid, latency_ms=10.0 + pid)
    reg.heartbeat_all(np.arange(n), now0 + 5.0)
    reg.apply_report(pkg.report(
        success=True, chain=[1, 2, 3],
        hops=[pkg.hop(1, 12.0, True), pkg.hop(2, 20.0, True)]))
    reg.apply_report(pkg.report(
        success=False, chain=[4, 5],
        hops=[pkg.hop(4, 30.0, True), pkg.hop(5, 250.0, False)],
        failed_peer=5))
    for pid in range(0, n, 7):
        reg.heartbeat(pid, now0 + 6.0)
    reg.sweep(now0 + 8.0)
    reg.deregister(3)
    reg.register(3, 0, 2, now=now0 + 9.0)        # re-register keeps seq
    reg.set_trust(7, 0.9)
    reg.register(n, 0, 2, now=now0)              # never heartbeats again
    reg.heartbeat_all(np.arange(n), now0 + 39.0)
    expired = reg.sweep(now0 + 40.0, expire_after_s=20.0)
    assert expired == 1                          # only the silent peer
    reg.sweep(now0 + 41.0, decay_rate=0.01)
    return reg.snapshot(now0 + 41.5)


def assert_columns_equal(a, b):
    """Snapshot columns bit-equal (tables composed at different times or
    by different registries carry their own version and stamp)."""
    for col in ("peer_ids", "layer_start", "layer_end", "trust",
                "latency_ms", "alive"):
        assert np.array_equal(getattr(a, col), getattr(b, col)), col


def _records(reg):
    return [dataclasses.asdict(r) for r in reg.peers.values()]


def _assert_composers_equal(reg_p, reg_r):
    assert reg_p.version_vector == reg_r.version_vector
    assert (reg_p.version, reg_p.topo_version) == \
        (reg_r.version, reg_r.topo_version)
    assert reg_p.digest_vector() == reg_r.digest_vector()
    assert dataclasses.asdict(reg_p.health) == \
        dataclasses.asdict(reg_r.health)
    assert _records(reg_p) == _records(reg_r)
    assert (reg_p.degraded, reg_p._dead, reg_p._home) == \
        (reg_r.degraded, reg_r._dead, reg_r._home)


# ---------------------------------------------------------------------------
# Composer parity over the loopback wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,shard_by", [(1, "peer"), (4, "peer"),
                                        (16, "peer"), (4, "layer")])
def test_composer_matches_reference_and_twin(S, shard_by):
    """The op script through both composers and the port's in-process
    twin: snapshots bit-identical to the twin's and to the reference's,
    and the same versions, digests, health counters and records."""
    got = {}
    for side, pkg in SIDES:
        cfg = pkg.cfg()
        reg = loopback_registry(pkg, cfg, S, shard_by=shard_by)
        got[side] = (reg, drive_ops(pkg, reg))
    twin = TShardedAnchorRegistry(TGTRACConfig(), n_shards=S,
                                  shard_by=shard_by)
    assert_tables_equal(got["port"][1], drive_ops(PORT, twin))
    assert_tables_equal(got["port"][1], got["ref"][1])
    _assert_composers_equal(got["port"][0], got["ref"][0])
    assert got["port"][0].digest_vector() == twin.digest_vector()
    for reg, _ in got.values():
        reg.close()


def test_layer_affinity_cross_shard_move_matches_reference():
    """``shard_by='layer'``: re-registering under another layer slot moves
    a peer between shards with its seq stamp; owners, rows and the
    release RPCs match the reference's."""
    got = {}
    for side, pkg in SIDES:
        with loopback_registry(pkg, pkg.cfg(), 4, shard_by="layer") as reg:
            for pid in range(12):
                reg.register(pid, (pid % 3) * 4, (pid % 3) * 4 + 4,
                             now=0.1 * pid)
            for pid in range(0, 12, 2):
                reg.register(pid, ((pid + 1) % 3) * 4,
                             ((pid + 1) % 3) * 4 + 4, now=2.0)
            reg.heartbeat_all(np.arange(12), 3.0)
            got[side] = (reg, reg.snapshot(4.0),
                         [reg.owner_of(p) for p in range(12)])
    assert_tables_equal(got["port"][1], got["ref"][1])
    assert got["port"][2] == got["ref"][2]
    _assert_composers_equal(got["port"][0], got["ref"][0])


def test_empty_pull_is_version_stable():
    with loopback_registry(PORT, TGTRACConfig(), 2) as reg:
        reg.register(0, 0, 2, now=0.0)
        reg.sync(1.0)
        vec = reg.version_vector
        reg.sync(2.0)
        assert reg.version_vector == vec


# ---------------------------------------------------------------------------
# RPC determinism: FakeClock schedules, exact against the reference
# ---------------------------------------------------------------------------


def _blackhole(pkg):
    """``BlackholeTransport`` of the reference test, on ``pkg``'s loopback:
    ``mute`` eats posts, ``drop_next`` eats the next n replies after
    servicing them."""
    class Blackhole(pkg.cp.LoopbackTransport):
        def __init__(self, host):
            super().__init__(host)
            self.mute = False
            self.drop_next = 0

        def post(self, msg):
            if self.mute:
                return
            super().post(msg)
            if self.drop_next > 0 and self._out:
                self._out.pop()
                self.drop_next -= 1
    return Blackhole


def _rpc_timeout_schedule(pkg, cfg, clock, ch, tr, host):
    tr.mute = True
    ch.request("ping")


def _rpc_lost_reply(pkg, cfg, clock, ch, tr, host):
    tr.drop_next = 1
    fresh, rec = ch.request("register", 7, 0, 2, 0.0, "", None, None, 0,
                            None)
    return fresh, dataclasses.asdict(rec), len(host.reg.peers)


def _rpc_duplicated_reply(pkg, cfg, clock, ch, tr, host):
    real_post = tr.post

    def dup_post(msg):
        real_post(msg)
        if tr._out:
            tr._out.append(tr._out[-1])
    tr.post = dup_post
    for pid in range(5):
        ch.request("register", pid, 0, 2, 0.0, "", None, None, pid, None)
    return len(host.reg.peers)


def _rpc_remote_error(pkg, cfg, clock, ch, tr, host):
    ch.request("no_such_op")


def _rpc_worker_down(pkg, cfg, clock, ch, tr, host):
    tr.mute = True
    tr._alive = False
    ch.request("ping")


def _rpc_pipelined(pkg, cfg, clock, ch, tr, host):
    rids = [ch.post("register", pid, 0, 2, 0.0, "", None, None, pid, None)
            for pid in range(6)]
    return [ch.collect(rid)[0] for rid in reversed(rids)]


RPC_CASES = {"timeout_schedule": _rpc_timeout_schedule,
             "lost_reply_applies_once": _rpc_lost_reply,
             "duplicated_reply_stale": _rpc_duplicated_reply,
             "remote_error_not_retried": _rpc_remote_error,
             "worker_down_beats_retry": _rpc_worker_down,
             "pipelined_interleaved": _rpc_pipelined}


@pytest.mark.parametrize("case", sorted(RPC_CASES))
def test_rpc_schedule_matches_reference(case):
    """The reference's ``TestRpcDeterminism`` cases on both channels: the
    same outcome (value or exception type and message), backoff sleeps,
    clock, ``RpcStats`` and worker dedup hits."""
    got = {}
    for side, pkg in SIDES:
        cfg = pkg.cfg()
        clock = pkg.cp.FakeClock()
        host = pkg.cp.ShardHost(cfg, 0)
        tr = _blackhole(pkg)(host)
        ch = pkg.cp.RpcChannel(tr, pkg.cp.RpcPolicy(**POL), clock)
        try:
            out = ("ok", RPC_CASES[case](pkg, cfg, clock, ch, tr, host))
        except RuntimeError as e:
            out = (type(e).__name__, str(e))
        got[side] = (out, clock.sleeps, clock.t, vars(ch.stats),
                     host.dedup_hits)
    assert got["port"] == got["ref"]
    out, sleeps, t, stats, dedup = got["port"]
    want = {"timeout_schedule": ("RpcTimeout", [0.05, 0.1], 3, 2),
            "lost_reply_applies_once": ("ok", [0.05], 1, 1),
            "remote_error_not_retried": ("RpcRemoteError", [], 0, 0),
            "worker_down_beats_retry": ("WorkerDown", [], 1, 0)}.get(case)
    if want is not None:
        assert (out[0], sleeps, stats["rpc_timeouts"],
                stats["rpc_retries"]) == want
    if case == "lost_reply_applies_once":
        assert dedup == 1 and out[1][2] == 1     # applied once, not twice
    if case == "duplicated_reply_stale":
        assert stats["stale_replies"] == 4 and out[1] == 5


# ---------------------------------------------------------------------------
# Degradation: a sick shard never blocks the cadence
# ---------------------------------------------------------------------------


def _degraded_registry(pkg, cfg, S=2):
    clock = pkg.cp.FakeClock()
    transports = {}

    def factory(s):
        t = transports[s] = _blackhole(pkg)(pkg.cp.ShardHost(cfg, s))
        return t
    reg = pkg.cp.ProcessShardedRegistry(
        cfg, n_shards=S, clock=clock, policy=pkg.cp.RpcPolicy(**POL),
        transport_factory=factory)
    return reg, transports, clock


def _deg_stale_and_drops(pkg, reg, transports, clock):
    for pid in range(10):
        reg.register(pid, 0, 2, now=0.0, trust=0.8)
    trail = [len(reg.snapshot(1.0).peer_ids)]
    transports[1].mute = True
    reg.sync(2.0)
    trail.append(len(reg.mirror.materialize(2.0).peer_ids))
    sick = [p for p in range(10) if reg.shard_of(p) == 1]
    reg.set_trust(sick[0], 0.1)
    reg.heartbeat_all(np.arange(10), 3.0)
    reg.sync(3.5)
    trail.append(dataclasses.asdict(reg.health))
    transports[1].mute = False
    reg.sync(4.0)
    trail.append(sorted(reg.degraded))
    return trail, reg.snapshot(5.0)


def _deg_register_local_record(pkg, reg, transports, clock):
    reg.register(0, 0, 2, now=0.0)
    sick = reg.shard_of(99)
    transports[sick].mute = True
    reg.sync(1.0)
    seq = reg._seq_next
    rec = reg.register(99, 0, 2, now=1.5, trust=0.7)
    return ([dataclasses.asdict(rec), seq, reg._seq_next,
             reg.owner_of(99)], reg.mirror.materialize(1.5))


def _deg_staleness_discount(pkg, reg, transports, clock):
    for pid in range(8):
        reg.register(pid, 0, 2, now=0.0, trust=0.9)
    reg.snapshot(1.0)
    transports[0].mute = True
    reg.sync(2.0)
    reg.sync(30.0)
    full = reg.mirror.materialize(30.0)
    view = reg.routing_view(30.0)
    sick = np.isin(full.peer_ids,
                   [p for p in range(8) if reg.shard_of(p) == 0])
    assert sick.any() and (~sick).any()
    assert np.all(view.trust[sick] < full.trust[sick])
    assert np.all(view.trust[~sick] == full.trust[~sick])
    return [reg.staleness(30.0).tolist(), full], view


DEGRADATION = {"serves_stale_and_drops_writes": (_deg_stale_and_drops, {}),
               "register_returns_local_record": (_deg_register_local_record,
                                                 {}),
               "staleness_discounts_routing_view": (
                   _deg_staleness_discount, {"gossip_stale_margin": 0.05})}


@pytest.mark.parametrize("case", sorted(DEGRADATION))
def test_degradation_matches_reference(case):
    """The reference's ``TestDegradation`` cases: the same tables (and
    ``routing_view`` discounts), backoff sleeps, degraded sets and
    ``ControlPlaneHealth`` after every step."""
    fn, kw = DEGRADATION[case]
    got = {}
    for side, pkg in SIDES:
        reg, transports, clock = _degraded_registry(pkg, pkg.cfg(**kw))
        trail, table = fn(pkg, reg, transports, clock)
        got[side] = (reg, trail, table, clock.sleeps)
        reg.close()
    (reg_p, trail_p, table_p, sleeps_p), (reg_r, trail_r, table_r,
                                          sleeps_r) = got["port"], got["ref"]
    assert sleeps_p == sleeps_r
    assert_tables_equal(table_p, table_r)
    if case == "staleness_discounts_routing_view":
        assert trail_p[0] == trail_r[0]
        assert_tables_equal(trail_p[1], trail_r[1])
    else:
        assert trail_p == trail_r
    _assert_composers_equal(reg_p, reg_r)
    if case == "serves_stale_and_drops_writes":
        assert sleeps_p == [0.05, 0.1]            # one retry ladder only
        health = trail_p[2]
        # three deadlines in the retry ladder, then one probe per sync
        assert health["rpc_timeouts"] == 4 and health["dropped_writes"] > 0
        assert health["degraded_windows"] == 2 and trail_p[3] == []
        assert trail_p[:2] == [10, 10]


# ---------------------------------------------------------------------------
# Scrambled delivery: seeded, and drawn by hypothesis
# ---------------------------------------------------------------------------


def _scramble(pkg):
    class Scramble(pkg.cp.LoopbackTransport):
        """Reply queue shuffled (and sometimes duplicated) before every
        poll by a seeded generator."""

        def __init__(self, host, rng, dup_p=0.2):
            super().__init__(host)
            self.rng, self.dup_p = rng, dup_p

        def poll(self, timeout_s):
            if self._out:
                buf = list(self._out)
                self.rng.shuffle(buf)
                if self.rng.random() < self.dup_p:
                    buf.append(buf[self.rng.integers(len(buf))])
                self._out.clear()
                self._out.extend(buf)
            return super().poll(timeout_s)
    return Scramble


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scrambled_delivery_matches_reference(seed):
    """Out-of-order, duplicated, interleaved replies over three rounds:
    the port's composer stays bit-identical to its twin, and its stale
    reply count and health to the reference's under the same scramble."""
    got = {}
    twin = TShardedAnchorRegistry(TGTRACConfig(), n_shards=4)
    for side, pkg in SIDES:
        cfg = pkg.cfg()
        rng = np.random.default_rng(seed)
        scramble = _scramble(pkg)
        reg = pkg.cp.ProcessShardedRegistry(
            cfg, n_shards=4, clock=pkg.cp.FakeClock(),
            transport_factory=lambda s: scramble(pkg.cp.ShardHost(cfg, s),
                                                 rng))
        with reg:
            got[side] = (reg, [drive_ops(pkg, reg, n=20, now0=r * 100.0)
                               for r in range(3)])
    twin_tables = [drive_ops(PORT, twin, n=20, now0=r * 100.0)
                   for r in range(3)]
    for a, b, c in zip(got["port"][1], got["ref"][1], twin_tables):
        assert_tables_equal(a, b)
        assert_tables_equal(a, c)
    _assert_composers_equal(got["port"][0], got["ref"][0])
    assert got["port"][0].health.stale_replies > 0


def _scheduled(pkg):
    class Scheduled(pkg.cp.LoopbackTransport):
        """Reply queue rotated / duplicated by a drawn integer schedule."""

        def __init__(self, host, schedule):
            super().__init__(host)
            self.schedule = list(schedule) or [0]
            self._i = 0

        def _next(self, n):
            v = self.schedule[self._i % len(self.schedule)]
            self._i += 1
            return v % n

        def poll(self, timeout_s):
            if len(self._out) > 1:
                buf = list(self._out)
                k = self._next(len(buf))
                buf = buf[k:] + buf[:k]
                if self._next(4) == 0:
                    buf.append(buf[self._next(len(buf))])
                self._out.clear()
                self._out.extend(buf)
            return super().poll(timeout_s)
    return Scheduled


def _drive_rounds(pkg, reg, rounds=3, n=18):
    """``tests/test_control_plane_properties.py``'s multi-round script."""
    t = None
    for r in range(rounds):
        now0 = 50.0 * r
        for pid in range(n):
            reg.register(pid, (pid % 3) * 2, (pid % 3) * 2 + 2,
                         now=now0 + pid * 0.1,
                         trust=0.5 + 0.02 * (pid % 9))
        reg.heartbeat_all(np.arange(n), now0 + 2.0)
        reg.apply_report(pkg.report(
            success=True, chain=[0, 1],
            hops=[pkg.hop(0, 10.0, True), pkg.hop(1, 11.0, True)]))
        reg.apply_report(pkg.report(
            success=False, chain=[2], hops=[pkg.hop(2, 300.0, False)],
            failed_peer=2))
        reg.deregister((r + 3) % n)
        reg.sweep(now0 + 3.0)
        t = reg.snapshot(now0 + 4.0)
    return t


@settings(max_examples=15, deadline=None)
@given(schedule=st.lists(st.integers(0, 63), min_size=1, max_size=48),
       shards=st.integers(1, 5))
def test_drawn_delivery_order_matches_reference(schedule, shards):
    """Hypothesis draws the delivery order: the port's composer equals
    its in-process twin and the reference composer under the same drawn
    schedule, with no shard degraded."""
    got = {}
    for side, pkg in SIDES:
        cfg = pkg.cfg()
        scheduled = _scheduled(pkg)
        reg = pkg.cp.ProcessShardedRegistry(
            cfg, n_shards=shards, clock=pkg.cp.FakeClock(),
            transport_factory=lambda s: scheduled(pkg.cp.ShardHost(cfg, s),
                                                  schedule))
        with reg:
            got[side] = (reg, _drive_rounds(pkg, reg))
    twin = TShardedAnchorRegistry(TGTRACConfig(), n_shards=shards)
    assert_tables_equal(got["port"][1], _drive_rounds(PORT, twin))
    assert_tables_equal(got["port"][1], got["ref"][1])
    _assert_composers_equal(got["port"][0], got["ref"][0])
    assert got["port"][0].degraded == set()


# ---------------------------------------------------------------------------
# Real worker processes
# ---------------------------------------------------------------------------


def _no_workers_left(timeout_s=10.0):
    for p in mp.active_children():
        p.join(timeout=timeout_s)
    return not [p for p in mp.active_children()
                if p.name.startswith("anchor-shard-")]


def test_real_workers_kill_restart_match_reference_twin():
    """Four spawned worker processes on a scaling testbed: snapshots equal
    the reference's in-process twin fed the same script; a SIGKILL via
    ``crash_anchor_shard(kill_worker=True)`` degrades one shard while the
    composer keeps serving its last slice, ``restart_worker`` restores it
    from the composer's mirror, and the respawned worker holds the rows."""
    cfg = TGTRACConfig(control_plane="procs")
    twin = ShardedAnchorRegistry(GTRACConfig(), n_shards=4)
    with tcp.ProcessShardedRegistry(cfg, n_shards=4) as reg:
        assert all(ch.transport.start_method == tworker.START_METHOD
                   == "spawn" for ch in reg.channels)
        t_proc, t_twin = drive_ops(PORT, reg, n=40), drive_ops(REF, twin,
                                                               n=40)
        assert_columns_equal(t_proc, t_twin)
        assert reg.digest_vector() == twin.digest_vector()
        assert all(ch.transport.startup_ms > 0 for ch in reg.channels)
        assert reg.health.rpc_timeouts == 0       # start-up is not a timeout
        bed = ttestbed.Testbed(cfg=cfg, total_layers=8, peers={},
                               anchor=reg, rng=np.random.default_rng(0))
        victim = 1
        bed.crash_anchor_shard(victim, kill_worker=True)
        assert reg.dead_workers() == [victim]
        t_deg = reg.snapshot(50.0)
        assert np.array_equal(t_deg.peer_ids, t_proc.peer_ids)
        assert reg.health.degraded_windows >= 1
        reg.restart_worker(victim)
        assert reg.health.worker_restarts == 1 and reg.dead_workers() == []
        t_back = reg.snapshot(51.0)
        assert_columns_equal(t_back, t_proc)
        exports = [reg.channels[s].request("export") for s in range(4)]
        assert sum(len(e.peer_ids) for e in exports) == len(t_proc.peer_ids)
        on_victim = [p for p in range(40) if reg.shard_of(p) == victim]
        reg.set_trust(on_victim[0], 0.99)         # lands on the new worker
        t = reg.snapshot(52.0)
        assert t.trust[t.peer_ids == on_victim[0]][0] == pytest.approx(0.99)
    assert _no_workers_left()


def test_replicated_anchor_over_process_backend_matches_reference():
    """``ReplicatedAnchor`` with a process-backed primary: replicate,
    kill a worker (a ledger restore needs a live worker first), restart
    it, restore the shard from the ledger; the tables equal the reference
    ``ReplicatedAnchor``'s over its in-process backend."""
    rep = TReplicatedAnchor(TGTRACConfig(control_plane="procs"),
                            n_backups=1, shards=4)
    jrep = ReplicatedAnchor(GTRACConfig(), n_backups=1, shards=4)
    prim = rep.primary
    assert isinstance(prim, tcp.ProcessShardedRegistry)
    assert isinstance(rep.replicas[1], TShardedAnchorRegistry)
    try:
        for r in (rep, jrep):
            for pid in range(32):
                r.register(pid, 0, 2, now=pid * 0.1, trust=0.7)
            r.heartbeat_all(np.arange(32), 3.0)
        prim.sync(3.5)
        for r in (rep, jrep):
            r.tick(TGTRACConfig().gossip_period_s + 10.0)
        t0, j0 = rep.snapshot(4.0), jrep.snapshot(4.0)
        assert_columns_equal(t0, j0)
        prim.kill_worker(2)
        with pytest.raises(tcp.WorkerDown):
            rep.restore_shard(2)
        assert len(rep.snapshot(5.0).peer_ids) == 32   # still serving
        prim.restart_worker(2)
        assert rep.restore_shard(2)
        assert_columns_equal(rep.snapshot(6.0), jrep.snapshot(6.0))
        assert prim.health.worker_restarts == 1
    finally:
        prim.close()
    assert _no_workers_left()


def test_crash_anchor_shard_guards_match_reference():
    """``crash_anchor_shard`` refuses an unsharded anchor and, on the
    in-process backend, ``kill_worker`` — before it mutates anything."""
    for side, pkg in SIDES:
        bed = pkg.testbed.build_scaling_testbed(16, cfg=pkg.cfg(), seed=0,
                                                shards=1)
        with pytest.raises(ValueError, match="sharded anchor"):
            bed.crash_anchor_shard(0)
        bed = pkg.testbed.build_scaling_testbed(16, cfg=pkg.cfg(), seed=0,
                                                shards=4)
        with pytest.raises(ValueError, match="process-backed"):
            bed.crash_anchor_shard(1, kill_worker=True)
        assert all(p.alive for p in bed.peers.values())


def test_worker_start_failure_raises(monkeypatch):
    """A worker that never reports ready fails the RPC that waits on it:
    no timeout is counted and nothing falls back to an in-process shard."""
    monkeypatch.setattr(tworker, "STARTUP_TIMEOUT_S", 0.0)
    w = tworker.ProcWorker(TGTRACConfig(), 0)
    try:
        ch = tcp.RpcChannel(w, tcp.RpcPolicy(**POL))
        with pytest.raises(RuntimeError, match="ready report"):
            ch.request("ping")
        assert ch.stats.rpc_timeouts == 0
    finally:
        w.close()
    assert not w.alive()


# ---------------------------------------------------------------------------
# The slice as a whole: run_queue on the process-backed anchor
# ---------------------------------------------------------------------------


def test_run_queue_procs_matches_reference(models, monkeypatch):
    """``run_queue`` at ``control_plane="procs"``, ``anchor_shards=4``,
    with hedging and tracing on: the port's server over four spawned
    worker processes gives the tokens, every ``ServeMetrics`` field (the
    control-plane fields included), router and health counters and the
    sim-domain spans of the reference server, whose shards are serviced
    over its loopback transport (the same commands, without forking a
    process that holds JAX's threads)."""
    monkeypatch.setattr(
        jcp_registry, "ProcWorker",
        lambda cfg, s, start_method=None: jcp.LoopbackTransport(
            jcp.ShardHost(cfg, s)))
    kw = dict(control_plane="procs", anchor_shards=4, disaggregate=True,
              prefill_chunk_tokens=16, hedge_enabled=True,
              trace_enabled=True)
    srv, tsrv = _servers(models, kw, "jnp", "kernel")
    try:
        assert isinstance(tsrv.bed.anchor, tcp.ProcessShardedRegistry)
        for p in _prompts():
            srv.submit(SubmitSpec(prompt=p, max_new_tokens=5))
            tsrv.submit(TSubmitSpec(prompt=p, max_new_tokens=5))
        done, tdone = srv.run_queue(), tsrv.run_queue()
        _assert_served_equal(tdone, done)
        assert vars(tsrv.router.stats) == vars(srv.router.stats)
        cp, jcp_ = tsrv._cp, srv._cp
        assert dataclasses.asdict(cp.health) == \
            dataclasses.asdict(jcp_.health)
        assert cp.health.rpc_timeouts == cp.health.dropped_writes == 0
        assert cp.digest_vector() == jcp_.digest_vector()
        snap = tsrv.obs.snapshot()
        # the port's own stage counters, which the reference has no view of
        stage = [snap.pop(f"stage/{k}") for k in ("forwards", "positions",
                                                      "fresh")]
        assert snap == srv.obs.snapshot()
        assert stage[0] > 0 and stage[1] >= stage[2] > 0

        def sim_spans(buf):
            return [(sp.name, sp.t0, sp.t1, sp.attrs.get("rid"))
                    for sp in buf.spans if sp.domain != "rpc"]

        assert sim_spans(tsrv.trace) == sim_spans(srv.trace)
        rpc = [sp for sp in tsrv.trace.spans if sp.domain == "rpc"]
        assert {sp.name for sp in rpc} >= {"rpc.collect", "rpc.attempt",
                                           "rpc.worker"}
        assert sum(r.metrics.hedges_fired for r in tdone) > 0
    finally:
        tsrv.close()
        srv.close()
    assert _no_workers_left()


def _drill(srv, window, shard):
    """Kill ``shard``'s worker with its peers at ``window`` (through
    ``crash_anchor_shard``) and respawn it once a sync has degraded it."""
    view, state = srv._sync_and_view, {"n": 0, "killed": None,
                                       "restarted": False}

    def drilled():
        state["n"] += 1
        if state["n"] == window:
            state["killed"] = srv.bed.crash_anchor_shard(shard,
                                                         kill_worker=True)
        table = view()
        if state["killed"] is not None and not state["restarted"] and \
                srv._cp.health.degraded_windows:
            srv._cp.restart_worker(shard)
            state["restarted"] = True
        return table
    srv._sync_and_view = drilled
    return state


def test_run_queue_worker_drill_matches_reference(models, monkeypatch):
    """A shard's worker SIGKILLed mid-run with its peers, then respawned
    from the composer's mirror: the port's server (spawned workers) serves
    the same tokens, ``ServeMetrics`` (failures, repairs, degraded windows,
    worker restarts) and health counters as the reference server (its
    loopback transport killed and replaced the same way), and after the
    restore every live worker's export equals the composer's mirror."""
    monkeypatch.setattr(
        jcp_registry, "ProcWorker",
        lambda cfg, s, start_method=None: jcp.LoopbackTransport(
            jcp.ShardHost(cfg, s)))
    kw = dict(control_plane="procs", anchor_shards=4, disaggregate=True,
              prefill_chunk_tokens=16, hedge_enabled=True)
    srv, tsrv = _servers(models, kw, "numpy", "numpy")
    try:
        drills = [_drill(s, window=3, shard=1) for s in (srv, tsrv)]
        for p in _prompts():
            srv.submit(SubmitSpec(prompt=p, max_new_tokens=5))
            tsrv.submit(TSubmitSpec(prompt=p, max_new_tokens=5))
        done, tdone = srv.run_queue(), tsrv.run_queue()
        _assert_served_equal(tdone, done)
        assert drills[0]["killed"] == drills[1]["killed"] != []
        assert all(d["restarted"] for d in drills)
        cp, jcp_ = tsrv._cp, srv._cp
        assert dataclasses.asdict(cp.health) == \
            dataclasses.asdict(jcp_.health)
        assert cp.health.worker_restarts == 1
        assert cp.health.degraded_windows >= 1
        assert all(r.metrics.worker_restarts == 1 for r in tdone)
        cp.sync(tsrv.bed.now)
        for s in range(4):
            live, mirror = cp.channels[s].request("export"), \
                cp.export_shard_state(s)
            for f in dataclasses.fields(live):
                a, b = getattr(mirror, f.name), getattr(live, f.name)
                assert (a == b) if isinstance(b, list) else \
                    np.array_equal(a, b), (s, f.name)
    finally:
        tsrv.close()
        srv.close()
    assert _no_workers_left()

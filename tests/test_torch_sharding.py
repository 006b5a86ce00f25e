"""The anchor side of the Hybrid Trust Architecture: the port against the
JAX package's reference modules.

Both packages run the same seeded scripts of registry mutations, and
everything they derive is compared with EXACT equality (no tolerance): the
composed snapshots of ``ShardedAnchorRegistry`` column for column, its
version, topology and digest vectors, the content digests of
``core/digest.py`` (the relay compares them bit for bit), the
``ReplicatedAnchor`` crash / failover / restore sequence and
``Testbed.crash_anchor_shard``. ``torch_apply_report`` is held against
``jax_apply_report`` within 1e-6 in f32. The planner's device-state cache
is checked to key by ``(source_id, version)``.
"""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GTRACConfig
from repro.core import digest as jdigest
from repro.core import sharding as jsharding
from repro.core.failover import ReplicatedAnchor
from repro.core.planner import RoutePlanner
from repro.core.registry import AnchorRegistry
from repro.core.trust import jax_apply_report
from repro.core.types import ExecReport, HopReport, RegistryState
from repro.serving import batch_router as jbr
from repro.sim import testbed as jtestbed
from repro.sync.gossip import make_sync_plane
from repro_torch.configs.base import GTRACConfig as TGTRACConfig
from repro_torch.core import digest as tdigest
from repro_torch.core import sharding as tsharding
from repro_torch.core.failover import ReplicatedAnchor as TReplicatedAnchor
from repro_torch.core.planner import RoutePlanner as TRoutePlanner
from repro_torch.core.registry import AnchorRegistry as TAnchorRegistry
from repro_torch.core.trust import torch_apply_report
from repro_torch.core.types import ExecReport as TExecReport
from repro_torch.core.types import HopReport as THopReport
from repro_torch.core.types import RegistryState as TRegistryState
from repro_torch.serving import batch_router as tbr
from repro_torch.sim import testbed as ttestbed
from repro_torch.sync.gossip import make_sync_plane as tmake_sync_plane

torch.set_num_threads(1)

L = 12

REF = SimpleNamespace(cfg=GTRACConfig, sharding=jsharding,
                      report=ExecReport, hop=HopReport,
                      replicated=ReplicatedAnchor)
PORT = SimpleNamespace(cfg=TGTRACConfig, sharding=tsharding,
                       report=TExecReport, hop=THopReport,
                       replicated=TReplicatedAnchor)


def populate(reg, n=40, seed=1, now=0.0):
    rng = np.random.default_rng(seed)
    for pid in range(n):
        s = (pid % 4) * 3
        reg.register(pid, s, s + 3, now=now, profile="golden",
                     trust=float(rng.uniform(0.5, 1.0)),
                     latency_ms=float(rng.uniform(10, 300)))
        reg.heartbeat(pid, now)
    return reg


def _script(seed, n_ops=150):
    """A seeded mutation script: (kind, a, b, x) tuples of plain numbers,
    replayed on each package's registry by ``_apply``."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(12)), int(rng.integers(1 << 16)),
             int(rng.integers(1 << 16)), float(rng.uniform(0.0, 1.0)))
            for _ in range(n_ops)]


def _apply(pkg, reg, op, now, state):
    """One scripted mutation on ``reg``; ``state`` carries the next fresh
    id and saved shard payloads between ops. Kinds 0-9 use the registry
    surface both anchors share; 10 saves and 11 loses (and mostly
    re-adopts) one shard of a sharded registry."""
    kind, a, b, x = op
    pids = sorted(reg.peers)
    if kind <= 2 or not pids:                       # register fresh
        pid = state["next_pid"]
        state["next_pid"] += 1
        s = (a % 4) * 3
        reg.register(pid, s, s + 3, now=now, profile="turtle",
                     trust=0.3 + 0.7 * x, latency_ms=20.0 + b % 300)
        reg.heartbeat(pid, now)
    elif kind == 3:
        reg.deregister(pids[a % len(pids)])
    elif kind == 4:
        reg.heartbeat(pids[a % len(pids)], now)
    elif kind == 5:
        reg.heartbeat_all(pids[a % 4:], now)
    elif kind <= 7:                                 # execution report
        chain = [pids[(a + i * b) % len(pids)] for i in range(1 + a % 3)]
        hops = [pkg.hop(p, 15.0 + (b % 97) + i, True)
                for i, p in enumerate(chain)]
        ok = x < 0.6
        if not ok:
            hops[-1] = pkg.hop(chain[-1], 250.0, False)
        reg.apply_report(pkg.report(ok, chain if ok else chain[:-1], hops,
                                    failed_peer=None if ok else chain[-1]))
    elif kind == 8:                                 # sweeps
        if a % 2:
            reg.sweep(now, decay_rate=0.05)
        else:
            reg.sweep(now, expire_after_s=30.0)
    elif kind == 9:
        reg.set_trust(pids[a % len(pids)], x)
    elif kind == 10:                                # save a shard's state
        s = a % reg.n_shards
        state["saved"][s] = reg.export_shard_state(s)
    else:                                           # lose, then adopt
        s = a % reg.n_shards
        saved = state["saved"].pop(s, None)
        if saved is None and b % 4:
            state["saved"][s] = reg.export_shard_state(s)
        else:
            reg.lose_shard(s)
            if saved is not None:
                reg.adopt_shard_state(s, saved)


def assert_tables_equal(t_port, t_ref):
    for col in ("peer_ids", "layer_start", "layer_end", "trust",
                "latency_ms", "alive"):
        a, b = getattr(t_port, col), getattr(t_ref, col)
        assert a.dtype == b.dtype, col
        assert np.array_equal(a, b), col          # bit-equal, not approx
    assert (t_port.version, t_port.topo_version, t_port.snapshot_time) == \
        (t_ref.version, t_ref.topo_version, t_ref.snapshot_time)


def assert_states_equal(s_port, s_ref):
    for f in dataclasses.fields(s_ref):
        a, b = getattr(s_port, f.name), getattr(s_ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("shard_by", ["peer", "layer"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_registry_scripts_match_reference(n_shards, shard_by):
    """Seeded scripts of register / deregister / heartbeat / apply_report /
    sweep / set_trust / lose_shard / adopt: after every op both packages'
    registries compose the same snapshot and carry the same version,
    topology and digest vectors."""
    regs = {}
    states = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        reg = pkg.sharding.ShardedAnchorRegistry(
            pkg.cfg(), n_shards=n_shards, shard_by=shard_by)
        regs[name] = populate(reg)
        states[name] = {"next_pid": 1000, "saved": {}}
    now = 0.0
    for i, op in enumerate(_script(seed=10 * n_shards + len(shard_by))):
        now += 0.5
        for name, pkg in (("ref", REF), ("port", PORT)):
            _apply(pkg, regs[name], op, now, states[name])
        ref, port = regs["ref"], regs["port"]
        assert port.version_vector == ref.version_vector, i
        assert port.topo_vector == ref.topo_vector, i
        assert port.digest_vector() == ref.digest_vector(), i
        s = i % n_shards
        assert port.shard_digest(s) == ref.shard_digest(s)
        assert port.owner_of(op[1]) == ref.owner_of(op[1])
        assert_tables_equal(port.compose_snapshot(now),
                            ref.compose_snapshot(now))
    assert_states_equal(regs["port"].export_state(),
                        regs["ref"].export_state())
    assert regs["port"].lost_shards == regs["ref"].lost_shards


def test_stable_peer_hash_and_digests_bit_equal():
    """splitmix64 placement and the u64 digest arithmetic wrap exactly as
    the reference's numpy does, on edge values and random ids."""
    rng = np.random.default_rng(3)
    ids = np.concatenate([
        np.array([0, 1, 2, 2**31 - 1, 2**32, 2**62, 2**63 - 1, -1, -2**63],
                 np.int64),
        rng.integers(-2**63, 2**63 - 1, size=200, dtype=np.int64)])
    assert np.array_equal(tsharding.stable_peer_hash_vec(ids),
                          jsharding.stable_peer_hash_vec(ids))
    for p in ids[:9].tolist() + [10**30]:
        if p >= 0:
            assert tsharding.stable_peer_hash(p) == \
                jsharding.stable_peer_hash(p)
    for x in (0, 1, 2**64 - 1, 0xDEADBEEF, 2**63):
        assert tdigest.mix64(x) == jdigest.mix64(x)
    for seed in (0, 7, 2**64 - 1):
        assert tdigest.empty_digest(seed) == jdigest.empty_digest(seed)


def test_state_digest_bit_equal():
    """``state_digest`` / ``row_hashes`` / ``xor_rows`` on the same
    ``RegistryState`` columns, and ``AnchorRegistry.state_digest`` after
    the same mutations, are bit-equal to the reference's."""
    cfg, tcfg = GTRACConfig(), TGTRACConfig()
    ref = populate(AnchorRegistry(cfg), n=30, seed=5)
    port = populate(TAnchorRegistry(tcfg), n=30, seed=5)
    st = ref.export_state()
    cols = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    st_ref, st_port = RegistryState(**cols), TRegistryState(**cols)
    for seed in (0, 12345):
        assert tdigest.state_digest(st_port, seed) == \
            jdigest.state_digest(st_ref, seed)
        assert np.array_equal(tdigest.row_hashes(st_port, seed),
                              jdigest.row_hashes(st_ref, seed))
        assert tdigest.xor_rows(st_port, seed) == \
            jdigest.xor_rows(st_ref, seed)
    for mod, cls in ((jdigest, RegistryState), (tdigest, TRegistryState)):
        with pytest.raises(ValueError, match="seq"):
            mod.state_digest(cls(**dict(cols, seq=None)), 0)
    assert port.state_digest() == ref.state_digest()
    states = ({"next_pid": 500}, {"next_pid": 500})
    now = 0.0
    for op in _script(seed=4, n_ops=40):
        now += 0.5
        op = (op[0] % 10,) + op[1:]       # monolithic surface: no shards
        for pkg, reg, state in zip((REF, PORT), (ref, port), states):
            _apply(pkg, reg, op, now, state)
        assert port.state_digest() == ref.state_digest()
        assert port.version == ref.version


@pytest.mark.parametrize("shards", [1, 4])
def test_replicated_anchor_failover_matches_reference(shards):
    """Replicate, crash the primary, fail over, lose a shard and restore it
    from a backup: the composed tables equal the reference's at every
    step."""
    ras = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        cfg = pkg.cfg()
        ra = pkg.replicated(cfg, n_backups=2, shards=shards)
        populate(ra, n=48)
        ras[name] = ra
    period = GTRACConfig().gossip_period_s

    def both(fn):
        return fn(ras["port"]), fn(ras["ref"])

    def check(now):
        assert_tables_equal(*both(lambda ra: ra.snapshot(now)))

    both(lambda ra: ra.tick(period + 0.1))
    check(0.5)
    both(lambda ra: ra.primary.set_trust(3, 0.123))
    both(lambda ra: ra.tick(2 * period + 0.2))
    check(1.0)
    both(lambda ra: ra.crash_primary())
    got, want = both(lambda ra: ra.maybe_failover(now=100.0))
    assert got == want is True
    assert ras["port"].failovers == ras["ref"].failovers == 1
    check(100.0)
    both(lambda ra: ra.heartbeat_all(range(48), 100.0))
    both(lambda ra: ra.tick(100.0 + period))
    if shards > 1:
        got, want = both(lambda ra: ra.primary.lose_shard(2))
        assert got == want > 0
        check(100.5)
        both(lambda ra: ra.tick(100.0 + 2 * period))   # the racing tick
        got, want = both(lambda ra: ra.restore_shard(2))
        assert got == want is True
        check(101.0)
        assert ras["port"].primary.digest_vector() == \
            ras["ref"].primary.digest_vector()


def test_crash_anchor_shard_matches_reference():
    """``crash_anchor_shard`` crashes the same peers, and the shard's next
    sweep expires them in both packages alike."""
    beds = {
        "ref": jtestbed.build_scaling_testbed(96, cfg=GTRACConfig(), seed=3,
                                              shards=4),
        "port": ttestbed.build_scaling_testbed(96, cfg=TGTRACConfig(),
                                               seed=3, shards=4),
    }
    ids = {k: b.crash_anchor_shard(1) for k, b in beds.items()}
    assert ids["port"] == ids["ref"] and len(ids["ref"]) > 0
    for b in beds.values():
        b.advance(b.cfg.node_ttl_s + 1.0)
        assert b.anchor.sweep(b.now, expire_after_s=b.cfg.node_ttl_s) == \
            len(ids["ref"])
    assert_tables_equal(beds["port"].anchor.snapshot(beds["port"].now),
                        beds["ref"].anchor.snapshot(beds["ref"].now))
    with pytest.raises(ValueError, match="sharded anchor"):
        ttestbed.build_scaling_testbed(16).crash_anchor_shard(0)


@pytest.mark.parametrize("success", [True, False])
def test_torch_apply_report_matches_jax(success):
    """The device twin of one ExecReport on (P,) f32 columns, within 1e-6
    of the reference's ``jax_apply_report`` (with the clip at both trust
    bounds exercised)."""
    cfg, tcfg = GTRACConfig(), TGTRACConfig()
    rng = np.random.default_rng(11 + success)
    P = 257
    trust = rng.uniform(0.0, 1.0, P).astype(np.float32)
    trust[:4] = [0.0, 1.0, cfg.min_trust, cfg.max_trust]
    latency = rng.uniform(5.0, 500.0, P).astype(np.float32)
    chain_mask = rng.uniform(size=P) < 0.3
    chain_mask[:4] = True
    observed = np.where(chain_mask & (rng.uniform(size=P) < 0.8),
                        rng.uniform(1.0, 400.0, P), 0.0).astype(np.float32)
    failed = np.zeros(P, bool)
    if not success:
        failed[int(np.flatnonzero(chain_mask)[2])] = True
    want = jax_apply_report(jnp.asarray(trust), jnp.asarray(latency),
                            jnp.asarray(chain_mask), jnp.asarray(failed),
                            jnp.asarray(observed), jnp.asarray(success), cfg)
    got = torch_apply_report(trust, latency, chain_mask, failed, observed,
                             success, tcfg, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_torch_apply_report_without_device_or_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros(4, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_apply_report(z, z, z > 0, z > 0, z, True, TGTRACConfig())


# ---------------------------------------------------------------------------
# The planner's device-state cache key
# ---------------------------------------------------------------------------


def test_device_state_keyed_by_source_and_version():
    """Equal version numbers from two numbering sequences are different
    contents: a table whose ``source_id`` moved (same object, as when a
    freed table's id is reused) uploads anew; a new object of the same
    ``(source_id, version)`` reuses the upload; a table outside a
    registry hits only as the same object."""
    tcfg = TGTRACConfig()
    reg = populate(TAnchorRegistry(tcfg), n=24)
    t = reg.snapshot(0.0)
    g = TRoutePlanner(L).compile(t)
    dev = torch.device("cpu")
    a = g.device_state(t, dev, np.array([0.5]))
    same = dataclasses.replace(t)
    b = g.device_state(same, dev, np.array([0.5]))
    assert all(x is y for x, y in zip(a[:3], b[:3]))
    t.source_id += 1000                   # same id(), same version
    t.trust = np.full(len(t), 0.25)
    c = g.device_state(t, dev, np.array([0.5]))
    assert c[1] is not a[1]
    assert np.array_equal(c[1].numpy(), np.float32(np.full(len(t), 0.25)))
    loose = dataclasses.replace(t, version=-1, source_id=-1)
    d = g.device_state(loose, dev, np.array([0.5]))
    assert g.device_state(loose, dev, np.array([0.5]))[1] is d[1]
    twin = dataclasses.replace(loose)
    assert g.device_state(twin, dev, np.array([0.5]))[1] is not d[1]


def test_base_and_adjusted_views_plan_as_reference():
    """One planner fed a gossip seeker's base tables and its trust-adjusted
    routing views (two numbering sequences whose version numbers meet)
    plans every window as the reference does."""
    kw = dict(anchor_shards=4, gossip_fanout=1, gossip_stale_margin=0.05)
    sides = {}
    for name, pkg, bed_mod, plane in (
            ("ref", REF, jtestbed, make_sync_plane),
            ("port", PORT, ttestbed, tmake_sync_plane)):
        cfg = pkg.cfg(**kw)
        bed = bed_mod.build_scaling_testbed(120, cfg=cfg, seed=4, shards=4)
        _, (seeker,), sched = plane(bed.anchor, cfg, now=0.0)
        sides[name] = (cfg, bed, seeker, sched)
    routers = {
        "ref": jbr.BatchRouter(planner=RoutePlanner(36, k_best=4),
                               cfg=sides["ref"][0], total_layers=36,
                               backend="jnp"),
        "port": tbr.BatchRouter(planner=TRoutePlanner(36, k_best=4),
                                cfg=sides["port"][0], total_layers=36,
                                backend="kernel", device="cpu"),
    }
    seen = {"base": set(), "adjusted": set()}
    rng = np.random.default_rng(2)
    for w in range(24):
        cut = [int(s) for s in np.flatnonzero(rng.uniform(size=4) < 0.4)]
        views = {}
        for name, (cfg, bed, seeker, sched) in sides.items():
            if w % 3 == 0:
                sched.partition(seeker, cut)
            elif w % 3 == 2:
                sched.heal(seeker, range(4))
            bed.anchor.set_trust(int(w * 7 % 120), 0.55 + 0.01 * w)
            bed.advance(cfg.gossip_period_s)
            bed.anchor.sweep(bed.now)
            sched.tick(bed.now)
            views[name] = seeker.routing_view(bed.now)
        tp, tr = views["port"], views["ref"]
        assert_tables_equal(tp, tr)
        kind = "base" if tp is sides["port"][2].materialize(
            sides["port"][1].now) else "adjusted"
        seen[kind].add(tp.version)
        for rid, tau in enumerate((0.0, 0.6, 0.8)):
            for r in routers.values():
                r.submit(rid, tau)
        pr, pp = routers["ref"].route_window(tr), \
            routers["port"].route_window(tp)
        for rid in pr:
            assert pp[rid].chain_rows == pr[rid].chain_rows, (w, rid)
            assert pp[rid].costs == pr[rid].costs, (w, rid)
    # the run alternated both kinds of view, under shared version numbers
    assert seen["base"] & seen["adjusted"]

"""Batched routing DPs: the port (``repro_torch``) against the JAX reference.

K-best (kernel K1): the port's plain DP (``routing_torch.layered_dp_kbest``)
and backtrack must reproduce the reference's ``layered_dp_kbest``, its
Pallas ``tropical_route_kbest`` kernel (interpret mode) and its numpy
oracle ``tropical_route_kbest_ref`` BIT FOR BIT: distK, pedge and prank are
compared with exact equality (tolerance 0) — tie order included — on
float, tie-forcing integer, INF-pruned and all-INF cost rows, on invalid
segments and on R == 0. Plans built by the port's ``plan_batched`` must
equal the reference's chain for chain and cost for cost on the numpy and
device backends, including tau de-duplication and the KV-bonus route.

Single best (kernel K2): the port's ``layered_dp`` must equal the
reference's ``layered_dp`` and both numpy / torch ``tropical_route_ref``
oracles bit for bit (dist with +inf included, and pred) on float,
tie-forcing, all-INF and "+inf" (every peer ends at one boundary whose
start is unreachable) cases, at L in {6, 12, 36} and R == 0. Against the
Pallas interpret run pred is equal and dist is equal where < 1e38 (that
kernel clamps dist to INF before its one-hot gather). ``backtrack`` and
``route_batched`` (with and without a planner, plain DP and ``ops``
dispatch) return the reference's ids and costs exactly.

The kernels themselves run only on an H100 (the ``*_on_h100`` tests;
skipped elsewhere).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GTRACConfig
from repro.core import routing_jax as RJ
from repro.core.planner import RoutePlanner
from repro.kernels import ref as jref
from repro.kernels.tropical_route import tropical_route, tropical_route_kbest
from repro.serving import batch_router as jbr
from repro_torch.configs.base import GTRACConfig as TGTRACConfig
from repro_torch.core import routing_torch as RT
from repro_torch.core.planner import RoutePlanner as TRoutePlanner
from repro_torch.core.registry import AnchorRegistry as TAnchorRegistry
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tropical_route as ttr
from repro_torch.serving import batch_router as tbr

from conftest import build_layered_anchor

torch.set_num_threads(1)

INF = np.float32(3.0e38)


def _topology(P, L, segs, rng, invalid=False):
    starts, ends = [], []
    for _ in range(P):
        s = int(rng.choice(segs))
        st = int(rng.integers(0, L // s)) * s
        starts.append(st)
        ends.append(min(st + s, L))
    starts = np.array(starts, np.int32)
    ends = np.array(ends, np.int32)
    if invalid:   # degenerate / out-of-range segments the DP must ignore
        starts[:3] = [L + 2, -1, 4]
        ends[:3] = [L + 5, 2, 4]
    return starts, ends


def _costs(R, P, kind, rng):
    if kind == "float":
        c = rng.uniform(1, 500, (R, P)).astype(np.float32)
        c[rng.random((R, P)) < 0.3] = INF
    elif kind == "ties":
        c = rng.integers(1, 4, (R, P)).astype(np.float32)
        c[rng.random((R, P)) < 0.2] = INF
    else:
        c = np.full((R, P), INF, np.float32)
    if kind != "allinf" and R > 1:
        c[-1] = INF               # one all-INF (infeasible) row in every batch
    return c


def _port_dp(starts, ends, costs, L, K):
    out = RT.layered_dp_kbest(torch.as_tensor(starts), torch.as_tensor(ends),
                              torch.as_tensor(costs), total_layers=L,
                              k_best=K)
    return [t.numpy() for t in out]


def _assert_same(got, want):
    for name, g, w in zip(("distK", "pedge", "prank"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("R,P,L,segs,K,kind", [
    (6, 40, 12, (3, 4, 6), 4, "float"),
    (6, 40, 12, (3, 4, 6), 4, "ties"),
    (5, 30, 8, (2, 4), 3, "ties"),
    (3, 30, 8, (2, 4), 2, "allinf"),
])
def test_plain_dp_matches_jax_dp_kernel_and_oracle(R, P, L, segs, K, kind):
    rng = np.random.default_rng(R * 100 + P)
    starts, ends = _topology(P, L, segs, rng)
    costs = _costs(R, P, kind, rng)
    got = _port_dp(starts, ends, costs, L, K)
    j = RJ.layered_dp_kbest(jnp.asarray(starts), jnp.asarray(ends),
                            jnp.asarray(costs), total_layers=L, k_best=K)
    _assert_same(got, j)
    kern = tropical_route_kbest(jnp.asarray(starts), jnp.asarray(ends),
                                jnp.asarray(costs), total_layers=L,
                                k_best=K, blk_r=4, interpret=True)
    _assert_same(got, kern)
    _assert_same(got, jref.tropical_route_kbest_ref(starts, ends, costs, L,
                                                    K))
    _assert_same(got, [t.numpy() for t in tref.tropical_route_kbest_ref(
        starts, ends, costs, L, K)])


@pytest.mark.parametrize("kind", ["float", "ties"])
def test_plain_dp_serving_shape_and_invalid_segments(kind):
    """Main-path shapes (L = 36, K = 4) plus degenerate segments, against
    the reference's jnp DP and numpy oracle."""
    rng = np.random.default_rng(7)
    starts, ends = _topology(108, 36, (2, 3, 6), rng, invalid=True)
    costs = _costs(5, 108, kind, rng)
    got = _port_dp(starts, ends, costs, 36, 4)
    _assert_same(got, RJ.layered_dp_kbest(
        jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(costs),
        total_layers=36, k_best=4))
    _assert_same(got, jref.tropical_route_kbest_ref(starts, ends, costs, 36,
                                                    4))


def test_empty_batch():
    starts, ends = _topology(10, 6, (2, 3), np.random.default_rng(0))
    costs = np.zeros((0, 10), np.float32)
    got = _port_dp(starts, ends, costs, 6, 4)
    assert [g.shape for g in got] == [(0, 7, 4)] * 3
    want = tropical_route_kbest(jnp.asarray(starts), jnp.asarray(ends),
                                jnp.asarray(costs), total_layers=6,
                                k_best=4, interpret=True)
    _assert_same(got, want)
    # the dispatch on a CPU tensor takes the plain version
    out = ops.tropical_route_kbest(torch.as_tensor(starts),
                                   torch.as_tensor(ends),
                                   torch.as_tensor(costs), total_layers=6,
                                   k_best=4)
    assert out[0].shape == (0, 7, 4)
    h, c = RT.route_batched_kbest(None, 6, TGTRACConfig(), np.zeros(0),
                                  k_max=6, k_best=4)
    hj, cj = RJ.route_batched_kbest(None, 6, GTRACConfig(), np.zeros(0),
                                    k_max=6, k_best=4)
    np.testing.assert_array_equal(h, hj)
    np.testing.assert_array_equal(c, cj)


def test_backtrack_matches_reference():
    rng = np.random.default_rng(3)
    starts, ends = _topology(40, 12, (3, 4, 6), rng)
    costs = _costs(6, 40, "ties", rng)
    dist, pedge, prank = _port_dp(starts, ends, costs, 12, 4)
    got = RT.backtrack_kbest(torch.as_tensor(starts), torch.as_tensor(pedge),
                             torch.as_tensor(prank), total_layers=12,
                             k_max=12).numpy()
    want = RJ.backtrack_kbest(jnp.asarray(starts), jnp.asarray(pedge),
                              jnp.asarray(prank), total_layers=12, k_max=12)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_route_batched_without_planner_matches_planner_path():
    """The planner-less branch of ``_device_inputs`` (validity mask built
    from the table) routes exactly like the compiled-snapshot branch."""
    tcfg = TGTRACConfig()
    t = _port_layered_anchor(tcfg, L=12, replicas=3, seed=5).snapshot(0.0)
    taus = np.array([0.0, 0.7])
    a = RT.route_batched_kbest(t, 12, tcfg, taus, k_max=12, k_best=4,
                               planner=TRoutePlanner(12, k_best=4),
                               device="cpu")
    b = RT.route_batched_kbest(t, 12, tcfg, taus, k_max=12, k_best=4,
                               device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_effective_costs_bitwise():
    """Eq. 4 + trust-floor prune in f32 from f32 copies of the f64 columns."""
    rng = np.random.default_rng(5)
    lat = rng.uniform(1, 400, 50)
    trust = rng.uniform(0.3, 1.0, 50)
    alive = rng.random(50) < 0.9
    tau = np.array([0.0, 0.5, 0.9, 0.97])
    got = RT.effective_costs(torch.as_tensor(lat.astype(np.float32)),
                             torch.as_tensor(trust.astype(np.float32)),
                             torch.as_tensor(alive),
                             torch.as_tensor(tau.astype(np.float32)),
                             25_000.0).numpy()
    want = RJ.effective_costs(jnp.asarray(lat, jnp.float32),
                              jnp.asarray(trust, jnp.float32),
                              jnp.asarray(alive),
                              jnp.asarray(tau, jnp.float32), 25_000.0)
    np.testing.assert_array_equal(got, np.asarray(want))


def _port_layered_anchor(cfg, L=12, segments=(3, 6), replicas=4, seed=0,
                         trust_range=(0.5, 1.0), latency_range=(10, 300)):
    """``conftest.build_layered_anchor`` on the port's registry: the same
    registrations from the same seed."""
    rng = np.random.default_rng(seed)
    anchor = TAnchorRegistry(cfg)
    pid = 0
    for seg in segments:
        for s in range(0, L, seg):
            for _ in range(replicas):
                anchor.register(pid, s, s + seg, now=0.0,
                                trust=float(rng.uniform(*trust_range)),
                                latency_ms=float(rng.uniform(*latency_range)))
                anchor.heartbeat(pid, 0.0)
                pid += 1
    return anchor


def _plans_equal(p_port, p_ref):
    assert len(p_port) == len(p_ref)
    for a, b in zip(p_port, p_ref):
        assert a.chain_rows == b.chain_rows
        assert a.costs == b.costs          # bit for bit: same float path


@pytest.mark.parametrize("backend,ref_backend", [("numpy", "numpy"),
                                                 ("torch", "jnp"),
                                                 ("kernel", "jnp")])
@pytest.mark.parametrize("seed,trust_range", [(0, (0.5, 1.0)),
                                              (2, (0.9, 1.0))])
def test_plan_batched_matches_reference(backend, ref_backend, seed,
                                        trust_range):
    cfg, tcfg = GTRACConfig(), TGTRACConfig()
    t_ref = build_layered_anchor(cfg, L=12, replicas=4, seed=seed,
                                 trust_range=trust_range).snapshot(0.0)
    t_port = _port_layered_anchor(tcfg, L=12, replicas=4, seed=seed,
                                  trust_range=trust_range).snapshot(0.0)
    np.testing.assert_array_equal(t_port.trust, t_ref.trust)
    taus = np.array([0.0, 0.6, 0.9, 0.95])
    got = tbr.plan_batched(t_port, 12, tcfg, taus,
                           planner=TRoutePlanner(12, k_best=4),
                           backend=backend, device="cpu")
    want = jbr.plan_batched(t_ref, 12, cfg, taus,
                            planner=RoutePlanner(12, k_best=4),
                            backend=ref_backend)
    _plans_equal(got, want)


def test_router_tau_dedupe_and_kv_bonus_route_match_reference():
    """BatchRouter windows: requests sharing a floor share one DP row and
    one plan object; a window with a live KV bonus routes on the numpy DP
    with per-request discounted costs — both exactly as the reference."""
    cfg = GTRACConfig(kv_reuse_bonus=0.4)
    tcfg = TGTRACConfig(kv_reuse_bonus=0.4)
    a_ref = build_layered_anchor(cfg, L=12, replicas=3, seed=1)
    a_port = _port_layered_anchor(tcfg, L=12, replicas=3, seed=1)
    r_ref = jbr.BatchRouter(planner=RoutePlanner(12), cfg=cfg,
                            total_layers=12, backend="jnp")
    r_port = tbr.BatchRouter(planner=TRoutePlanner(12), cfg=tcfg,
                             total_layers=12, backend="auto", device="cpu")
    t_ref, t_port = a_ref.snapshot(0.0), a_port.snapshot(0.0)
    warm = [int(p) for p in t_ref.peer_ids[:6:2]]
    for router in (r_ref, r_port):
        router.submit(1, 0.8)
        router.submit(2, 0.8)
        router.submit(3, 0.5)
        router.submit(4, 0.8, warm_ids=warm)
    pr, pp = r_ref.route_window(t_ref), r_port.route_window(t_port)
    assert pp[1] is pp[2] and pp[1] is not pp[3]
    for rid in (1, 2, 3, 4):
        assert pp[rid].chain_rows == pr[rid].chain_rows
        assert pp[rid].costs == pr[rid].costs
    assert vars(r_port.stats) == vars(r_ref.stats)
    # bonus off: warm hints are discarded and the device DP stays in
    # charge (f32 costs), on both sides
    r0 = tbr.BatchRouter(planner=TRoutePlanner(12), cfg=TGTRACConfig(),
                         total_layers=12, backend="torch", device="cpu")
    j0 = jbr.BatchRouter(planner=RoutePlanner(12), cfg=GTRACConfig(),
                         total_layers=12, backend="jnp")
    r0.submit(1, 0.8, warm_ids=warm)
    j0.submit(1, 0.8, warm_ids=warm)
    _plans_equal([r0.route_window(t_port)[1]], [j0.route_window(t_ref)[1]])


@pytest.mark.parametrize("seed", [0, 2])
def test_auto_backend_off_cuda_plans_as_numpy(seed):
    """Off CUDA ``auto`` is the host numpy DP, as the reference's ``auto``
    is off TPU: the same plans, bit for bit, as ``backend="numpy"``."""
    tcfg = TGTRACConfig()
    table = _port_layered_anchor(tcfg, L=12, replicas=4,
                                 seed=seed).snapshot(0.0)
    taus = np.array([0.0, 0.6, 0.9, 0.95])
    got = tbr.plan_batched(table, 12, tcfg, taus,
                           planner=TRoutePlanner(12, k_best=4),
                           backend="auto", device="cpu")
    want = tbr.plan_batched(table, 12, tcfg, taus,
                            planner=TRoutePlanner(12, k_best=4),
                            backend="numpy", device="cpu")
    _plans_equal(got, want)


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        tbr._resolve_backend("pallas", "cpu")
    assert tbr._resolve_backend("auto", "cpu") == "numpy"
    assert tbr._resolve_backend("auto", "cuda") == "kernel"


@pytest.mark.h100
def test_kernel_matches_plain_on_h100():
    """The CUDA kernel equals the plain DP bit for bit (H100 only)."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")
    rng = np.random.default_rng(11)
    starts, ends = _topology(108, 36, (2, 3, 6), rng)
    for kind in ("float", "ties", "allinf"):
        costs = _costs(8, 108, kind, rng)
        args = [torch.as_tensor(a, device="cuda")
                for a in (starts, ends, costs)]
        got = ttr.tropical_route_kbest_cuda(*args, total_layers=36,
                                            k_best=4)
        want = ttr.tropical_route_kbest_plain(*args, total_layers=36,
                                              k_best=4)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Single-best DP (kernel K2) and route_batched
# ---------------------------------------------------------------------------


def _single_case(L, kind, R, rng):
    """(starts, ends, costs) for one K2 case. "plusinf": every peer spans
    [1, 2), boundary 1 is unreachable and the costs are INF, so every
    candidate at boundary 2 is INF + INF = +inf."""
    if kind == "plusinf":
        P = 9
        return (np.ones(P, np.int32), np.full(P, 2, np.int32),
                np.full((R, P), INF, np.float32))
    starts, ends = _topology(4 * L, L, (1, 2, 3) if L < 12 else (3, 4, 6),
                             rng)
    degenerate = np.array([L // 2, 1], np.int32)      # start == end peers
    starts = np.concatenate([starts, degenerate])
    ends = np.concatenate([ends, degenerate])
    return starts, ends, _costs(R, len(starts), kind, rng)


def _port_single(starts, ends, costs, L):
    d, p = RT.layered_dp(torch.as_tensor(starts), torch.as_tensor(ends),
                         torch.as_tensor(costs), total_layers=L)
    return d.numpy(), p.numpy()


@pytest.mark.parametrize("L", [6, 12, 36])
@pytest.mark.parametrize("kind", ["float", "ties", "allinf", "plusinf"])
def test_single_best_dp_matches_jax_dp_kernel_and_oracles(L, kind):
    rng = np.random.default_rng(L * 10 + len(kind))
    starts, ends, costs = _single_case(L, kind, 6, rng)
    d, p = _port_single(starts, ends, costs, L)
    if kind == "plusinf":
        assert np.isposinf(d[:, 2]).all()        # the overflow case is hit
    js, je, jc = (jnp.asarray(a) for a in (starts, ends, costs))
    for want in (RJ.layered_dp(js, je, jc, total_layers=L),
                 jref.tropical_route_ref(starts, ends, costs, L),
                 [t.numpy() for t in tref.tropical_route_ref(
                     starts, ends, costs, L)]):
        np.testing.assert_array_equal(d, np.asarray(want[0]), err_msg="dist")
        np.testing.assert_array_equal(p, np.asarray(want[1]), err_msg="pred")
    kd, kp = tropical_route(js, je, jc, total_layers=L, interpret=True,
                            blk_r=8)
    np.testing.assert_array_equal(p, np.asarray(kp))
    kd = np.asarray(kd)
    np.testing.assert_array_equal(np.where(d < 1e38, d, 0),
                                  np.where(kd < 1e38, kd, 0))
    # the dispatch on a CPU tensor takes the plain version
    od, op = ops.tropical_route(torch.as_tensor(starts),
                                torch.as_tensor(ends),
                                torch.as_tensor(costs), total_layers=L)
    np.testing.assert_array_equal(od.numpy(), d)
    np.testing.assert_array_equal(op.numpy(), p)


def test_single_best_empty_batch():
    starts, ends = _topology(10, 6, (2, 3), np.random.default_rng(0))
    costs = np.zeros((0, 10), np.float32)
    d, p = _port_single(starts, ends, costs, 6)
    assert d.shape == p.shape == (0, 7)
    jd, jp = tropical_route(jnp.asarray(starts), jnp.asarray(ends),
                            jnp.asarray(costs), total_layers=6,
                            interpret=True)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_array_equal(p, np.asarray(jp))
    ids, c = RT.route_batched(None, 6, TGTRACConfig(), np.zeros(0), k_max=6)
    jids, jc = RJ.route_batched(None, 6, GTRACConfig(), np.zeros(0), k_max=6)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(c, jc)
    assert ids.dtype == jids.dtype and c.dtype == jc.dtype


def test_single_best_backtrack_matches_reference():
    rng = np.random.default_rng(4)
    starts, ends, costs = _single_case(12, "ties", 6, rng)
    _, pred = _port_single(starts, ends, costs, 12)
    for k_max in (0, 4, 12):
        got = RT.backtrack(torch.as_tensor(starts), torch.as_tensor(pred),
                           total_layers=12, k_max=k_max).numpy()
        want = RJ.backtrack(jnp.asarray(starts), jnp.asarray(pred),
                            total_layers=12, k_max=k_max)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_single_best_backtrack_out_of_range_boundaries_match_reference():
    """Chains that reach a start outside [0, L] (above L, below 0 and
    below -(L + 1)) end there, as in the reference, whose out-of-range
    read of ``pred`` gives an invalid step: every entry of ``pred`` is a
    valid peer, so a clamped read would carry the chain on."""
    L = 6
    starts = np.array([-1, L + 3, 3, L + 1, -L - 3, 2, 0, 4], np.int32)
    P = len(starts)
    rng = np.random.default_rng(11)
    pred = rng.integers(0, P, (2 * P, L + 1)).astype(np.int32)
    pred[:, L] = np.tile(np.arange(P), 2)        # every peer ends a chain
    for k_max in (1, 3, L, 2 * L):
        got = RT.backtrack(torch.as_tensor(starts), torch.as_tensor(pred),
                           total_layers=L, k_max=k_max).numpy()
        want = RJ.backtrack(jnp.asarray(starts), jnp.asarray(pred),
                            total_layers=L, k_max=k_max)
        np.testing.assert_array_equal(got, np.asarray(want))
        emu = np.stack([_emulate_backtrack(starts, row, None, L, 1,
                                           k_max)[0] for row in pred])
        np.testing.assert_array_equal(emu, got)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seed,trust_range", [(0, (0.5, 1.0)),
                                              (3, (0.9, 1.0))])
def test_route_batched_matches_reference(use_kernel, seed, trust_range):
    """Peer ids and f32 costs equal the reference's, with the planner's
    cached topology and without; ``use_kernel`` goes through ``ops``
    (the plain DP for CPU tensors)."""
    cfg, tcfg = GTRACConfig(), TGTRACConfig()
    t_ref = build_layered_anchor(cfg, L=12, replicas=4, seed=seed,
                                 trust_range=trust_range).snapshot(0.0)
    t_port = _port_layered_anchor(tcfg, L=12, replicas=4, seed=seed,
                                  trust_range=trust_range).snapshot(0.0)
    taus = np.array([0.0, 0.6, 0.8, 0.95, 0.999])
    for k_max in (6, 12):
        want = RJ.route_batched(t_ref, 12, cfg, taus, k_max=k_max,
                                use_kernel=use_kernel,
                                planner=RoutePlanner(12), interpret=True)
        for planner in (TRoutePlanner(12), None):
            got = RT.route_batched(t_port, 12, tcfg, taus, k_max=k_max,
                                   use_kernel=use_kernel, planner=planner,
                                   device="cpu")
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))
    assert (want[1] >= 1e38).any() and (want[1] < 1e38).any()


def test_route_csr_buckets_peers_by_end_boundary():
    """Kernel K2's CSR (built by torch code the CPU reaches): boundary b's
    bucket holds exactly the peers ending at b, in ascending index order;
    peers ending outside [1, L] are in no bucket; starts are clamped."""
    rng = np.random.default_rng(2)
    L = 12
    starts = rng.integers(-1, L + 2, 50).astype(np.int32)
    ends = rng.integers(-1, L + 3, 50).astype(np.int32)
    off, order, sstart = (t.numpy() for t in ttr.route_csr(
        torch.as_tensor(starts), torch.as_tensor(ends), L))
    assert off.shape == (L + 2,) and off[0] == off[1] == 0
    for b in range(1, L + 1):
        bucket = order[off[b]:off[b + 1]]
        np.testing.assert_array_equal(bucket, np.nonzero(ends == b)[0])
    np.testing.assert_array_equal(sstart, np.clip(starts[order], 0, L))
    assert sorted(order.tolist()) == list(range(50))


@pytest.mark.h100
def test_tropical_route_kernel_matches_plain_on_h100():
    """Kernel K2 equals the plain DP bit for bit (H100 only)."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")
    rng = np.random.default_rng(12)
    for L, kind in ((36, "float"), (36, "ties"), (12, "allinf"),
                    (6, "plusinf")):
        starts, ends, costs = _single_case(L, kind, 70, rng)
        args = [torch.as_tensor(a, device="cuda")
                for a in (starts, ends, costs)]
        got = ttr.tropical_route_cuda(*args, total_layers=L)
        want = ttr.tropical_route_plain(*args, total_layers=L)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The fused window entries: effective costs -> DP -> backtrack in one launch
# ---------------------------------------------------------------------------

WINDOW_CASES = ["float", "ties", "degenerate", "allinf", "plusinf", "wide",
                "outside"]


def _window_case(name, R=6, seed=0):
    """(starts, ends, L, latency, trust, alive, tau, timeout_ms) of one
    window, numpy, from a seed. ``alive`` is what the entries take (alive
    ∧ valid on the serving path); the "degenerate" and "outside" cases
    leave their degenerate peers alive to reach the kernels' handling:
    start == end peers, and starts below 0 / above L (clamped for the DP,
    read unclamped by the backtrack). "wide": one bucket of 40 peers
    (160 K-best candidates, over a warp). "plusinf": every peer spans
    [1, 2) and all are pruned, so dist[2] = INF + INF = +inf."""
    rng = np.random.default_rng(seed * 31 + WINDOW_CASES.index(name))
    timeout = 25_000.0
    if name == "plusinf":
        P, L = 9, 2
        starts, ends = np.ones(P, np.int32), np.full(P, 2, np.int32)
    elif name == "wide":
        L = 8
        starts = np.array([0] * 6 + list(rng.integers(0, 4, 40)) + [4] * 6,
                          np.int32)
        ends = np.array([4] * 6 + [6] * 40 + [8] * 6, np.int32)
        P = len(starts)
    else:
        L = 12
        starts, ends = _topology(40, L, (3, 4, 6), rng)
        if name == "degenerate":
            starts = np.concatenate([starts, [6, 1, 3]]).astype(np.int32)
            ends = np.concatenate([ends, [6, 1, 3]]).astype(np.int32)
        if name == "outside":
            starts[:3] = [-1, -2, L + 3]
            ends[:3] = [2, 3, L]
        P = len(starts)
    lat = rng.uniform(10, 300, P)
    trust = rng.uniform(0.3, 1.0, P)
    alive = rng.random(P) < 0.9
    tau = rng.uniform(0.3, 0.95, R)
    if name == "ties":
        lat = rng.integers(1, 4, P).astype(np.float64)
        trust = rng.choice([0.5, 0.75, 1.0], P)
        tau = rng.choice([0.5, 0.75, 1.0], R)
        timeout = 4.0
    if name in ("allinf", "plusinf"):
        alive[:] = False
    if name in ("degenerate", "outside"):
        alive[-3:] = True
        alive[:3] = True
        trust[:3] = trust[-3:] = 1.0
    return (starts, ends, L, lat.astype(np.float32),
            trust.astype(np.float32), alive, tau.astype(np.float32), timeout)


def _port_window(case, K, k_max):
    """The port's plain window composition on CPU tensors (numpy out)."""
    starts, ends, L, lat, trust, alive, tau, timeout = case
    st = torch.as_tensor(starts)
    csr = ttr.route_csr(st, torch.as_tensor(ends), L)
    args = (csr, st, torch.as_tensor(lat), torch.as_tensor(trust),
            torch.as_tensor(alive), torch.as_tensor(tau))
    if K is None:
        out = ttr.route_window_plain(*args, timeout_ms=timeout,
                                     total_layers=L, k_max=k_max)
    else:
        out = ttr.route_window_kbest_plain(*args, timeout_ms=timeout,
                                           total_layers=L, k_best=K,
                                           k_max=k_max)
    return [t.numpy() for t in out]


def _ref_window(case, K, k_max):
    """The reference's composition: effective_costs -> layered_dp[_kbest]
    -> backtrack[_kbest]."""
    starts, ends, L, lat, trust, alive, tau, timeout = case
    costs = RJ.effective_costs(jnp.asarray(lat), jnp.asarray(trust),
                               jnp.asarray(alive), jnp.asarray(tau), timeout)
    js, je = jnp.asarray(starts), jnp.asarray(ends)
    if K is None:
        dist, pred = RJ.layered_dp(js, je, costs, total_layers=L)
        hops = RJ.backtrack(js, pred, total_layers=L, k_max=k_max)
        return [np.asarray(hops), np.asarray(dist)[:, L]]
    _, pedge, prank = dk = RJ.layered_dp_kbest(js, je, costs, total_layers=L,
                                               k_best=K)
    hops = RJ.backtrack_kbest(js, pedge, prank, total_layers=L, k_max=k_max)
    return [np.asarray(hops), np.asarray(dk[0])[:, L, :]]


def _assert_window_equal(got, want):
    for name, g, w in zip(("hops", "costs"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("K", [None, 1, 4])
@pytest.mark.parametrize("name", WINDOW_CASES)
def test_window_plain_matches_reference(name, K):
    """The plain window composition (what the CPU runs and what the fused
    kernels are held to) equals the reference's effective_costs -> DP ->
    backtrack exactly, at k_max = L and a truncating k_max. With starts
    outside [0, L] the single-best DP clamps them (the port's documented
    contract) where the reference's ``layered_dp`` reads ``dist`` out of
    range (a NaN fill above L, a wrapped index below 0), so that case is
    held to the emulation below only; its backtrack is held to the
    reference's in ``test_single_best_backtrack_out_of_range_*``."""
    case = _window_case(name)
    L = case[2]
    for k_max in (L, max(1, L // 3)):
        got = _port_window(case, K, k_max)
        if not (name == "outside" and K is None):
            _assert_window_equal(got, _ref_window(case, K, k_max))
        assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    if name == "plusinf":
        assert np.isposinf(got[1]).all() if K is None else \
            (got[1] >= INF).all()


# -- a numpy emulation of the CUDA kernels' order of work -------------------

_NONE = (1 << 64) - 1


def _key(v, i):
    """(f32 value, index) -> the kernels' 64-bit key: the float's bits made
    monotone in the high word, the index in the low word."""
    u = int(np.float32(v).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | int(i)


def _key_value(key):
    u = key >> 32
    u = (u & 0x7FFFFFFF) if u & 0x80000000 else (~u & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32)


def _warp_argmin(lanes):
    """The kernels' warp argmin, in every lane: a redux min over the value
    words, then over the index words of the lanes holding the least one."""
    mh = min(k >> 32 for k in lanes)
    ml = min((k & 0xFFFFFFFF) if k >> 32 == mh else 0xFFFFFFFF
             for k in lanes)
    return [(mh << 32) | ml] * 32


def _f32_add(a, b):
    with np.errstate(over="ignore"):
        return np.float32(a) + np.float32(b)


def _emulate_prologue(lat, trust, alive, tau, timeout, P):
    """Each warp's cost row, peer order: the block's per-peer cost (three
    rounded f32 operations) and trust (NaN where dead), pruned by tau."""
    one, to = np.float32(1.0), np.float32(timeout)
    cbase = [np.float32(lat[p]) + (one - np.float32(trust[p])) * to
             for p in range(P)]
    ctrust = [np.float32(trust[p]) if alive[p] else np.float32("nan")
              for p in range(P)]
    with np.errstate(invalid="ignore"):
        return [cbase[p] if ctrust[p] >= np.float32(tau) else INF
                for p in range(P)]


def _winner_lane(words):
    """One candidate per lane, lanes in ascending index order: the least
    value word (a redux min), then the lowest lane holding it (ballot)."""
    least = min(words)
    return words.index(least), least


def _emulate_dp_single(off, peer, sst, crow, P, L):
    dist = [INF] * (L + 1)
    dist[0] = np.float32(0.0)
    pred = [-1] * (L + 1)
    for b in range(1, L + 1):
        lo, hi = int(off[b]), int(off[b + 1])
        n = hi - lo
        if n == 0:                                    # not in the bucket list
            continue
        if n <= 32:                                   # lane l: slot lo + l
            vals = [_f32_add(dist[sst[lo + ln]], crow[peer[lo + ln]])
                    if ln < n else None for ln in range(32)]
            w, _ = _winner_lane([_key(v, 0) >> 32 if v is not None
                                 else 0xFFFFFFFF for v in vals])
            v, p = vals[w], int(peer[lo + w])
        else:                                         # lane-strided shares
            lanes = [_NONE] * 32
            for ln in range(32):
                for j in range(lo + ln, hi, 32):
                    lanes[ln] = min(lanes[ln], _key(
                        _f32_add(dist[sst[j]], crow[peer[j]]), peer[j]))
            best = _warp_argmin(lanes)[0]
            v, p = _key_value(best), best & 0xFFFFFFFF
        if n < P:
            v = np.float32(min(v, INF))               # fminf(v, INF)
        dist[b] = v
        pred[b] = p if v < INF else -1
    return np.array(dist, np.float32), np.array(pred, np.int32)


def _emulate_dp_kbest(off, peer, sst, crow, L, K):
    distK = np.full(((L + 1) * K), INF, np.float32)
    distK[0] = 0.0
    pedge = np.full((L + 1) * K, -1, np.int32)
    prank = np.full((L + 1) * K, -1, np.int32)
    q32, r32 = divmod(32, K)

    def cand(j, kk):
        p = int(peer[j])
        v = _f32_add(distK[sst[j] * K + kk], crow[p])
        return _key(v, p * K + kk) if v < INF else _NONE

    for b in range(1, L + 1):
        lo, hi = int(off[b]), int(off[b + 1])
        ncand = (hi - lo) * K
        if ncand == 0:
            continue
        if ncand <= 32:
            # lane l holds candidate l = (slot l // K, rank l % K); a
            # round's winner lane leaves, and writes itself after the rounds
            words, vals = [0xFFFFFFFF] * 32, [None] * 32
            for ln in range(ncand):
                key = cand(lo + ln // K, ln % K)
                if key != _NONE:
                    words[ln], vals[ln] = key >> 32, _key_value(key)
            won = {}
            for k in range(min(K, ncand)):
                w, least = _winner_lane(words)
                if least == 0xFFFFFFFF:
                    break
                won[w], words[w] = k, 0xFFFFFFFF
            for ln, k in won.items():
                p, kk = int(peer[lo + ln // K]), ln % K
                distK[b * K + k], pedge[b * K + k], prank[b * K + k] = \
                    vals[ln], p, kk
            continue
        # each lane's candidates c = lane + 32 t as (slot, rank), stepped
        # by (q32, r32) without a divide
        mine = []
        for ln in range(32):
            q, r = divmod(ln, K)
            keys, c = [], ln
            while c < ncand:
                keys.append(cand(lo + q, r))
                c, q, r = c + 32, q + q32, r + r32
                if r >= K:
                    r, q = r - K, q + 1
            mine.append(keys)
        last = [0] * 32
        wins = [_NONE] * 32
        for k in range(min(K, ncand)):
            lanes = [min([x for x in mine[ln] if x > last[ln]],
                         default=_NONE) for ln in range(32)]
            res = _warp_argmin(lanes)
            wins[k] = res[k]                          # lane k keeps round k
            last = res
        for ln in range(K):                           # after all rounds
            if wins[ln] != _NONE:
                i = wins[ln] & 0xFFFFFFFF
                distK[b * K + ln] = _key_value(wins[ln])
                pedge[b * K + ln], prank[b * K + ln] = divmod(i, K)
    return distK, pedge, prank


def _emulate_backtrack(starts, pedge, prank, L, K, k_max):
    """Lanes 0..K-1 each follow one chain (K = 1 with prank None: single
    best); invalid once means invalid for good, so the rest is -1."""
    LK = (L + 1) * K
    out = np.full((K, k_max), -1, np.int32)
    for ln in range(K):
        b, rank = L, ln
        for t in range(k_max):
            if prank is not None:
                idx = min(max(b * K + rank, 0), LK - 1)   # clamped index
                e = int(pedge[idx])
                if not (b > 0 and rank >= 0 and e >= 0):
                    break
                rank = int(prank[idx])
            else:
                if not 0 < b <= L:                     # out of range
                    break
                e = int(pedge[b])
                if e < 0:
                    break
            out[ln, k_max - 1 - t] = e
            b = int(starts[e])                         # unclamped starts
    return out


def _emulate_window(case, K, k_max):
    starts, ends, L, lat, trust, alive, tau, timeout = case
    P = len(starts)
    off, order, sst = (t.numpy() for t in ttr.route_csr(
        torch.as_tensor(starts), torch.as_tensor(ends), L))
    hops, costs = [], []
    for r in range(len(tau)):
        crow = _emulate_prologue(lat, trust, alive, tau[r], timeout, P)
        if K is None:
            dist, pred = _emulate_dp_single(off, order, sst, crow, P, L)
            hops.append(_emulate_backtrack(starts, pred, None, L, 1,
                                           k_max)[0])
            costs.append(dist[L])
        else:
            distK, pedge, prank = _emulate_dp_kbest(off, order, sst, crow,
                                                    L, K)
            hops.append(_emulate_backtrack(starts, pedge, prank, L, K,
                                           k_max))
            costs.append(distK[L * K:])
    return [np.array(hops, np.int32), np.array(costs, np.float32)]


@pytest.mark.parametrize("K", [None, 1, 4])
@pytest.mark.parametrize("name", WINDOW_CASES)
def test_kernel_emulation_matches_plain_and_reference(name, K):
    """The fused kernels' order of work, emulated in numpy, equals the
    plain composition and the reference exactly: the per-warp scan of the
    non-empty buckets; up to 32 candidates one per lane in ascending index
    order, each round's winner the lowest lane holding the least value
    word, which then leaves and writes itself after the rounds; larger
    buckets lane-strided, 64-bit (value, index) keys reduced across the
    warp in K rounds under the successor rule, winners written after the
    rounds; the backtrack with the clamped index and unclamped starts."""
    case = _window_case(name)
    L = case[2]
    for k_max in (L, max(1, L // 3)):
        got = _emulate_window(case, K, k_max)
        _assert_window_equal(got, _port_window(case, K, k_max))
        if not (name == "outside" and K is None):
            _assert_window_equal(got, _ref_window(case, K, k_max))


@pytest.mark.parametrize("name", ["ties", "degenerate", "wide", "outside"])
def test_kernel_emulation_dp_matches_plain_dps(name):
    """The emulated DP cores alone, as the unchanged kernel entries run
    them on given costs, equal the plain DPs' full outputs (dist/pred and
    distK/pedge/prank) and the reference's K-best DP."""
    starts, ends, L, lat, trust, alive, tau, timeout = _window_case(name)
    P = len(starts)
    st, en = torch.as_tensor(starts), torch.as_tensor(ends)
    costs = RT.effective_costs(torch.as_tensor(lat), torch.as_tensor(trust),
                               torch.as_tensor(alive), torch.as_tensor(tau),
                               timeout)
    off, order, sst = (t.numpy() for t in ttr.route_csr(st, en, L))
    d, p = RT.layered_dp(st, en, costs, total_layers=L)
    dk = RT.layered_dp_kbest(st, en, costs, total_layers=L, k_best=4)
    jdk = RJ.layered_dp_kbest(jnp.asarray(starts), jnp.asarray(ends),
                              jnp.asarray(costs.numpy()), total_layers=L,
                              k_best=4)
    for r in range(costs.shape[0]):
        crow = costs[r].numpy()
        ed, ep = _emulate_dp_single(off, order, sst, crow, P, L)
        np.testing.assert_array_equal(ed, d[r].numpy())
        np.testing.assert_array_equal(ep, p[r].numpy())
        ek = _emulate_dp_kbest(off, order, sst, crow, L, 4)
        for e, w, j in zip(ek, dk, jdk):
            np.testing.assert_array_equal(e, w[r].reshape(-1).numpy())
            np.testing.assert_array_equal(e, np.asarray(j)[r].reshape(-1))


def test_csr_ends_and_window_uploads_roundtrip():
    """The plain window reads ends back from the CSR (peers outside [1, L]
    as L + 1, never matched); the packed upload and ``window_to_host``
    return the host arrays exactly, with their dtypes."""
    rng = np.random.default_rng(9)
    L = 10
    starts = rng.integers(-1, L + 2, 30).astype(np.int32)
    ends = rng.integers(-1, L + 3, 30).astype(np.int32)
    csr = ttr.route_csr(torch.as_tensor(starts), torch.as_tensor(ends), L)
    got = ttr.csr_ends(csr, 30, L).numpy()
    inside = (ends >= 1) & (ends <= L)
    np.testing.assert_array_equal(got[inside], ends[inside])
    assert (got[~inside] == L + 1).all() and got.dtype == np.int32
    lat, trust = rng.uniform(1, 9, 30), rng.uniform(0, 1, 30)
    alive, tau = rng.random(30) < 0.5, rng.uniform(0, 1, 7)
    up = ttr.upload_window_state(lat, trust, alive, tau, "cpu")
    for t, want, dt in zip(up, (lat, trust, alive, tau),
                           (torch.float32, torch.float32, torch.bool,
                            torch.float32)):
        assert t.dtype == dt
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(want, t.numpy().dtype))
    h, c = torch.arange(12, dtype=torch.int32).view(2, 6), torch.ones(2)
    hh, cc = ttr.window_to_host(h, c)
    np.testing.assert_array_equal(hh, h.numpy())
    np.testing.assert_array_equal(cc, c.numpy())


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_planner", [False, True])
def test_route_batched_kbest_matches_reference(use_kernel, with_planner):
    """K-best hops and costs equal the reference's, through the window
    entry (``use_kernel``: ``ops.route_window_kbest``, the plain
    composition on the CPU) and through the plain pieces one by one."""
    cfg, tcfg = GTRACConfig(), TGTRACConfig()
    t_ref = build_layered_anchor(cfg, L=12, replicas=4, seed=6).snapshot(0.0)
    t_port = _port_layered_anchor(tcfg, L=12, replicas=4,
                                  seed=6).snapshot(0.0)
    taus = np.array([0.0, 0.6, 0.8, 0.95, 0.999])
    want = RJ.route_batched_kbest(t_ref, 12, cfg, taus, k_max=12, k_best=4,
                                  planner=RoutePlanner(12, k_best=4))
    got = RT.route_batched_kbest(
        t_port, 12, tcfg, taus, k_max=12, k_best=4, use_kernel=use_kernel,
        planner=TRoutePlanner(12, k_best=4) if with_planner else None,
        device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].dtype == np.int64 and got[1].dtype == np.float32


def test_device_state_uploads_once_per_version():
    """The planner's cached state is reused while the registry version
    holds (only tau is new) and replaced when it moves."""
    tcfg = TGTRACConfig()
    anchor = _port_layered_anchor(tcfg, L=12, replicas=2, seed=1)
    planner = TRoutePlanner(12, k_best=4)
    t = anchor.snapshot(0.0)
    g = planner.compile(t)
    a = g.device_state(t, torch.device("cpu"), np.array([0.5, 0.7]))
    b = g.device_state(t, torch.device("cpu"), np.array([0.9]))
    assert all(x is y for x, y in zip(a[:3], b[:3]))
    np.testing.assert_array_equal(b[3].numpy(), np.float32([0.9]))
    anchor.set_trust(int(t.peer_ids[0]), 0.1)
    t2 = anchor.snapshot(0.0)
    c = planner.compile(t2).device_state(t2, torch.device("cpu"),
                                         np.array([0.5]))
    assert c[1] is not a[1]
    assert float(c[1][0]) == np.float32(0.1)


@pytest.mark.h100
def test_window_entries_match_plain_on_h100():
    """The fused window kernels equal the plain compositions bit for bit
    (H100 only)."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")
    for name in WINDOW_CASES:
        starts, ends, L, lat, trust, alive, tau, timeout = _window_case(
            name, R=70)
        st = torch.as_tensor(starts, device="cuda")
        csr = ttr.route_csr(st, torch.as_tensor(ends, device="cuda"), L)
        state = ttr.upload_window_state(lat, trust, alive, tau, "cuda")
        for K in (None, 4):
            kw = dict(timeout_ms=timeout, total_layers=L, k_max=L)
            if K is None:
                got = ttr.route_window_cuda(csr, st, *state, **kw)
                want = ttr.route_window_plain(csr, st, *state, **kw)
            else:
                got = ttr.route_window_kbest_cuda(csr, st, *state,
                                                  k_best=K, **kw)
                want = ttr.route_window_kbest_plain(csr, st, *state,
                                                    k_best=K, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, K)

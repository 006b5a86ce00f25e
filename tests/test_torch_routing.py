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

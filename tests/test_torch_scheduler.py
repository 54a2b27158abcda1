"""The port's scheduling program (ray_tpu_torch._private.scheduler
.tpu_policy.schedule_classes_plain) against the JAX package's
``_schedule_classes_kernel``, on the same numpy inputs, on the CPU.

The JAX side runs its jitted program on the CPU, as its own tests run it.
The port's side is what a CPU tensor goes through: the plain version of
the ``schedule_classes`` kernel. The outputs are placements packed as
int32 and the new availability, so both must be equal element for
element: the clusters of ``tests/test_tpu_policy.py`` and the
benchmark's shape cut to 2,000 nodes and 100,000 tasks
(``tests/test_torch_scheduler_random.py`` adds 20 seeded random
clusters). Then the policy: ``schedule_batch`` of both packages on twin
clusters built from the same node hex ids gives every request the same
node, and the assertions of ``tests/test_tpu_policy.py`` hold for the
port's classes.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ray_tpu._private.scheduler.tpu_policy import _schedule_classes_kernel

tp = importlib.import_module("ray_tpu_torch._private.scheduler.tpu_policy")
wl = importlib.import_module("ray_tpu_torch._private.scheduler.workload")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _assert_programs_equal(avail, total, alive, demands, counts, prefs,
                           threshold=0.5):
    """Both programs on the same arrays: packed outputs and new_avail
    equal element for element. Returns the packed outputs."""
    arrays = (np.asarray(avail, np.float32), np.asarray(total, np.float32),
              np.asarray(alive, bool), np.asarray(demands, np.float32),
              np.asarray(counts, np.int32), np.asarray(prefs, np.int32))
    want, want_avail = _schedule_classes_kernel(
        *(jnp.asarray(a) for a in arrays), jnp.float32(threshold),
        num_classes=len(arrays[4]))
    got, got_avail = tp.schedule_classes_plain(
        *(torch.from_numpy(a.copy()) for a in arrays), threshold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_avail.numpy(), np.asarray(want_avail))
    return got.numpy()


def _dense(node_cpus, extra=None, n_pad=8, r_pad=4):
    """Dense arrays of a cluster of CPU-only nodes (column 0), padded as
    the policy's view pads them; ``extra`` sets more columns."""
    total = np.zeros((n_pad, r_pad), np.float32)
    total[:len(node_cpus), 0] = node_cpus
    for (i, j), v in (extra or {}).items():
        total[i, j] = v
    alive = np.zeros(n_pad, bool)
    alive[:len(node_cpus)] = True
    return total.copy(), total, alive


def test_never_oversubscribes_cluster():
    """make_cluster([2, 3, 5]) and 30 one-CPU tasks: 10 placed."""
    avail, total, alive = _dense([2, 3, 5])
    packed = _assert_programs_equal(avail, total, alive,
                                    [[1, 0, 0, 0]], [30], [-1])
    assert packed[0, 3] == 10


@pytest.mark.parametrize("pref", [-1, 0, 1])
def test_preferred_node_and_threshold(pref):
    """Two 8-CPU nodes, 8 tasks preferring node 0 or 1, or none; a 0.8
    threshold as well as the default."""
    avail, total, alive = _dense([8, 8])
    for threshold in (0.5, 0.8):
        _assert_programs_equal(avail, total, alive, [[1, 0, 0, 0]], [8],
                               [pref], threshold)


def test_dead_and_preloaded_nodes():
    """A dead preferred node and a node preloaded to 80%."""
    avail, total, alive = _dense([8, 8, 10])
    alive[0] = False
    avail[2, 0] = 2.0
    _assert_programs_equal(avail, total, alive, [[1, 0, 0, 0]] * 2,
                           [4, 6], [0, -1])


@pytest.mark.parametrize("counts", [[2, 2], [5, 2]])
def test_scarcity_order(counts):
    """tests/test_tpu_policy.py:246: a CPU class and a CPU+TPU class on
    nodes (CPU 2, TPU 2) and (CPU 2); the CPU class over-subscribed in
    the second case."""
    avail, total, alive = _dense([2, 2], extra={(0, 1): 2.0})
    packed = _assert_programs_equal(avail, total, alive,
                                    [[1, 0, 0, 0], [1, 1, 0, 0]], counts,
                                    [-1, -1])
    assert packed[1, 3] == 2


def test_zero_count_padded_classes():
    """tests/test_tpu_policy.py:286: classes with zero count, K = 4 with
    one pad row."""
    total = np.full((2, 2), 4.0, np.float32)
    packed = _assert_programs_equal(
        total.copy(), total, np.ones(2, bool),
        [[1.0, 0.0], [0.0, 1.0], [2.0, 0.0], [0.0, 0.0]], [3, 0, 1, 0],
        [-1] * 4)
    assert packed[1, 3] == 0 and packed[3, 3] == 0


def test_zero_valued_demand():
    """tests/test_tpu_policy.py:329: a demand with a zero-valued entry,
    and a class whose demand is zero everywhere (its totals bound is +inf,
    clamped to 2^30)."""
    avail, total, alive = _dense([1])
    packed = _assert_programs_equal(avail, total, alive,
                                    [[1, 0, 0, 0], [0, 0, 0, 0]], [3, 3],
                                    [-1, -1])
    assert packed[1, 4] == 2 ** 30 and packed[1, 2] == 0


def test_capacity_fence():
    """tests/test_tpu_policy.py:186: 2 x 2-CPU nodes and 10 one-CPU
    tasks: 6 fenced, bound 4; with preferred nodes as two classes."""
    avail, total, alive = _dense([2, 2])
    packed = _assert_programs_equal(avail, total, alive, [[1, 0, 0, 0]],
                                    [10], [-1])
    assert packed[0, 2] == 6 and packed[0, 4] == 4
    _assert_programs_equal(avail, total, alive, [[1, 0, 0, 0]] * 2, [5, 5],
                           [0, 1])


def test_negative_availability():
    """A node oversubscribed by a reacquire (avail below zero)."""
    avail, total, alive = _dense([4, 4, 4])
    avail[1, 0] = -2.0
    _assert_programs_equal(avail, total, alive, [[1, 0, 0, 0]], [9], [1])


def test_residual_pass():
    """Nodes of 0.9 CPU and a 0.3-CPU class: the fence and the live bound
    admit 3 a node through their 1e-6 slack, but floor(0.9 / 0.3) in fp32
    is 2, so the fill leaves an admitted remainder and the residual pass
    runs (and places nothing more). Both programs take that branch."""
    n = 8
    total = np.zeros((n, 4), np.float32)
    total[:4, 0] = 0.9
    alive = np.arange(n) < 4
    packed = _assert_programs_equal(total.copy(), total, alive,
                                    [[0.3, 0, 0, 0], [0.1, 0, 0, 0]],
                                    [20, 5], [-1, 2])
    assert packed[0, 3] == 12 and packed[0, 5 + n:5 + 2 * n].sum() == 8
    assert packed[:, 5 + 2 * n:5 + 3 * n].any()      # order2: the pass ran


def test_bench_shape_reduced():
    """The benchmark's cluster and classes (bench.py:20-47) at 2,000
    nodes and 100,000 tasks: placed equals admitted, no node
    oversubscribed."""
    w = wl.workload(np.random.RandomState(42), 2000, 100_000)
    packed = _assert_programs_equal(w.avail, w.total, w.alive, w.demands,
                                    w.counts, np.full(8, -1))
    n = 2000
    placed = (packed[:, 0] + packed[:, 5 + n:5 + 2 * n].sum(1)
              + packed[:, 5 + 3 * n:].sum(1))
    np.testing.assert_array_equal(placed, packed[:, 3])


def test_workload_is_the_benchmarks():
    """The port's copy of bench.py's builders draws the same arrays."""
    rng = np.random.RandomState(42)
    avail, total, alive = bench.build_cluster_arrays(rng)
    demands, counts, _ = bench.build_demand_classes(rng)
    w = wl.workload(np.random.RandomState(42))
    for a, b in ((avail, w.avail), (total, w.total), (alive, w.alive),
                 (demands, w.demands), (counts, w.counts)):
        np.testing.assert_array_equal(a, b)
    assert w.counts.sum() == bench.N_TASKS and len(w.avail) == bench.N_NODES
    pg = np.zeros((512, 4), np.float32)
    pg[:, 0] = rng.choice([1, 2, 4], 512)
    pg[:, 2] = rng.choice([1, 2], 512)
    np.testing.assert_array_equal(pg, w.pg_demands)
    groups = np.zeros((64, 8, 4), np.float32)
    groups[:, :, 0] = rng.choice([1, 2, 4], (64, 8))
    groups[:, :, 2] = rng.choice([1, 2], (64, 8))
    np.testing.assert_array_equal(groups, w.batch_demands)


# --------------------------------------------------------------------------
# The policy: schedule_batch of both packages, and the reference's
# assertions on the port's classes
# --------------------------------------------------------------------------

from ray_tpu._private.ids import NodeID as JNodeID  # noqa: E402
from ray_tpu._private.scheduler import policy as jpol  # noqa: E402
from ray_tpu._private.scheduler import resources as jres  # noqa: E402
from ray_tpu._private.scheduler import tpu_policy as jtp  # noqa: E402

pol = importlib.import_module("ray_tpu_torch._private.scheduler.policy")
res = importlib.import_module("ray_tpu_torch._private.scheduler.resources")
pids = importlib.import_module("ray_tpu_torch._private.ids")


def _twins(totals, rng, allocated=None):
    """The same cluster in both packages, from the same node hex ids."""
    jc, pc = jres.ClusterResourceManager(), res.ClusterResourceManager()
    hexes = []
    for i, total in enumerate(totals):
        h = rng.bytes(28).hex()
        jc.add_or_update_node(JNodeID.from_hex(h),
                              jres.NodeResources.of(**total))
        pc.add_or_update_node(pids.NodeID.from_hex(h),
                              res.NodeResources.of(**total))
        for demand in (allocated or {}).get(i, []):
            jc.allocate(JNodeID.from_hex(h), demand)
            pc.allocate(pids.NodeID.from_hex(h), demand)
        hexes.append(h)
    return jc, pc, hexes


def _requests(specs, hexes):
    """Twin request lists from (demand, preferred node index or None)."""
    jreqs = [jpol.SchedulingRequest(
        demand=dict(d), preferred_node=(None if p is None
                                        else JNodeID.from_hex(hexes[p])))
        for d, p in specs]
    preqs = [pol.SchedulingRequest(
        demand=dict(d), preferred_node=(None if p is None
                                        else pids.NodeID.from_hex(hexes[p])))
        for d, p in specs]
    return jreqs, preqs


def _outcome(results):
    return [(None if r.node_id is None else r.node_id.hex(), r.is_infeasible,
             r.is_fenced, r.fence_bound) for r in results]


@pytest.mark.parametrize("seed", range(4))
def test_schedule_batch_matches_jax(seed):
    """Random twin clusters (some nodes preloaded) and mixed batches with
    preferred nodes: the same node, or the same infeasible / fenced
    verdict with the same bound, for every request."""
    rng = np.random.RandomState(100 + seed)
    n = int(rng.randint(3, 40))
    totals = [dict(CPU=float(rng.choice([2, 4, 8, 16])),
                   memory=float(rng.choice([8, 32])),
                   **({"GPU": 2.0} if rng.rand() < 0.3 else {}))
              for _ in range(n)]
    allocated = {i: [{"CPU": 1.0}] for i in range(n) if rng.rand() < 0.3}
    jc, pc, hexes = _twins(totals, rng, allocated)
    kinds = [{"CPU": 1.0}, {"CPU": 2.0, "memory": 4.0}, {"CPU": 1.0,
                                                         "GPU": 1.0},
             {"CPU": 0.5}, {"CPU": 64.0}]
    specs = [(kinds[rng.randint(len(kinds))],
              int(rng.randint(n)) if rng.rand() < 0.3 else None)
             for _ in range(int(rng.randint(20, 200)))]
    jreqs, preqs = _requests(specs, hexes)
    want = _outcome(jtp.TpuSchedulingPolicy().schedule_batch(jc, jreqs))
    got = _outcome(tp.TpuSchedulingPolicy(device="cpu").schedule_batch(
        pc, preqs))
    assert got == want
    assert any(o[0] is not None for o in got)


def _port_cluster(node_cpus):
    cluster, ids = res.ClusterResourceManager(), []
    for cpus in node_cpus:
        nid = pids.NodeID.from_random()
        cluster.add_or_update_node(nid, res.NodeResources.of(CPU=cpus))
        ids.append(nid)
    return cluster, ids


def _policy(**kw):
    return tp.TpuSchedulingPolicy(device="cpu", **kw)


def _per_node(results):
    counts = {}
    for r in results:
        if r.node_id is not None:
            counts[r.node_id] = counts.get(r.node_id, 0) + 1
    return counts


def test_port_policy_local_packing_and_spread():
    """tests/test_tpu_policy.py:34-52, 108-116: a single task goes to its
    preferred node; packing stops at the spread threshold; spread goes to
    the least utilized node."""
    cluster, ids = _port_cluster([4, 4, 4])
    assert _policy().schedule(cluster, pol.SchedulingRequest(
        demand={"CPU": 1}, preferred_node=ids[1])).node_id == ids[1]
    cluster, ids = _port_cluster([8, 8])
    results = _policy(spread_threshold=0.5).schedule_batch(cluster, [
        pol.SchedulingRequest(demand={"CPU": 1}, preferred_node=ids[0])
        for _ in range(8)])
    assert sum(r.node_id == ids[0] for r in results) == 4
    assert all(r.node_id is not None for r in results)
    cluster, ids = _port_cluster([10, 10])
    cluster.allocate(ids[0], {"CPU": 8})
    results = _policy().schedule_batch(
        cluster, [pol.SchedulingRequest(demand={"CPU": 1}) for _ in range(4)])
    assert all(r.node_id == ids[1] for r in results)


def test_port_policy_capacity_and_feasibility():
    """tests/test_tpu_policy.py:54-90, 186-200: never oversubscribes;
    infeasible flags; dead nodes excluded; the totals surplus fenced."""
    cluster, ids = _port_cluster([2, 3, 5])
    results = _policy().schedule_batch(
        cluster, [pol.SchedulingRequest(demand={"CPU": 1})
                  for _ in range(30)])
    counts = _per_node(results)
    assert sum(counts.values()) == 10
    assert [counts.get(i, 0) for i in ids] == [2, 3, 5]
    assert all(not r.is_infeasible for r in results if r.node_id is None)
    cluster, _ = _port_cluster([2, 2])
    for demand in ({"CPU": 16}, {"GPU": 1}):
        r = _policy().schedule(cluster, pol.SchedulingRequest(demand=demand))
        assert r.node_id is None and r.is_infeasible
    cluster, ids = _port_cluster([4, 4])
    node = cluster.get_node(ids[0])
    node.alive = False
    cluster.add_or_update_node(ids[0], node)
    results = _policy().schedule_batch(
        cluster, [pol.SchedulingRequest(demand={"CPU": 1}) for _ in range(4)])
    assert all(r.node_id == ids[1] for r in results)
    cluster, _ = _port_cluster([2, 2])
    results = _policy().schedule_batch(
        cluster, [pol.SchedulingRequest(demand={"CPU": 1})
                  for _ in range(10)])
    assert sum(r.node_id is not None for r in results) == 4
    assert sum(r.is_fenced for r in results) == 6
    assert all(r.node_id is not None for r in results[:4])


def test_port_policy_balanced_fill_and_classes():
    """tests/test_tpu_policy.py:93-106, 144-175, 347-362: water-fill
    balances by utilization; mixed classes share capacity; one large class
    fills without oversubscribing; the fence aggregates across
    preferred-node classes."""
    cluster, _ = _port_cluster([8, 8, 8])
    results = _policy().schedule_batch(
        cluster, [pol.SchedulingRequest(demand={"CPU": 1}) for _ in range(9)])
    assert sorted(_per_node(results).values()) == [3, 3, 3]
    cluster, ids = _port_cluster([12, 4])
    counts = _per_node(_policy().schedule_batch(
        cluster, [pol.SchedulingRequest(demand={"CPU": 1}) for _ in range(8)]))
    assert counts[ids[0]] == 6 and counts[ids[1]] == 2
    cluster, ids = _port_cluster([4])
    cluster.add_or_update_node(ids[0], res.NodeResources.of(CPU=4, TPU=2))
    results = _policy().schedule_batch(cluster, (
        [pol.SchedulingRequest(demand={"CPU": 2}) for _ in range(2)]
        + [pol.SchedulingRequest(demand={"CPU": 1, "TPU": 1})
           for _ in range(4)]))
    assert results[0].node_id == ids[0] and results[1].node_id == ids[0]
    assert all(r.node_id is None and not r.is_infeasible
               for r in results[2:])
    cluster, _ = _port_cluster([64] * 32)
    results = _policy().schedule_batch(
        cluster, [pol.SchedulingRequest(demand={"CPU": 1})
                  for _ in range(2048)])
    assert sum(r.node_id is not None for r in results) == 2048
    assert max(_per_node(results).values()) <= 64
    cluster, ids = _port_cluster([2, 2])
    results = _policy().schedule_batch(cluster, [
        pol.SchedulingRequest(demand={"CPU": 1}, preferred_node=ids[i // 5])
        for i in range(10)])
    assert sum(r.node_id is not None for r in results) == 4
    assert sum(r.is_fenced for r in results) == 6


def test_port_policy_dense_contracts():
    """tests/test_tpu_policy.py:286-327, 365-388: padded classes are
    inert; the host view survives repeated invocations; placed equals
    admitted on random clusters."""
    pol_ = _policy()
    total = np.full((2, 2), 4.0, np.float32)
    ds = pol_.schedule_dense(total.copy(), total, np.ones(2, bool),
                             np.array([[1.0, 0.0], [0.0, 1.0], [2.0, 0.0]],
                                      np.float32),
                             np.array([3, 0, 1], np.int32),
                             np.full(3, -1, np.int32))
    placed = ds.local_take + ds.take_sorted.sum(1) + ds.take2.sum(1)
    assert list(placed) == [3, 0, 1, 0] and ds.fenced[3] == 0
    assert isinstance(ds.new_avail, torch.Tensor)
    cluster, _ = _port_cluster([4, 4])
    pol_.schedule_batch(cluster, [pol.SchedulingRequest(demand={"CPU": 1})
                                  for _ in range(3)])
    view = pol_._view
    before = view.avail.copy()
    args = (view.avail, view.total, view.alive,
            np.array([[1.0] + [0.0] * (view.total.shape[1] - 1)], np.float32),
            np.array([2], np.int32), np.array([-1], np.int32))
    ds1, ds2 = pol_.schedule_dense(*args), pol_.schedule_dense(*args)
    np.testing.assert_array_equal(view.avail, before)
    np.testing.assert_array_equal(ds1.take_sorted, ds2.take_sorted)
    rng = np.random.RandomState(7)
    for _ in range(5):
        cluster, _ = _port_cluster(rng.randint(1, 12, rng.randint(1, 10))
                                   .tolist())
        pol_ = _policy()
        pol_._view.refresh(cluster, extra_resources=["CPU"])
        view = pol_._view
        k = int(rng.randint(1, 4))
        demands = np.zeros((k, view.total.shape[1]), np.float32)
        demands[:, view.res_index["CPU"]] = rng.randint(1, 4, k)
        counts = rng.randint(0, 40, k).astype(np.int32)
        ds = pol_.schedule_dense(view.avail, view.total, view.alive, demands,
                                 counts, np.full(k, -1, np.int32))
        placed = ds.local_take + ds.take_sorted.sum(1) + ds.take2.sum(1)
        np.testing.assert_array_equal(placed[:k], ds.admitted[:k])
        assert (ds.fenced[:k] + ds.admitted[:k] <= counts).all()


def test_registry_default_policy_and_device():
    """The registry keeps the reference's names; the kernel policies and
    default_policy run on the card unless the caller asks for the CPU,
    and 'auto' means the kernel policy on the given device, the CPU hybrid
    on the CPU."""
    if torch.cuda.is_available():
        assert isinstance(pol.create_policy("tpu"), tp.TpuSchedulingPolicy)
    else:
        for make in (lambda: pol.create_policy("tpu"),
                     lambda: pol.create_policy("tpu_adaptive"),
                     pol.default_policy):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    composite = pol.default_policy(device="cpu")
    assert isinstance(composite._inner, pol.HybridSchedulingPolicy)
    cfg = importlib.import_module("ray_tpu_torch._private.config")
    old = cfg.get_config()._values["use_tpu_scheduler"]
    try:
        cfg.get_config()._values["use_tpu_scheduler"] = "1"
        inner = pol.default_policy(device="cpu")._inner
        assert isinstance(inner, tp.AdaptiveSchedulingPolicy)
        assert inner.device.type == "cpu"
    finally:
        cfg.get_config()._values["use_tpu_scheduler"] = old


def test_adaptive_policy_routes_by_its_cost_model():
    """Below the minimum batch, and until the round trip is measured, the
    CPU scan; above it on a large cluster, the kernel policy, whose
    placements equal the kernel policy's own."""
    inner = tp.AdaptiveSchedulingPolicy(device="cpu")
    tp._device_rt_threads[inner.device].join(timeout=30)
    assert inner.device in tp._device_rt_s
    cluster, _ = _port_cluster([16] * 200)
    small = [pol.SchedulingRequest(demand={"CPU": 1}) for _ in range(8)]
    assert not inner._kernel_pays_off(len(small), 200) or len(small) < 64
    big = [pol.SchedulingRequest(demand={"CPU": 1}) for _ in range(3000)]
    if inner._kernel_pays_off(len(big), 200):
        want = _policy().schedule_batch(cluster, big)
        got = inner.schedule_batch(cluster, big)
        assert [r.node_id for r in got] == [r.node_id for r in want]
    results = inner.schedule_batch(cluster, small)
    assert all(r.node_id is not None for r in results)


def test_adaptive_policy_raises_when_its_probe_fails(monkeypatch):
    """A round-trip probe that fails does not leave every batch on the
    CPU scan: the next schedule_batch raises its error, and the one after
    starts a new probe."""
    monkeypatch.setattr(tp, "_device_rt_s", {})
    monkeypatch.setattr(tp, "_device_rt_errors", {})
    monkeypatch.setattr(tp, "_device_rt_threads", {})

    def broken(device):
        raise RuntimeError("device lost")

    monkeypatch.setattr(tp, "_measure_device_rt", broken)
    inner = tp.AdaptiveSchedulingPolicy(device="cpu")
    tp._device_rt_threads[inner.device].join(timeout=30)
    cluster, _ = _port_cluster([16] * 4)
    requests = [pol.SchedulingRequest(demand={"CPU": 1}) for _ in range(4)]
    with pytest.raises(RuntimeError, match="device lost"):
        inner.schedule_batch(cluster, requests)
    monkeypatch.setattr(tp, "_measure_device_rt", lambda device: 1e-4)
    results = inner.schedule_batch(cluster, requests)
    assert all(r.node_id is not None for r in results)
    inner._kernel_pays_off(1, 1)
    tp._device_rt_threads[inner.device].join(timeout=30)
    assert tp._device_rt_s[inner.device] == 1e-4


def test_config_keys_and_env_overrides(monkeypatch):
    """The scheduler's keys have the reference's defaults and its
    RAY_TPU_<name> overrides."""
    from ray_tpu._private.config import Config as JConfig
    cfg = importlib.import_module("ray_tpu_torch._private.config")
    keys = ("scheduler_spread_threshold", "scheduler_top_k_fraction",
            "scheduler_top_k_absolute", "tpu_scheduler_min_batch",
            "pg_pack_topk", "use_tpu_scheduler")
    fresh = cfg.Config()
    for key in keys:
        assert getattr(fresh, key) == JConfig._DEFS[key][1]
    monkeypatch.setenv("RAY_TPU_pg_pack_topk", "32")
    monkeypatch.setenv("RAY_TPU_scheduler_spread_threshold", "0.75")
    fresh = cfg.Config()
    assert fresh.pg_pack_topk == 32 and fresh.scheduler_spread_threshold == 0.75

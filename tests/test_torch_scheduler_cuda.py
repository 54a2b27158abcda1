"""The port's scheduler kernels (schedule_classes, pg_pack, pg_pack_batch)
against their plain versions, on the card. Placements are integers, so
every comparison is exact. Marked ``cuda``: each test skips without an
NVIDIA GPU.

This file imports torch only, so it also runs where JAX is absent:
``python -m pytest --noconftest -q tests/test_torch_scheduler_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch

tp = importlib.import_module("ray_tpu_torch._private.scheduler.tpu_policy")
pk = importlib.import_module("ray_tpu_torch._private.scheduler.pg_kernel")
wl = importlib.import_module("ray_tpu_torch._private.scheduler.workload")
res = importlib.import_module("ray_tpu_torch._private.scheduler.resources")
pol = importlib.import_module("ray_tpu_torch._private.scheduler.policy")
ids = importlib.import_module("ray_tpu_torch._private.ids")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return "cuda"


def _dense(w, dev, prefs=None):
    k = len(w.counts)
    prefs = np.full(k, -1, np.int32) if prefs is None else prefs
    return [torch.as_tensor(a).to(dev) for a in
            (w.avail, w.total, w.alive, w.demands, w.counts.astype(np.int32),
             prefs.astype(np.int32))]


@pytest.mark.parametrize("n_nodes,n_tasks,with_prefs",
                         [(wl.N_NODES, wl.N_TASKS, False),
                          (wl.N_NODES, wl.N_TASKS, True),
                          (40_000, 4_000_000, False),
                          (300, 20_000, True)])
def test_schedule_classes_kernel_equals_plain(cuda, n_nodes, n_tasks,
                                              with_prefs):
    """The bench shape (10,000 nodes, 1M tasks, 8 classes), with preferred
    nodes, at 40,000 nodes (the sort past shared memory) and small:
    packed outputs and the new availability equal the plain version's
    element for element; no node is oversubscribed; placed == admitted."""
    w = wl.workload(np.random.RandomState(42), n_nodes, n_tasks)
    prefs = (np.random.RandomState(1).randint(0, n_nodes, 8)
             if with_prefs else None)
    args = _dense(w, cuda, prefs)
    want, want_avail = tp.schedule_classes_plain(*args, 0.5)
    before = tp.launches
    got, got_avail = tp.schedule_classes(*[a.clone() for a in args], 0.5)
    torch.cuda.synchronize()
    assert tp.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got_avail, want_avail)
    assert bool((got_avail >= -1e-6).all())
    n = n_nodes
    g = got.cpu().numpy()
    placed = g[:, 0] + g[:, 5 + n:5 + 2 * n].sum(1) + g[:, 5 + 3 * n:].sum(1)
    np.testing.assert_array_equal(placed, g[:, 3])


@pytest.mark.parametrize("seed", range(6))
def test_schedule_classes_kernel_equals_plain_on_random_clusters(cuda, seed):
    """Random clusters with 8 resource columns, up to 48 classes (padded
    to a power of two), dead nodes, preferred nodes, fractional demands,
    an oversubscribed node, and nodes of 0.9 against 0.3-CPU classes,
    which make the residual pass run."""
    rs = np.random.RandomState(seed)
    n, k, r = int(rs.randint(8, 3000)), int(rs.randint(1, 49)), 8
    total = np.zeros((n, r), np.float32)
    total[:, 0] = rs.choice([0.9, 4, 8, 16, 32], n)
    total[:, 1:6] = rs.choice([0, 0, 1, 4, 64], (n, 5))
    avail = np.maximum(total * (1 - rs.uniform(0, 0.6, (n, 1))),
                       0).astype(np.float32)
    avail[0, 0] = -2.0
    alive = rs.rand(n) > 0.1
    demands = np.zeros((k, r), np.float32)
    demands[:, 0] = rs.choice([0.3, 0.5, 1, 2], k)
    demands[:, 1:6] = rs.choice([0, 0, 0, 0.5, 1], (k, 5))
    counts = rs.randint(0, 3000, k).astype(np.int32)
    prefs = np.where(rs.rand(k) < 0.4, rs.randint(0, n, k), -1)
    k_pad = tp._bucket(k, minimum=1) - k
    arrays = (avail, total, alive, np.pad(demands, ((0, k_pad), (0, 0))),
              np.pad(counts, (0, k_pad)),
              np.pad(prefs, (0, k_pad), constant_values=-1))
    args = [torch.as_tensor(np.ascontiguousarray(a)).to(cuda)
            for a in arrays]
    args[4], args[5] = args[4].int(), args[5].int()
    want, want_avail = tp.schedule_classes_plain(*args, 0.5)
    got, got_avail = tp.schedule_classes(*[a.clone() for a in args], 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_avail, want_avail)


def test_schedule_classes_kernel_runs_the_residual_pass(cuda):
    """The case of tests/test_torch_scheduler.py::test_residual_pass on
    the card: the kernel takes the residual branch as the plain version
    does."""
    n = 8
    total = np.zeros((n, 4), np.float32)
    total[:4, 0] = 0.9
    arrays = (total.copy(), total, np.arange(n) < 4,
              np.array([[0.3, 0, 0, 0], [0.1, 0, 0, 0]], np.float32),
              np.array([20, 5], np.int32), np.array([-1, 2], np.int32))
    args = [torch.as_tensor(a).to(cuda) for a in arrays]
    want, want_avail = tp.schedule_classes_plain(*args, 0.5)
    got, got_avail = tp.schedule_classes(*[a.clone() for a in args], 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_avail, want_avail)
    assert bool(got[:, 5 + 2 * n:5 + 3 * n].any())


@pytest.mark.parametrize("mode", ["pack", "spread", "strict_spread"])
def test_pg_pack_kernel_equals_plain(cuda, mode):
    """bench_pg_pack's shape: 512 bundles over 10,000 nodes."""
    w = wl.workload(np.random.RandomState(42))
    args = [torch.as_tensor(a).to(cuda) for a in
            (w.avail, w.total, w.alive, w.pg_demands)]
    want = pk.pack_plain(*args, mode)
    before = pk.launches_pack
    got = pk.pack(*args, mode)
    torch.cuda.synchronize()
    assert pk.launches_pack == before + 1
    assert torch.equal(got, want)
    assert got[-1].item() == 1


@pytest.mark.parametrize("mode", ["pack", "spread", "strict_spread"])
@pytest.mark.parametrize("n_nodes", [wl.N_NODES, 40_000, 300])
def test_pg_pack_batch_kernel_equals_plain(cuda, mode, n_nodes):
    """bench_pg_pack_batched's shape (G, B, k = 64, 8, 128), at 10,000
    nodes, past the shared-memory sort, and with the deal wrapping past N
    (300 nodes < k G), one group padded."""
    w = wl.workload(np.random.RandomState(42), n_nodes, 1000)
    valid = np.ones(w.batch_demands.shape[:2], bool)
    demands = w.batch_demands.copy()
    valid[3, 5:] = False
    demands[3, 5:] = 0.0
    args = [torch.as_tensor(a).to(cuda) for a in
            (w.avail, w.total, w.alive, demands, valid)]
    want = pk.pack_batch_plain(*args, mode, wl.PG_TOPK)
    before = pk.launches_pack_batch
    got = pk.pack_batch(*args, mode, wl.PG_TOPK)
    torch.cuda.synchronize()
    assert pk.launches_pack_batch == before + 2   # the ranking, the groups
    assert torch.equal(got, want)


def test_policy_on_the_card_places_as_on_the_cpu(cuda):
    """schedule_batch through a ClusterResourceManager: the kernel on the
    card gives every request the node the plain version gives it."""
    rng = np.random.RandomState(3)
    cluster = res.ClusterResourceManager()
    nodes = []
    for _ in range(1000):
        nid = ids.NodeID.from_random()
        cluster.add_or_update_node(nid, res.NodeResources.of(
            CPU=float(rng.choice([8, 16, 32])),
            memory=float(rng.choice([32, 64]))))
        nodes.append(nid)
    reqs = [pol.SchedulingRequest(
        demand={"CPU": float(rng.choice([1, 2])),
                "memory": float(rng.choice([1, 4]))},
        preferred_node=nodes[rng.randint(0, 8)] if i % 3 == 0 else None)
        for i in range(4096)]
    before = tp.launches
    on_card = tp.TpuSchedulingPolicy().schedule_batch(cluster, reqs)
    assert tp.launches == before + 1
    on_cpu = tp.TpuSchedulingPolicy(device="cpu").schedule_batch(cluster,
                                                                 reqs)
    assert [r.node_id for r in on_card] == [r.node_id for r in on_cpu]
    assert sum(r.node_id is not None for r in on_card) == 4096


def test_kernels_reject_what_they_do_not_take(cuda):
    w = wl.workload(np.random.RandomState(42), 64, 100)
    args = _dense(w, cuda)
    with pytest.raises(ValueError, match="alive"):
        tp.schedule_classes(*args[:2], args[2].float(), *args[3:], 0.5)
    with pytest.raises(ValueError, match="demands"):
        pk.pack(*args[:3], args[3].double(), "spread")


@pytest.mark.parametrize("name", wl.CLASS_EDGE_NAMES)
def test_schedule_classes_edge_shapes(cuda, name):
    """The cluster kernel on each edge shape of
    ``workload.class_edge_case``: one-node and odd slices, slices kept in
    global memory, R = 1 and 64, dead and
    identical rows, the residual pass, zero-count padded classes. Packed
    rows and the new availability equal the plain version's exactly."""
    case = wl.class_edge_case(name)
    args = [torch.as_tensor(a).to(cuda) for a in (
        case.avail, case.total, case.alive, case.demands, case.counts,
        case.prefs)]
    want, want_avail = tp.schedule_classes_plain(*[a.clone() for a in args],
                                                 0.5)
    got, got_avail = tp.schedule_classes(*[a.clone() for a in args], 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_avail, want_avail)


@pytest.mark.parametrize("name", wl.PACK_EDGE_NAMES)
def test_pg_pack_edge_shapes(cuda, name):
    """The cluster kernel on each edge shape of ``workload.pack_edge_case``:
    one row, odd sizes, rows in global memory (R = 64), identical and dead
    rows, bundles that fit nowhere, STRICT_SPREAD with more bundles than
    alive rows: the same nodes and all-placed flag as the plain version."""
    case = wl.pack_edge_case(name)
    args = [torch.as_tensor(a).to(cuda) for a in (
        case.avail, case.total, case.alive, case.demands)]
    want = pk.pack_plain(*args, case.mode)
    got = pk.pack(*args, case.mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", wl.BATCH_EDGE_NAMES)
def test_pg_pack_batch_edge_shapes(cuda, name):
    """The S3 cluster kernel on each edge shape of
    ``workload.batch_edge_case``: one node, odd slices, either side of
    16,384 rows, slices in global memory (70,000 rows), R = 1 and 64, one
    group and 1,024 groups over aliased slots, identical rows, PACK rows
    at util 0, a group all padding, bundles that fit nowhere: the same
    nodes and all-placed flags as the plain version, and its ranking
    alone the plain version's order."""
    case = wl.batch_edge_case(name)
    args = [torch.as_tensor(a).to(cuda) for a in (
        case.avail, case.total, case.alive, case.demands, case.valid)]
    want = pk.pack_batch_plain(*args, case.mode, case.k)
    got = pk.pack_batch(*args, case.mode, case.k)
    ranked = pk.rank_nodes_cuda(*args[:3], case.mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(ranked, pk.rank_nodes_plain(*args[:3], case.mode))


def test_kernels_on_each_card_in_turn(cuda):
    """Kernel attributes and launch shapes are kept per device: with two
    or more cards, both cluster kernels run on card 1, card 0 and card 1
    again, each equal to its plain version on that card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    case = wl.class_edge_case("n10007")
    pack = wl.pack_edge_case("n10007_spread")
    for dev in ("cuda:1", "cuda:0", "cuda:1"):
        args = [torch.as_tensor(a).to(dev) for a in (
            case.avail, case.total, case.alive, case.demands, case.counts,
            case.prefs)]
        want, want_avail = tp.schedule_classes_plain(
            *[a.clone() for a in args], 0.5)
        got, got_avail = tp.schedule_classes(*[a.clone() for a in args], 0.5)
        pargs = [torch.as_tensor(a).to(dev) for a in (
            pack.avail, pack.total, pack.alive, pack.demands)]
        assert torch.equal(pk.pack(*pargs, pack.mode),
                           pk.pack_plain(*pargs, pack.mode))
        torch.cuda.synchronize(dev)
        assert torch.equal(got, want) and torch.equal(got_avail, want_avail)

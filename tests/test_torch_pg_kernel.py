"""The port's placement-group packer (ray_tpu_torch._private.scheduler
.pg_kernel) against the JAX package's, on the same inputs, on the CPU.

The JAX side runs its jitted programs on the CPU, as its own tests run
them. The port's side is what a CPU tensor goes through: the plain
versions of its kernels (``pack_plain``, ``pack_batch_plain``).
Assignments are integers, so every comparison is exact: the programs
element for element, and ``PgKernelSolver.solve`` / ``solve_many`` node
for node on twin clusters built from the same node hex ids.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private.ids import NodeID as JNodeID
from ray_tpu._private.scheduler import pg_kernel as jpk
from ray_tpu._private.scheduler import resources as jres

ppk = importlib.import_module("ray_tpu_torch._private.scheduler.pg_kernel")
pres = importlib.import_module("ray_tpu_torch._private.scheduler.resources")
pids = importlib.import_module("ray_tpu_torch._private.ids")
wl = importlib.import_module("ray_tpu_torch._private.scheduler.workload")

STRATEGIES = ["PACK", "SPREAD", "STRICT_SPREAD", "STRICT_PACK"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _twins(specs, rng):
    """The same cluster in both packages: (jax cluster, port cluster, hex
    ids). ``specs`` is a list of (total, used) resource dicts."""
    jc, pc = jres.ClusterResourceManager(), pres.ClusterResourceManager()
    hexes = []
    for total, used in specs:
        h = rng.bytes(28).hex()
        avail = {k: v - used.get(k, 0.0) for k, v in total.items()}
        jc.add_or_update_node(JNodeID.from_hex(h), jres.NodeResources(
            total=dict(total), available=dict(avail)))
        pc.add_or_update_node(pids.NodeID.from_hex(h), pres.NodeResources(
            total=dict(total), available=dict(avail)))
        hexes.append(h)
    return jc, pc, hexes


def _hex(assign):
    return None if assign is None else [n.hex() for n in assign]


def _random_specs(rng, n):
    specs = []
    for _ in range(n):
        total = {"CPU": float(rng.choice([4, 8, 16])),
                 "memory": float(rng.choice([16, 64]))}
        if rng.rand() < 0.3:
            total["GPU"] = float(rng.choice([1, 4]))
        used = {"CPU": float(rng.randint(0, int(total["CPU"]) // 2 + 1))}
        specs.append((total, used))
    return specs


def _bundles(rng, b):
    out = []
    for _ in range(b):
        d = {"CPU": float(rng.choice([1, 2, 3]))}
        if rng.rand() < 0.5:
            d["memory"] = float(rng.choice([1, 4]))
        out.append(d)
    return out


@pytest.mark.parametrize("mode", ["pack", "spread", "strict_spread"])
def test_pack_program_equals_jax(mode):
    """pack_plain against _pack_kernel on the benchmark's cluster cut to
    2,000 nodes (every seventh dead) and its first 64 bundles."""
    w = wl.workload(np.random.RandomState(42), 2000, 1000)
    alive = w.alive.copy()
    alive[::7] = False
    arrays = (w.avail, w.total, alive, w.pg_demands[:64])
    want = np.asarray(jpk._pack_kernel(*(jnp.asarray(a) for a in arrays),
                                       mode))
    got = ppk.pack_plain(*(torch.from_numpy(a) for a in arrays), mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["pack", "spread", "strict_spread"])
@pytest.mark.parametrize("n_nodes,k", [(2000, 16), (40, 16)])
def test_pack_batch_program_equals_jax(mode, n_nodes, k):
    """pack_batch_plain against _pack_batch_kernel: 8 groups of 8 bundles,
    one group padded, at 2,000 nodes and with the deal wrapping past N
    (40 nodes < k G)."""
    w = wl.workload(np.random.RandomState(42), n_nodes, 1000)
    alive = w.alive.copy()
    alive[::7] = False
    demands = w.batch_demands[:8].copy()
    valid = np.ones(demands.shape[:2], bool)
    valid[3, 5:] = False
    demands[3, 5:] = 0.0
    arrays = (w.avail, w.total, alive, demands, valid)
    want = np.asarray(jpk._pack_batch_kernel(
        *(jnp.asarray(a) for a in arrays), mode, k))
    got = ppk.pack_batch_plain(*(torch.from_numpy(a) for a in arrays),
                               mode, k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_solve_matches_jax(strategy):
    """solve on twin random clusters gives the same node per bundle (or
    None in both), over several groups that land or do not fit."""
    rng = np.random.RandomState(11)
    jc, pc, _ = _twins(_random_specs(rng, 24), rng)
    jsol, psol = jpk.PgKernelSolver(), ppk.PgKernelSolver(device="cpu")
    outcomes = set()
    for b in (1, 3, 6, 12):
        bundles = _bundles(rng, b)
        want = _hex(jsol.solve(jc, bundles, strategy))
        assert _hex(psol.solve(pc, bundles, strategy)) == want
        outcomes.add(want is None)
    assert False in outcomes


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_solve_many_matches_jax(strategy):
    """solve_many on twin random clusters: the same assignments per group,
    including the groups that do not fit their candidate set."""
    rng = np.random.RandomState(12)
    jc, pc, _ = _twins(_random_specs(rng, 40), rng)
    groups = [_bundles(rng, int(rng.randint(1, 6))) for _ in range(6)]
    want = [_hex(a) for a in jpk.PgKernelSolver().solve_many(jc, groups,
                                                             strategy)]
    got = [_hex(a) for a in ppk.PgKernelSolver(device="cpu").solve_many(
        pc, groups, strategy)]
    assert got == want
    assert any(a is not None for a in got)


def test_solve_many_strict_spread_distinct_through_aliased_slots():
    """On a cluster smaller than the top-k deal (k G > N), one node is
    dealt into several slots of a group; STRICT_SPREAD still never places
    two bundles of a group on one node, and both packages agree."""
    rng = np.random.RandomState(13)
    specs = [({"CPU": 16.0}, {}), ({"CPU": 16.0}, {"CPU": 8.0}),
             ({"CPU": 16.0}, {"CPU": 10.0}), ({"CPU": 16.0}, {"CPU": 12.0})]
    jc, pc, _ = _twins(specs, rng)
    for n_groups in (2, 3):
        groups = [[{"CPU": 1.0}] * 3] * n_groups
        want = [_hex(a) for a in jpk.PgKernelSolver().solve_many(
            jc, groups, "STRICT_SPREAD")]
        got = [_hex(a) for a in ppk.PgKernelSolver(device="cpu").solve_many(
            pc, groups, "STRICT_SPREAD")]
        assert got == want
        for assign in got:
            if assign is not None:
                assert len(set(assign)) == 3, assign


def test_solve_many_strict_pack_no_single_node_fits():
    """STRICT_PACK whose bundle sum exceeds every node fails per group on
    the batched path and on the single path, in both packages."""
    rng = np.random.RandomState(14)
    jc, pc, _ = _twins([({"CPU": 16.0}, {})] * 8, rng)
    groups = [[{"CPU": 10.0}] * 3] * 4
    psol = ppk.PgKernelSolver(device="cpu")
    assert psol.solve_many(pc, groups, "STRICT_PACK") == [None] * 4
    assert jpk.PgKernelSolver().solve_many(jc, groups, "STRICT_PACK") == \
        [None] * 4
    assert psol.solve(pc, groups[0], "STRICT_PACK") is None


def test_port_solver_semantics():
    """The JAX package's own assertions (tests/test_pg_kernel.py) on the
    port's solver: PACK co-locates, SPREAD distributes, STRICT_SPREAD
    needs distinct nodes, STRICT_PACK needs one node that fits the sum."""
    rng = np.random.RandomState(15)

    def fresh(specs):   # a solver's view is keyed by its cluster's version
        _, pc, hexes = _twins(specs, rng)
        return pc, hexes, ppk.PgKernelSolver(device="cpu")

    pc, _, sol = fresh([({"CPU": 8.0}, {})] * 3)
    assert len(set(sol.solve(pc, [{"CPU": 2}] * 3, "PACK"))) == 1
    pc, _, sol = fresh([({"CPU": 8.0}, {})] * 4)
    assert len(set(sol.solve(pc, [{"CPU": 2}] * 4, "SPREAD"))) == 4
    pc, _, sol = fresh([({"CPU": 8.0}, {})] * 2)
    assert sol.solve(pc, [{"CPU": 1}] * 3, "STRICT_SPREAD") is None
    assert len(set(sol.solve(pc, [{"CPU": 1}] * 2, "STRICT_SPREAD"))) == 2
    pc, hexes, sol = fresh([({"CPU": 2.0}, {}), ({"CPU": 16.0}, {})])
    assert _hex(sol.solve(pc, [{"CPU": 4}] * 3, "STRICT_PACK")) == \
        [hexes[1]] * 3
    assert sol.solve(pc, [{"CPU": 10}] * 3, "STRICT_PACK") is None


def test_solver_dense_view_refreshes_rows():
    """Same version: the cached view, no snapshot; an allocation out of
    band: a row-wise refresh that sees it, still without a snapshot."""
    rng = np.random.RandomState(16)
    _, pc, hexes = _twins([({"CPU": 8.0}, {})] * 2, rng)
    sol = ppk.PgKernelSolver(device="cpu")
    assert sol.solve(pc, [{"CPU": 6}] * 2, "SPREAD") is not None
    snaps = {"n": 0}
    orig = pc.snapshot

    def counting_snapshot():
        snaps["n"] += 1
        return orig()

    pc.snapshot = counting_snapshot
    assert sol.solve(pc, [{"CPU": 6}] * 2, "SPREAD") is not None
    assert pc.allocate(pids.NodeID.from_hex(hexes[0]), {"CPU": 6})
    assert sol.solve(pc, [{"CPU": 6}] * 2, "SPREAD") is None
    pc.free(pids.NodeID.from_hex(hexes[0]), {"CPU": 6})
    assert sol.solve(pc, [{"CPU": 6}] * 2, "SPREAD") is not None
    assert snaps["n"] == 0


def test_solver_defaults_to_the_card():
    if torch.cuda.is_available():
        assert ppk.PgKernelSolver().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ppk.PgKernelSolver()

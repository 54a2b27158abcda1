"""The port's object plane under chaos (``_private/object_transfer.py``'s
``PullManager`` over ``RpcServer``, no cluster): the cases of
``tests/test_object_plane.py`` on ``ray_tpu_torch`` — pull dedup (one
wire fetch per object per node), failure-rerouted tree broadcast with
bounded per-link bytes, striped multi-source pulls that re-assign a dead
holder's ranges, spill-restored serves inside the admission budget, the
pickle-safe typed transfer taxonomy, and the restart-storm seal kill
(chaos point ``object.transfer.seal``).

Harness: each simulated node is a real ``ShmStore`` + ``PullManager``
+ ``RpcServer`` triple in this process, wired through ``serve_store``
with a private wire counter — per-link served bytes are observable
per node. Where the reference's race depends on thread start order,
the port's case waits for the condition it needs (with a deadline)
instead, so that it holds under load; no assertion differs.
"""

import glob
import os
import pickle
import subprocess
import sys
import threading
import time

import pytest

from ray_tpu_torch._private import chaos, wire_stats
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID
from ray_tpu_torch._private.object_store import ShmStore
from ray_tpu_torch._private.object_transfer import (PeerClients, PullManager,
                                              pull_counters,
                                              reset_counters,
                                              serve_store)
from ray_tpu_torch._private.rpc import RpcServer
from ray_tpu_torch.exceptions import (ObjectSourceLostError, ObjectTransferError,
                                ObjectTransferTimeoutError)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oid(i: int) -> ObjectID:
    return ObjectID.from_index(
        TaskID.for_normal_task(JobID.from_int(7)), i)


class _Node:
    """One simulated node: local store, pull engine, object server."""

    def __init__(self, name: str, tmp: str, capacity: int = 64 << 20,
                 threshold: float = 0.95, view_fn=None):
        self.name = name
        self.store = ShmStore(f"op{os.getpid()}-{name}",
                              capacity_bytes=capacity,
                              spill_dir=os.path.join(tmp, name),
                              spill_threshold=threshold)
        self.peers = PeerClients()
        self.pm = PullManager(self.store, self.peers, label=name)
        self.served = wire_stats.ChannelStats()
        self.server = RpcServer(component=f"objsrv_{name}")
        serve_store(self.server, view_fn or self._view,
                    progress=self.pm.progress, stats=self.served)
        self.addr = tuple(self.server.address)

    def _view(self, oid_bytes: bytes):
        return self.store.get_local(ObjectID(oid_bytes))

    def close(self) -> None:
        self.peers.close()
        self.server.shutdown()
        self.store.shutdown()


@pytest.fixture
def mesh(tmp_path):
    nodes = []

    def make(name, **kw):
        node = _Node(name, str(tmp_path), **kw)
        nodes.append(node)
        return node

    yield make
    for node in nodes:
        node.close()


def _wait_pulling(node: _Node, oid: ObjectID, timeout: float = 5.0):
    """Block until ``node`` either holds ``oid`` sealed or has the
    pull in flight (its serve side can stream chunks either way)."""
    deadline = time.monotonic() + timeout
    oid_b = oid.binary()
    while time.monotonic() < deadline:
        if node.store.contains(oid) \
                or node.pm.progress(oid_b, 0, 0) is not None:
            return
        time.sleep(0.002)
    raise AssertionError(f"{node.name} never began pulling {oid}")


# ---------------------------------------------------------------------------
# typed taxonomy


def test_transfer_taxonomy_is_pickle_safe_and_retryable():
    """The taxonomy crosses task and RPC boundaries: every class must
    round-trip pickle as ITSELF with its context attached, and carry
    the retryable contract (a failed pull sealed nothing)."""
    for cls in (ObjectTransferError, ObjectSourceLostError,
                ObjectTransferTimeoutError):
        err = cls("holder gone", object_id_hex="ab" * 14, offset=4096)
        back = pickle.loads(pickle.dumps(err))
        assert type(back) is cls
        assert isinstance(back, ObjectTransferError)
        assert back.object_id_hex == "ab" * 14
        assert back.offset == 4096
        assert back.retryable is True
        assert "holder gone" in str(back)


# ---------------------------------------------------------------------------
# pull dedup


def test_concurrent_pulls_dedupe_to_one_wire_fetch(mesh):
    """Six racing readers of one remote object drive exactly ONE wire
    transfer; the other five attach and wake on seal byte-identical.
    The source holds its serve until all five have attached (deadline
    30 s): a reader that started after the seal would find the object
    local and neither start nor attach, which only thread start order
    under load decides."""
    src_ref = {}

    def held_view(oid_bytes):
        deadline = time.monotonic() + 30.0
        while (pull_counters()["deduped"] < 5
               and time.monotonic() < deadline):
            time.sleep(0.002)
        return src_ref["node"].store.get_local(ObjectID(oid_bytes))

    src = src_ref["node"] = mesh("src", view_fn=held_view)
    dst = mesh("dst")
    oid = _oid(1)
    payload = os.urandom(2 << 20)
    src.store.put_blob(oid, payload)
    reset_counters()

    errors = []

    def pull():
        try:
            dst.pm.pull(oid.binary(), len(payload), (src.addr,))
        except BaseException as e:  # pragma: no cover - fail the test
            errors.append(e)

    threads = [threading.Thread(target=pull) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    counters = pull_counters()
    assert counters["started"] == 1
    assert counters["deduped"] == 5
    assert counters["failed"] == 0
    # one full copy crossed the wire, no more (5MiB chunks -> 1 frame)
    assert src.served.bytes == len(payload)
    view = dst.store.get_local(oid)
    assert bytes(view) == payload
    del view


# ---------------------------------------------------------------------------
# tree broadcast


def test_tree_broadcast_bounds_per_link_bytes(mesh):
    """8 consumers in a binary tree over one 4MiB object: every node
    re-serves chunks as soon as it holds them, so no single link
    carries more than ~2x the object (its two children), and the root
    serves one copy instead of eight."""
    cfg = get_config()
    cfg.apply_system_config({"object_chunk_size_bytes": 256 * 1024})
    try:
        root = mesh("root")
        consumers = [mesh(f"c{i}") for i in range(8)]
        oid = _oid(2)
        payload = os.urandom(4 << 20)
        root.store.put_blob(oid, payload)
        reset_counters()

        errors = []

        def pull(node, sources):
            try:
                node.pm.pull(oid.binary(), len(payload), sources)
            except BaseException as e:  # pragma: no cover
                errors.append((node.name, e))

        threads = []
        for k, node in enumerate(consumers):
            parent = root if k == 0 else consumers[(k - 1) // 2]
            # tree parent first, root as the re-route fallback — the
            # same order _pull_sources_for hands raylets
            _wait_pulling(parent, oid) if parent is not root else None
            t = threading.Thread(
                target=pull, args=(node, (parent.addr, root.addr)))
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors

        for node in consumers:
            view = node.store.get_local(oid)
            assert bytes(view) == payload      # byte-identical seals
            del view
        size = len(payload)
        # peak per-link bound: a node feeds at most its two children
        # (plus bounded re-route slack); the root is ONE link wide
        for node in (root, *consumers):
            assert node.served.bytes <= 2.5 * size, (
                f"{node.name} served {node.served.bytes} "
                f"(> 2.5x object size {size})")
        assert root.served.bytes <= 1.5 * size
        # fan-out actually happened: the first consumer fed its two
        # children at least one full copy's worth of chunks
        assert consumers[0].served.bytes >= size
        assert pull_counters()["started"] == 8
    finally:
        cfg.apply_system_config(
            {"object_chunk_size_bytes": 5 * 1024 * 1024})


# ---------------------------------------------------------------------------
# striped pulls


def test_striped_pull_reassigns_dead_holders_ranges(mesh):
    """A large object stripes across three sealed holders; one holder
    starts failing mid-transfer and ONLY its remaining ranges drain to
    the survivors — the pull still seals byte-identical. A survivor
    holds its first chunk until the other survivor has been asked for
    one too (deadline 30 s): the stripe workers share one queue, and
    under load one survivor's worker could otherwise drain it before
    the other's thread ran at all."""
    cfg = get_config()
    cfg.apply_system_config({"object_stripe_min_bytes": 256 * 1024,
                             "object_chunk_size_bytes": 64 * 1024})
    try:
        oid = _oid(3)
        payload = os.urandom(1 << 20)       # 16 chunks

        calls = {"n": 0}
        asked = {"h0": 0, "h1": 0}      # the survivors' calls so far
        asked_lock = threading.Lock()
        holders = []

        def make_holder(name, dies=False):
            node_ref = {}

            def view(oid_bytes):
                if dies:
                    calls["n"] += 1
                    if calls["n"] > 3:  # 1 stripe probe + 2 chunks
                        raise RuntimeError("holder crashed")
                else:
                    with asked_lock:
                        asked[name] += 1
                        mine = asked[name]
                    deadline = time.monotonic() + 30.0
                    # past the probe: wait for both survivors' first chunk
                    while (mine >= 2 and min(asked.values()) < 2
                           and time.monotonic() < deadline):
                        time.sleep(0.002)
                return node_ref["node"].store.get_local(
                    ObjectID(oid_bytes))

            node = mesh(name, view_fn=view)
            node_ref["node"] = node
            node.store.put_blob(oid, payload)
            holders.append(node)
            return node

        make_holder("h0")
        make_holder("h1")
        make_holder("h2", dies=True)
        dst = mesh("puller")
        reset_counters()
        dst.pm.pull(oid.binary(), len(payload),
                    tuple(h.addr for h in holders))
        counters = pull_counters()
        assert counters["striped"] == 1
        assert counters["failed"] == 0
        view = dst.store.get_local(oid)
        assert bytes(view) == payload
        del view
        # the dead holder served at most its pre-crash chunks; the
        # survivors carried the rest of the stripe set between them
        assert holders[2].served.bytes <= 2 * 64 * 1024
        assert (holders[0].served.bytes + holders[1].served.bytes
                >= len(payload) - 2 * 64 * 1024)
        assert holders[0].served.bytes > 0
        assert holders[1].served.bytes > 0
    finally:
        cfg.apply_system_config(
            {"object_stripe_min_bytes": 32 * 1024 * 1024,
             "object_chunk_size_bytes": 5 * 1024 * 1024})


# ---------------------------------------------------------------------------
# spill-restore + admission budget


def test_spilled_source_serves_and_pulls_respect_admission(mesh):
    """Restored-from-spill serves work transparently, and a storm of
    concurrent pulls on the destination queues at the admission gate —
    unsealed pull buffers never exceed the configured budget."""
    cap = 600_000
    cfg = get_config()
    cfg.apply_system_config({"object_pull_max_inflight_bytes": cap})
    try:
        src = mesh("spilly", capacity=2 << 20, threshold=0.5)
        dst = mesh("sink")
        payloads = {}
        for i in range(4):
            oid = _oid(10 + i)
            payloads[oid] = os.urandom(512 * 1024)
            src.store.put_blob(oid, payloads[oid])
        assert src.store.num_spilled > 0    # the source really spilled

        peak = {"v": 0}
        stop = threading.Event()

        def sample():
            while not stop.is_set():
                peak["v"] = max(peak["v"], dst.pm.inflight_bytes())
                time.sleep(0.0005)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        errors = []

        def pull(oid, n):
            try:
                dst.pm.pull(oid.binary(), n, (src.addr,))
            except BaseException as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=pull, args=(oid, len(p)))
                   for oid, p in payloads.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        stop.set()
        sampler.join(timeout=5)
        assert not errors
        assert src.store.num_restored > 0   # serves restored on demand
        assert 0 < peak["v"] <= cap, (
            f"unsealed pull buffers peaked at {peak['v']} > {cap}")
        for oid, payload in payloads.items():
            view = dst.store.get_local(oid)
            assert bytes(view) == payload
            del view
    finally:
        cfg.apply_system_config(
            {"object_pull_max_inflight_bytes": 256 * 1024 * 1024})


# ---------------------------------------------------------------------------
# fetch-path chaos (drop / sever) converges through typed retries


def test_fetch_chaos_drop_and_sever_retried_in_budget(mesh):
    src = mesh("src")
    dst = mesh("dst")
    oid = _oid(20)
    payload = os.urandom(256 * 1024)
    src.store.put_blob(oid, payload)
    chaos.install_phase("objplane-test",
                        ["object.transfer.fetch:drop@1x2",
                         "object.transfer.fetch:sever@4"])
    try:
        dst.pm.pull(oid.binary(), len(payload), (src.addr,))
    finally:
        chaos.clear_phase("objplane-test")
    fired = [e for e in chaos.events()
             if e[:3] == ("object", "transfer", "fetch")]
    assert ("object", "transfer", "fetch", "drop") in fired
    view = dst.store.get_local(oid)
    assert bytes(view) == payload
    del view


def test_exhausted_sources_raise_typed_source_lost(mesh):
    dst = mesh("lonely")
    oid = _oid(21)
    with pytest.raises(ObjectSourceLostError) as ei:
        dst.pm.pull(oid.binary(), 1024,
                    (("127.0.0.1", 1),),       # nothing listens there
                    deadline_s=3.0)
    assert ei.value.object_id_hex == oid.binary().hex()
    assert ei.value.retryable is True


# ---------------------------------------------------------------------------
# the restart-storm death: kill at seal, survivors re-serve

_SEAL_KILL_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.object_store import ShmStore
from ray_tpu_torch._private.object_transfer import PeerClients, PullManager

host, port, oid_hex, size, spill = sys.argv[2:7]
chaos.install("object.transfer.seal:kill@1")
store = ShmStore("sealkill%d" % os.getpid(), capacity_bytes=32 << 20,
                 spill_dir=spill, spill_threshold=0.9)
pm = PullManager(store, PeerClients(), label="victim")
pm.pull(bytes.fromhex(oid_hex), int(size), ((host, int(port)),))
print("survived-seal")          # unreachable if the kill landed
sys.exit(3)
"""


def test_seal_kill_leaves_survivors_consistent(mesh, tmp_path):
    """Restart-storm shape: a consumer dies AT seal time holding a
    complete unsealed buffer. The death is abrupt (chaos kill), the
    source keeps serving, and a later consumer listing the corpse
    first fails over typed-only and seals byte-identical."""
    src = mesh("src")
    oid = _oid(30)
    payload = os.urandom(512 * 1024)
    src.store.put_blob(oid, payload)

    try:
        out = subprocess.run(
            [sys.executable, "-c", _SEAL_KILL_CHILD, REPO_ROOT,
             src.addr[0], str(src.addr[1]), oid.binary().hex(),
             str(len(payload)), str(tmp_path / "victim-spill")],
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode == chaos.KILL_EXIT_CODE, out.stderr
        assert "survived-seal" not in out.stdout
    finally:
        # the kill is an os._exit with a complete UNSEALED buffer —
        # the victim's shm segment outlives it by design (that is the
        # restart-storm shape); reap the corpse's segment here
        for seg in glob.glob("/dev/shm/rtpt_sealkill*"):
            try:
                os.unlink(seg)
            except OSError:
                pass

    # a later consumer lists the corpse's (never-served) address
    # first: connect fails TRANSIENT, fails over, seals identical
    late = mesh("late")
    reset_counters()
    late.pm.pull(oid.binary(), len(payload),
                 (("127.0.0.1", 1), src.addr), deadline_s=30.0)
    assert pull_counters()["failed"] == 0
    view = late.store.get_local(oid)
    assert bytes(view) == payload
    del view

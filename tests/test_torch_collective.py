"""The port's actor-level collective groups
(``ray_tpu_torch/collective/collective.py``): the ``shm`` cases of the
JAX package's ``test_collective.py`` — the operations, the rendezvous
directory's teardown, gang abort on a member's death, the coordinated
restart with the epoch bumped and the epoch fence — plus torch tensors
as inputs and the refusal of ``nccl``/``gloo``. Its group root is
``/dev/shm/ray_tpu_torch_coll``, apart from the JAX package's."""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import collective as col
from ray_tpu_torch._private import chaos
from ray_tpu_torch.exceptions import CollectiveAbortError


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Member:
    def ping(self):
        return "up"

    def _join_collective_group(self, world, rank, backend, name):
        # Join timeout well under the get() timeouts below: a member
        # crash aborts peers via the liveness marker in milliseconds,
        # so the rendezvous deadline is a backstop, not the fast path.
        col.init_collective_group(world, rank, backend, name,
                                  timeout_s=20.0)
        self._group = name
        return rank

    def group_epoch(self):
        return col.get_group_epoch(self._group)

    def do_allreduce(self, value):
        return col.allreduce(np.asarray(value, np.float32), self._group)

    def do_allgather(self, value):
        return col.allgather(np.asarray(value, np.float32), self._group)

    def do_reducescatter(self, value):
        return col.reducescatter(np.asarray(value, np.float32), self._group)

    def do_broadcast(self, value, src):
        return col.broadcast(np.asarray(value, np.float32), src,
                             self._group)

    def do_sendrecv(self, value, peer, is_sender):
        if is_sender:
            col.send(np.asarray(value, np.float32), peer, self._group)
            return None
        return col.recv(peer, self._group)

    def do_tensor_allreduce(self, value):
        import torch as _torch
        return col.allreduce(_torch.tensor(value, dtype=_torch.float32),
                             self._group)

    def do_allreduce_in_thread(self, value):
        """From a thread of the actor's own making, which carries no
        actor identity: the process's one membership still answers."""
        import threading
        out = {}
        t = threading.Thread(target=lambda: out.update(
            v=col.allreduce(np.asarray(value, np.float32), self._group)))
        t.start()
        t.join(timeout=30)
        return out["v"]

    def leave(self):
        col.destroy_collective_group(self._group)
        return True


@pytest.fixture
def members(ray_start_regular):
    ms = [Member.options(num_cpus=0.5).remote() for _ in range(2)]
    name = col.create_collective_group(ms, world_size=2, ranks=[0, 1])
    yield ms, name
    ray_tpu_torch.get([m.leave.remote() for m in ms], timeout=30)
    col.destroy_collective_group(name)   # driver side: gang record too


def test_allreduce_and_allgather(members):
    ms, _ = members
    # A member crash now fails these gets in seconds via the abort
    # marker (liveness-aware _wait_load), so the old 60s worst-case
    # get timeouts are down to a bound that keeps tier-1 wall-clock
    # tight even when something does break.
    outs = ray_tpu_torch.get(
        [m.do_allreduce.remote([float(i + 1)] * 3)
         for i, m in enumerate(ms)], timeout=30)
    for o in outs:
        np.testing.assert_allclose(o, [3.0, 3.0, 3.0])
    gathers = ray_tpu_torch.get(
        [m.do_allgather.remote([float(i)]) for i, m in enumerate(ms)],
        timeout=30)
    for g in gathers:
        np.testing.assert_allclose(np.concatenate(g), [0.0, 1.0])


def test_reducescatter_broadcast_sendrecv(members):
    ms, _ = members
    outs = ray_tpu_torch.get(
        [m.do_reducescatter.remote([1.0, 2.0, 3.0, 4.0])
         for m in ms], timeout=30)
    np.testing.assert_allclose(outs[0], [2.0, 4.0])
    np.testing.assert_allclose(outs[1], [6.0, 8.0])

    outs = ray_tpu_torch.get(
        [m.do_broadcast.remote([float(i) * 7], 1)
         for i, m in enumerate(ms)], timeout=30)
    for o in outs:
        np.testing.assert_allclose(o, [7.0])

    r_send = ms[0].do_sendrecv.remote([5.0, 6.0], 1, True)
    r_recv = ms[1].do_sendrecv.remote(None, 0, False)
    ray_tpu_torch.get(r_send, timeout=30)
    np.testing.assert_allclose(ray_tpu_torch.get(r_recv, timeout=30),
                               [5.0, 6.0])


def test_destroy_cleans_rendezvous_dir(members):
    """Leak check: generation dirs and rank files live under the group
    root; destroy tears the whole root down so group-name reuse can
    never collide with stale artifacts."""
    ms, name = members
    ray_tpu_torch.get([m.do_allreduce.remote([1.0]) for m in ms], timeout=30)
    root = col.group_root(name)
    assert os.path.isdir(root)
    assert any(p.startswith("ep_") for p in os.listdir(root))
    ray_tpu_torch.get([m.leave.remote() for m in ms], timeout=30)
    assert not os.path.exists(root)     # nothing leaks on destroy


def _armed_member_pair():
    """(doomed, survivor) Member actors where ONLY the doomed one's
    worker process carries the mid-allreduce chaos kill rule. The
    runtime must run with max_process_workers=1: the pool spawns ahead
    during creation retries, and a second worker spawned while the env
    rule is set would arm the survivor too."""
    os.environ[chaos.ENV_VAR] = "collective.rendezvous.save_ar:kill@1"
    try:
        doomed = Member.options(num_cpus=0.5).remote()
        assert ray_tpu_torch.get(doomed.ping.remote(), timeout=60) == "up"
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
    survivor = Member.options(num_cpus=0.5).remote()
    assert ray_tpu_torch.get(survivor.ping.remote(), timeout=60) == "up"
    return doomed, survivor


def test_gang_member_death_aborts_restarts_and_fences():
    """Acceptance: a gang member chaos-killed mid-allreduce

    - aborts every surviving rank with CollectiveAbortError well under
      the group timeout (< 5s; the join deadline is 20s),
    - triggers ONE coordinated gang restart with the epoch bumped,
    - a post-restart allreduce at the new epoch returns correct values,
    - an injected stale-epoch rank file from the old incarnation is
      provably ignored (correct results, no hang), and
    - the gang gauges move.
    """
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=1)
    doomed, survivor = _armed_member_pair()
    ms = [doomed, survivor]
    name = col.create_collective_group(ms, world_size=2, ranks=[0, 1],
                                       gang_max_restarts=1)
    try:
        info = w.gcs.get_gang_info(name)
        assert info.state == "ALIVE" and info.epoch == 1

        # Submit the SURVIVOR first and wait (deadline 30 s) until it is
        # inside the allreduce (its rank file landed) before the doomed
        # rank runs: a survivor call still queued at the death would be
        # replayed after the restart as a half-gang collective (the
        # queued-call semantics), which is not this scenario; under load
        # its dispatch can trail the doomed rank's.
        ep1 = os.path.join(col.group_root(name), "ep_00000001")
        r1 = survivor.do_allreduce.remote([2.0])
        deadline = time.monotonic() + 30
        while not any(os.path.exists(os.path.join(ep1, gen, "rank_1.npy"))
                      for gen in (os.listdir(ep1) if os.path.isdir(ep1)
                                  else ()) if gen.startswith("ar_")):
            assert time.monotonic() < deadline, (
                "survivor never entered the allreduce")
            time.sleep(0.01)
        t0 = time.monotonic()
        r0 = doomed.do_allreduce.remote([1.0])
        # rank 0 dies at the rank-file save (chaos kill): its own call
        # fails with a system error...
        with pytest.raises(Exception) as exc0:
            ray_tpu_torch.get(r0, timeout=30)
        assert not isinstance(exc0.value, ray_tpu_torch.exceptions.GetTimeoutError)
        # ...and the surviving rank aborts out of its 20s rendezvous
        # deadline in well under 5s via the liveness/abort marker —
        # typed, retryable, and carrying the fenced incarnation.
        with pytest.raises(CollectiveAbortError) as exc1:
            ray_tpu_torch.get(r1, timeout=30)
        assert exc1.value.retryable
        assert exc1.value.group == name and exc1.value.epoch == 1
        assert time.monotonic() - t0 < 5.0, (
            "surviving rank burned the rendezvous deadline instead of "
            "aborting on member death")

        # the gang restarts exactly once, re-forming at epoch 2
        deadline = time.monotonic() + 60
        info = None
        while time.monotonic() < deadline:
            info = w.gcs.get_gang_info(name)
            if info is not None and info.state == "ALIVE" \
                    and info.epoch == 2:
                break
            time.sleep(0.05)
        assert info is not None and info.state == "ALIVE", info
        assert info.epoch == 2 and info.num_aborts == 1
        assert info.num_restarts == 1
        assert w.num_gang_aborts == 1 and w.num_gang_restarts == 1

        # the old incarnation's artifacts were scrubbed by the restart
        root = col.group_root(name)
        leftovers = [p for p in os.listdir(root)
                     if (p.startswith("ep_") or p.startswith("aborted_"))
                     and not p.endswith("00000002")]
        assert leftovers == [], f"stale incarnation leaked: {leftovers}"

        # epoch fencing: inject a stale rank file where the OLD
        # incarnation's next allreduce generation would have lived —
        # without the fence this is exactly the path a resurrected
        # epoch-1 writer (or an unfenced layout) would collide on.
        stale_gen = os.path.join(root, "ep_00000001", "ar_00000002")
        os.makedirs(stale_gen)
        for r in range(2):
            with open(os.path.join(stale_gen, f"rank_{r}.npy"), "wb") as f:
                np.save(f, np.asarray([99.0], np.float32))

        # post-restart allreduce at the new epoch: correct values (the
        # stale 99s are provably ignored), no hang.
        epochs = ray_tpu_torch.get([m.group_epoch.remote() for m in ms],
                             timeout=60)
        assert epochs == [2, 2]
        outs = ray_tpu_torch.get(
            [m.do_allreduce.remote([float(i + 1)])
             for i, m in enumerate(ms)], timeout=30)
        for o in outs:
            np.testing.assert_allclose(o, [3.0])

        # observability: all three gang gauges moved
        from ray_tpu_torch.util import metrics
        text = metrics.prometheus_text()
        lines = dict()
        for line in text.splitlines():
            if line.startswith("ray_tpu_gang"):
                key, val = line.rsplit(" ", 1)
                lines[key] = float(val)
        assert lines.get("ray_tpu_gang_aborts") == 1.0
        assert lines.get("ray_tpu_gang_restarts") == 1.0
        assert lines.get(f'ray_tpu_gang_epoch{{group="{name}"}}') == 2.0
    finally:
        col.destroy_collective_group(name)
        ray_tpu_torch.shutdown()


def test_gang_budget_exhausted_surfaces_actor_death():
    """With gang_max_restarts=0 a member death kills the gang: the dead
    member surfaces ActorDiedError to callers, survivors' collectives
    abort, and the gang is DEAD with its epoch fenced."""
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=1)
    doomed, survivor = _armed_member_pair()
    ms = [doomed, survivor]
    name = col.create_collective_group(ms, world_size=2, ranks=[0, 1],
                                       gang_max_restarts=0)
    try:
        r0 = doomed.do_allreduce.remote([1.0])
        r1 = survivor.do_allreduce.remote([2.0])
        with pytest.raises(Exception):
            ray_tpu_torch.get(r0, timeout=30)
        with pytest.raises(CollectiveAbortError):
            ray_tpu_torch.get(r1, timeout=30)

        deadline = time.monotonic() + 30
        info = None
        while time.monotonic() < deadline:
            info = w.gcs.get_gang_info(name)
            if info is not None and info.state == "DEAD":
                break
            time.sleep(0.05)
        assert info is not None and info.state == "DEAD"
        # no restart: the member stays dead and callers see it
        from ray_tpu_torch.exceptions import ActorDiedError
        with pytest.raises(ActorDiedError):
            ray_tpu_torch.get(doomed.ping.remote(), timeout=30)
    finally:
        col.destroy_collective_group(name)
        ray_tpu_torch.shutdown()


def test_p2p_fails_fast_on_aborted_epoch_at_entry(tmp_path, monkeypatch):
    """Entry-check audit (every public op must fail fast on a fenced
    incarnation): a payload queued BEFORE the abort must not be
    consumed at the aborted epoch — without recv's entry check, the
    pre-abort send's file satisfies the poll immediately and the
    fence never fires."""
    monkeypatch.setenv("RAY_TPU_COLL_DIR", str(tmp_path))
    monkeypatch.setattr(col.collective, "_BASE", str(tmp_path))
    name = "torch_p2p_abort_entry"
    col.init_collective_group(1, 0, "shm", name, timeout_s=5.0)
    try:
        # queue a payload, THEN fence the epoch
        col.send(np.asarray([1.0], np.float32), 0, name)
        col.write_abort_marker(col.group_root(name), 1, "test fence")
        t0 = time.monotonic()
        with pytest.raises(CollectiveAbortError):
            col.recv(0, name)
        with pytest.raises(CollectiveAbortError):
            col.send(np.asarray([2.0], np.float32), 0, name)
        with pytest.raises(CollectiveAbortError):
            col.reducescatter(np.zeros(2, np.float32), name)
        assert time.monotonic() - t0 < 1.0, "entry checks must not poll"
    finally:
        col.destroy_collective_group(name)


def test_recv_racing_gang_abort_fails_typed():
    """Regression (point-to-point op racing a gang abort): a rank
    blocked in recv when a peer's death fences the gang aborts typed
    well under the group timeout — the in-poll marker check covers
    p2p waits just like the reduction ops."""
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=1)
    doomed, survivor = _armed_member_pair()
    ms = [doomed, survivor]
    name = col.create_collective_group(ms, world_size=2, ranks=[0, 1],
                                       gang_max_restarts=0)
    try:
        t0 = time.monotonic()
        # rank 1 blocks in recv(0); rank 0 dies at its next allreduce
        # rank-file save (the armed rule), fencing the gang
        r_recv = survivor.do_sendrecv.remote(None, 0, False)
        r_dead = doomed.do_allreduce.remote([1.0])
        with pytest.raises(Exception):
            ray_tpu_torch.get(r_dead, timeout=30)
        with pytest.raises(CollectiveAbortError) as exc:
            ray_tpu_torch.get(r_recv, timeout=30)
        assert exc.value.group == name and exc.value.epoch == 1
        assert time.monotonic() - t0 < 10.0, (
            "recv burned the rendezvous deadline instead of aborting "
            "on the gang fence")
    finally:
        col.destroy_collective_group(name)
        ray_tpu_torch.shutdown()


def test_tensor_inputs_reduce_to_numpy(members):
    """A ``torch.Tensor`` goes in (``_as_np`` takes its host copy); the
    result is numpy, as the reference's operations return."""
    ms, _ = members
    outs = ray_tpu_torch.get(
        [m.do_tensor_allreduce.remote([float(i + 1), 2.0])
         for i, m in enumerate(ms)], timeout=30)
    for o in outs:
        assert isinstance(o, np.ndarray)
        np.testing.assert_allclose(o, [3.0, 4.0])


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_device_backends_point_to_the_device_plane(backend):
    with pytest.raises(ValueError, match="ray_tpu_torch.collective.xla"):
        col.init_collective_group(2, 0, backend, "torch_refused")


def test_collective_from_a_thread_of_the_actor(members):
    ms, _ = members
    outs = ray_tpu_torch.get(
        [ms[0].do_allreduce_in_thread.remote([1.0, 2.0]),
         ms[1].do_allreduce.remote([3.0, 4.0])], timeout=30)
    for o in outs:
        np.testing.assert_allclose(o, [4.0, 6.0])


def test_two_members_on_threads_of_one_process(ray_start_regular):
    """GPU-demand actors run on threads of the driver: two ranks of one
    group in one process each keep their own membership."""
    ms = [Member.options(num_gpus=1).remote() for _ in range(2)]
    name = col.create_collective_group(ms, world_size=2, ranks=[0, 1])
    try:
        x = [torch.arange(4.0) + 10 * i for i in range(2)]
        outs = ray_tpu_torch.get(
            [m.do_tensor_allreduce.remote(v.tolist()) for m, v in zip(ms, x)],
            timeout=30)
        for o in outs:
            np.testing.assert_allclose(o, (x[0] + x[1]).numpy())
        assert ray_tpu_torch.get(
            [m.group_epoch.remote() for m in ms]) == [1, 1]
        ray_tpu_torch.get([m.leave.remote() for m in ms], timeout=30)
    finally:
        col.destroy_collective_group(name)

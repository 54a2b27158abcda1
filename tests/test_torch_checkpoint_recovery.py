"""The port's stateful recovery plane (``_private/actor_checkpoint.py``,
``durable``, ``chaos`` and the worker's restart/restore path): the cases
of ``tests/test_checkpoint_recovery.py`` on ``ray_tpu_torch`` —
checkpointable actors, gang-consistent two-phase commits,
restore-before-replay restarts — the plane ``MultiSliceTrainer``'s
recovery stands on. Files only under ``tmp_path`` and the runtime's own
session directory.

All failures are chaos-seeded and deterministic; every wait is
liveness-driven with an explicit deadline, so wall-clock stays bounded
even when something breaks.
"""

import json
import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import collective as col
from ray_tpu_torch._private import actor_checkpoint as ackpt
from ray_tpu_torch._private import chaos


def _poll(predicate, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@ray_tpu_torch.remote(max_restarts=1, max_task_retries=2,
                checkpoint_interval=1)
class Counter:
    """Checkpointable actor: a step counter plus an external
    side-effect log (one line per executed bump — the double-execution
    detector)."""

    def __init__(self):
        self.n = 0

    def ping(self):
        return "up"

    def bump(self, path):
        self.n += 1
        with open(path, "a") as f:
            f.write(f"{self.n}\n")
        return self.n

    def value(self):
        return self.n

    def __ray_save__(self):
        return {"n": self.n}

    def __ray_restore__(self, state):
        self.n = state["n"]


def _spawn_armed(cls, rule, **opts):
    """Create an actor whose (sole) worker process carries ``rule``;
    the runtime must run max_process_workers=1 so no other worker
    spawns while the env rule is set (test idiom)."""
    os.environ[chaos.ENV_VAR] = rule
    try:
        a = cls.options(**opts).remote() if opts else cls.remote()
        assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "up"
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
    return a


def test_actor_restores_committed_state_and_replays_no_side_effects(
        tmp_path):
    """A chaos-killed checkpointable actor restarts, restores its last
    COMMITTED generation, and the replay is trimmed to calls after the
    checkpoint cursor: every side effect happens exactly once and the
    restored state is bit-identical to the pre-kill committed state."""
    ray_tpu_torch.shutdown()
    marker = tmp_path / "bumps.txt"
    w = ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_process_workers=1)
    try:
        # kill at the 4th bump's exec entry (before its user code ran:
        # the retried attempt replays it exactly once)
        a = _spawn_armed(Counter, "worker.exec.Counter.bump:kill@4")
        refs = [a.bump.remote(str(marker)) for _ in range(6)]
        assert ray_tpu_torch.get(refs, timeout=120) == [1, 2, 3, 4, 5, 6]
        # exactly-once side effects across the kill/restore/replay
        assert marker.read_text().splitlines() == [str(i)
                                                  for i in range(1, 7)]
        assert ray_tpu_torch.get(a.value.remote(), timeout=30) == 6
        info = w.gcs.get_actor_info(a._actor_id)
        assert info.num_restarts == 1
        # the GCS checkpoint table records only committed generations
        ck = w.gcs.get_checkpoint(a._actor_id)
        assert ck is not None and ck.gen >= 4 and ck.gang is None
        root = ackpt.actor_ckpt_dir(w.session, a._actor_id.binary())
        assert os.path.exists(ackpt.commit_marker_path(root, ck.gen))
        # gauges: saves committed, exactly one restore, nothing torn
        assert w.num_ckpt_saved >= 4
        assert w.num_ckpt_restored == 1
        assert w.ckpt_bytes_total > 0
        assert w.last_restore_ms >= 0.0
    finally:
        ray_tpu_torch.shutdown()


def test_mid_save_kill_leaves_previous_generation_intact(tmp_path):
    """A kill injected mid-save (generation staged, not yet renamed)
    must leave the previous committed generation as the restore point
    and provably discard the torn stage."""
    ray_tpu_torch.shutdown()
    marker = tmp_path / "bumps.txt"
    w = ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_process_workers=1)
    try:
        # saves fire after ping (gen1), bump1 (gen2), bump2 (gen3):
        # die mid-save of gen3 — bump2's reply already shipped, its
        # state only lives in the torn stage
        a = _spawn_armed(Counter, "actor.checkpoint.save:kill@3")
        assert ray_tpu_torch.get(a.bump.remote(str(marker)), timeout=60) == 1
        # bump2's reply ships BEFORE the autosave (FIFO contract), so
        # the result arrives even though the worker dies saving gen3
        assert ray_tpu_torch.get(a.bump.remote(str(marker)), timeout=60) == 2
        _poll(lambda: w.gcs.get_actor_info(a._actor_id).num_restarts
              == 1, 30, "actor restart")
        _poll(lambda: w.gcs.get_actor_info(a._actor_id).state
              == "ALIVE", 30, "actor ALIVE")
        # BEFORE any new call (whose own autosave would stage a fresh
        # tmp dir): the torn gen3 stage was discarded at restore and
        # the committed frontier is still gen2
        root = ackpt.actor_ckpt_dir(w.session, a._actor_id.binary())
        names = os.listdir(root)
        assert not any(".tmp" in n for n in names), names
        assert not os.path.exists(ackpt.commit_marker_path(root, 3))
        ck = w.gcs.get_checkpoint(a._actor_id)
        assert ck is not None and ck.gen == 2
        # restored state is gen2's (ping + bump1): n == 1 — bump2's
        # mutation lived only in the torn stage and is gone, exactly
        # the committed-or-nothing contract
        assert ray_tpu_torch.get(a.value.remote(), timeout=60) == 1
        assert w.num_ckpt_restored == 1
    finally:
        ray_tpu_torch.shutdown()


def test_dropped_commit_marker_discards_generation(tmp_path):
    """Two-phase safety, solo flavor: a saved generation whose COMMIT
    marker never lands (chaos drop at the driver's commit site) is
    invisible to the GCS table and provably discarded at restore — the
    actor comes back from the previous committed generation."""
    ray_tpu_torch.shutdown()
    marker = tmp_path / "bumps.txt"
    w = ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_process_workers=1)
    try:
        # driver-side rule: the 2nd commit (gen2, covering bump1) is
        # dropped; gen1 (covering ping) stays the committed frontier
        chaos.install("actor.checkpoint.commit:drop@2")
        a = _spawn_armed(Counter, "worker.exec.Counter.bump:kill@2",
                         max_task_retries=2)
        assert ray_tpu_torch.get(a.bump.remote(str(marker)), timeout=60) == 1
        _poll(lambda: (w.gcs.get_checkpoint(a._actor_id) or
                       None) is not None, 30, "first commit")
        assert w.gcs.get_checkpoint(a._actor_id).gen == 1
        # bump2 dies at exec entry -> restart -> restore. gen2 was
        # saved but never committed: restore discards it and comes
        # back from gen1 (n == 0, cursor == 1), then replays bump2.
        assert ray_tpu_torch.get(a.bump.remote(str(marker)), timeout=120) == 1
        assert ray_tpu_torch.get(a.value.remote(), timeout=30) == 1
        info = w.gcs.get_actor_info(a._actor_id)
        assert info.num_restarts == 1
        assert w.num_ckpt_discarded >= 1   # the dropped commit + the
        #                                    discarded on-disk stage
        # the replayed bump re-saves a FRESH gen2 (cursor 3 = the
        # replayed call's seq); the dropped generation's cursor was 2
        # — proving the uncommitted one was discarded, not reused
        root = ackpt.actor_ckpt_dir(w.session, a._actor_id.binary())
        _, meta = ackpt.load_generation(root, 2)
        assert meta["cursor"] == 3, meta
    finally:
        chaos.clear()
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# gang-consistent checkpoints (the acceptance scenario)


@ray_tpu_torch.remote(max_restarts=4, max_task_retries=0,
                checkpoint_interval=1)
class Trainer:
    """One SPMD gang member: state advances via an allreduced step.
    max_task_retries=0 — the DRIVER re-drives a failed step after the
    gang re-forms (an auto-replayed half-gang collective would only
    time out)."""

    def __init__(self):
        self.state = np.zeros(3, np.float64)
        self.steps = 0
        self.log_path = None

    def ping(self):
        return "up"

    def arm(self, rule):
        chaos.install(rule)
        return True

    def set_log(self, path):
        self.log_path = path
        return True

    def _join_collective_group(self, world, rank, backend, name):
        col.init_collective_group(world, rank, backend, name,
                                  timeout_s=20.0)
        self._group = name
        return rank

    def step(self, value):
        # allreduce FIRST: a member killed mid-collective dies before
        # mutating state, so the re-driven step is side-effect clean
        out = col.allreduce(np.asarray([value] * 3, np.float64),
                            self._group)
        self.state = self.state + out
        self.steps += 1
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(f"{self.steps}\n")
        return self.steps

    def snapshot(self):
        return self.steps, self.state

    def __ray_save__(self):
        return {"state": self.state, "steps": self.steps,
                "log_path": self.log_path}

    def __ray_restore__(self, st):
        self.state = st["state"]
        self.steps = st["steps"]
        self.log_path = st["log_path"]


def test_trainer_gang_resumes_from_last_committed_step(tmp_path):
    """Acceptance: a 2-member trainer gang with checkpoint_interval is
    chaos-killed mid-step after K=2 committed steps; the gang restarts
    (path), every rank restores the newest FULLY committed
    generation, training resumes at step K+1 with bit-identical state,
    no pre-checkpoint side effects replay, a partial (one-rank)
    save provably never commits, and the checkpoint gauges move."""
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=1)
    logs = [tmp_path / "rank0.txt", tmp_path / "rank1.txt"]
    try:
        # rank 0 dies at its 3rd allreduce rank-file save = step 3
        doomed = _spawn_armed(
            Trainer, "collective.rendezvous.save_ar:kill@3",
            num_cpus=0.5)
        survivor = Trainer.options(num_cpus=0.5).remote()
        assert ray_tpu_torch.get(survivor.ping.remote(), timeout=60) == "up"
        ms = [doomed, survivor]
        ray_tpu_torch.get([m.set_log.remote(str(p))
                     for m, p in zip(ms, logs)], timeout=30)
        name = col.create_collective_group(ms, world_size=2,
                                           ranks=[0, 1],
                                           gang_max_restarts=1)

        # K = 2 steps; wait until BOTH ranks' post-step-2 generation
        # is committed (two-phase: the table only shows full commits)
        for k in (1, 2):
            assert ray_tpu_torch.get([m.step.remote(float(k)) for m in ms],
                               timeout=30) == [k, k]
        # step-2's call seq is 5 per rank (ping, set_log, join, step1,
        # step2): poll until the generation with that cursor committed
        # on BOTH ranks (two-phase: the table only shows full commits)
        gens = _poll(
            lambda: (lambda a, b: (a, b) if a and b and a.gen == b.gen
                     and a.cursor == 5 == b.cursor else None)(
                w.gcs.get_checkpoint(ms[0]._actor_id),
                w.gcs.get_checkpoint(ms[1]._actor_id)),
            30, "both ranks' step-2 checkpoint to commit")
        committed_gen = gens[0].gen
        assert gens[0].gang == name and gens[1].gang == name

        # step 3: rank 0 dies mid-allreduce; the survivor aborts
        # typed and fast (liveness marker), the gang restarts once.
        # Submit the SURVIVOR first and wait until it is provably
        # inside the allreduce (its rank file landed) before letting
        # the doomed rank run — a survivor whose call were still
        # queued at abort time would instead replay it post-restart
        # as a half-gang collective (the known queued-call
        # semantics), which is not this scenario.
        ep1 = os.path.join(col.group_root(name), "ep_00000001")
        before = set(os.listdir(ep1))
        r1 = ms[1].step.remote(3.0)

        def survivor_in_op():
            for n in set(os.listdir(ep1)) - before:
                if n.startswith("ar_") and os.path.exists(
                        os.path.join(ep1, n, "rank_1.npy")):
                    return True
            return False
        _poll(survivor_in_op, 20, "survivor inside step-3 allreduce")
        t0 = time.monotonic()
        r0 = ms[0].step.remote(3.0)
        with pytest.raises(Exception):
            ray_tpu_torch.get(r0, timeout=30)
        with pytest.raises(ray_tpu_torch.exceptions.CollectiveAbortError):
            ray_tpu_torch.get(r1, timeout=30)
        assert time.monotonic() - t0 < 10.0
        _poll(lambda: (lambda g: g is not None and g.state == "ALIVE"
                       and g.epoch == 2)(w.gcs.get_gang_info(name)),
              60, "gang re-form at epoch 2")

        # every rank restored the newest fully-committed generation:
        # steps == 2, state bit-identical to the committed step-2
        # state, and the side-effect logs show steps 1..2 exactly once
        expected2 = np.asarray([1.0 + 2.0] * 3) * 2   # 2 ranks summed
        snaps = ray_tpu_torch.get([m.snapshot.remote() for m in ms],
                            timeout=60)
        for steps, state in snaps:
            assert steps == 2
            np.testing.assert_array_equal(state, expected2)
        for p in logs:
            assert p.read_text().splitlines() == ["1", "2"]
        assert w.num_ckpt_restored == 2

        # the driver re-drives step 3: resumes at K+1
        assert ray_tpu_torch.get([m.step.remote(3.0) for m in ms],
                           timeout=30) == [3, 3]
        expected3 = expected2 + np.asarray([3.0] * 3) * 2
        for steps, state in ray_tpu_torch.get(
                [m.snapshot.remote() for m in ms], timeout=30):
            assert steps == 3
            np.testing.assert_array_equal(state, expected3)
        for p in logs:
            assert p.read_text().splitlines() == ["1", "2", "3"]

        # settle: the redriven step-3 generation commits on both ranks
        # (its cursor is the redo call's driver-assigned seq — read it
        # from the owner's per-actor counter rather than hardcoding;
        # the restart's re-join call consumed a seq too)
        seqs = [w._actor_seq[m._actor_id] for m in ms]
        g3 = _poll(
            lambda: (lambda a, b: a.gen if a and b and a.gen == b.gen
                     and (a.cursor, b.cursor) == tuple(seqs)
                     else None)(
                w.gcs.get_checkpoint(ms[0]._actor_id),
                w.gcs.get_checkpoint(ms[1]._actor_id)),
            30, "both ranks' step-3 checkpoint to commit")

        # torn gang generation: drop rank 1's next save so only rank 0
        # stages that generation. Gang generations align by call
        # count (SPMD symmetric calls), so BOTH ranks get an arm()
        # call — rank 0's rule is a never-firing placeholder.
        ray_tpu_torch.get(
            [ms[0].arm.remote("actor.checkpoint.save:drop@99"),
             ms[1].arm.remote("actor.checkpoint.save:drop@1")],
            timeout=30)
        torn_gen = g3 + 1    # the arm-call generation: rank 1 dropped
        assert ray_tpu_torch.get([m.step.remote(4.0) for m in ms],
                           timeout=30) == [4, 4]
        after = _poll(
            lambda: (lambda a: a if a and a.gen >= g3 + 2
                     else None)(w.gcs.get_checkpoint(ms[0]._actor_id)),
            30, "post-arm full generation commit")
        assert after.gen == g3 + 2   # the partial was skipped, never
        #                              recorded as committed
        for m in ms:
            root = ackpt.actor_ckpt_dir(w.session, m._actor_id.binary())
            assert not os.path.exists(
                ackpt.commit_marker_path(root, torn_gen)), (
                "a partial (one-rank) generation must never commit")
        _poll(lambda: w.num_ckpt_discarded >= 1, 30,
              "partial stage discarded")

        # observability: the checkpoint gauges move
        from ray_tpu_torch.util import metrics
        text = metrics.prometheus_text()
        series = {}
        for line in text.splitlines():
            if line.startswith("ray_tpu_checkpoint") \
                    or line.startswith("ray_tpu_restore_ms"):
                key, val = line.rsplit(" ", 1)
                series[key] = float(val)
        assert series.get('ray_tpu_checkpoints{state="saved"}', 0) >= 4
        assert series.get('ray_tpu_checkpoints{state="restored"}') == 2.0
        assert series.get('ray_tpu_checkpoints{state="discarded"}',
                          0) >= 1
        assert series.get("ray_tpu_checkpoint_bytes", 0) > 0
        assert "ray_tpu_restore_ms" in series
    finally:
        try:
            col.destroy_collective_group(name)
        except Exception:
            pass
        ray_tpu_torch.shutdown()


def test_checkpoint_table_survives_in_snapshot():
    """The GCS checkpoint table rides the persisted snapshot: a
    dump/load round-trip preserves committed rows (restart-tolerant
    GCS, machinery)."""
    from ray_tpu_torch._private.gcs import CheckpointInfo, GcsLite
    from ray_tpu_torch._private.ids import ActorID, JobID
    g = GcsLite()
    aid = ActorID.of(JobID.from_int(1))
    g.record_checkpoint(CheckpointInfo(actor_id=aid, gen=3, cursor=7,
                                       size_bytes=21, gang="grp",
                                       ts=1.0))
    # stale/out-of-order records are ignored (commits are monotonic)
    g.record_checkpoint(CheckpointInfo(actor_id=aid, gen=2, cursor=5))
    blob = g.dump_state()
    g2 = GcsLite()
    g2.load_state(blob)
    row = g2.get_checkpoint(aid)
    assert row is not None and row.gen == 3 and row.cursor == 7
    assert row.gang == "grp"
    assert [r.gen for r in g2.list_checkpoints()] == [3]
    g2.drop_checkpoint(aid)
    assert g2.get_checkpoint(aid) is None

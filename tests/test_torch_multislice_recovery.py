"""The recovery cases of ``tests/test_multislice.py`` on the port's
multi-slice plane: a whole slice killed mid-step and restored at a
fenced DCN epoch, a dropped DCN transfer re-formed past its poisoned
epoch, ``recover`` on a healthy set never re-joining a used epoch (and a
poisoned slice group failing fast), and a slice killed in its commit
window caught up locally. (Split from ``test_torch_multislice.py`` to
keep each file's time down.) The ranks are process workers, as in the
reference: a driver-thread rank cannot be killed like a process.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import collective as col
from ray_tpu_torch.exceptions import CollectiveAbortError
from ray_tpu_torch.train.multislice import MultiSliceConfig, MultiSliceTrainer
from tests.test_torch_multislice import (  # noqa: F401
    GRAD,
    _all_committed,
    _apply_fn,
    _expected_state0,
    _few_threads,
    _grad_fn,
    _init_fn,
    _poll,
)


def test_slice_kill_recovers_with_fenced_dcn_epoch():
    """Acceptance, part 2: chaos-killing an entire slice mid-step

    - aborts the surviving slice's DCN wait TYPED in < 5s (leader via
      the fenced DCN epoch's marker, its non-leader via the status
      fan-out),
    - restarts ONLY the dead slice's gang with checkpoint
      restore — the surviving slice's gang keeps epoch 1, zero
      restarts,
    - resumes training at step K+1 with the correct loss,
    - provably ignores a stale-epoch DCN rank file from the dead
      incarnation, and
    - moves ray_tpu_slice_restarts{slice}.
    """
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_process_workers=2)
    try:
        tr = MultiSliceTrainer(
            _init_fn, _grad_fn, _apply_fn,
            MultiSliceConfig(num_slices=2, ranks_per_slice=2,
                             gang_max_restarts=1))
        tr.start()
        assert tr.run(2) == [(1, _expected_state0(1)),
                             (2, _expected_state0(2))]
        # K = 2: wait until every rank's step-2 generation is FULLY
        # committed — the restore point the dead slice comes back from
        _poll(lambda: _all_committed(w, tr), 30,
              "step-2 checkpoints to commit on every rank")

        # arm: slice-0 leader dies at its next DCN rank-file save
        # (mid-step-3, inside the cross-slice exchange); every other
        # rank arms a never-firing placeholder for call symmetry
        arms = []
        for k, members in enumerate(tr.workers):
            for i, h in enumerate(members):
                rule = ("multislice.dcn.save_ar:kill@1"
                        if (k, i) == (0, 0)
                        else "multislice.dcn.save_ar:kill@999")
                arms.append(h.arm.remote(rule))
        ray_tpu_torch.get(arms, timeout=30)

        t0 = time.monotonic()
        refs = {(k, i): h.train_step.remote(3)
                for k, members in enumerate(tr.workers)
                for i, h in enumerate(members)}
        # the doomed slice's calls fail (killed worker / gang abort)
        with pytest.raises(Exception) as exc00:
            ray_tpu_torch.get(refs[(0, 0)], timeout=30)
        assert not isinstance(exc00.value,
                              ray_tpu_torch.exceptions.GetTimeoutError)
        with pytest.raises(Exception):
            ray_tpu_torch.get(refs[(0, 1)], timeout=30)
        # the SURVIVING slice aborts typed out of the fenced DCN tier:
        # its leader from the marker, its non-leader from the status
        # broadcast — both carry the DCN group + fenced epoch
        for key in ((1, 0), (1, 1)):
            with pytest.raises(CollectiveAbortError) as exc:
                ray_tpu_torch.get(refs[key], timeout=30)
            assert exc.value.group == tr.name + ".dcn"
            assert exc.value.epoch == 1
        assert time.monotonic() - t0 < 5.0, (
            "survivor burned the DCN rendezvous deadline instead of "
            "aborting on the fence")

        # recovery: slice-0 gang re-forms at epoch 2, restores
        # the step-2 generation, DCN tier re-joins at epoch 2
        resume_step = tr.recover()
        assert resume_step == 2
        info0 = w.gcs.get_gang_info(tr.name + ".s0")
        info1 = w.gcs.get_gang_info(tr.name + ".s1")
        assert info0.state == "ALIVE" and info0.epoch == 2
        assert info0.num_restarts == 1
        # only the dead slice restarted
        assert info1.state == "ALIVE" and info1.epoch == 1
        assert info1.num_restarts == 0
        ss = w.gcs.get_sliceset_info(tr.name)
        assert ss.state == "ALIVE" and ss.dcn_epoch == 2
        assert ss.slice_restarts == (1, 0)
        assert w.num_ckpt_restored == 2     # both slice-0 ranks

        # stale-epoch fencing: plant rank files where the DEAD DCN
        # incarnation's next allreduce generation would land — without
        # the epoch fence this is exactly what a resurrected epoch-1
        # writer would collide on
        dcn_root = col.group_root(tr.name + ".dcn")
        stale_gen = os.path.join(dcn_root, "ep_00000001", "ar_00000001")
        os.makedirs(stale_gen)
        for r in range(2):
            col.collective._atomic_save(
                os.path.join(stale_gen, f"rank_{r}.npy"),
                np.full(GRAD, 9999.0))

        # training resumes at K+1 = 3 with the correct loss; the
        # stale 9999s are provably ignored (numerics exact, no hang)
        hist = tr.run(2)
        assert hist == [(3, _expected_state0(3)),
                        (4, _expected_state0(4))]
        for steps_done, state in tr.snapshots():
            assert steps_done == 4
            np.testing.assert_allclose(state,
                                       np.full(GRAD,
                                               _expected_state0(4)))

        # observability: per-slice restart gauge + DCN gauges move
        tr.dcn_stats()
        from ray_tpu_torch.util import metrics
        series = {}
        for line in metrics.prometheus_text().splitlines():
            if line.startswith("ray_tpu_dcn") \
                    or line.startswith("ray_tpu_slice_restarts"):
                key, val = line.rsplit(" ", 1)
                series[key] = float(val)
        assert series.get('ray_tpu_slice_restarts{slice="0"}') == 1.0
        assert series.get("ray_tpu_dcn_bytes", 0) > 0
        assert series.get("ray_tpu_dcn_collective_ms", 0) > 0
        tr.shutdown()
    finally:
        ray_tpu_torch.shutdown()


def test_dcn_load_drop_aborts_typed_and_rejoin_reforms():
    """A dropped DCN transfer (chaos ``multislice.dcn.load_ar:drop``)
    is a transport abort with NO slice death behind it: the dropped
    reader raises typed fast; its peer may either abort too or
    legitimately complete the op (the dropped side's rank file landed
    BEFORE its load failed — a real partial DCN failure), leaving the
    ranks divergent by one step. ``recover`` re-forms PAST the
    poisoned epoch (an epoch with an abort marker can never run
    another op) and catch-up re-levels the laggard, all without any
    gang restart."""
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_process_workers=2)
    try:
        tr = MultiSliceTrainer(
            _init_fn, _grad_fn, _apply_fn,
            MultiSliceConfig(num_slices=2, ranks_per_slice=1))
        tr.start()
        tr.run(1)
        # slice-1's leader drops its next DCN read; slice-0's arms a
        # never-firing placeholder (call symmetry)
        ray_tpu_torch.get(
            [tr.workers[0][0].arm.remote(
                "multislice.dcn.load_ar:drop@999"),
             tr.workers[1][0].arm.remote(
                 "multislice.dcn.load_ar:drop@1")], timeout=30)
        t0 = time.monotonic()
        r0 = tr.workers[0][0].train_step.remote(2)
        r1 = tr.workers[1][0].train_step.remote(2)
        with pytest.raises(CollectiveAbortError):
            ray_tpu_torch.get(r1, timeout=30)
        assert time.monotonic() - t0 < 5.0
        try:
            ray_tpu_torch.get(r0, timeout=30)   # completed-or-aborted race:
        except CollectiveAbortError:      # both outcomes are correct
            pass
        # no slice restarted — this was a transport abort
        for k in range(2):
            assert w.gcs.get_gang_info(
                tr.name + f".s{k}").num_restarts == 0
        resume = tr.recover()
        assert resume in (1, 2)           # 2 iff slice-0 completed and
        #                                   slice-1 caught up locally
        tr.run(3 - resume)
        for steps, state in tr.snapshots():
            assert steps == 3
            np.testing.assert_allclose(
                state, np.full(GRAD, _expected_state0(3, world=2)))

        # the COORDINATOR must have learned the epoch the rejoin
        # re-formed at: a slice death now must fence the LIVE epoch
        # (marker at 2, not the dead 1) so the survivor still aborts
        # typed in milliseconds, not the group timeout
        assert w._slicesets[tr.name].dcn_epoch == 2
        ray_tpu_torch.get(
            [tr.workers[0][0].arm.remote("multislice.dcn.save_ar:kill@1"),
             tr.workers[1][0].arm.remote(
                 "multislice.dcn.save_ar:kill@999")], timeout=30)
        t0 = time.monotonic()
        r0 = tr.workers[0][0].train_step.remote(4)
        r1 = tr.workers[1][0].train_step.remote(4)
        with pytest.raises(Exception):
            ray_tpu_torch.get(r0, timeout=30)
        with pytest.raises(CollectiveAbortError) as exc:
            ray_tpu_torch.get(r1, timeout=30)
        assert exc.value.epoch == 2
        assert time.monotonic() - t0 < 5.0, (
            "post-rejoin fence wrote its marker at a stale epoch")
        assert tr.recover() == 3
        tr.run(1)
        for steps, state in tr.snapshots():
            assert steps == 4
            np.testing.assert_allclose(
                state, np.full(GRAD, _expected_state0(4, world=2)))
        tr.shutdown()
    finally:
        ray_tpu_torch.shutdown()


def test_rejoin_never_joins_used_epoch_and_poisoned_slice_fails_fast():
    """(a) ``recover`` on a healthy set (say, after a driver-side step
    timeout that never engaged any fault) must NOT re-join the live
    ALIVE DCN epoch: a re-join resets each leader's generation
    counter, so the epoch's existing generation dirs would satisfy
    fresh collectives — and even the join barrier — with stale
    payloads. The rejoin fences the used epoch and re-forms one up,
    and training stays numerically exact across the spurious recover.
    (b) An intra-slice transport abort (abort marker at a slice
    group's live epoch with every member healthy) cannot self-heal —
    slice epochs are owned by the death-triggered restart plane
    (docs/multislice.md "Limitations") — so ``recover`` must fail
    fast with the remedy instead of burning step retries."""
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_process_workers=2)
    try:
        tr = MultiSliceTrainer(
            _init_fn, _grad_fn, _apply_fn,
            MultiSliceConfig(num_slices=2, ranks_per_slice=1))
        tr.start()
        tr.run(2)
        assert w._slicesets[tr.name].dcn_epoch == 1
        assert tr.recover() == 2              # spurious: nothing failed
        root = col.group_root(tr.name + ".dcn")
        st = col.collective.read_group_state(root)
        assert int(st["epoch"]) == 2, "re-joined an already-used epoch"
        assert w._slicesets[tr.name].dcn_epoch == 2
        tr.run(2)
        for steps, state in tr.snapshots():
            assert steps == 4
            np.testing.assert_allclose(
                state, np.full(GRAD, _expected_state0(4, world=2)))
        # (b) poison slice-0's live epoch: transport abort, no death
        sroot = col.group_root(tr.name + ".s0")
        sst = col.collective.read_group_state(sroot)
        col.write_abort_marker(sroot, int(sst["epoch"]),
                               "test: local-timeout fan-out")
        poisoned = tr.slice_set.poisoned_slice_groups()
        assert len(poisoned) == 1
        # diagnosis carries group, epoch, and the marker's reason
        assert poisoned[0].startswith(tr.name + ".s0@ep")
        assert "local-timeout fan-out" in poisoned[0]
        with pytest.raises(RuntimeError, match="transport-abort"):
            tr.recover()
        tr.shutdown()
    finally:
        ray_tpu_torch.shutdown()


def test_slice_killed_in_commit_window_catches_up():
    """The commit-window race: a slice dies AFTER its step-K replies
    shipped but BEFORE generation K two-phase committed. It restores
    K-1 while the survivors hold K — recover() levels the laggard
    through local catch-up (the synced update is a pure function of
    (state, step); the reduction mirrors the hierarchical op tree so
    the caught-up state is bit-identical) and training continues."""
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_process_workers=2)
    try:
        tr = MultiSliceTrainer(
            _init_fn, _grad_fn, _apply_fn,
            MultiSliceConfig(num_slices=2, ranks_per_slice=2,
                             gang_max_restarts=1))
        tr.start()
        # arm FIRST: counting slice-0 leader's autosaves from here,
        # the arm call's own save is match 1, steps 1/2/3 are 2/3/4 —
        # the kill fires mid-save of step-3's generation, AFTER the
        # step-3 reply (FIFO contract)
        arms = []
        for k, members in enumerate(tr.workers):
            for i, h in enumerate(members):
                rule = ("actor.checkpoint.save:kill@4"
                        if (k, i) == (0, 0)
                        else "actor.checkpoint.save:kill@999")
                arms.append(h.arm.remote(rule))
        ray_tpu_torch.get(arms, timeout=30)
        assert tr.run(2) == [(1, _expected_state0(1)),
                             (2, _expected_state0(2))]
        _poll(lambda: _all_committed(w, tr), 30,
              "step-2 checkpoints to commit on every rank")
        # step 3 SUCCEEDS (replies precede the autosave) — then the
        # slice-0 leader dies saving it: generation 3 never commits
        assert tr.run(1) == [(3, _expected_state0(3))]
        # step 4 fails on the dead slice; run() recovers: slice-0
        # restores step-2, survivors hold step-3, catch-up levels
        # slice-0 to 3, then step 4 is re-driven
        assert tr.run(1) == [(4, _expected_state0(4))]
        for steps, state in tr.snapshots():
            assert steps == 4
            np.testing.assert_allclose(
                state, np.full(GRAD, _expected_state0(4)))
        assert w.gcs.get_gang_info(tr.name + ".s0").num_restarts == 1
        assert w.gcs.get_gang_info(tr.name + ".s1").num_restarts == 0
        assert w.num_ckpt_restored == 2
        tr.shutdown()
    finally:
        ray_tpu_torch.shutdown()

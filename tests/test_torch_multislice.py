"""The port's multi-slice plane (``ray_tpu_torch/multislice`` and
``ray_tpu_torch/train/multislice.py``): the cases of
``tests/test_multislice.py`` on the port (the four recovery cases are in
``test_torch_multislice_recovery.py``), plus the reference's numpy
functions through both packages' ``MultiSliceTrainer`` (equal histories,
snapshots and DCN byte counts) and two slices of one ``{"GPU": 0.5}``
leader each, both on threads of the driver, whose DCN counters stay
apart (each leader's ``bytes_tx`` exact).

All failures are chaos-armed per rank (the ``arm`` hook) and every
wait is liveness-driven with an explicit deadline, so wall-clock stays
bounded even when something breaks.
"""

import importlib
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch

GRAD = 32                      # float64 elements => 256 B per payload
PORT_INIT = {"num_gpus": 0}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _poll(predicate, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _init_fn():
    return np.zeros(GRAD)


def _grad_fn(state, global_rank, world, step):
    # depends only on (rank, step): a re-driven step reproduces the
    # same update, and the global mean is layout-independent
    return np.full(GRAD, float(global_rank + 1) * step)


def _apply_fn(state, synced):
    state = state + synced
    return state, float(state[0])


def _expected_state0(n_steps, world=4):
    # mean over ranks of (rank+1)*step, summed over steps
    per_step = sum(r + 1 for r in range(world)) / world
    return per_step * sum(range(1, n_steps + 1))


def _all_committed(w, trainer):
    """Every rank's newest committed generation covers its latest
    driver-assigned call seq (idiom: read the owner's counter,
    don't hardcode)."""
    for members in trainer.workers:
        for h in members:
            ck = w.gcs.get_checkpoint(h._actor_id)
            if ck is None or ck.cursor != w._actor_seq[h._actor_id]:
                return False
    return True


def _run_trainer(num_slices, ranks_per_slice, steps, rt=ray_tpu_torch,
                 init_kw=PORT_INIT, **cfg_kw):
    """One complete trainer run in a fresh runtime of the package ``rt``;
    returns (history, final snapshots, dcn stats, prometheus text)."""
    ms = importlib.import_module(f"{rt.__name__}.train.multislice")
    metrics = importlib.import_module(f"{rt.__name__}.util.metrics")
    rt.shutdown()
    rt.init(num_cpus=4, max_process_workers=2,
            _system_config={"dcn_latency_ms": 2.0}, **init_kw)
    try:
        tr = ms.MultiSliceTrainer(
            _init_fn, _grad_fn, _apply_fn,
            ms.MultiSliceConfig(num_slices=num_slices,
                                ranks_per_slice=ranks_per_slice,
                                **cfg_kw))
        tr.start()
        hist = tr.run(steps)
        snaps = tr.snapshots()
        stats = tr.dcn_stats()

        def _gauges_caught_up():
            series = {}
            for line in metrics.prometheus_text().splitlines():
                if line.startswith("ray_tpu_dcn"):
                    key, val = line.rsplit(" ", 1)
                    series[key] = float(val)
            if series.get("ray_tpu_dcn_bytes") != stats["bytes_tx"]:
                return None
            if series.get("ray_tpu_dcn_collective_ms", 0) <= 0:
                return None
            return metrics.prometheus_text()

        if stats["bytes_tx"] == 0:
            # flat run: no DCN tier, nothing to wait for
            text = metrics.prometheus_text()
        else:
            # gauge publication trails the last step's stats update;
            # scrape until the DCN counters catch up instead of racing.
            # Generous deadline: the publisher thread shares the
            # driver with a loaded tier-1 run — this wait is pure
            # backstop, the poll exits the moment the counters match.
            text = _poll(_gauges_caught_up, 30.0,
                         "DCN gauges to match dcn_stats()")
        tr.shutdown()
        return hist, snaps, stats, text
    finally:
        rt.shutdown()


def test_two_slice_trainer_matches_single_mesh_and_dcn_bytes():
    """Acceptance, part 1: the 2-slice hierarchical-DCN run is
    numerically equal (allclose) to the single-mesh run, and the byte
    counters prove the hierarchical allreduce moves <= 1/num_slices of
    the gradient bytes a flat allreduce would push across the DCN
    tier. The DCN gauges move."""
    steps = 4
    # wide backstops: on a loaded machine the slice-group rendezvous
    # can trail the default deadline even though nothing is wrong —
    # faults still abort typed via liveness, so the only cost of a
    # large timeout here is on genuine breakage
    slack = dict(collective_timeout_s=120.0, step_timeout_s=240.0,
                 recover_timeout_s=120.0)
    flat_hist, flat_snaps, flat_stats, _ = _run_trainer(
        1, 4, steps, **slack)
    hier_hist, hier_snaps, hier_stats, text = _run_trainer(
        2, 2, steps, **slack)

    # the flat (single-mesh) baseline has NO DCN tier at all
    assert flat_stats["bytes_tx"] == 0 and flat_stats["ops"] == 0

    assert [s for s, _ in hier_hist] == list(range(1, steps + 1))
    for (_, flat_loss), (_, hier_loss) in zip(flat_hist, hier_hist):
        np.testing.assert_allclose(hier_loss, flat_loss)
    expected = _expected_state0(steps)
    for (fs, fstate), (hs, hstate) in zip(flat_snaps, hier_snaps):
        assert fs == hs == steps
        np.testing.assert_allclose(fstate, hstate)
        np.testing.assert_allclose(hstate[0], expected)

    # DCN traffic: exactly one leader payload per slice per step
    # crosses the tier; a flat allreduce over DCN would move every
    # rank's payload. num_slices * measured == flat byte count.
    grad_bytes = GRAD * 8
    world, num_slices = 4, 2
    assert hier_stats["bytes_tx"] == num_slices * grad_bytes * steps
    flat_dcn_bytes = world * grad_bytes * steps
    assert hier_stats["bytes_tx"] * num_slices <= flat_dcn_bytes
    assert hier_stats["ops"] == num_slices * steps
    # (The reference's cost-model assertion, hier_stats["ms"] >= 2.0 *
    # num_slices * steps, is left out here: ``_system_config`` reaches
    # no process worker in either package, so CPU leaders charge no
    # latency. ``test_gpu_half_leaders_count_their_own_dcn_bytes``
    # holds it on leaders that run on threads of the driver.)

    series = {}
    for line in text.splitlines():
        if line.startswith("ray_tpu_dcn"):
            key, val = line.rsplit(" ", 1)
            series[key] = float(val)
    assert series.get("ray_tpu_dcn_bytes") == hier_stats["bytes_tx"]
    assert series.get("ray_tpu_dcn_collective_ms", 0) > 0


def test_dcn_cost_model_math():
    from ray_tpu_torch.multislice import DcnCostModel
    m = DcnCostModel(latency_s=0.001, bytes_per_s=1e9 / 8)
    # 1 ms latency + 1 MiB over 125 MB/s
    nbytes = 1 << 20
    assert m.delay_s(nbytes) == pytest.approx(0.001 + nbytes / (1e9 / 8))
    assert DcnCostModel().delay_s(1 << 30) == 0.0   # both terms off
    lat_only = DcnCostModel(latency_s=0.002)
    assert lat_only.delay_s(1 << 30) == 0.002


def test_sliceset_table_survives_in_snapshot():
    """The GCS sliceset table rides the persisted snapshot (the
    restart-tolerant GCS), epoch updates are monotonic, and per-slice
    restart counters accumulate."""
    from ray_tpu_torch._private.gcs import GcsLite, SliceSetInfo
    g = GcsLite()
    g.register_sliceset(SliceSetInfo(
        name="ms", slice_gangs=("ms.s0", "ms.s1"), dcn_group="ms.dcn",
        world_size=4))
    g.update_sliceset("ms", state="ALIVE")
    g.update_sliceset("ms", state="DEGRADED", dcn_epoch=2,
                      restarted_slice=0)
    g.update_sliceset("ms", dcn_epoch=1)     # stale: must not unfence
    blob = g.dump_state()
    g2 = GcsLite()
    g2.load_state(blob)
    row = g2.get_sliceset_info("ms")
    assert row is not None and row.dcn_epoch == 2
    assert row.state == "DEGRADED"
    assert row.slice_restarts == (1, 0)
    assert [r.name for r in g2.list_slicesets()] == ["ms"]
    # DEAD is terminal: the fence's DEAD write carries no epoch, so a
    # rejoin's late ALIVE (any epoch) must not resurrect the row
    g2.update_sliceset("ms", state="DEAD", death_cause="slice 1 died")
    g2.update_sliceset("ms", state="ALIVE", dcn_epoch=9)
    row = g2.get_sliceset_info("ms")
    assert row.state == "DEAD" and row.death_cause == "slice 1 died"
    assert row.dcn_epoch == 2    # dead rows stop moving entirely
    g2.unregister_sliceset("ms")
    assert g2.get_sliceset_info("ms") is None


def test_both_packages_agree_on_the_reference_functions():
    """The reference's numpy ``init/grad/apply`` functions through both
    packages' ``MultiSliceTrainer`` (2 slices x 2 ranks, process
    workers): equal histories, final snapshots and DCN byte counts."""
    import ray_tpu
    slack = dict(collective_timeout_s=120.0, step_timeout_s=240.0,
                 recover_timeout_s=120.0)
    ref = _run_trainer(2, 2, 3, rt=ray_tpu, init_kw={}, **slack)
    got = _run_trainer(2, 2, 3, **slack)
    assert got[0] == ref[0]
    assert [s for s, _ in got[0]] == [1, 2, 3]
    for (gs, gstate), (rs, rstate) in zip(got[1], ref[1]):
        assert gs == rs == 3
        np.testing.assert_array_equal(gstate, rstate)
    for key in ("bytes_tx", "bytes_rx", "ops"):
        assert got[2][key] == ref[2][key], key
    assert got[2]["bytes_tx"] == 2 * GRAD * 8 * 3


def test_gpu_half_leaders_count_their_own_dcn_bytes():
    """2 slices x 1 rank of ``{"GPU": 0.5}`` under ``init(num_gpus=1)``:
    both leaders run on threads of the driver, in one process with one
    pid. Each keeps its own DCN counters, so the set's ``bytes_tx`` is
    exactly one payload per leader per step (a process-wide counter read
    by both would double it), and the cost model, configured on the
    driver, is charged on every remote read."""
    steps, num_slices = 3, 2
    hist, snaps, stats, text = _run_trainer(
        num_slices, 1, steps, init_kw={"num_gpus": 1},
        resources_per_worker={"GPU": 0.5})
    assert [s for s, _ in hist] == list(range(1, steps + 1))
    for steps_done, state in snaps:
        assert steps_done == steps
        np.testing.assert_allclose(
            state, np.full(GRAD, _expected_state0(steps, world=2)))
    grad_bytes = GRAD * 8
    assert stats["bytes_tx"] == num_slices * grad_bytes * steps
    assert stats["bytes_rx"] == num_slices * grad_bytes * steps
    assert stats["ops"] == num_slices * steps
    assert stats["ms"] >= 2.0 * num_slices * steps
    series = dict(line.rsplit(" ", 1) for line in text.splitlines()
                  if line.startswith("ray_tpu_dcn"))
    assert float(series["ray_tpu_dcn_bytes"]) == stats["bytes_tx"]

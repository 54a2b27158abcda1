"""The cases of ``tests/test_data_trainer_ingest.py`` on both packages: a
Data pipeline feeds a two-slice ``MultiSliceTrainer`` through the
prefetched batch iterators (the port's ``run_with_data``, which takes its
prefetching iterator and its starvation gauge from ``ray_tpu_torch.data``)
and stays exact, with and without chaos-killed map-pool workers. Where
the reference's chaos case feeds ``iter_jax_batches``, the port's feeds
``iter_device_batches(device="cpu")``; the port's numerics case also
runs ``train.ingest.iter_train_batches``.

The trainer's functions and the pool's class are defined inside the
cases, so that they travel by value and a process worker imports neither
this file nor torch for them."""

import time

import numpy as np

from tests.test_torch_data import (  # noqa: F401
    PACKAGES, _few_threads, data_of, mod)


def _make_trainer(rt):
    """2-slice trainer whose state accumulates the per-step batch sum:
    the final state IS the exactly-once proof — a dropped or duplicated
    block moves it off the analytic total."""

    def init_fn():
        return np.zeros((1,), dtype=np.float64)

    def grad_fn(state, rank, world, step, batch):
        # every slice sees the same batch; mean-allreduce keeps the sum
        return np.asarray([float(np.sum(batch["x"]))])

    def apply_fn(state, synced):
        new = state + synced
        return new, float(new[0])

    ms = mod(rt, "train.multislice")
    return ms.MultiSliceTrainer(
        init_fn, grad_fn, apply_fn,
        ms.MultiSliceConfig(num_slices=2, ranks_per_slice=1))


def _run(scenario, **init_kw):
    outs = []
    for rt, accel in PACKAGES:
        rt.init(num_cpus=init_kw.get("num_cpus", 4), **{accel: 8},
                max_process_workers=init_kw.get("max_process_workers", 2))
        try:
            outs.append(scenario(rt, data_of(rt)))
        finally:
            rt.shutdown()
    return outs


def test_trainer_ingest_numerics_and_starvation():
    """No chaos: pipeline -> iter_batches(prefetch) -> run_with_data is
    numerically exact, records ingest starvation, and the data gauges
    return to baseline after the epoch. The port's
    ``iter_train_batches`` feeds a second epoch the same way."""
    n, blocks = 96, 6
    per = n // blocks

    def scenario(rt, rdata):
        ingest = mod(rt, "train.ingest")
        ds = rdata.range(n, parallelism=blocks).map_batches(
            lambda b: {"x": b["id"].astype(np.float64)})
        out = {}
        tr = _make_trainer(rt)
        tr.start()
        try:
            batches = (ingest.to_numpy_batch(b) for b in ds.iter_batches(
                batch_size=per, prefetch_batches=2))
            out["history"] = len(tr.run_with_data(batches, keep_batches=4))
            out["snapshots"] = [(steps, state.tolist())
                                for steps, state in tr.snapshots()]
            out["ingest"] = dict(tr.last_ingest)
            out["text"] = mod(rt, "util.metrics").prometheus_text()
        finally:
            tr.shutdown()
        out["live"] = mod(rt, "_private.data_stats").queued_bytes_by_stage()
        if rt.__name__ == "ray_tpu_torch":
            tr = _make_trainer(rt)
            tr.start()
            try:
                out["second"] = len(tr.run_with_data(
                    ingest.iter_train_batches(ds, batch_size=per),
                    keep_batches=4))
                out["second_snapshots"] = [
                    (steps, state.tolist()) for steps, state
                    in tr.snapshots()]
            finally:
                tr.shutdown()
        return out

    ref, got = _run(scenario)
    expect = float(np.arange(n).sum())
    for out in (ref, got):
        assert out["history"] == blocks
        for steps, state in out["snapshots"]:
            assert steps == blocks
            assert np.allclose(state, [expect]), (state, expect)
        # ingest accounting made it to the trainer and the gauge
        assert out["ingest"]["steps"] == blocks
        assert 0.0 <= out["ingest"]["starvation_fraction"] <= 1.0
        assert "ray_tpu_data_trainer_starvation" in out["text"]
        # pipeline finished: no stage holds bytes
        assert out["live"] == {}
    assert got["snapshots"] == ref["snapshots"]
    assert got["second"] == blocks
    assert got["second_snapshots"] == ref["snapshots"]


def test_trainer_fed_under_chaos_exactly_once(tmp_path):
    """Map-pool workers are chaos-killed mid-epoch while the pipeline
    feeds a live 2-slice trainer. Blocks re-drive exactly once (final
    state equals the analytic sum, one step per batch), reconstructions
    are observable, and the trainer never wedges."""
    n, blocks = 64, 8
    per = n // blocks

    def scenario(rt, rdata):
        data_stats = mod(rt, "_private.data_stats")
        ingest = mod(rt, "train.ingest")
        package = rt.__name__

        class SelfArmingAsFloat:
            """Pool-worker callable that arms the chaos plane in ITS OWN
            process at construction; the marker file makes arming
            one-shot across incarnations."""

            def __init__(self, marker):
                import importlib
                import os
                if not os.path.exists(marker):
                    with open(marker, "w"):
                        pass
                    importlib.import_module(
                        f"{package}._private.chaos").install(
                        "data.map.MapBatches:kill@2")

            def __call__(self, batch):
                return {"x": batch["id"].astype(np.float64)}

        tr = _make_trainer(rt)
        tr.start()
        try:
            marker = str(tmp_path / f"armed_once_{package}")
            ds = rdata.range(n, parallelism=blocks).map_batches(
                SelfArmingAsFloat, concurrency=2, fn_args=(marker,))
            before = data_stats.snapshot()
            if package == "ray_tpu_torch":
                source = ds.iter_device_batches(
                    batch_size=per, device="cpu", prefetch_batches=2)
            else:
                source = ds.iter_jax_batches(batch_size=per,
                                             prefetch_batches=2)
            batches = (ingest.to_numpy_batch(b) for b in source)
            t0 = time.monotonic()
            history = tr.run_with_data(batches, keep_batches=4)
            seconds = time.monotonic() - t0
            after = data_stats.snapshot()
            return {"seconds": seconds, "history": len(history),
                    "snapshots": [(steps, state.tolist())
                                  for steps, state in tr.snapshots()],
                    "redriven": (after["blocks_reconstructed"]
                                 - before["blocks_reconstructed"]),
                    "starvation": tr.last_ingest["starvation_fraction"],
                    "live": data_stats.queued_bytes_by_stage()}
        finally:
            tr.shutdown()

    ref, got = _run(scenario, num_cpus=8, max_process_workers=4)
    expect = float(np.arange(n).sum())
    assert got["seconds"] < 120, "epoch under chaos stalled"
    # exactly-once: one step per block, state == analytic sum
    assert got["history"] == blocks
    for steps, state in got["snapshots"]:
        assert steps == blocks
        assert np.allclose(state, [expect]), (state, expect)
    assert got["snapshots"] == ref["snapshots"]
    # chaos actually fired and the re-drive is visible
    assert got["redriven"] >= 1 and ref["redriven"] >= 1
    # trainer-starvation accounting survived the faults
    assert 0.0 <= got["starvation"] <= 1.0
    assert got["live"] == {}

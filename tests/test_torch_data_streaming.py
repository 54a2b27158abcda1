"""The port's streaming data plane against the JAX package's: the cases of
``tests/test_data_streaming.py`` that run on one node — incremental
consumption, the bounded-memory plateau under typed backpressure, the
block counters on /metrics, zero-copy blocks, a chaos-killed pool worker
re-driven exactly once, and the prefetching iterator — each under both
packages and held to the reference's assertions, and to its values where
they do not depend on timing. The two ``Cluster`` cases are in
``test_torch_data_streaming_cluster.py``.

``test_first_batch_before_last_block`` runs on the port alone, under the
reference's assertions. Its gate holds every block but the one with id
0 until the consumer has had its first batch. The reference hands blocks
to the map stage in the order their reads finished, and the stage gives
its outputs in that order: when the read of rows 16-31 finishes before
that of rows 0-15, the held block comes first, no batch can arrive, and
the case waits out its 30 s gate (the reference's case fails so under
load). The port hands blocks over in read order (ROADMAP C), which
``test_blocks_go_downstream_in_read_order`` holds with the first read
made the slowest."""

import functools
import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from tests.test_torch_data import (  # noqa: F401
    LIVE, _few_threads, _live, both, mod, run_alone)


def _poll(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out waiting for {what}")


def test_first_batch_before_last_block(tmp_path):
    """iter_batches consumes blocks as they stream out: block 0 is
    gated open while blocks 1..3 hold on a marker file the CONSUMER
    writes after receiving the first batch — so receiving it at all
    proves the iterator didn't materialize the dataset first."""
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch._private import data_stats
    n, parallelism = 64, 4
    per = n // parallelism
    marker = str(tmp_path / "go")

    def gate(batch):
        if 0 not in batch["id"]:
            deadline = time.monotonic() + 30
            while not os.path.exists(batch["marker"][0]):
                if time.monotonic() > deadline:
                    raise RuntimeError("consumer never released the gate")
                time.sleep(0.02)
        return {"id": batch["id"] * 2}

    LIVE.stop()
    ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    try:
        ds = rdata.range(n, parallelism=parallelism).map_batches(
            lambda b: {"id": b["id"],
                       "marker": np.array([marker] * len(b["id"]))}
        ).map_batches(gate)

        before = data_stats.snapshot()
        got = []
        it = ds.iter_batches(batch_size=per)
        first = next(it)
        # gated blocks can't have been produced yet: strictly fewer map
        # outputs exist than the pipeline will produce in total
        mid = data_stats.snapshot()
        produced_so_far = mid["blocks_produced"] - before["blocks_produced"]
        got.extend(first["id"].tolist())
        with open(marker, "w") as f:
            f.write("go")
        for batch in it:
            got.extend(batch["id"].tolist())
        after = data_stats.snapshot()
        produced_total = after["blocks_produced"] - before["blocks_produced"]
    finally:
        ray_tpu_torch.shutdown()
    assert produced_so_far < produced_total, (
        "first batch only arrived after every block was produced")
    assert sorted(got) == sorted((np.arange(n) * 2).tolist())


def test_blocks_go_downstream_in_read_order():
    """Port only (a repair of the reference, ROADMAP C): the read of rows
    0-15 is made the slowest of four, and its rows still come out first,
    then each read's rows in read order; in the reference the rows of
    whichever read finished first come out first."""
    from ray_tpu_torch.data._internal.plan import Read
    from ray_tpu_torch.data.dataset import Dataset

    def read(start, nap):
        time.sleep(nap)
        return {"id": np.arange(start, start + 16)}

    tasks = [functools.partial(read, s, 0.5 if s == 0 else 0.0)
             for s in range(0, 64, 16)]

    LIVE.stop()
    ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    try:
        ds = Dataset(Read(tasks)).map_batches(lambda b: {"id": b["id"]})
        got = [b["id"].tolist() for b in ds.iter_batches(batch_size=16)]
    finally:
        ray_tpu_torch.shutdown()
    assert got == [list(range(s, s + 16)) for s in range(0, 64, 16)]


def test_bounded_memory_plateau_and_backpressure():
    """With a SLOW DOWNSTREAM stage (an actor pool that naps per block),
    the upstream stage's launches throttle on the downstream queue's
    byte budget, so queued bytes plateau at the budget independent of
    input size; the throttle is a typed BackpressureError, and the
    queued-bytes gauges return to baseline after completion."""
    block_rows = 8192                       # int64 => 64 KiB per block
    block_bytes = block_rows * 8

    def scenario(rt, rdata):
        data_stats = mod(rt, "_private.data_stats")
        bp_error = mod(rt, "exceptions").BackpressureError
        ctx = mod(rt, "data.context").DataContext.get_current()
        saved = dict(ctx.__dict__)
        ctx.per_stage_memory_budget = 2 * block_bytes
        ctx.max_in_flight = 2

        class Slow:
            def __call__(self, batch):
                time.sleep(0.04)
                return {"id": batch["id"]}

        def run(num_blocks):
            ds = rdata.range(block_rows * num_blocks,
                             parallelism=num_blocks).map_batches(
                lambda b: {"id": b["id"]}).map_batches(Slow, concurrency=2)
            peak, saw_typed, rows = 0, False, 0
            for b in ds.iter_batches(batch_size=block_rows):
                rows += len(b["id"])
                queued = sum(data_stats.queued_bytes_by_stage().values())
                peak = max(peak, queued)
                for ex in data_stats.executors():
                    for _label, rtm in list(getattr(ex, "_live", [])):
                        if isinstance(rtm.last_backpressure, bp_error):
                            saw_typed = True
            return peak, saw_typed, rows

        try:
            before = data_stats.snapshot()
            peak_n, typed_n, rows_n = run(8)
            peak_2n, typed_2n, rows_2n = run(16)
            after = data_stats.snapshot()
            return {"peaks": (peak_n, peak_2n), "typed": typed_n or typed_2n,
                    "rows": (rows_n, rows_2n),
                    "events": (after["backpressure_events"]
                               - before["backpressure_events"]),
                    "budget": ctx.per_stage_memory_budget,
                    "live": data_stats.queued_bytes_by_stage(),
                    "text": mod(rt, "util.metrics").prometheus_text()}
        finally:
            ctx.__dict__.update(saved)

    ref, got = both(scenario)
    peak_n, peak_2n = got["peaks"]
    budget = got["budget"]
    # plateau: doubling the input must not move the peak by more than
    # scheduling slack (a few in-flight blocks)
    assert peak_2n <= peak_n + 3 * block_bytes, (peak_n, peak_2n)
    # bounded: budgets + in-flight slack, nowhere near the 2N input's
    # total footprint (16 blocks)
    assert peak_2n <= 2 * budget + 4 * block_bytes, (peak_2n, budget)
    # the throttle is typed and counted
    assert got["typed"] and got["events"] > 0
    # gauges to baseline: no live stage series after completion
    assert got["live"] == {}
    assert "ray_tpu_data_queued_bytes{" not in got["text"], got["text"]
    assert got["rows"] == ref["rows"] == (8 * block_rows, 16 * block_rows)
    assert ref["typed"] and ref["live"] == {}


def test_data_metrics_accounting():
    def scenario(rt, rdata):
        data_stats = mod(rt, "_private.data_stats")
        before = data_stats.snapshot()
        ds = rdata.range(100, parallelism=4).map_batches(
            lambda b: {"id": b["id"] + 1})
        total = sum(len(b["id"]) for b in ds.iter_batches(batch_size=25))
        after = data_stats.snapshot()
        return (total, {k: after[k] - before[k] for k in after},
                mod(rt, "util.metrics").prometheus_text())

    ref, got = both(scenario)
    total, delta, text = got
    assert total == 100
    # 4 read blocks + 4 map blocks produced; 4 final blocks consumed
    assert delta["blocks_produced"] == 8
    assert delta["blocks_consumed"] == 4
    assert delta["bytes_produced"] > 0
    for family in ("ray_tpu_data_blocks", "ray_tpu_data_backpressure",
                   "ray_tpu_data_zero_copy_blocks",
                   "ray_tpu_data_trainer_starvation"):
        assert family in text, family
    assert 'ray_tpu_data_blocks{state="produced"}' in text
    assert (total, delta["blocks_produced"], delta["blocks_consumed"],
            delta["bytes_produced"]) == (
        ref[0], ref[1]["blocks_produced"], ref[1]["blocks_consumed"],
        ref[1]["bytes_produced"])


def test_zero_copy_blocks_over_threshold():
    rows = 131072                           # 1 MiB blocks >> 100 KiB

    def scenario(rt, rdata):
        data_stats = mod(rt, "_private.data_stats")
        before = data_stats.snapshot()
        ds = rdata.range(rows * 2, parallelism=2).map_batches(
            lambda b: {"id": b["id"]})
        n = sum(len(b["id"]) for b in ds.iter_batches(batch_size=rows))
        after = data_stats.snapshot()
        return n, after["zero_copy_blocks"] - before["zero_copy_blocks"]

    ref, got = both(scenario)
    assert got[0] == rows * 2
    assert got[1] >= 2
    assert got == ref


def test_chaos_kill_map_pool_worker_exactly_once():
    """Seeded chaos kill of an actor-pool map worker mid-block: the
    executor re-drives the in-flight block from its input on the
    restarted worker — no duplicated and no dropped rows — and the
    reconstruction is observable."""
    def scenario(rt, rdata, w):
        chaos = mod(rt, "_private.chaos")
        data_stats = mod(rt, "_private.data_stats")
        try:
            # Arm ONLY the initial worker processes: the rule rides the
            # env into the prestarted pair (where the pool actors land).
            head = w.node_group._raylets[w.node_group.head_node_id]
            os.environ[chaos.ENV_VAR] = "data.map.MapBatches:kill@2"
            head.worker_pool.prestart(2)
            _poll(lambda: head.worker_pool.stats()["idle_process"] >= 2,
                  60, "armed workers to prestart")
            os.environ.pop(chaos.ENV_VAR)

            class Double:
                def __call__(self, batch):
                    return {"id": batch["id"] * 2}

            before = data_stats.snapshot()
            ds = rdata.range(64, parallelism=8).map_batches(
                Double, concurrency=2)
            got = []
            deadline = time.monotonic() + 120
            for batch in ds.iter_batches(batch_size=8):
                got.extend(batch["id"].tolist())
                assert time.monotonic() < deadline, "consume stalled"
            after = data_stats.snapshot()
            return (sorted(got), after["blocks_reconstructed"]
                    - before["blocks_reconstructed"],
                    mod(rt, "util.metrics").prometheus_text())
        finally:
            os.environ.pop(chaos.ENV_VAR, None)

    ref, got = run_alone(scenario, num_cpus=4, max_process_workers=2,
                         accel=0)
    rows, redriven, text = got
    # exactly-once: every row exactly once despite the kills
    assert rows == sorted((np.arange(64) * 2).tolist()) == ref[0]
    # the re-drive is visible
    assert redriven >= 1 and ref[1] >= 1
    assert 'ray_tpu_data_blocks{state="reconstructed"}' in text


@pytest.mark.parametrize("rt", [ray_tpu, ray_tpu_torch],
                         ids=["ray_tpu", "ray_tpu_torch"])
def test_prefetch_iterator_unit(rt):
    PrefetchIterator = mod(rt, "data._internal.prefetch").PrefetchIterator

    def source():
        for i in range(10):
            yield i

    it = PrefetchIterator(source(), depth=2)
    assert list(it) == list(range(10))
    st = it.stats()
    assert st["items"] == 10
    assert 0.0 <= st["starvation_fraction"] <= 1.0

    # error propagation: the consumer sees the source's exception
    def bad():
        yield 1
        raise ValueError("boom")

    it2 = PrefetchIterator(bad(), depth=2)
    assert next(it2) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it2)

    # closing early releases the producer thread (no stranded put)
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it3 = PrefetchIterator(endless(), depth=1)
    assert next(it3) == 0
    it3.close()
    it3._thread.join(timeout=5)
    assert not it3._thread.is_alive(), "producer thread stranded"

"""The port's Data (``ray_tpu_torch/data``) against the JAX package's: the
cases of ``tests/test_data.py`` up to its round-4 section (the rest are in
``test_torch_data_backpressure.py``), each run under both packages on the
same inputs and held to the reference's assertions and to the
reference's values. Both runtimes (the reference fixture's ``num_cpus=4``, 8
accelerators, 2 process workers) stay up for the module, side by side in
this process: a case's cost is then its pipelines, not two worker starts.
A case that needs a runtime of its own stops them first (``LIVE.stop``).

Beyond the reference's cases: torch tensors returned by a map function
(the port's counterpart of jax arrays), bfloat16
columns refused with the reference's error class, ``iter_device_batches``
against the reference's ``iter_jax_batches``, and a ``num_gpus`` actor
pool, which runs on threads of the driver."""

import importlib
import os

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

PACKAGES = ((ray_tpu, "num_tpus"), (ray_tpu_torch, "num_gpus"))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class Live:
    """Both packages' runtimes, started on first use and kept until
    ``stop`` (a module fixture stops them at the end)."""

    def __init__(self):
        self.up = False

    def ensure(self):
        if not self.up:
            for rt, accel in PACKAGES:
                rt.init(num_cpus=4, **{accel: 8}, max_process_workers=2)
            self.up = True

    def stop(self):
        if self.up:
            for rt, _ in PACKAGES:
                rt.shutdown()
            self.up = False


LIVE = Live()


@pytest.fixture(scope="module", autouse=True)
def _live():
    yield LIVE
    LIVE.stop()


def mod(rt, name):
    """The package's module ``name`` (``"data.block"``, ...)."""
    return importlib.import_module(f"{rt.__name__}.{name}")


def data_of(rt):
    return mod(rt, "data")


def both(scenario):
    """``scenario(rt, rdata)`` under each package's live runtime: the
    reference's result, then the port's."""
    LIVE.ensure()
    return [scenario(rt, data_of(rt)) for rt, _ in PACKAGES]


def run_alone(scenario, **init_kw):
    """``scenario(rt, rdata)`` under each package's runtime of its own,
    started with ``init_kw`` (and the package's accelerator count given as
    ``accel``), one at a time."""
    LIVE.stop()
    outs = []
    for rt, accel in PACKAGES:
        kw = dict(init_kw)
        if "accel" in kw:
            kw[accel] = kw.pop("accel")
        w = rt.init(**kw)
        try:
            outs.append(scenario(rt, data_of(rt), w))
        finally:
            rt.shutdown()
    return outs


def test_range_map_batches_fusion_and_count():
    def scenario(rt, rdata):
        ds = rdata.range(100, parallelism=4).map_batches(
            lambda b: {"id": b["id"] * 2})
        # fusion: one map stage for chained batch+row transforms
        ds2 = ds.map(lambda row: {"id": row["id"] + 1})
        stages = mod(rt, "data._internal.plan").plan(ds2._op).stages
        return len(stages), sorted(r["id"] for r in ds2.take_all())

    ref, got = both(scenario)
    assert got[0] == 1, got[0]
    assert got[1] == sorted((np.arange(100) * 2 + 1).tolist())
    assert got == ref


def test_from_items_filter_flat_map():
    def scenario(rt, rdata):
        ds = rdata.from_items(list(range(20)), parallelism=3)
        even = ds.filter(lambda x: x % 2 == 0)
        doubled = rdata.from_items([1, 2, 3]).flat_map(lambda x: [x, x])
        return ds.count(), sorted(even.take_all()), sorted(doubled.take_all())

    ref, got = both(scenario)
    assert got == (20, list(range(0, 20, 2)), [1, 1, 2, 2, 3, 3])
    assert got == ref


def test_iter_batches_rechunking():
    def scenario(rt, rdata):
        ds = rdata.range(50, parallelism=5)
        return [len(b["id"]) for b in ds.iter_batches(batch_size=16)]

    ref, got = both(scenario)
    assert sum(got) == 50
    assert all(s == 16 for s in got[:-1])
    assert got == ref


def test_limit_and_take():
    def scenario(rt, rdata):
        return (rdata.range(1000, parallelism=8).limit(10).count(),
                rdata.range(100).take(5))

    ref, got = both(scenario)
    assert got[0] == 10 and len(got[1]) == 5
    # which block comes first is whichever read finishes first, in both
    assert got[0] == ref[0] and len(got[1]) == len(ref[1])
    assert all(0 <= r["id"] < 100 for r in got[1])


def test_repartition_and_shuffle():
    def scenario(rt, rdata):
        blocks = list(rdata.range(40, parallelism=2).repartition(8)
                      .iter_blocks())
        shuffled = rdata.range(40, parallelism=2).random_shuffle(seed=7)
        return ([b.num_rows for b in blocks],
                [r["id"] for r in shuffled.take_all()])

    ref, got = both(scenario)
    rows, vals = got
    assert len(rows) == 8 and sum(rows) == 40
    assert sorted(vals) == list(range(40))
    assert vals != list(range(40))
    # the order depends on which read finishes first, in both packages
    assert rows == ref[0] and sorted(vals) == sorted(ref[1])


def test_sort_and_groupby():
    rng = np.random.RandomState(0)
    items = [{"k": int(k), "v": float(v)}
             for k, v in zip(rng.randint(0, 5, 60), rng.randn(60))]

    def scenario(rt, rdata):
        ds = rdata.from_items(items, parallelism=4)
        vs = [r["v"] for r in ds.sort("v").take_all()]
        desc = [r["v"] for r in ds.sort("v", descending=True).take_all()]
        counts = {r["k"]: r["k_count"]
                  for r in ds.groupby("k").count().take_all()}
        sums = {r["k"]: r["v_sum"]
                for r in ds.groupby("k").sum("v").take_all()}
        return vs, desc, counts, sums

    ref, got = both(scenario)
    vs, desc, counts, sums = got
    assert vs == sorted(vs)
    assert desc == sorted(vs, reverse=True)
    expect = {}
    for it in items:
        expect[it["k"]] = expect.get(it["k"], 0) + 1
    assert counts == expect
    for k, v in sums.items():
        np.testing.assert_allclose(
            v, sum(it["v"] for it in items if it["k"] == k), rtol=1e-6)
    # a float sum's last bit follows the blocks' order, which follows
    # which task finishes first: held to the reference's own 1e-6
    assert got[:3] == ref[:3] and sums.keys() == ref[3].keys()
    for k, v in sums.items():
        np.testing.assert_allclose(v, ref[3][k], rtol=1e-6)


def test_aggregations_and_schema():
    def scenario(rt, rdata):
        ds = rdata.range(10, parallelism=2)
        return ds.sum("id"), ds.min("id"), ds.max("id"), ds.mean("id"), \
            ds.columns()

    ref, got = both(scenario)
    assert got[:4] == (45, 0, 9, 4.5)
    assert "id" in got[4]
    assert got == ref


def test_union_and_split():
    def scenario(rt, rdata):
        a = rdata.from_items([1, 2, 3])
        b = rdata.from_items([4, 5, 6])
        parts = rdata.range(30, parallelism=3).split(3)
        return sorted(a.union(b).take_all()), [p.count() for p in parts]

    ref, got = both(scenario)
    assert got == ([1, 2, 3, 4, 5, 6], [10, 10, 10])
    assert got == ref


def test_streaming_split():
    def scenario(rt, rdata):
        got = []
        for it in rdata.range(64, parallelism=8).streaming_split(2):
            for batch in it.iter_batches(batch_size=8):
                got.extend(batch["id"].tolist())
        return sorted(got)

    ref, got = both(scenario)
    assert got == list(range(64))
    assert got == ref


def test_parquet_roundtrip(tmp_path):
    def scenario(rt, rdata):
        path = str(tmp_path / rt.__name__)
        rdata.range(100, parallelism=4).map_batches(
            lambda b: {"id": b["id"], "sq": b["id"] ** 2}).write_parquet(path)
        back = rdata.read_parquet(path)
        return back.count(), sorted(back.take_all(), key=lambda r: r["id"])

    ref, got = both(scenario)
    assert got[0] == 100
    assert got[1][10] == {"id": 10, "sq": 100}
    assert got == ref


def test_map_batches_actor_pool():
    def scenario(rt, rdata):
        class AddConst:
            def __init__(self, c):
                self.c = c

            def __call__(self, batch):
                return {"id": batch["id"] + self.c}

        ds = rdata.range(32, parallelism=4).map_batches(
            AddConst, fn_args=(100,), concurrency=2)
        return sorted(r["id"] for r in ds.take_all())

    ref, got = both(scenario)
    assert got == list(range(100, 132))
    assert got == ref


def test_gpu_actor_pool_runs_on_driver_threads():
    """A ``num_gpus`` pool (the reference's ``num_tpus``): the port's
    actors are built once in the driver's process and stream their blocks
    back from there; every row arrives, once. The reference's pool of
    ``num_tpus`` actors runs in the driver too."""
    def scenario(rt, rdata):
        accel = "num_gpus" if rt is ray_tpu_torch else "num_tpus"

        class Tag:
            def __init__(self):
                self.built_in = os.getpid()

            def __call__(self, batch):
                n = len(batch["id"])
                return {"id": batch["id"] * 3,
                        "pid": np.full(n, self.built_in),
                        "now": np.full(n, os.getpid())}

        ds = rdata.range(64, parallelism=8).map_batches(
            Tag, batch_size=4, concurrency=2, **{accel: 1})
        rows = ds.take_all()
        return (sorted(r["id"] for r in rows), {r["pid"] for r in rows},
                {r["now"] for r in rows})

    ref, got = both(scenario)
    assert got[0] == [3 * i for i in range(64)]
    assert got[0] == ref[0]
    assert got[1] == got[2] == {os.getpid()}
    assert got == ref


def test_map_batches_returns_torch_tensors_like_jax_arrays():
    """A map function that returns tensors (CPU here; the card's come to
    the host the same way) gives the blocks the reference's gives for jax
    arrays: same columns, same values, fixed-shape tensor columns for 2-d
    values."""
    def scenario(rt, rdata):
        if rt is ray_tpu_torch:
            def fn(b):
                x = torch.from_numpy(b["id"].astype(np.float32))
                return {"id": x * 2, "pair": torch.stack([x, x + 1], 1)}
        else:
            def fn(b):
                import jax.numpy as jnp
                x = jnp.asarray(b["id"].astype(np.float32))
                return {"id": x * 2, "pair": jnp.stack([x, x + 1], 1)}
        blocks = list(rdata.range(16, parallelism=2).map_batches(
            fn, batch_size=4).iter_blocks())
        batches = sorted(
            ({k: v.tolist() for k, v in
              mod(rt, "data.block").block_to_batch(b).items()}
             for b in blocks), key=lambda b: b["id"][0])
        return sorted({str(b.schema) for b in blocks}), batches

    ref, got = both(scenario)
    assert got == ref
    assert got[1][0]["pair"][1] == [1, 2]


@pytest.mark.parametrize("shape", [(4,), (4, 3)], ids=["1d", "2d"])
def test_bf16_column_is_refused_like_the_reference(shape):
    """bfloat16 has no numpy or arrow type: the reference's
    ``block_from_batch`` raises pyarrow's ArrowNotImplementedError for a
    bf16 ``jax.Array`` column, and the port's for a bf16 tensor, in a
    dict batch and as a bare batch."""
    import jax.numpy as jnp
    import pyarrow as pa

    from ray_tpu.data import block as ref_block
    from ray_tpu_torch.data import block as blk

    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    with pytest.raises(pa.ArrowNotImplementedError):
        ref_block.block_from_batch({"x": jnp.asarray(x, jnp.bfloat16)})
    with pytest.raises(pa.ArrowNotImplementedError):
        blk.block_from_batch({"x": torch.from_numpy(x).bfloat16()})
    with pytest.raises(pa.ArrowNotImplementedError):
        blk.block_from_batch(torch.from_numpy(x).bfloat16())
    # a float32 tensor gives the reference's block for a float32 array
    assert blk.block_from_batch({"x": torch.from_numpy(x)}).equals(
        ref_block.block_from_batch({"x": jnp.asarray(x)}))


def test_iter_torch_and_device_batches():
    """``iter_torch_batches`` under both packages; the port's
    ``iter_device_batches(device="cpu")`` against the reference's
    ``iter_jax_batches``, which places its batches on the default (CPU)
    device here."""
    def scenario(rt, rdata):
        seen, dtypes = 0, set()
        for batch in rdata.range(100).iter_torch_batches(
                batch_size=32, dtypes=torch.float32):
            assert isinstance(batch["id"], torch.Tensor)
            dtypes.add(batch["id"].dtype)
            seen += batch["id"].shape[0]
        total = 0.0
        if rt is ray_tpu_torch:
            for batch in rdata.range(10).iter_device_batches(
                    batch_size=4, device="cpu"):
                assert isinstance(batch["id"], torch.Tensor)
                assert batch["id"].device.type == "cpu"
                total += float(batch["id"].sum())
        else:
            import jax
            for batch in rdata.range(10).iter_jax_batches(batch_size=4):
                assert isinstance(batch["id"], jax.Array)
                total += float(batch["id"].sum())
        return seen, dtypes, total

    ref, got = both(scenario)
    assert got[0] == 100 and got[1] == {torch.float32}
    assert got[2] == float(np.arange(10).sum())
    assert got == ref


def test_iter_device_batches_needs_a_card_or_the_cpu():
    LIVE.ensure()
    from ray_tpu_torch import data as rdata
    it = rdata.range(8).iter_device_batches(batch_size=4)
    if torch.cuda.is_available():
        assert next(it)["id"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(it)

"""The port's Train core (``ray_tpu_torch/train``) against the JAX
package's, one runtime at a time in this process: the cases of
``tests/test_train.py``, run under both packages and held to the same
values (the two checkpoint cases are in
``test_torch_train_checkpoint.py``);
``save_pytree``/``load_pytree`` on one nested tree under both; and a
gang of two ``{"GPU": 0.5}`` workers, which run on threads of the driver
in one process and still each see their own session."""

import os
import tempfile

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


def _run(scenario):
    """``scenario(rt)`` on each package's runtime in turn (the reference
    fixture's ``num_cpus=4``, 8 accelerators, 2 process workers)."""
    outs = []
    for rt, accel in PACKAGES:
        rt.init(num_cpus=4, **{accel: 8}, max_process_workers=2)
        try:
            outs.append(scenario(rt))
        finally:
            rt.shutdown()
    return outs


def _train(rt):
    return __import__(f"{rt.__name__}.train", fromlist=["train"])


def test_simple_gang_reports_metrics():
    def scenario(rt):
        train = _train(rt)

        def loop(config):
            ctx = train.get_context()
            for step in range(3):
                train.report({"step": step, "rank": ctx.get_rank(),
                              "world": ctx.get_world_size()})

        res = train.DataParallelTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2)).fit()
        assert res.error is None
        return res.metrics, res.metrics_history

    (ref_m, ref_h), (got_m, got_h) = _run(scenario)
    assert got_m["step"] == 2 and got_m["world"] == 2
    assert len(got_h) == 3
    assert got_m == ref_m and got_h == ref_h


def test_collective_allreduce_between_workers():
    def scenario(rt):
        train = _train(rt)
        col = __import__(f"{rt.__name__}.collective", fromlist=["x"])

        def loop(config):
            ctx = train.get_context()
            out = col.allreduce(np.asarray([float(ctx.get_rank() + 1)]),
                                ctx.collective_group)
            train.report({"sum": float(out[0])})

        res = train.DataParallelTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2)).fit()
        assert res.error is None
        return res.metrics

    ref, got = _run(scenario)
    assert got["sum"] == 3.0 and got == ref


def test_dataset_ingest_sharding():
    """A Dataset handed to the trainer is split into one contiguous shard
    per worker; each worker reads its own through ``get_dataset_shard``."""
    def scenario(rt):
        train = _train(rt)
        rdata = __import__(f"{rt.__name__}.data", fromlist=["data"])

        def loop(config):
            ctx = train.get_context()
            shard = train.get_dataset_shard("train")
            total = sum(int(np.sum(b["id"]))
                        for b in shard.iter_batches(batch_size=8))
            train.report({"total": total, "n": shard.count(),
                          "rank": ctx.get_rank()})

        ds = rdata.range(64, parallelism=4)
        res = train.DataParallelTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2),
            datasets={"train": ds}).fit()
        assert res.error is None
        return res.metrics

    ref, got = _run(scenario)
    assert got["n"] == 32 == ref["n"]
    # which rows a shard holds follows which read finished first
    assert got["rank"] == ref["rank"]
    assert 0 < got["total"] < sum(range(64))


def _regression_data():
    rng = np.random.RandomState(0)
    x = rng.randn(128, 4).astype(np.float32)
    return x, x @ np.asarray([1.0, -2.0, 3.0, 0.5], np.float32)


def test_training_loop_learns():
    """The reference's jitted optax SGD loop in its gang, and a torch SGD
    loop on the same data in the port's: both reach the reference's
    loss bound, with the same loss."""
    def jax_loop(config):
        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu import train
        x, y = (jnp.asarray(a) for a in _regression_data())
        w = jnp.zeros(4)
        tx = optax.sgd(0.1)
        opt = tx.init(w)

        @jax.jit
        def step(w, opt):
            loss, g = jax.value_and_grad(
                lambda w: jnp.mean((x @ w - y) ** 2))(w)
            up, opt = tx.update(g, opt)
            return optax.apply_updates(w, up), opt, loss

        for _ in range(60):
            w, opt, loss = step(w, opt)
        train.report({"loss": float(loss)})

    def torch_loop(config):
        from ray_tpu_torch import train
        x, y = (torch.from_numpy(a) for a in _regression_data())
        w = torch.zeros(4, requires_grad=True)
        opt = torch.optim.SGD([w], lr=0.1)
        for _ in range(60):
            opt.zero_grad()
            loss = torch.mean((x @ w - y) ** 2)
            loss.backward()
            opt.step()
        train.report({"loss": float(loss)})

    def scenario(rt):
        train = _train(rt)
        loop = torch_loop if rt is ray_tpu_torch else jax_loop
        res = train.DataParallelTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1)).fit()
        assert res.error is None
        return res.metrics["loss"]

    ref, got = _run(scenario)
    assert ref < 1e-2 and got < 1e-2
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_pytree_round_trip_matches_the_jax_package(tmp_path):
    """One nested dict/list/tuple/None tree with fp32, int and bf16
    leaves through both packages' ``save_pytree``/``load_pytree``: the
    same structure and the same values; the port's bf16 leaf comes back
    bit for bit as a CPU bf16 tensor, every other leaf as numpy."""
    import jax.numpy as jnp

    from ray_tpu.train import load_pytree as jax_load
    from ray_tpu.train import save_pytree as jax_save
    from ray_tpu_torch.train import load_pytree, save_pytree

    rs = np.random.RandomState(0)
    w = rs.standard_normal((3, 5)).astype(np.float32)
    ids = rs.randint(0, 1000, (7,)).astype(np.int64)
    half = rs.standard_normal((4, 2)).astype(np.float32)

    def tree(f32, i64, bf16):
        return {"params": {"w": f32, "layers": [i64, (bf16, None)]},
                "step": 12, "opt": (np.float32(0.5), [])}

    jax_save(tree(jnp.asarray(w), jnp.asarray(ids, jnp.int32),
                  jnp.asarray(half, jnp.bfloat16)), str(tmp_path / "jax"))
    save_pytree(tree(torch.from_numpy(w), torch.from_numpy(ids),
                     torch.from_numpy(half).to(torch.bfloat16)),
                str(tmp_path / "torch"))
    ref = jax_load(str(tmp_path / "jax"))
    got = load_pytree(str(tmp_path / "torch"))

    assert got["params"]["layers"][1][1] is None
    assert ref["params"]["layers"][1][1] is None
    assert got["opt"][1] == [] and ref["opt"][1] == []
    np.testing.assert_array_equal(got["params"]["w"], w)
    np.testing.assert_array_equal(got["params"]["w"], ref["params"]["w"])
    np.testing.assert_array_equal(got["params"]["layers"][0], ids)
    np.testing.assert_array_equal(got["params"]["layers"][0],
                                  ref["params"]["layers"][0])
    assert int(got["step"]) == int(ref["step"]) == 12
    assert float(got["opt"][0]) == float(ref["opt"][0]) == 0.5
    bf16 = got["params"]["layers"][1][0]
    assert isinstance(bf16, torch.Tensor) and bf16.dtype == torch.bfloat16
    assert bf16.device.type == "cpu"
    want = torch.from_numpy(half).to(torch.bfloat16)
    assert torch.equal(bf16.view(torch.int16), want.view(torch.int16))
    # the JAX package's npz keeps bf16 as raw 2-byte records: same bits
    np.testing.assert_array_equal(
        bf16.view(torch.int16).numpy(),
        ref["params"]["layers"][1][0].view(np.int16))


def test_gpu_half_workers_share_the_driver_with_their_own_sessions(tmp_path):
    """Two ``{"GPU": 0.5}`` workers under ``init(num_gpus=1)``: both run
    on threads of the driver (no card is needed for what they do), each
    sees its own rank, and the allreduce over their group is right. The
    JAX package's gang of two CPU workers (process workers) is the
    reference for the values."""
    data = np.random.RandomState(3).standard_normal((2, 1024)).astype(
        np.float32)
    outs = {}
    for rt, res in ((ray_tpu, None), (ray_tpu_torch, {"GPU": 0.5})):
        train = _train(rt)
        col = __import__(f"{rt.__name__}.collective", fromlist=["x"])
        rank_dir = tmp_path / rt.__name__
        rank_dir.mkdir()

        def loop(config):
            ctx = train.get_context()
            x = config["data"][ctx.get_rank()]
            out = col.allreduce(x, ctx.collective_group)
            np.save(os.path.join(config["dir"], f"rank_{ctx.get_rank()}.npy"),
                    out)
            train.report({"rank": ctx.get_rank(),
                          "world": ctx.get_world_size(), "pid": os.getpid()})

        kw = {"num_gpus": 1} if rt is ray_tpu_torch else {}
        rt.init(num_cpus=4, max_process_workers=2, **kw)
        try:
            result = train.DataParallelTrainer(
                loop, train_loop_config={"data": data, "dir": str(rank_dir)},
                scaling_config=train.ScalingConfig(
                    num_workers=2, resources_per_worker=res)).fit()
        finally:
            rt.shutdown()
        assert result.error is None, result.error
        outs[rt.__name__] = (
            result.metrics, sorted(os.listdir(rank_dir)),
            [np.load(rank_dir / f"rank_{r}.npy") for r in range(2)])
    ref_m, ref_files, ref_sums = outs["ray_tpu"]
    got_m, got_files, got_sums = outs["ray_tpu_torch"]
    # both ranks wrote their own file: no rank was seen twice
    assert got_files == ref_files == ["rank_0.npy", "rank_1.npy"]
    assert got_m["pid"] == os.getpid()        # a thread of this driver
    assert ref_m["pid"] != os.getpid()        # the reference's workers
    assert got_m["world"] == ref_m["world"] == 2
    for got, ref in zip(got_sums, ref_sums):
        np.testing.assert_array_equal(got, data[0] + data[1])
        np.testing.assert_array_equal(got, ref)

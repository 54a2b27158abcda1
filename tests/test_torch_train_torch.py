"""The port's TorchTrainer (``ray_tpu_torch/train/torch.py``) against the
JAX package's: the case of the JAX package's ``tests/test_torch_trainer.py``
(a gloo process group over a gang of two process workers, DDP keeping
both replicas equal) run under both packages, one runtime at a time in
this process, on the same seeds. The port's trainer is the reference's:
CPU workers and ``get_device()`` the CPU."""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _ddp_loop(package):
    def loop(config):
        import importlib

        import torch
        import torch.distributed as dist

        train = importlib.import_module(f"{package}.train")
        train_torch = importlib.import_module(f"{package}.train.torch")
        ctx = train.get_context()
        assert dist.is_initialized()
        assert dist.get_world_size() == 2
        assert dist.get_rank() == ctx.get_rank()
        assert train_torch.get_device() == torch.device("cpu")

        torch.manual_seed(1234)          # same init on every rank
        model = torch.nn.Linear(4, 1)
        model = train_torch.prepare_model(model)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)

        # rank-dependent data: DDP's gradient allreduce is the only
        # thing keeping replicas identical
        rng = np.random.RandomState(100 + ctx.get_rank())
        x = torch.tensor(rng.rand(64, 4), dtype=torch.float32)
        w_true = torch.tensor([[1.0], [-2.0], [3.0], [0.5]])
        y = x @ w_true

        losses = []
        for _ in range(30):
            opt.zero_grad()
            loss = torch.nn.functional.mse_loss(model(x), y)
            loss.backward()
            opt.step()
            losses.append(float(loss))
        param_sum = float(sum(p.detach().sum() for p in
                              model.parameters()))
        gathered = [torch.zeros(1) for _ in range(2)]
        dist.all_gather(gathered, torch.tensor([param_sum]))
        train.report({"loss": losses[-1], "first_loss": losses[0],
                      "param_sum_r0": float(gathered[0]),
                      "param_sum_r1": float(gathered[1]),
                      "rank": ctx.get_rank()})
    return loop


def test_torch_ddp_gang_trains_and_syncs():
    results = []
    for rt, accel in ((ray_tpu, "num_tpus"), (ray_tpu_torch, "num_gpus")):
        rt.init(num_cpus=4, **{accel: 8}, max_process_workers=2)
        try:
            trainer_mod = __import__(f"{rt.__name__}.train.torch",
                                     fromlist=["x"])
            train = __import__(f"{rt.__name__}.train", fromlist=["x"])
            result = trainer_mod.TorchTrainer(
                _ddp_loop(rt.__name__),
                scaling_config=train.ScalingConfig(num_workers=2)).fit()
        finally:
            rt.shutdown()
        assert result.error is None, result.error
        results.append(result.metrics)
    ref, got = results
    assert got["loss"] < got["first_loss"] * 0.5          # learned
    # allreduced gradients keep both replicas bit-identical
    assert got["param_sum_r0"] == pytest.approx(got["param_sum_r1"],
                                                abs=1e-6)
    # the same seeds, data and gloo reductions under both packages
    for key in ("loss", "first_loss", "param_sum_r0", "param_sum_r1"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6)

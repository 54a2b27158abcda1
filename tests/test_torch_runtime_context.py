"""The port's ``ray_tpu_torch.get_runtime_context()``: the cases of
``tests/test_runtime_context.py`` on ``ray_tpu_torch`` (driver, task and
actor identity; the driver's context after an in-process task; an
in-process async actor's context).
"""

import pytest

import ray_tpu_torch


@pytest.fixture
def ray_start_regular():
    """The reference fixture's runtime on the port: 4 CPUs, 8 GPUs of
    resource (no card is needed for work that demands none), 2 process
    workers."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()



def test_driver_context(ray_start_regular):
    ctx = ray_tpu_torch.get_runtime_context()
    assert ctx.is_driver
    assert ctx.worker_mode == "driver"
    assert ctx.get_task_id() is None
    assert ctx.get_actor_id() is None
    assert ctx.get_job_id()


def test_task_context_matches_ref(ray_start_regular):
    @ray_tpu_torch.remote
    def who():
        c = ray_tpu_torch.get_runtime_context()
        return c.worker_mode, c.get_task_id(), c.get_actor_id()

    ref = who.remote()
    mode, task_id, actor_id = ray_tpu_torch.get(ref)
    assert mode == "worker"
    assert task_id == ref.id().task_id().hex()
    assert actor_id is None


def test_actor_context(ray_start_regular):
    @ray_tpu_torch.remote
    class A:
        def me(self):
            c = ray_tpu_torch.get_runtime_context()
            return c.get_actor_id(), c.get_task_id()

        async def me_async(self):
            c = ray_tpu_torch.get_runtime_context()
            return c.get_actor_id()

    a = A.remote()
    actor_id, task_id = ray_tpu_torch.get(a.me.remote())
    assert actor_id == a._actor_id.hex()
    assert task_id                      # actor call has a task id

    @ray_tpu_torch.remote
    class B:
        async def me(self):
            return ray_tpu_torch.get_runtime_context().get_actor_id()

    b = B.remote()
    assert ray_tpu_torch.get(b.me.remote()) == b._actor_id.hex()


def test_driver_context_after_inprocess_task(ray_start_regular):
    """In-process (TPU-substrate) tasks run in the driver process; a
    finished one must not make the driver thread report worker mode."""
    @ray_tpu_torch.remote(num_gpus=1)
    def on_tpu_substrate():
        return ray_tpu_torch.get_runtime_context().worker_mode

    assert ray_tpu_torch.get(on_tpu_substrate.remote()) == "worker"
    assert ray_tpu_torch.get_runtime_context().is_driver


def test_inprocess_async_actor_context(ray_start_regular):
    """Async actors on the in-process (TPU) substrate report identity
    through the per-asyncio-task contextvar."""
    @ray_tpu_torch.remote(num_gpus=1)
    class A:
        async def me(self):
            c = ray_tpu_torch.get_runtime_context()
            return c.worker_mode, c.get_actor_id()

    a = A.remote()
    mode, aid = ray_tpu_torch.get(a.me.remote())
    assert mode == "worker" and aid == a._actor_id.hex()
    assert ray_tpu_torch.get_runtime_context().is_driver

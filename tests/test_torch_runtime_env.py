"""The port's runtime_env: the cases of ``tests/test_runtime_env.py`` on
``ray_tpu_torch`` (per-task/actor ``env_vars`` and ``working_dir``
applied around execution; conda and other agent-built pieces refused).
"""

import os

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



def test_task_env_vars_applied_and_restored(ray_start_regular):
    @ray_tpu_torch.remote
    def read_env():
        return os.environ.get("RTPU_TEST_VAR")

    assert ray_tpu_torch.get(read_env.options(
        runtime_env={"env_vars": {"RTPU_TEST_VAR": "hello"}}).remote()) \
        == "hello"
    # a later task on the same worker pool sees a clean environment
    assert ray_tpu_torch.get(read_env.remote()) is None


def test_task_working_dir(ray_start_regular, tmp_path):
    @ray_tpu_torch.remote
    def cwd():
        return os.getcwd()

    out = ray_tpu_torch.get(cwd.options(
        runtime_env={"working_dir": str(tmp_path)}).remote())
    assert out == str(tmp_path)


def test_actor_keeps_env_for_lifetime(ray_start_regular):
    @ray_tpu_torch.remote
    class EnvActor:
        def read(self):
            return os.environ.get("RTPU_ACTOR_VAR")

    a = EnvActor.options(
        runtime_env={"env_vars": {"RTPU_ACTOR_VAR": "sticky"}}).remote()
    assert ray_tpu_torch.get(a.read.remote()) == "sticky"
    assert ray_tpu_torch.get(a.read.remote()) == "sticky"


def test_unsupported_runtime_env_rejected(ray_start_regular):
    @ray_tpu_torch.remote
    def f():
        return 1

    with pytest.raises(ValueError, match="unsupported runtime_env"):
        f.options(runtime_env={"conda": "env"}).remote()
    with pytest.raises(ValueError, match="pip"):
        f.options(runtime_env={"pip": {"bogus_key": 1}}).remote()
    with pytest.raises(ValueError, match="str -> str"):
        f.options(runtime_env={"env_vars": {"A": 1}}).remote()

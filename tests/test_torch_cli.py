"""The port's command line (``python -m ray_tpu_torch``,
``ray_tpu_torch.scripts.cli``): the case of
``tests/test_cluster_bootstrap.py`` on ``ray_tpu_torch`` (a head GCS and
a raylet started by the CLI, a driver joining with
``init(address=..., num_gpus=0)``), and ``start --address --num-gpus 1``
refused (a raylet process sees no card). ``test_torch_detached.py``
imports its helpers.

Every CLI process and driver here runs with its own ``TMPDIR`` (a
temporary directory of the test): the session directories, and what
``stop`` looks for, live there.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def _tmpdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cli_tmp"))


@pytest.fixture(autouse=True)
def _own_tmpdir(_tmpdir, monkeypatch):
    monkeypatch.setenv("RTPT_CLI_TEST_TMPDIR", _tmpdir)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = os.environ["RTPT_CLI_TEST_TMPDIR"]
    return env


def _cli(*args, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", *args],
        capture_output=True, text=True, env=_env(), timeout=timeout)


def _run_driver(path, timeout=180):
    return subprocess.run([sys.executable, str(path)],
                          capture_output=True, text=True, env=_env(),
                          timeout=timeout)


def test_cli_bootstrap_join_and_stop(tmp_path):
    session = f"boot{os.getpid()}"
    head = _cli("start", "--head", "--session", session)
    assert head.returncode == 0, head.stderr
    m = re.search(r"at (\d+\.\d+\.\d+\.\d+:\d+)", head.stdout)
    assert m, head.stdout
    addr = m.group(1)
    try:
        node = _cli("start", "--address", addr, "--session", session,
                    "--num-cpus", "2", "--resources", '{"BOOT": 1}')
        assert node.returncode == 0, node.stderr
        assert "raylet started" in node.stdout

        status = _cli("status", "--address", addr)
        assert status.returncode == 0, status.stderr
        assert "BOOT" in status.stdout
        assert "True" in status.stdout

        # a driver process joins the cluster and runs a task on the
        # CLI-started raylet
        driver = tmp_path / "driver.py"
        driver.write_text(f"""
import ray_tpu_torch
w = ray_tpu_torch.init(address="{addr}", num_cpus=1, num_gpus=0,
                       max_process_workers=1)

@ray_tpu_torch.remote(num_cpus=1, resources={{"BOOT": 1}})
def whereami():
    import os
    return os.getpid()

pid = ray_tpu_torch.get(whereami.remote(), timeout=120)
import os
assert pid != os.getpid()
print("JOIN-OK", pid)
ray_tpu_torch.shutdown()
""")
        run = subprocess.run([sys.executable, str(driver)],
                             capture_output=True, text=True, env=_env(),
                             timeout=180)
        assert run.returncode == 0, run.stderr[-2000:]
        assert "JOIN-OK" in run.stdout
    finally:
        stop = _cli("stop", "--session", session)
        assert "terminated" in stop.stdout


def test_start_num_gpus_on_a_raylet_is_refused():
    """A raylet process sees no card: ``start --address`` refuses
    ``--num-gpus`` (and a GPU in ``--resources``) with ``Cluster``'s
    message, and starts nothing."""
    from ray_tpu_torch.cluster_utils import refuse_remote_gpu
    with pytest.raises(ValueError) as err:
        refuse_remote_gpu({"GPU": 1.0})
    for extra in (("--num-gpus", "1"), ("--resources", '{"GPU": 2}')):
        out = _cli("start", "--address", "127.0.0.1:1", "--session",
                   f"gpu{os.getpid()}", *extra)
        assert out.returncode == 2, out.stdout
        assert str(err.value) in out.stderr
        assert "raylet started" not in out.stdout
    tmp = os.environ["RTPT_CLI_TEST_TMPDIR"]
    assert not [d for d in os.listdir(tmp)
                if d.startswith(f"rtpt_gpu{os.getpid()}")]


def test_cli_job_submit_takes_the_session_token():
    """``job submit`` against a CLI-started head finds the session token
    as ``status`` does (the same-host token file); the job joins the
    cluster, runs a task, and its
    log holds the job's line. The JAX package's ``job`` commands install
    no token, and the GCS refuses them."""
    session = f"job{os.getpid()}"
    head = _cli("start", "--head", "--session", session)
    assert head.returncode == 0, head.stderr
    addr = re.search(r"at (\d+\.\d+\.\d+\.\d+:\d+)", head.stdout).group(1)
    try:
        entry = ("import os, ray_tpu_torch as rt; "
                 "rt.init(address=os.environ['RAY_TPU_ADDRESS'], "
                 "num_cpus=1, num_gpus=0, max_process_workers=1); "
                 "print('job-sum', rt.get(rt.remote(sum).remote([1, 2]))); "
                 "rt.shutdown()")
        out = _cli("job", "submit", "--address", addr, "--",
                   sys.executable, "-c", f'"{entry}"', timeout=180)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "job-sum 3" in out.stdout
        assert "SUCCEEDED (rc=0)" in out.stdout
        listed = _cli("job", "list", "--address", addr)
        assert listed.returncode == 0 and "SUCCEEDED" in listed.stdout
    finally:
        stop = _cli("stop", "--session", session)
        assert "terminated" in stop.stdout

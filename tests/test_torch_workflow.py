"""The port's durable workflows (``ray_tpu_torch.workflow``): every case
of ``tests/test_workflow.py`` on ``ray_tpu_torch``, and a step record of
the JAX package's refused by the port's ``resume``.

``test_parallel_branches_run_concurrently`` waits for the event it
asserts on: each branch records its start and waits until it has seen
another branch start, so the case holds under load where the
reference's wall-time bound (three 0.6 s branches under 1.7 s) does not.
The crash driver starts its runtime with ``num_gpus=0``: the port's
``init`` without it raises where there is no card.
"""

import os
import shutil

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    """The reference's fixture on the port: 4 CPUs, 2 process workers and
    8 GPUs of resource, whose work runs on driver threads."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


def _counter_task(path):
    @ray_tpu_torch.remote
    def step(x, tag):
        with open(path, "a") as f:
            f.write(f"{tag}\n")
        return x + 1

    return step


def test_workflow_runs_and_persists(ray_start_regular, tmp_path):
    marks = tmp_path / "marks.txt"
    step = _counter_task(str(marks))
    with InputNode() as inp:
        dag = step.bind(step.bind(inp, "a"), "b")
    out = workflow.run(dag, 10, workflow_id="w1",
                       storage=str(tmp_path / "store"))
    assert out == 12
    assert workflow.get_status("w1", str(tmp_path / "store")) == "SUCCEEDED"
    assert marks.read_text().splitlines() == ["a", "b"]
    # re-running the same workflow replays from persisted results
    out2 = workflow.run(dag, 10, workflow_id="w1",
                        storage=str(tmp_path / "store"))
    assert out2 == 12
    assert marks.read_text().splitlines() == ["a", "b"]  # no re-execution


def test_workflow_resume_after_failure(ray_start_regular, tmp_path):
    marks = tmp_path / "marks.txt"
    flag = tmp_path / "let_b_pass"
    storage = str(tmp_path / "store")

    @ray_tpu_torch.remote
    def step_a(x):
        with open(marks, "a") as f:
            f.write("a\n")
        return x + 1

    @ray_tpu_torch.remote
    def step_b(x):
        if not os.path.exists(flag):
            raise RuntimeError("transient failure")
        with open(marks, "a") as f:
            f.write("b\n")
        return x * 2

    with InputNode() as inp:
        dag = step_b.bind(step_a.bind(inp))

    with pytest.raises(RuntimeError):
        workflow.run(dag, 5, workflow_id="w2", storage=storage)
    assert workflow.get_status("w2", storage) == "FAILED"
    assert marks.read_text().splitlines() == ["a"]   # a persisted

    flag.touch()
    out = workflow.resume("w2", storage)
    assert out == 12
    assert workflow.get_status("w2", storage) == "SUCCEEDED"
    # step a did NOT re-run; only b did
    assert marks.read_text().splitlines() == ["a", "b"]


def test_workflow_list_and_delete(ray_start_regular, tmp_path):
    storage = str(tmp_path / "store")

    @ray_tpu_torch.remote
    def one():
        return 1

    workflow.run(one.bind(), workflow_id="wx", storage=storage)
    assert ("wx", "SUCCEEDED") in workflow.list_all(storage)
    workflow.delete("wx", storage)
    assert workflow.list_all(storage) == []
    assert workflow.get_status("wx", storage) == "NOT_FOUND"


def test_step_level_retries_to_success(ray_start_regular, tmp_path):
    attempts = tmp_path / "attempts"
    storage = str(tmp_path / "store")

    @ray_tpu_torch.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        with open(attempts, "a") as f:
            f.write("x")
        if len(open(attempts).read()) < 3:
            raise ValueError("not yet")
        return "ok"

    out = workflow.run(flaky.bind(), workflow_id="wr", storage=storage)
    assert out == "ok"
    assert open(attempts).read() == "xxx"      # 2 failures + 1 success
    assert workflow.get_status("wr", storage) == "SUCCEEDED"


def test_catch_exceptions_step(ray_start_regular, tmp_path):
    storage = str(tmp_path / "store")

    @ray_tpu_torch.remote
    def bad():
        raise ValueError("boom")

    @ray_tpu_torch.remote
    def good():
        return 7

    node_bad = workflow.options(catch_exceptions=True)(bad.bind())
    node_good = workflow.options(catch_exceptions=True)(good.bind())

    @ray_tpu_torch.remote
    def join(a, b):
        (va, ea), (vb, eb) = a, b
        assert va is None and "boom" in str(ea)
        assert vb == 7 and eb is None
        return "joined"

    out = workflow.run(join.bind(node_bad, node_good),
                       workflow_id="wc", storage=storage)
    assert out == "joined"
    assert workflow.get_status("wc", storage) == "SUCCEEDED"


def test_dynamic_continuation(ray_start_regular, tmp_path):
    storage = str(tmp_path / "store")

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    @ray_tpu_torch.remote
    def fib(n):
        from ray_tpu_torch import workflow as wf
        if n <= 1:
            return n
        # dynamic: this step's value is the result of a NEW dag
        return wf.continuation(add.bind(fib.bind(n - 1),
                                        fib.bind(n - 2)))

    out = workflow.run(fib.bind(7), workflow_id="wf7", storage=storage)
    assert out == 13            # fib(7)
    assert workflow.get_status("wf7", storage) == "SUCCEEDED"


def test_parallel_branches_run_concurrently(ray_start_regular, tmp_path):
    """Each branch records its start, then waits (up to 60 s) until it
    has seen another branch start. Run one after another, the first
    branch would see no other and report it; run concurrently, every
    branch sees at least two starts."""
    storage = str(tmp_path / "store")
    starts = str(tmp_path / "starts")

    @ray_tpu_torch.remote
    def branch(tag):
        import time as _t
        with open(starts, "a") as f:
            f.write(tag + "\n")
        deadline = _t.monotonic() + 60.0
        while _t.monotonic() < deadline:
            with open(starts) as f:
                if len(f.read().split()) >= 2:
                    return tag, True
            _t.sleep(0.01)
        return tag, False

    @ray_tpu_torch.remote
    def join(*parts):
        return "".join(t for t, _ in parts), [seen for _, seen in parts]

    dag = join.bind(branch.bind("a"), branch.bind("b"), branch.bind("c"))
    out, overlapped = workflow.run(dag, workflow_id="wp", storage=storage)
    assert out == "abc"
    assert overlapped == [True, True, True]


_CRASH_DRIVER = """
import os, sys
sys.path.insert(0, {repo!r})
os.environ["RTPU_TEST_DRIVER_PID"] = str(os.getpid())
import ray_tpu_torch
from ray_tpu_torch import workflow

marks = {marks!r}
storage = {storage!r}

@ray_tpu_torch.remote
def stamp(x, tag):
    with open(marks, "a") as f:
        f.write(tag + "\\n")
    return x + 1

@ray_tpu_torch.remote
def spawn(x):
    from ray_tpu_torch import workflow as wf
    with open(marks, "a") as f:
        f.write("spawn\\n")
    return wf.continuation(stamp.bind(stamp.bind(x, "c1"), "c2"))

@ray_tpu_torch.remote
def crashpoint(x):
    # first run: SIGKILL the DRIVER (pid inherited via env) after
    # every upstream step has persisted — a real mid-workflow crash
    if not os.path.exists(storage + "/survive"):
        import signal, time
        os.kill(int(os.environ["RTPU_TEST_DRIVER_PID"]), signal.SIGKILL)
        time.sleep(30)
    with open(marks, "a") as f:
        f.write("tail\\n")
    return x * 10

ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_process_workers=2)
from ray_tpu_torch.dag import InputNode
with InputNode() as inp:
    dag = crashpoint.bind(spawn.bind(stamp.bind(inp, "head")))
print(workflow.{entry}, flush=True)
"""


def test_crash_resume_through_continuation(ray_start_regular, tmp_path):
    """Kill the DRIVER mid-workflow (after a continuation persisted);
    resume in a fresh process: completed steps (including continuation
    sub-steps) must not re-execute, and the tail completes."""
    import subprocess
    import sys

    marks = str(tmp_path / "marks.txt")
    storage = str(tmp_path / "store")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    env = dict(os.environ, PYTHONPATH=repo)
    run_src = _CRASH_DRIVER.format(
        repo=repo, marks=marks, storage=storage,
        entry="run(dag, 1, workflow_id='wk', storage=" + repr(storage)
              + ")")
    p = subprocess.run([sys.executable, "-c", run_src], env=env,
                       timeout=180)
    assert p.returncode == -9      # driver SIGKILLed mid-workflow
    first = open(marks).read().splitlines()
    assert first == ["head", "spawn", "c1", "c2"]

    open(storage + "/survive", "w").write("1")
    resume_src = _CRASH_DRIVER.format(
        repo=repo, marks=marks, storage=storage,
        entry="resume('wk', " + repr(storage) + ")")
    p2 = subprocess.run([sys.executable, "-c", resume_src], env=env,
                        capture_output=True, timeout=180)
    assert p2.returncode == 0, p2.stderr.decode()[-2000:]
    assert p2.stdout.decode().strip().endswith("40")   # ((1+1)+1+1)*10
    after = open(marks).read().splitlines()
    # head/spawn/c1/c2 did NOT re-run; only the tail executed
    assert after == ["head", "spawn", "c1", "c2", "tail"]


def test_catch_exceptions_through_continuation(ray_start_regular,
                                               tmp_path):
    storage = str(tmp_path / "store")

    @ray_tpu_torch.remote
    def inner_bad():
        raise ValueError("deep boom")

    @ray_tpu_torch.remote
    def outer():
        from ray_tpu_torch import workflow as wf
        return wf.continuation(inner_bad.bind())

    node = workflow.options(catch_exceptions=True)(outer.bind())

    @ray_tpu_torch.remote
    def unwrap(pair):
        v, e = pair
        return (v, "deep boom" in str(e))

    out = workflow.run(unwrap.bind(node), workflow_id="wcc",
                       storage=storage)
    assert out == (None, True)
    assert workflow.get_status("wcc", storage) == "SUCCEEDED"

    # successful continuation under catch wraps as (value, None)
    @ray_tpu_torch.remote
    def inner_ok():
        return 5

    @ray_tpu_torch.remote
    def outer_ok():
        from ray_tpu_torch import workflow as wf
        return wf.continuation(inner_ok.bind())

    node2 = workflow.options(catch_exceptions=True)(outer_ok.bind())
    out2 = workflow.run(unwrap.bind(node2), workflow_id="wcc2",
                        storage=storage)
    assert out2 == (5, False)


def test_multi_return_step(ray_start_regular, tmp_path):
    storage = str(tmp_path / "store")

    @ray_tpu_torch.remote(num_returns=2)
    def pair():
        return 3, 4

    @ray_tpu_torch.remote
    def mul(xy):
        a, b = xy
        return a * b

    out = workflow.run(mul.bind(pair.bind()), workflow_id="wm",
                       storage=storage)
    assert out == 12


def test_record_of_the_jax_package_is_refused(tmp_path):
    """The same two-step workflow fails at its second step under each
    package; the JAX package's persisted first-step record, put in the
    port's workflow directory, is refused by the port's ``resume`` with
    the reference's storage-format error, and the port's own record
    resumes."""
    import ray_tpu
    import ray_tpu.workflow as jax_workflow

    flag = tmp_path / "let_b_pass"

    def scenario(rt, wf, accel):
        @rt.remote
        def step_a(x):
            return x + 1

        @rt.remote
        def step_b(x):
            if not os.path.exists(flag):
                raise RuntimeError("transient failure")
            return x * 2

        dag_mod = __import__(f"{rt.__name__}.dag", fromlist=["InputNode"])
        with dag_mod.InputNode() as inp:
            dag = step_b.bind(step_a.bind(inp))
        rt.init(num_cpus=2, max_process_workers=1, **{accel: 0})
        try:
            with pytest.raises(Exception, match="transient failure"):
                wf.run(dag, 5, workflow_id="wz",
                       storage=str(tmp_path / rt.__name__))
        finally:
            rt.shutdown()

    scenario(ray_tpu, jax_workflow, "num_tpus")
    scenario(ray_tpu_torch, workflow, "num_gpus")
    ours = tmp_path / "ray_tpu_torch" / "wz"
    theirs = tmp_path / "ray_tpu" / "wz"
    steps = sorted(p.name for p in ours.glob("step_*.pkl"))
    assert steps == sorted(p.name for p in theirs.glob("step_*.pkl"))
    assert len(steps) == 1
    kept = ours / "kept.pkl"
    shutil.copy(ours / steps[0], kept)
    shutil.copy(theirs / steps[0], ours / steps[0])
    flag.touch()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_process_workers=1)
    try:
        with pytest.raises(RuntimeError,
                           match="incompatible workflow storage format"):
            workflow.resume("wz", str(tmp_path / "ray_tpu_torch"))
        shutil.copy(kept, ours / steps[0])
        assert workflow.resume("wz", str(tmp_path / "ray_tpu_torch")) == 12
    finally:
        ray_tpu_torch.shutdown()

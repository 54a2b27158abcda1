"""The port's job submission and dashboard
(``ray_tpu_torch.job_submission``, ``ray_tpu_torch.dashboard``): the 5
cases of ``tests/test_jobs_dashboard.py`` on ``ray_tpu_torch`` (drivers
start with ``num_gpus=0``: the port's ``init`` without it raises where
there is no card), and a job submitted without ``log_dir`` keeping its
log in the session directory ``rtpt_jobs`` under ``TMPDIR``.
"""

import json
import os
import urllib.request

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it. Imported
    here, not at the top: a process worker that unpickles this module's
    functions then loads no torch."""
    import torch
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


def test_job_submission_end_to_end(tmp_path):
    """Submit entrypoints against a cluster GCS; statuses, logs, and
    the joined driver's task execution all work."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_process_workers=2,
                           _system_config={"gcs_mode": "process"})
    try:
        from ray_tpu_torch.job_submission import JobSubmissionClient
        addr = f"{w.gcs_address[0]}:{w.gcs_address[1]}"
        client = JobSubmissionClient(addr)

        script = tmp_path / "entry.py"
        script.write_text(
            "import os, ray_tpu_torch\n"
            "w = ray_tpu_torch.init(address=os.environ['RAY_TPU_ADDRESS'],\n"
            "                       num_cpus=1, num_gpus=0,\n"
            "                       max_process_workers=1)\n"
            "print('job ran against', os.environ['RAY_TPU_ADDRESS'])\n"
            "ray_tpu_torch.shutdown()\n")
        job_id = client.submit_job(
            entrypoint=f"python {script}",
            log_dir=str(tmp_path))
        info = client.wait_until_finished(job_id, timeout=120)
        assert info.status == "SUCCEEDED", client.get_job_logs(job_id)
        assert "job ran against" in client.get_job_logs(job_id)

        bad = client.submit_job(entrypoint="python -c 'raise SystemExit(3)'",
                                log_dir=str(tmp_path))
        info = client.wait_until_finished(bad, timeout=60)
        assert info.status == "FAILED"
        assert info.return_code == 3

        jobs = {j.job_id: j.status for j in client.list_jobs()}
        assert jobs[job_id] == "SUCCEEDED" and jobs[bad] == "FAILED"
        client.close()
    finally:
        ray_tpu_torch.shutdown()


def test_dashboard_endpoints(ray_start_regular):
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    @ray_tpu_torch.remote
    def f():
        return 1

    ray_tpu_torch.get(f.remote())
    host, port = start_dashboard()
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://{host}:{port}{path}", timeout=30) as r:
                return r.read().decode()

        summary = json.loads(get("/api/summary"))
        assert summary["tasks"]["finished"] >= 1
        nodes = json.loads(get("/api/nodes"))
        assert any(n["is_head"] for n in nodes)
        html = get("/")
        assert "ray_tpu_torch" in html and "summary" in html
        assert "ray_tpu_tasks" in get("/metrics")
    finally:
        stop_dashboard()


def test_dashboard_api_endpoints_full(ray_start_regular):
    """Every JSON API endpoint serves well-formed rows; /metrics carries
    runtime + per-node series; unknown endpoints 404; long task lists
    are capped server-side."""
    import json as _json
    import urllib.error
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    @ray_tpu_torch.remote
    def work(i):
        return i

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    # >500 completed tasks so the server-side row cap is really hit
    ray_tpu_torch.get([work.remote(i) for i in range(520)]
                + [a.ping.remote()])

    host, port = start_dashboard()
    base = f"http://{host}:{port}"

    def get(path):
        return urllib.request.urlopen(base + path, timeout=10).read()

    try:
        for kind, key in [("nodes", "node_id"), ("actors", "actor_id"),
                          ("tasks", "task_id"), ("workers", "node_id"),
                          ("objects", "object_id")]:
            rows = _json.loads(get(f"/api/{kind}"))
            assert isinstance(rows, list), kind
            assert len(rows) <= 500
            if kind == "tasks":
                assert len(rows) == 500   # the cap actually engaged
            if rows:
                assert key in rows[0], (kind, rows[0])
        metrics = get("/metrics").decode()
        assert "ray_tpu_node_resource_available" in metrics
        assert "# TYPE" in metrics
        page = get("/").decode()
        assert "ray_tpu_torch" in page and "summary" in page
        try:
            get("/api/nonsense")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        stop_dashboard()


def test_dashboard_timeline_api_and_tab(ray_start_regular):
    """/api/timeline serves Chrome-trace spans from a live run and the
    single-file UI carries the timeline tab (reference: `ray timeline`
    + the dashboard timeline view)."""
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    @ray_tpu_torch.remote
    def traced(i):
        return i * 2

    assert ray_tpu_torch.get([traced.remote(i) for i in range(4)]) \
        == [0, 2, 4, 6]
    host, port = start_dashboard()
    try:
        with urllib.request.urlopen(
                f"http://{host}:{port}/api/timeline", timeout=30) as r:
            spans = json.loads(r.read().decode())
        assert spans, "no spans from a run with finished tasks"
        one = spans[0]
        assert one["ph"] == "X" and one["dur"] >= 0 and "name" in one
        with urllib.request.urlopen(
                f"http://{host}:{port}/", timeout=30) as r:
            html = r.read().decode()
        assert "timeline" in html and "metrics" in html
        assert "pollMetrics" in html      # browser-side series tab
    finally:
        stop_dashboard()


def test_cli_list_and_timeline(ray_start_regular, tmp_path):
    """`ray_tpu_torch list <kind> --dashboard` renders tables over the state
    API; `ray_tpu_torch timeline` exports Chrome-trace JSON (reference:
    `ray list tasks`, `ray timeline`)."""
    import subprocess
    import sys

    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    @ray_tpu_torch.remote
    class Svc:
        def ping(self):
            return "pong"

    @ray_tpu_torch.remote
    def tsk():
        return 1

    svc = Svc.options(name="cli_svc").remote()
    assert ray_tpu_torch.get(svc.ping.remote()) == "pong"
    assert ray_tpu_torch.get(tsk.remote()) == 1
    host, port = start_dashboard()
    dash = f"{host}:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", "")

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", *args],
            capture_output=True, text=True, env=env, timeout=60)

    try:
        out = cli("list", "actors", "--dashboard", dash)
        assert out.returncode == 0, out.stderr
        assert "Svc" in out.stdout and "ALIVE" in out.stdout
        assert "CLASS_NAME" in out.stdout      # table header
        out = cli("list", "tasks", "--dashboard", dash)
        assert out.returncode == 0, out.stderr
        assert "tsk" in out.stdout and "finished" in out.stdout
        out = cli("list", "nodes", "--dashboard", dash)
        assert out.returncode == 0, out.stderr
        assert "True" in out.stdout
        out = cli("list", "objects", "--dashboard", dash,
                  "--format", "json")
        assert out.returncode == 0, out.stderr
        json.loads(out.stdout)
        # driver-owned kinds refuse a GCS-only route with guidance
        out = cli("list", "tasks", "--address", "127.0.0.1:1")
        assert out.returncode != 0
        assert "--dashboard" in (out.stderr + out.stdout)

        out = cli("memory", "--dashboard", dash)
        assert out.returncode == 0, out.stderr
        assert "OBJECT STORE" in out.stdout
        assert "live object reference" in out.stdout

        trace_path = tmp_path / "trace.json"
        out = cli("timeline", "--dashboard", dash,
                  "--out", str(trace_path))
        assert out.returncode == 0, out.stderr
        spans = json.loads(trace_path.read_text())
        assert spans and all(e["ph"] == "X" for e in spans)
    finally:
        stop_dashboard()
        ray_tpu_torch.kill(svc)


def test_job_log_defaults_to_the_session_dir(tmp_path, monkeypatch):
    """Without ``log_dir`` a job's log lands in ``$TMPDIR/rtpt_jobs``,
    never in ``/tmp``."""
    import tempfile
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    w = ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_process_workers=1,
                           _system_config={"gcs_mode": "process"})
    try:
        from ray_tpu_torch.job_submission import JobSubmissionClient
        client = JobSubmissionClient(
            f"{w.gcs_address[0]}:{w.gcs_address[1]}")
        job_id = client.submit_job(entrypoint="echo job-log-line")
        info = client.wait_until_finished(job_id, timeout=60)
        assert info.status == "SUCCEEDED"
        assert info.log_path == str(tmp_path / "rtpt_jobs" / f"{job_id}.log")
        assert client.get_job_logs(job_id) == "job-log-line\n"
        assert not os.path.exists(f"/tmp/rtpt_jobs/{job_id}.log")
        client.close()
    finally:
        ray_tpu_torch.shutdown()

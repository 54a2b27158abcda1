"""Job submission: run driver entrypoints against a cluster.

Reference: ``python/ray/job_submission/`` + the dashboard job manager
(``ray job submit`` runs the entrypoint under a supervisor, streams
logs, tracks status) [UNVERIFIED — mount empty, SURVEY.md §0]. The
job table lives in the cluster GCS's KV store, so any client connected
to the GCS can list/poll jobs; entrypoints get the cluster address via
``RAY_TPU_ADDRESS`` and join with ``init(address=...)``. Job logs go
to the session directory ``jobs`` under ``TMPDIR`` unless ``log_dir``
says otherwise.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.session_dir import session_dir

_KV_NS = "job"


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str                 # PENDING|RUNNING|SUCCEEDED|FAILED
    start_time: float
    end_time: Optional[float] = None
    return_code: Optional[int] = None
    log_path: str = ""


class JobSubmissionClient:
    def __init__(self, address: str):
        from ray_tpu_torch._private.gcs_client import GcsClient
        host, port = address.rsplit(":", 1)
        self.address = address
        self._gcs = GcsClient((host, int(port)))
        self._procs: Dict[str, subprocess.Popen] = {}

    # -- submission ----------------------------------------------------

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   submission_id: Optional[str] = None,
                   log_dir: Optional[str] = None) -> str:
        job_id = submission_id or f"job-{uuid.uuid4().hex[:10]}"
        d = log_dir or session_dir("jobs")
        os.makedirs(d, exist_ok=True)
        log_path = os.path.join(d, f"{job_id}.log")
        env = dict(os.environ)
        env["RAY_TPU_ADDRESS"] = self.address
        # the entrypoint sees the same ray_tpu_torch the submitter runs
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + env.get("PYTHONPATH", "").split(os.pathsep))
        for k, v in ((runtime_env or {}).get("env_vars") or {}).items():
            env[k] = v
        info = JobInfo(job_id=job_id, entrypoint=entrypoint,
                       status="RUNNING", start_time=time.time(),
                       log_path=log_path)
        self._put(info)
        log = open(log_path, "ab")
        proc = subprocess.Popen(
            entrypoint, shell=True, env=env, stdout=log, stderr=log,
            cwd=(runtime_env or {}).get("working_dir"),
            start_new_session=True)
        log.close()
        self._procs[job_id] = proc
        return job_id

    # -- tracking ------------------------------------------------------

    def _put(self, info: JobInfo) -> None:
        self._gcs.kv_put(info.job_id.encode(),
                         json.dumps(info.__dict__).encode(), _KV_NS)

    def _read(self, job_id: str) -> Optional[JobInfo]:
        blob = self._gcs.kv_get(job_id.encode(), _KV_NS)
        if blob is None:
            return None
        return JobInfo(**json.loads(blob))

    def _reap(self, job_id: str) -> None:
        proc = self._procs.get(job_id)
        if proc is None:
            return
        rc = proc.poll()
        if rc is None:
            return
        info = self._read(job_id)
        if info and info.status == "RUNNING":
            info.status = "SUCCEEDED" if rc == 0 else "FAILED"
            info.end_time = time.time()
            info.return_code = rc
            self._put(info)

    def get_job_info(self, job_id: str) -> Optional[JobInfo]:
        self._reap_if_local(job_id)
        return self._read(job_id)

    def _reap_if_local(self, job_id: str) -> None:
        if job_id in self._procs:
            self._reap(job_id)

    def get_job_status(self, job_id: str) -> str:
        info = self.get_job_info(job_id)
        return info.status if info else "NOT_FOUND"

    def wait_until_finished(self, job_id: str, timeout: float = 300.0
                            ) -> JobInfo:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = self.get_job_info(job_id)
            if info and info.status in ("SUCCEEDED", "FAILED"):
                return info
            time.sleep(0.2)
        raise TimeoutError(f"job {job_id} still running after {timeout}s")

    def get_job_logs(self, job_id: str) -> str:
        info = self.get_job_info(job_id)
        if info is None or not os.path.exists(info.log_path):
            return ""
        with open(info.log_path, "r", errors="replace") as f:
            return f.read()

    def list_jobs(self) -> List[JobInfo]:
        out = []
        for key in self._gcs.kv_keys(b"", _KV_NS):
            self._reap_if_local(key.decode())
            blob = self._gcs.kv_get(key, _KV_NS)
            if blob:
                out.append(JobInfo(**json.loads(blob)))
        return sorted(out, key=lambda j: j.start_time)

    def stop_job(self, job_id: str) -> bool:
        proc = self._procs.get(job_id)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
            info = self.get_job_info(job_id)
            if info:
                info.status = "FAILED"
                info.end_time = time.time()
                info.return_code = proc.returncode
                self._put(info)
            return True
        return False

    def close(self) -> None:
        self._gcs.close()

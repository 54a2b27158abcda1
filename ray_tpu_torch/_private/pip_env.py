"""pip/venv runtime environments with a per-node cache.

Reference: ``python/ray/_private/runtime_env/pip.py`` [UNVERIFIED —
mount empty, SURVEY.md §0] — per-task/actor pip environments, built
once per node and cached by requirements hash; workers for such tasks
run inside the environment.

TPU-first adaptation: environments are real venvs created with
``--system-site-packages`` (torch/numpy and the rest of the base image
stay importable; the env only ADDS packages), and activation is a
dedicated worker process exec'd with the venv's interpreter — the
worker pool tags these workers by env key and reuses them, so the
build cost is paid once per node and the spawn cost once per idle
pool slot. Tasks demanding TPU cannot use pip envs (TPU work runs
in-process in the host that owns the chips); the API rejects that
combination up front.

Spec shapes accepted in ``runtime_env={"pip": ...}``:
  ["pkg==1.2", ...]                                  — list of reqs
  {"packages": [...], "pip_install_options": [...]}  — with options
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import logging
import os
import subprocess
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.session_dir import venv_root

logger = logging.getLogger(__name__)

_BUILD_TIMEOUT_S = 600


def normalize_pip_spec(spec) -> dict:
    if isinstance(spec, (list, tuple)):
        spec = {"packages": list(spec)}
    if not isinstance(spec, dict) or not spec.get("packages"):
        raise ValueError(
            "runtime_env pip must be a list of requirements or "
            "{'packages': [...], 'pip_install_options': [...]}")
    bad = set(spec) - {"packages", "pip_install_options"}
    if bad:
        raise ValueError(f"unsupported pip spec key(s) {sorted(bad)}")
    packages = [str(p) for p in spec["packages"]]
    options = [str(o) for o in spec.get("pip_install_options", ())]
    return {"packages": packages, "pip_install_options": options}


def env_key(spec) -> str:
    norm = normalize_pip_spec(spec)
    blob = json.dumps(norm, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def ensure_env(spec) -> str:
    """Build (or reuse) the venv for ``spec``; returns its python
    executable. Safe under concurrent builders on one node (file
    lock); a failed build is torn down and raises with the pip tail."""
    norm = normalize_pip_spec(spec)
    key = env_key(norm)
    env_dir = os.path.join(venv_root(), key)
    python = os.path.join(env_dir, "bin", "python")
    ready = os.path.join(env_dir, ".ready")
    if os.path.exists(ready):
        return python
    os.makedirs(venv_root(), exist_ok=True)
    lock_path = os.path.join(venv_root(), f"{key}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(ready):     # another builder won the race
                return python
            import shutil
            if os.path.exists(env_dir):   # partial from a dead builder
                shutil.rmtree(env_dir, ignore_errors=True)
            out = subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 env_dir],
                capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
            if out.returncode != 0:
                raise RuntimeError(
                    f"venv creation failed: {out.stderr[-2000:]}")
            # --system-site-packages exposes the BASE prefix — when this
            # interpreter is itself a venv (normal for the shipped
            # image), its packages (numpy/torch/setuptools) would be
            # invisible. Link the PARENT's site-packages via a .pth;
            # the new env's own site-packages still wins the path order.
            parent_paths = [p for p in sys.path
                            if p.endswith("site-packages")
                            and os.path.isdir(p)]
            sp = os.path.join(
                env_dir, "lib",
                f"python{sys.version_info[0]}.{sys.version_info[1]}",
                "site-packages")
            with open(os.path.join(sp, "_rtpu_parent.pth"), "w") as f:
                f.write("\n".join(parent_paths) + "\n")
            cmd = ([python, "-m", "pip", "install",
                    "--disable-pip-version-check"]
                   + norm["pip_install_options"] + norm["packages"])
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=_BUILD_TIMEOUT_S)
            if out.returncode != 0:
                shutil.rmtree(env_dir, ignore_errors=True)
                raise RuntimeError(
                    "pip install failed for runtime_env "
                    f"{norm['packages']}: "
                    f"{(out.stderr or out.stdout)[-2000:]}")
            # build ledger: one line per actual build (tests assert the
            # cache prevents rebuilds)
            with open(os.path.join(env_dir, ".builds"), "a") as f:
                f.write(f"{os.getpid()}\n")
            with open(ready, "w") as f:
                f.write(json.dumps(norm))
            return python
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_FAILED_STATE_TTL_S = 30.0


def resolve_for_dispatch(manager: "PipEnvManager", pip_spec, resources,
                         substrate_for, fail, park_item):
    """The ONE pip-env dispatch gate, shared by the driver's node
    manager and remote raylets. Returns:

      ("go", env_tag, python_exe)  — lease a tagged worker
      ("parked", None, None)       — parked inside the manager; a
                                     requeue event will retry
      ("failed", None, None)       — ``fail(err)`` was called

    ``fail(exception)`` must complete the work item with an app-level
    error (no retry)."""
    if substrate_for(resources or {}) == "in_process":
        fail(ValueError(
            "pip runtime envs cannot demand TPU: TPU work runs "
            "in-process in the host that owns the chips"))
        return ("failed", None, None)
    status, key, detail = manager.poll(pip_spec, park_item=park_item)
    if status == "building":
        return ("parked", None, None)
    if status == "failed":
        fail(RuntimeError(f"runtime_env pip build failed: {detail}"))
        return ("failed", None, None)
    return ("go", key, detail)


class PipEnvManager:
    """Async build coordinator for a dispatcher: ``poll`` never blocks
    and OWNS the parking of work items waiting on a build (parking and
    state transitions share one lock, so a build finishing can never
    race a park into a stranded task). ``on_requeue(items)`` fires with
    the parked items when a build finishes — ready or failed — and the
    dispatcher re-queues them; the re-poll then leases or fails each.

    A failed build is remembered for a short TTL (parked tasks fail
    fast as a burst) and then forgotten, so a later attempt rebuilds
    instead of failing forever on a transient error."""

    def __init__(self, on_requeue: Callable[[list], None]):
        self._on_requeue = on_requeue
        self._lock = threading.Lock()
        # key -> ("ready", python, 0) | ("building", None, 0)
        #      | ("failed", msg, monotonic_ts)
        self._states: Dict[str, tuple] = {}
        self._parked: Dict[str, list] = {}

    def poll(self, pip_spec, park_item=None
             ) -> Tuple[str, str, Optional[str]]:
        """Returns (status, key, detail): ready|building|failed; detail
        is the python path (ready) or the error (failed). When status
        is "building", ``park_item`` has been parked atomically and
        will be passed to ``on_requeue`` when the build finishes."""
        import time as _time
        key = env_key(pip_spec)
        with self._lock:
            state = self._states.get(key)
            if state is not None and state[0] == "failed" \
                    and _time.monotonic() - state[2] > _FAILED_STATE_TTL_S:
                state = None            # forget stale failures: rebuild
                del self._states[key]
            if state is None:
                self._states[key] = ("building", None, 0)
                self._parked[key] = ([park_item]
                                     if park_item is not None else [])
                threading.Thread(target=self._build, args=(key, pip_spec),
                                 daemon=True,
                                 name=f"rtpu-pipenv-{key[:6]}").start()
                return ("building", key, None)
            if state[0] == "building":
                if park_item is not None:
                    self._parked.setdefault(key, []).append(park_item)
                return ("building", key, None)
        return (state[0], key, state[1])

    def _build(self, key: str, pip_spec) -> None:
        import time as _time
        try:
            python = ensure_env(pip_spec)
            with self._lock:
                self._states[key] = ("ready", python, 0)
                parked = self._parked.pop(key, [])
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self._states[key] = ("failed", str(e), _time.monotonic())
                parked = self._parked.pop(key, [])
        try:
            self._on_requeue(parked)
        except Exception:
            # a failed requeue strands every task parked on this env —
            # loud log so the hang is diagnosable
            logger.exception("pip-env requeue callback failed; %d "
                             "parked task(s) stranded", len(parked))

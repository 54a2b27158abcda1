"""Runtime context: identity of the current driver/task/actor.

Reference: ``python/ray/runtime_context.py``
(``ray.get_runtime_context()`` — job/task/actor/node identity from
inside user code) [UNVERIFIED — mount empty, SURVEY.md §0].
"""

from __future__ import annotations

from typing import Optional


class RuntimeContext:
    """Identity of the calling context. ``None`` fields mean "not in
    that kind of context" (e.g. ``get_actor_id()`` outside an actor)."""

    def __init__(self, *, worker_mode: str, job_id: Optional[str],
                 task_id: Optional[str], actor_id: Optional[str]):
        self.worker_mode = worker_mode      # "driver" | "worker"
        self._job_id = job_id
        self._task_id = task_id
        self._actor_id = actor_id

    def get_job_id(self) -> Optional[str]:
        return self._job_id

    def get_task_id(self) -> Optional[str]:
        """Hex id of the currently executing task (None on the
        driver)."""
        return self._task_id

    def get_actor_id(self) -> Optional[str]:
        """Hex id of the current actor (None outside actor methods)."""
        return self._actor_id

    @property
    def is_driver(self) -> bool:
        return self.worker_mode == "driver"

    def __repr__(self):
        return (f"RuntimeContext(mode={self.worker_mode}, "
                f"job={self._job_id}, task={self._task_id}, "
                f"actor={self._actor_id})")


def get_runtime_context() -> RuntimeContext:
    import os
    if os.environ.get("RAY_TPU_WORKER_MODE") == "1":
        from ray_tpu_torch._private.worker_process import _CURRENT_TASK
        task_id = _CURRENT_TASK.get("task_id") or None
        actor_id = _CURRENT_TASK.get("actor_id") or None
        return RuntimeContext(
            worker_mode="worker",
            job_id=(task_id.hex()[:8] if task_id else None),
            task_id=(task_id.hex() if isinstance(task_id, bytes)
                     else task_id),
            actor_id=(actor_id.hex() if isinstance(actor_id, bytes)
                      else actor_id))
    from ray_tpu_torch._private.worker import try_global_worker
    w = try_global_worker()
    # In-process (TPU-substrate) workers run in the driver process:
    # their per-task identity (thread-local or, for async actors, the
    # per-asyncio-task contextvar) takes precedence when set. The
    # process-level fallback is cleared after each in-process normal
    # task, so a finished one cannot misreport the driver thread.
    from ray_tpu_torch._private.worker_process import _CURRENT_TASK
    task_id = _CURRENT_TASK.get("task_id") or None
    actor_id = _CURRENT_TASK.get("actor_id") or None
    if task_id:
        return RuntimeContext(
            worker_mode="worker",
            job_id=w.job_id.hex() if w else None,
            task_id=(task_id.hex() if isinstance(task_id, bytes)
                     else task_id),
            actor_id=(actor_id.hex() if isinstance(actor_id, bytes)
                      else actor_id))
    return RuntimeContext(
        worker_mode="driver",
        job_id=w.job_id.hex() if w else None,
        task_id=None, actor_id=None)

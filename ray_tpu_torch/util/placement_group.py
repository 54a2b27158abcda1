"""Public placement group API.

Reference: ``python/ray/util/placement_group.py`` [UNVERIFIED — mount
empty, SURVEY.md §0]: ``placement_group()``, ``PlacementGroup`` handle
(``ready()``, ``wait()``, ``bundle_specs``), ``remove_placement_group``,
``get_current_placement_group``, ``placement_group_table``.
"""

from __future__ import annotations

import contextvars
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.worker import global_worker

_current_pg: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_current_placement_group", default=None)


class PlacementGroup:
    """Handle to a gang resource reservation."""

    def __init__(self, pg_id: PlacementGroupID,
                 bundles: Optional[List[Dict[str, float]]] = None,
                 capture_child_tasks: bool = False):
        self.id = pg_id
        self._bundles = bundles
        self.capture_child_tasks = capture_child_tasks

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        if self._bundles is None:
            info = global_worker().pg_manager.get(self.id)
            self._bundles = [dict(b) for b in info.bundles] if info else []
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self):
        """ObjectRef that resolves (to this PlacementGroup) once every
        bundle is reserved — awaitable with ``ray_tpu_torch.get``."""
        w = global_worker()
        return w.pg_ready_ref(self.id)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        w = global_worker()
        deadline = time.monotonic() + timeout_seconds
        while time.monotonic() < deadline:
            info = w.pg_manager.get(self.id)
            if info is not None and info.state == "CREATED":
                return True
            if info is None or info.state == "REMOVED":
                return False
            time.sleep(0.005)
        return False

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles,
                                 self.capture_child_tasks))

    def __repr__(self):
        return f"PlacementGroup({self.id.hex()[:12]})"


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None,
                    _capture_child_tasks: bool = False) -> PlacementGroup:
    """Reserve a gang of resource bundles atomically."""
    w = global_worker()
    pg_id = PlacementGroupID.of(w.job_id)
    w.create_placement_group(pg_id, bundles, strategy, name)
    return PlacementGroup(pg_id, [dict(b) for b in bundles],
                          capture_child_tasks=_capture_child_tasks)


def remove_placement_group(pg: PlacementGroup) -> None:
    global_worker().remove_placement_group(pg.id)


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The placement group capturing the current (driver) context."""
    return _current_pg.get()


def placement_group_table() -> List[dict]:
    return global_worker().pg_manager.table()


class _PgCaptureContext:
    """Driver-side context: tasks submitted inside inherit the PG when
    ``placement_group_capture_child_tasks`` is set."""

    def __init__(self, pg: PlacementGroup):
        self._pg = pg
        self._token = None

    def __enter__(self):
        self._token = _current_pg.set(self._pg)
        return self._pg

    def __exit__(self, *exc):
        _current_pg.reset(self._token)
        return False

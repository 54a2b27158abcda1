"""The scheduler's configuration keys.

The port's own copy of the keys of ``ray_tpu/_private/config.py`` that
the scheduler reads, with the same names, types, defaults and the same
per-process overrides: each key ``name`` is read from the environment
variable ``RAY_TPU_<name>`` when it is set.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


class Config:
    """Process-wide config. Access keys as attributes."""

    _DEFS: Dict[str, tuple] = {}  # name -> (type, default, doc)

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._load_env()

    @classmethod
    def define(cls, name: str, typ: type, default: Any, doc: str = ""):
        cls._DEFS[name] = (typ, default, doc)

    def _load_env(self):
        for name, (typ, default, _doc) in self._DEFS.items():
            env = os.environ.get(_ENV_PREFIX + name)
            self._values[name] = (_PARSERS[typ](env) if env is not None
                                  else default)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def reset(self):
        with self._lock:
            self._values.clear()
            self._load_env()


_D = Config.define

_D("scheduler_spread_threshold", float, 0.5,
   "Critical-resource utilization above which the hybrid policy stops "
   "packing onto the local node and spreads by least-utilization.")
_D("scheduler_top_k_fraction", float, 0.2,
   "Fraction of feasible nodes considered in the top-k tie-break.")
_D("scheduler_top_k_absolute", int, 1,
   "Minimum top-k regardless of fraction.")
_D("tpu_scheduler_min_batch", int, 64,
   "Pending-queue depth below which the adaptive policy uses the CPU "
   "scan (no device round-trip floor) instead of the kernel.")
_D("pg_pack_topk", int, 128,
   "Candidate nodes per group in the batched gang-packing kernel's "
   "top-k pre-filter (raised to the group's bundle count, capped at "
   "the cluster size). Groups that don't fit their candidate set "
   "fall back to the full single-group solve.")
_D("use_tpu_scheduler", str, "auto",
   "Select the kernel policy in the ISchedulingPolicy registry: "
   "'auto' (default) uses it on a CUDA device and the CPU hybrid on "
   "the CPU, '1'/'true' forces it, '0'/'false' forces the CPU hybrid.")


_global_config: Config | None = None
_global_lock = threading.Lock()


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        with _global_lock:
            if _global_config is None:
                _global_config = Config()
    return _global_config

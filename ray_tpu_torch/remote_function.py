"""@ray_tpu_torch.remote for functions.

Reference: ``python/ray/remote_function.py`` [UNVERIFIED — mount empty,
SURVEY.md §0]: decorator machinery, ``.remote()``, ``.options()``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private.task_spec import TaskOptions
from ray_tpu_torch._private.worker import global_worker

_OPTION_KEYS = {
    "num_cpus", "num_tpus", "num_gpus", "memory", "resources",
    "num_returns", "max_retries", "retry_exceptions",
    "scheduling_strategy", "runtime_env", "name",
    "placement_group", "placement_group_bundle_index",
}


def _make_options(defaults: Dict[str, Any],
                  overrides: Optional[Dict[str, Any]] = None) -> TaskOptions:
    merged = dict(defaults)
    if overrides:
        bad = set(overrides) - _OPTION_KEYS
        if bad:
            raise ValueError(f"invalid option(s): {sorted(bad)}")
        merged.update(overrides)
    return TaskOptions(**{k: v for k, v in merged.items()
                          if k in TaskOptions.__dataclass_fields__})


class RemoteFunction:
    def __init__(self, fn, **default_options):
        self._function = fn
        self._defaults = default_options
        self._descriptor = None
        self._descriptor_session = None
        functools.update_wrapper(self, fn)

    def _get_descriptor(self):
        # Re-register after shutdown()/init(): the new runtime has a
        # fresh function registry.
        w = global_worker()
        if self._descriptor is None or self._descriptor_session != w.session:
            self._descriptor = w.register_function(self._function)
            self._descriptor_session = w.session
        return self._descriptor

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._defaults)

    def _default_options(self) -> TaskOptions:
        """One TaskOptions per decorated function for the no-override
        path: building the 19-field dataclass (plus the placement-group
        normalization) per .remote() call was measurable at wave rates.
        Safe to share — the normal-task submit path never mutates its
        options (actors build fresh options per call)."""
        opts = getattr(self, "_cached_opts", None)
        if opts is None:
            from ray_tpu_torch.util.scheduling_strategies import (
                apply_placement_group_option)
            opts = _make_options(self._defaults)
            apply_placement_group_option(opts)
            self._cached_opts = opts
        return opts

    def options(self, **overrides) -> "_BoundRemoteFunction":
        return _BoundRemoteFunction(self, overrides)

    def bind(self, *args, **kwargs):
        """Build a DAG node instead of submitting (ray_tpu_torch.dag)."""
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    def _remote(self, args, kwargs, options_dict):
        if options_dict is self._defaults:
            opts = self._default_options()
        else:
            opts = _make_options(options_dict)
            from ray_tpu_torch.util.scheduling_strategies import (
                apply_placement_group_option)
            apply_placement_group_option(opts)
        w = global_worker()
        if opts.num_returns == "streaming":
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator
            refs = w.submit_task(self._get_descriptor(), args, kwargs,
                                 opts)
            return ObjectRefGenerator(refs[0].id().task_id(), refs[0])
        refs = w.submit_task(self._get_descriptor(), args, kwargs, opts)
        if opts.num_returns == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self.__name__}' cannot be called directly; "
            f"use '{self.__name__}.remote()'.")


class _BoundRemoteFunction:
    def __init__(self, parent: RemoteFunction, overrides: dict):
        bad = set(overrides) - _OPTION_KEYS
        if bad:
            raise ValueError(f"invalid option(s): {sorted(bad)}")
        self._parent = parent
        self._overrides = overrides

    def remote(self, *args, **kwargs):
        merged = dict(self._parent._defaults)
        merged.update(self._overrides)
        return self._parent._remote(args, kwargs, merged)

    def bind(self, *args, **kwargs):
        """DAG node carrying these options (workflow per-step retry
        policy rides this: f.options(max_retries=3,
        retry_exceptions=True).bind(x))."""
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs)


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=...)`` for functions and classes."""
    from ray_tpu_torch.actor import ActorClass
    import inspect

    def decorator(fn_or_cls):
        if inspect.isclass(fn_or_cls):
            return ActorClass(fn_or_cls, **kwargs)
        return RemoteFunction(fn_or_cls, **kwargs)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return decorator(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return decorator

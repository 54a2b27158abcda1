"""Actor API: ActorClass / ActorHandle / ActorMethod.

Reference: ``python/ray/actor.py`` [UNVERIFIED — mount empty,
SURVEY.md §0].
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.task_spec import TaskOptions
from ray_tpu_torch._private.worker import global_worker

_ACTOR_OPTION_KEYS = {
    "num_cpus", "num_tpus", "num_gpus", "memory", "resources",
    "max_restarts", "max_task_retries", "max_concurrency", "name",
    "namespace", "lifetime", "scheduling_strategy", "runtime_env",
    "get_if_exists", "placement_group", "placement_group_bundle_index",
    "checkpoint_interval",
}


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    _METHOD_OPTION_KEYS = {"num_returns", "name"}

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, {})

    def bind(self, *args, **kwargs):
        """Build a DAG node instead of submitting (ray_tpu_torch.dag)."""
        from ray_tpu_torch.dag import ClassMethodNode
        return ClassMethodNode(self, args, kwargs)

    def options(self, **overrides):
        bad = set(overrides) - self._METHOD_OPTION_KEYS
        if bad:
            raise ValueError(
                f"invalid actor-method option(s): {sorted(bad)}; "
                f"supported: {sorted(self._METHOD_OPTION_KEYS)}")
        method = self

        class _Bound:
            def remote(self, *args, **kwargs):  # noqa: ANN001
                return method._remote(args, kwargs, overrides)

        return _Bound()

    def _remote(self, args, kwargs, overrides):
        num_returns = overrides.get("num_returns", self._num_returns)
        opts = TaskOptions(num_returns=num_returns)
        refs = global_worker().submit_actor_task(
            self._handle._actor_id, self._method_name, args, kwargs, opts)
        if num_returns == "streaming":
            # Generator (or async-generator) method: items stream to
            # the owner as they are yielded (reference: streaming
            # generator actor tasks).
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator
            return ObjectRefGenerator(refs[0].id().task_id(), refs[0])
        if num_returns == 1:
            return refs[0]
        return refs


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str,
                 method_names: tuple):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_names = method_names

    def __getattr__(self, item: str):
        if item in self._method_names:
            return ActorMethod(self, item)
        if item.startswith("_"):
            raise AttributeError(item)
        raise AttributeError(
            f"actor {self._class_name} has no method {item!r}")

    def __repr__(self):
        return (f"ActorHandle({self._class_name}, "
                f"{self._actor_id.hex()[:12]})")

    def __reduce__(self):
        return (ActorHandle,
                (self._actor_id, self._class_name, self._method_names))


class ActorClass:
    def __init__(self, cls: type, **default_options):
        bad = set(default_options) - _ACTOR_OPTION_KEYS
        if bad:
            raise ValueError(f"invalid actor option(s): {sorted(bad)}")
        self._cls = cls
        self._defaults = default_options
        self._descriptor = None
        self._descriptor_session = None

    def _get_descriptor(self):
        w = global_worker()
        if self._descriptor is None or self._descriptor_session != w.session:
            self._descriptor = w.register_function(self._cls)
            self._descriptor_session = w.session
        return self._descriptor

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._defaults)

    def options(self, **overrides):
        bad = set(overrides) - _ACTOR_OPTION_KEYS
        if bad:
            raise ValueError(f"invalid actor option(s): {sorted(bad)}")
        parent = self

        class _Bound:
            def remote(self, *args, **kwargs):  # noqa: ANN001
                merged = dict(parent._defaults)
                merged.update(overrides)
                return parent._remote(args, kwargs, merged)

        return _Bound()

    def _has_async_methods(self) -> bool:
        import inspect
        return any(
            inspect.iscoroutinefunction(m) or inspect.isasyncgenfunction(m)
            for m in (getattr(self._cls, n, None)
                      for n in dir(self._cls) if not n.startswith("_"))
            if m is not None)

    def _remote(self, args, kwargs, options_dict) -> ActorHandle:
        lifetime = options_dict.get("lifetime")
        if lifetime not in (None, "detached", "non_detached"):
            raise ValueError(
                f"lifetime must be 'detached' or 'non_detached', "
                f"got {lifetime!r}")
        if lifetime == "detached" and not options_dict.get("name"):
            raise ValueError(
                "detached actors must be named (name=...) — the name "
                "is how later drivers reach them via get_actor()")
        opts = TaskOptions(**{k: v for k, v in options_dict.items()
                              if k in TaskOptions.__dataclass_fields__})
        if "max_concurrency" not in options_dict \
                and self._has_async_methods():
            # Async actors default to a high in-flight cap (reference:
            # async actors default max_concurrency=1000) — the event
            # loop, not a thread pool, is the concurrency substrate.
            opts.max_concurrency = 1000
        from ray_tpu_torch.util.scheduling_strategies import (
            apply_placement_group_option)
        apply_placement_group_option(opts)
        w = global_worker()
        if opts.get_if_exists and opts.name:
            info = w.gcs.get_named_actor(opts.name,
                                         opts.namespace or "default")
            if info is not None and info.state != "DEAD":
                return ActorHandle(info.actor_id, info.class_name,
                                   self._method_names())
        actor_id = w.create_actor(
            self._get_descriptor(), args, kwargs, opts,
            class_name=self._cls.__name__,
            method_names=self._method_names(),
            is_async=self._has_async_methods())
        return ActorHandle(actor_id, self._cls.__name__,
                           self._method_names())

    def _method_names(self) -> tuple:
        return tuple(name for name in dir(self._cls)
                     if callable(getattr(self._cls, name, None))
                     and not name.startswith("__"))

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote()")


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    info = global_worker().gcs.get_named_actor(name, namespace)
    if info is None or info.state == "DEAD":
        raise ValueError(f"no live actor named {name!r}")
    methods = tuple(getattr(info, "method_names", ()) or ())
    if not methods:
        # Pre-detached registrations: derive from the registered class
        # (only possible on the creating driver).
        import cloudpickle
        spec = info.creation_spec
        cls = cloudpickle.loads(
            global_worker()._get_function_blob(spec.function.function_id))
        methods = tuple(n for n in dir(cls)
                        if callable(getattr(cls, n, None))
                        and not n.startswith("__"))
    return ActorHandle(info.actor_id, info.class_name, methods)


def kill(handle: ActorHandle) -> None:
    global_worker().kill_actor(handle._actor_id)

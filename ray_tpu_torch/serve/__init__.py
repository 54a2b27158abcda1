"""ray_tpu_torch.serve — model serving on the core actor API.

Reference: ``python/ray/serve/`` [UNVERIFIED — mount empty, SURVEY.md
§0]: ``@serve.deployment`` classes/functions, ``serve.run`` deploying
them, a controller reconciling target vs actual replica actors, a
power-of-two-choices router over replica queue lengths, deployment
handles, request-based autoscaling, and HTTP ingress.

The port's copy of ``ray_tpu/serve``, unchanged in behaviour. Replicas
are ordinary actors: a deployment with ``num_gpus`` in its
``ray_actor_options`` runs on a thread of the driver, which owns the
cards, and serves its model there (the flagship use: batched
transformer forward on the card); one without runs in a process worker
that sees no card. The controller is a driver-side loop (this runtime's workers
are pure executors; all library control planes live with the driver —
same topology as Tune's controller).

Usage::

    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, x):
            return ...

    handle = serve.run(Model.bind())
    ref = handle.remote(x)
    result = ray_tpu_torch.get(ref)
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional, Union

from ray_tpu_torch.serve._private.controller import (
    AutoscalingConfig,
    ServeController,
)

__all__ = [
    "deployment", "run", "delete", "get_deployment_handle", "start",
    "shutdown", "status", "http_address", "AutoscalingConfig",
    "Deployment", "DeploymentHandle", "multiplexed",
    "get_multiplexed_model_id", "batch",
]

# Per-request model id inside a replica (model multiplexing) — the
# ContextVar lives with the replica so workers never import this
# package's control-plane machinery. ``batch`` is defined with the
# replica for the same reason (the decorated body executes there).
from ray_tpu_torch.serve._private.replica import _multiplex_ctx, batch


def get_multiplexed_model_id() -> Optional[str]:
    """The model id of the CURRENT request (set by
    ``handle.options(multiplexed_model_id=...)``), or None."""
    return _multiplex_ctx.get()


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorate a replica's model-loader method: results are cached
    per model id in an LRU bounded by ``max_num_models_per_replica``
    (reference: ``@serve.multiplexed``). Combined with the router's
    sticky model→replica routing, each model's requests keep landing
    where it is already loaded::

        @serve.deployment(num_replicas=2)
        class M:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                return load(model_id)

            def __call__(self, x):
                model = self.get_model(
                    serve.get_multiplexed_model_id())
                return model(x)
    """
    import functools
    import threading as _threading
    from collections import OrderedDict

    def wrap(fn):
        # cache + lock are PER decorated function (two multiplexed
        # loaders on one class must not share entries or caps)
        cache_attr = f"_rtpu_mux_cache_{fn.__name__}"
        lock_attr = f"_rtpu_mux_lock_{fn.__name__}"

        @functools.wraps(fn)
        def loader(self, model_id: str):
            lock = getattr(self, lock_attr, None)
            if lock is None:
                lock = _threading.Lock()
                setattr(self, lock_attr, lock)
            # Serialize loads (threaded replicas would otherwise load
            # the same model twice on a concurrent miss).
            with lock:
                cache = getattr(self, cache_attr, None)
                if cache is None:
                    cache = OrderedDict()
                    setattr(self, cache_attr, cache)
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                # Evict BEFORE loading: cap models resident at once
                # (loading first would transiently hold cap+1 — an OOM
                # on device-memory-sized models).
                while len(cache) >= max_num_models_per_replica:
                    cache.popitem(last=False)
                model = fn(self, model_id)
                cache[model_id] = model
                return model

        return loader

    return wrap if _fn is None else wrap(_fn)

_controller: Optional[ServeController] = None
_proxy = None
_worker_proxy = None     # ActorHandle of the worker-hosted ProxyActor
_lock = threading.Lock()


def _get_controller(start_http: bool = False) -> ServeController:
    global _controller, _proxy
    with _lock:
        if _controller is None:
            import ray_tpu_torch
            ray_tpu_torch.init()
            _controller = ServeController()
        if start_http and _proxy is None:
            from ray_tpu_torch.serve._private.http_proxy import HttpProxy
            _proxy = HttpProxy(_controller)
        return _controller


class DeploymentHandle:
    """Client handle: routes calls through the deployment's router.

    ``remote`` (and method calls) may raise a retryable
    ``BackpressureError`` when the deployment's queue is at its
    ``max_queued_requests`` bound — callers back off and retry (the
    HTTP ingress translates it to 503 + Retry-After).
    """

    def __init__(self, name: str, replica_set, _model_id=None,
                 _stream=False):
        self.deployment_name = name
        self._replica_set = replica_set
        self._model_id = _model_id
        self._stream = _stream
        # method-proxy cache: attribute access on the hot path must
        # not build a fresh class object per call (satellite fix) —
        # one _Method per (handle, method_name), reused
        self._methods = {}

    def remote(self, *args, **kwargs):
        return self._replica_set.assign("__call__", args, kwargs,
                                        model_id=self._model_id,
                                        stream=self._stream)

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        """Per-call options; ``multiplexed_model_id`` routes with model
        affinity and exposes the id via get_multiplexed_model_id();
        ``stream=True`` makes ``remote`` return an ObjectRefGenerator
        over the deployment's (possibly async) generator response
        (reference: handle.options(stream=True)). Returns a full
        handle (attribute-style methods and chained options keep
        working)."""
        return DeploymentHandle(
            self.deployment_name, self._replica_set,
            _model_id=(multiplexed_model_id
                       if multiplexed_model_id is not None
                       else self._model_id),
            _stream=self._stream if stream is None else bool(stream))

    def method(self, method_name: str):
        cached = self._methods.get(method_name)
        if cached is not None:
            return cached
        proxy = _MethodProxy(self, method_name)
        self._methods[method_name] = proxy
        return proxy

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return self.method(item)


class _MethodProxy:
    """Bound method-call proxy: ``handle.foo.remote(...)``. One
    instance per (handle, method) — built once, cached on the handle
    (``__getattr__`` used to mint a fresh class object per attribute
    access on the hot path)."""

    __slots__ = ("_handle", "_method")

    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        h = self._handle
        return h._replica_set.assign(self._method, args, kwargs,
                                     model_id=h._model_id,
                                     stream=h._stream)


class Application:
    """A bound deployment (deployment + init args), ready to run."""

    def __init__(self, deployment: "Deployment", args: tuple,
                 kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


class Deployment:
    def __init__(self, target: Union[type, Callable], name: str,
                 num_replicas: int, ray_actor_options: Optional[dict],
                 autoscaling_config: Optional[dict],
                 max_ongoing_requests: Optional[int] = None,
                 graceful_shutdown_timeout_s: float = 20.0,
                 max_queued_requests: Optional[int] = None):
        self._target = target
        self.name = name
        self.num_replicas = num_replicas
        self.ray_actor_options = dict(ray_actor_options or {})
        self.autoscaling_config = autoscaling_config
        self.max_ongoing_requests = max_ongoing_requests
        self.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        self.max_queued_requests = max_queued_requests

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                ray_actor_options: Optional[dict] = None,
                autoscaling_config: Optional[dict] = None,
                max_ongoing_requests: Optional[int] = None,
                graceful_shutdown_timeout_s: Optional[float] = None,
                max_queued_requests: Optional[int] = None
                ) -> "Deployment":
        return Deployment(
            self._target,
            name if name is not None else self.name,
            num_replicas if num_replicas is not None else self.num_replicas,
            ray_actor_options if ray_actor_options is not None
            else self.ray_actor_options,
            autoscaling_config if autoscaling_config is not None
            else self.autoscaling_config,
            max_ongoing_requests if max_ongoing_requests is not None
            else self.max_ongoing_requests,
            graceful_shutdown_timeout_s
            if graceful_shutdown_timeout_s is not None
            else self.graceful_shutdown_timeout_s,
            max_queued_requests if max_queued_requests is not None
            else self.max_queued_requests)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(_target=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               ray_actor_options: Optional[dict] = None,
               autoscaling_config: Optional[dict] = None,
               max_ongoing_requests: Optional[int] = None,
               graceful_shutdown_timeout_s: float = 20.0,
               max_queued_requests: Optional[int] = None):
    """``@serve.deployment`` decorator for classes and functions.
    ``max_ongoing_requests`` caps each replica's in-flight requests
    (admission control): excess callers wait in the router instead of
    piling onto replicas. ``max_queued_requests`` bounds the TOTAL
    queue per routing process (pending batches + in-flight + waiters);
    beyond it, requests shed with a retryable ``BackpressureError``
    instead of queueing unboundedly (default: the
    ``serve_max_queued_requests`` config knob).
    ``graceful_shutdown_timeout_s`` bounds the drain wait when a
    replica retires (redeploy roll or downscale)."""

    def wrap(target):
        return Deployment(target, name or target.__name__, num_replicas,
                          ray_actor_options, autoscaling_config,
                          max_ongoing_requests,
                          graceful_shutdown_timeout_s,
                          max_queued_requests)

    if _target is not None:
        return wrap(_target)
    return wrap


def run(app: Union[Application, Deployment], *, name: Optional[str] = None,
        wait_for_healthy: bool = True, timeout: float = 120.0
        ) -> DeploymentHandle:
    """Deploy (or redeploy) and return a handle."""
    if isinstance(app, Deployment):
        app = app.bind()
    dep = app.deployment
    controller = _get_controller()
    autoscaling = None
    if dep.autoscaling_config is not None:
        cfg = dep.autoscaling_config
        autoscaling = (cfg if isinstance(cfg, AutoscalingConfig)
                       else AutoscalingConfig(**cfg))
    dep_name = name or dep.name
    replica_set = controller.deploy(
        dep_name, dep._target, app.init_args, app.init_kwargs,
        dep.num_replicas, actor_options=dep.ray_actor_options,
        autoscaling=autoscaling,
        max_ongoing_requests=dep.max_ongoing_requests,
        graceful_shutdown_timeout_s=dep.graceful_shutdown_timeout_s,
        max_queued_requests=dep.max_queued_requests)
    if wait_for_healthy:
        controller.wait_healthy(dep_name, timeout=timeout)
    return DeploymentHandle(dep_name, replica_set)


def get_deployment_handle(name: str) -> DeploymentHandle:
    controller = _get_controller()
    replica_set = controller.get_replica_set(name)
    if replica_set is None:
        raise ValueError(f"no deployment named {name!r}")
    return DeploymentHandle(name, replica_set)


def delete(name: str) -> None:
    _get_controller().delete(name)


def status() -> dict:
    return _get_controller().status()


def start(http: bool = True, proxy_location: str = "worker"):
    """Start serve, optionally with the HTTP ingress.

    ``proxy_location``:
    - "worker" (default): the ingress runs in a WORKER process (the
      reference's proxy-actor topology) — HTTP parsing and response
      serialization stay off the driver's scheduling threads; the
      controller pushes route-table updates to it. This is the
      production topology and the one BASELINE.md's serve numbers use.
    - "driver": threaded server in the driver process — TEST-ONLY
      convenience (no worker spawn): ingress threads compete with the
      driver's scheduling loop for CPU.
    """
    global _worker_proxy
    if proxy_location not in ("driver", "worker"):
        raise ValueError(f"unknown proxy_location {proxy_location!r}")
    controller = _get_controller(
        start_http=http and proxy_location == "driver")
    if http and proxy_location == "worker":
        with _lock:
            if _worker_proxy is None:
                import ray_tpu_torch
                from ray_tpu_torch._private.worker import global_worker
                from ray_tpu_torch.serve._private.http_proxy import ProxyActor
                from ray_tpu_torch.util.scheduling_strategies import (
                    NodeAffinitySchedulingStrategy)
                # Pin to the head node: the proxy binds loopback and
                # advertises its address to local clients — landing it
                # on a remote raylet would hand out an unreachable
                # 127.0.0.1 of another machine.
                head = global_worker().node_group.head_node_id.hex()
                actor = ray_tpu_torch.remote(ProxyActor).options(
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=head)).remote()
                # blocking-ok: one-time proxy bring-up; the lock is
                # what makes "exactly one worker proxy" true, and a
                # second serve.start() racing it must wait for
                # readiness, not spawn a twin
                ray_tpu_torch.get(actor.ping.remote(), timeout=60)
                _worker_proxy = actor
                controller.register_proxy(actor)
    return controller


def http_address():
    """(host, port) of the ingress — the worker-hosted proxy when one
    is up, else the in-driver server (started on demand)."""
    if _worker_proxy is not None:
        import ray_tpu_torch
        return tuple(ray_tpu_torch.get(_worker_proxy.address.remote(),
                                       timeout=30))
    _get_controller(start_http=True)
    return _proxy.address


def shutdown() -> None:
    """Tear serve down in dependency order (docs/serve.md §Shutdown):

    1. detach proxies from the controller — no more route pushes or
       autoscale aggregation target them;
    2. drain ingress — both proxies stop ACCEPTING and finish their
       in-flight HTTP requests while replicas are still alive (the
       old order killed the worker proxy while requests raced through
       it);
    3. stop the controller — deployments deleted, replicas drained
       and killed;
    4. kill the (now idle, unrouted) worker proxy actor.
    """
    global _controller, _proxy, _worker_proxy
    with _lock:
        controller, proxy = _controller, _proxy
        worker_proxy = _worker_proxy
        _controller = _proxy = _worker_proxy = None
    if controller is not None:
        controller.detach_proxies()
    if proxy is not None:
        proxy.shutdown()
    if worker_proxy is not None:
        try:
            import ray_tpu_torch
            ray_tpu_torch.get(worker_proxy.prepare_shutdown.remote(),
                              timeout=30)
        except Exception:
            pass    # proxy actor already dead / runtime torn down
    if controller is not None:
        controller.shutdown()
    if worker_proxy is not None:
        try:
            import ray_tpu_torch
            ray_tpu_torch.kill(worker_proxy)
        except Exception:
            pass    # proxy actor already dead

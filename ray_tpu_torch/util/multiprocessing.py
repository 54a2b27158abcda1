"""``multiprocessing.Pool`` API over ray_tpu_torch tasks.

Reference: ``python/ray/util/multiprocessing/`` [UNVERIFIED — mount
empty, SURVEY.md §0] — drop-in Pool whose workers are cluster tasks,
so ``pool.map`` scales past one machine and composes with the rest of
the runtime (placement, retries, the object store). ``processes``
bounds in-flight chunks (stdlib semantics), enforced by windowed
submission — a rate-limit-minded ``Pool(processes=2)`` really runs at
most 2 chunks at a time regardless of cluster size.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import GetTimeoutError

__all__ = ["Pool", "AsyncResult"]


@ray_tpu_torch.remote
def _run_chunk(fn, chunk, star):
    return [fn(*item) if star else fn(item) for item in chunk]


@ray_tpu_torch.remote
def _apply_one(fn, args, kwds):
    return fn(*args, **(kwds or {}))


class AsyncResult:
    """``multiprocessing.pool.AsyncResult`` shape. Backed either by a
    single ObjectRef (``apply_async``) or fulfilled by a worker thread
    (``map_async``'s windowed execution)."""

    def __init__(self, ref=None, callback=None, error_callback=None):
        self._ref = ref
        self._cond = threading.Condition()
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None
        self._callback = callback
        self._error_callback = error_callback
        if ref is not None and (callback or error_callback):
            threading.Thread(target=self._resolve_and_notify,
                             daemon=True).start()

    # -- fulfillment ---------------------------------------------------

    def _fulfill(self, value, error) -> None:
        with self._cond:
            if self._done:
                return
            self._value, self._error, self._done = value, error, True
            self._cond.notify_all()
        if error is None and self._callback is not None:
            self._callback(value)
        if error is not None and self._error_callback is not None:
            self._error_callback(error)

    def _resolve_and_notify(self) -> None:
        try:
            self._fulfill(ray_tpu_torch.get(self._ref), None)
        except Exception as e:  # noqa: BLE001
            self._fulfill(None, e)

    # -- the AsyncResult API -------------------------------------------

    def get(self, timeout: Optional[float] = None):
        with self._cond:
            if self._done:
                if self._error is not None:
                    raise self._error
                return self._value
        if self._ref is not None:
            # A timeout does NOT poison the result (stdlib semantics:
            # retrieval can be retried after a timed-out get).
            try:
                value = ray_tpu_torch.get(self._ref, timeout=timeout)
            except GetTimeoutError:
                raise TimeoutError("result not ready") from None
            except Exception as e:  # noqa: BLE001
                self._fulfill(None, e)
                raise
            self._fulfill(value, None)
            return value
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError("result not ready")
            if self._error is not None:
                raise self._error
            return self._value

    def wait(self, timeout: Optional[float] = None) -> None:
        if self._ref is not None:
            ray_tpu_torch.wait([self._ref], num_returns=1, timeout=timeout)
            return
        with self._cond:
            self._cond.wait_for(lambda: self._done, timeout)

    def ready(self) -> bool:
        with self._cond:
            if self._done:
                return True
        if self._ref is None:
            return False
        ready, _ = ray_tpu_torch.wait([self._ref], num_returns=1, timeout=0)
        return bool(ready)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            self.get(timeout=30)    # ready: the fetch is local
        except Exception:  # noqa: BLE001
            pass
        return self._error is None


class Pool:
    """Task-backed process pool; ``processes`` bounds in-flight
    chunks."""

    def __init__(self, processes: Optional[int] = None,
                 ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        cpus = ray_tpu_torch.cluster_resources().get("CPU", 1)
        self._processes = int(processes or cpus)
        if self._processes < 1:
            raise ValueError("processes must be >= 1")
        self._remote_args = dict(ray_remote_args or {})
        self._closed = False

    # -- helpers -------------------------------------------------------

    def _check(self):
        if self._closed:
            raise ValueError("Pool is closed")

    def _chunk_task(self):
        if self._remote_args:
            return _run_chunk.options(**self._remote_args)
        return _run_chunk

    @staticmethod
    def _chunks(iterable: Iterable, chunksize: int) -> Iterator[list]:
        it = iter(iterable)
        while True:
            chunk = list(itertools.islice(it, chunksize))
            if not chunk:
                return
            yield chunk

    def _default_chunksize(self, n_items: int) -> int:
        return max(1, n_items // (self._processes * 4))

    def _windowed(self, func, items: List[Any], chunksize, star: bool,
                  ordered: bool) -> Iterator[list]:
        """Submit at most ``processes`` chunks at a time; yield chunk
        results (in submission order when ``ordered``)."""
        chunksize = chunksize or self._default_chunksize(len(items))
        task = self._chunk_task()
        chunks = self._chunks(items, chunksize)
        in_flight: List = []
        order: List = []
        for chunk in itertools.islice(chunks, self._processes):
            ref = task.remote(func, chunk, star)
            in_flight.append(ref)
            order.append(ref)
        while in_flight:
            if ordered:
                head = order.pop(0)
                result = ray_tpu_torch.get(head)
                in_flight.remove(head)
            else:
                ready, in_flight = ray_tpu_torch.wait(in_flight,
                                                num_returns=1)
                result = ray_tpu_torch.get(ready[0])
            nxt = next(chunks, None)
            if nxt is not None:
                ref = task.remote(func, nxt, star)
                in_flight.append(ref)
                order.append(ref)
            yield result

    # -- the Pool API --------------------------------------------------

    def apply(self, func: Callable, args: tuple = (), kwds=None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args: tuple = (), kwds=None,
                    callback=None, error_callback=None) -> AsyncResult:
        self._check()
        return AsyncResult(_apply_one.remote(func, args, kwds),
                           callback, error_callback)

    def map(self, func: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> list:
        self._check()
        out: list = []
        for chunk in self._windowed(func, list(iterable), chunksize,
                                    star=False, ordered=True):
            out.extend(chunk)
        return out

    def starmap(self, func: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> list:
        self._check()
        out: list = []
        for chunk in self._windowed(func, list(iterable), chunksize,
                                    star=True, ordered=True):
            out.extend(chunk)
        return out

    def map_async(self, func, iterable, chunksize=None,
                  callback=None, error_callback=None) -> AsyncResult:
        self._check()
        items = list(iterable)
        result = AsyncResult(None, callback, error_callback)

        def run():
            try:
                out: list = []
                for chunk in self._windowed(func, items, chunksize,
                                            star=False, ordered=True):
                    out.extend(chunk)
                result._fulfill(out, None)
            except Exception as e:  # noqa: BLE001
                result._fulfill(None, e)

        threading.Thread(target=run, daemon=True).start()
        return result

    def imap(self, func: Callable, iterable: Iterable,
             chunksize: int = 1) -> Iterator:
        self._check()
        for chunk in self._windowed(func, list(iterable), chunksize,
                                    star=False, ordered=True):
            yield from chunk

    def imap_unordered(self, func: Callable, iterable: Iterable,
                       chunksize: int = 1) -> Iterator:
        self._check()
        for chunk in self._windowed(func, list(iterable), chunksize,
                                    star=False, ordered=False):
            yield from chunk

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still open")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()

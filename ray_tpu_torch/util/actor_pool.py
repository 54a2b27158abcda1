"""ActorPool: multiplex tasks over a fixed set of actors.

Reference: ``python/ray/util/actor_pool.py`` [UNVERIFIED — mount
empty, SURVEY.md §0]. Same surface: submit/get_next[_unordered]/
map/map_unordered/has_next/has_free/push/pop_idle.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List):
        self._idle = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def submit(self, fn: Callable, value: Any) -> None:
        """``fn(actor, value) -> ObjectRef``; runs when an actor frees."""
        if not self._idle:
            raise ValueError("no idle actors; call get_next first "
                             "(use map for automatic pipelining)")
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def has_free(self) -> bool:
        return bool(self._idle)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in submission order.

        A timeout leaves the pending-slot bookkeeping intact (the call can
        be retried); the actor is returned to the idle pool *before* the
        result is fetched so a task that raised cannot strand it.
        """
        if self._next_return_index >= self._next_task_index:
            raise StopIteration("no pending results")
        ref = self._index_to_future[self._next_return_index]
        if timeout is not None:
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout)
            if not ready:
                raise TimeoutError("get_next timed out")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._idle.append(self._future_to_actor.pop(ref))
        return ray_tpu_torch.get(ref)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result to complete, any order."""
        if not self._future_to_actor:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut == ref:
                del self._index_to_future[idx]
                break
        self._idle.append(self._future_to_actor.pop(ref))
        return ray_tpu_torch.get(ref)

    def map(self, fn: Callable, values) -> Iterator[Any]:
        """Ordered streaming map with automatic backpressure."""
        values = list(values)
        sent = 0
        while sent < len(values) and self.has_free():
            self.submit(fn, values[sent])
            sent += 1
        while self._next_return_index < self._next_task_index or \
                sent < len(values):
            yield self.get_next()
            if sent < len(values):
                self.submit(fn, values[sent])
                sent += 1

    def map_unordered(self, fn: Callable, values) -> Iterator[Any]:
        values = list(values)
        sent = 0
        while sent < len(values) and self.has_free():
            self.submit(fn, values[sent])
            sent += 1
        while self.has_next() or sent < len(values):
            yield self.get_next_unordered()
            if sent < len(values):
                self.submit(fn, values[sent])
                sent += 1

    def push(self, actor) -> None:
        self._idle.append(actor)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

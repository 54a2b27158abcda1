"""Local ranks: one process group of n processes on this host.

``LocalRanks(n)`` spawns n processes, each rank r of a process group that
meets at a rendezvous file (``file://``, so no TCP port is chosen or
shared), caps each rank's torch threads at one (ranks share the host's
cores), and then runs functions on every
rank at once: ``ranks.run(fn, *args)`` calls ``fn(*args)`` on each rank
and returns their results in rank order. ``fn`` must be importable by name
from a spawned process (a module-level function), and its arguments and
results picklable. A rank that raises fails the call with its traceback;
a rank that dies, or a call that outlasts ``CALL_TIMEOUT_S``, fails it
too and kills the ranks, so that a broken rank cannot leave the others
waiting in a collective (the process group's own timeout is the same).

It serves a mesh on one host: one rank per card over NCCL (the default,
``device="cuda"``; it raises without a card), or CPU ranks over gloo
(``device="cpu"``).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

from ray_tpu_torch._private.device import resolve_device

CALL_TIMEOUT_S = 600.0


def _rank_main(rank: int, world: int, init_file: str, backend: str,
               conn) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(
                                seconds=CALL_TIMEOUT_S))
    try:
        while True:
            job = conn.recv()
            if job is None:
                break
            fn, args = job
            try:
                conn.send(("ok", fn(*args)))
            except BaseException:  # the parent re-raises it
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class LocalRanks:
    """``world_size`` spawned ranks of one process group (see the module
    docstring). Use as a context manager, or call ``close``."""

    def __init__(self, world_size: int, device="cuda"):
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self._dir = tempfile.mkdtemp(prefix="ray_tpu_torch_ranks_")
        init_file = os.path.join(self._dir, "rendezvous")
        self._conns, self._procs = [], []
        for rank in range(world_size):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(rank, world_size, init_file, backend, child))
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)

    def run(self, fn: Callable[..., Any], *args) -> List[Any]:
        for conn in self._conns:
            conn.send((fn, args))
        replies = [None] * self.world_size
        waiting = dict(enumerate(self._conns))
        deadline = time.monotonic() + CALL_TIMEOUT_S
        why = None
        while waiting and why is None:
            left = deadline - time.monotonic()
            ready = multiprocessing.connection.wait(
                list(waiting.values())
                + [self._procs[r].sentinel for r in waiting],
                timeout=max(left, 0))
            for r, conn in list(waiting.items()):
                if conn in ready:
                    try:
                        replies[r] = conn.recv()
                        del waiting[r]
                    except EOFError:
                        pass
            dead = [r for r in waiting if not self._procs[r].is_alive()]
            if dead:
                why = (f"rank {dead[0]} died (exit code "
                       f"{self._procs[dead[0]].exitcode})")
            elif waiting and left <= 0:
                why = (f"ranks {sorted(waiting)} did not answer in "
                       f"{CALL_TIMEOUT_S} s")
        if why is not None:
            self.close(kill=True)
            raise RuntimeError(f"{getattr(fn, '__name__', fn)}: {why}; the "
                               f"ranks are closed")
        errors = [f"rank {r}:\n{msg}" for r, (kind, msg) in enumerate(replies)
                  if kind == "error"]
        if errors:
            raise RuntimeError("\n".join(errors))
        return [value for _, value in replies]

    def close(self, kill: bool = False) -> None:
        """Stop the ranks: ask each to leave the process group and exit,
        or, with ``kill``, kill them at once."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=0 if kill else 30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "LocalRanks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

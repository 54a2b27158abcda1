"""Worker-side training session (reference:
``python/ray/train/_internal/session.py`` [UNVERIFIED — SURVEY.md §0]).

Reports travel driver-ward over the shared filesystem (one pickle per
``report()`` call, atomic rename) because the worker's actor thread is
busy inside the user loop — the same reason the reference uses a
result queue rather than an RPC back-channel.

The port keeps one session per gang worker, keyed by the calling actor
(as ``collective/collective.py`` keys group membership): a GPU-demand
worker runs on a thread of the driver, so two ``num_gpus=0.5`` workers
of one gang share a process, where the reference's one module-level
session would hand each the other's context.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


class StopTrial(Exception):
    """Raised inside ``report()`` when the controller has requested this
    trial stop (e.g. an ASHA rung decision). User training loops don't
    need to catch it — the trial actor does and exits cleanly."""


class ElasticResize(Exception):
    """Raised inside ``report()`` when the elastic trainer wants the
    gang to stop at this checkpoint boundary and re-form at a new
    world size (capacity returned after a shrink). The worker actor
    catches it and exits cleanly; training resumes from the latest
    checkpoint at the new size."""


@dataclass
class TrainContext:
    world_size: int = 1
    rank: int = 0
    node_rank: int = 0
    local_rank: int = 0
    experiment_name: str = ""
    trial_dir: str = ""
    report_dir: str = ""
    config: Dict[str, Any] = field(default_factory=dict)
    collective_group: str = ""
    # per-attempt backend wiring (e.g. the torch c10d rendezvous)
    backend_config: Dict[str, Any] = field(default_factory=dict)
    datasets: Dict[str, List] = field(default_factory=dict)  # name->blocks
    latest_checkpoint: Optional[Checkpoint] = None
    # When True (Tune trials), report() blocks until the controller acks
    # the report — this makes scheduler decisions (ASHA rung stops)
    # deterministic instead of racing trial completion. Train's gang
    # workers keep fire-and-forget reports.
    sync_reports: bool = False
    _report_seq: int = 0

    def get_world_size(self) -> int:
        return self.world_size

    def get_rank(self) -> int:
        return self.rank

    def get_trial_dir(self) -> str:
        return self.trial_dir


_sessions: Dict[bytes, TrainContext] = {}   # guarded-by: _lock
_lock = threading.Lock()


def _caller() -> bytes:
    from ray_tpu_torch.collective.collective import _current_actor
    return _current_actor()


def init_session(ctx: TrainContext) -> None:
    with _lock:
        _sessions[_caller()] = ctx


def shutdown_session() -> None:
    with _lock:
        _sessions.pop(_caller(), None)


def get_context() -> TrainContext:
    """The calling worker's session. A thread that carries no actor
    identity (the driver, or a thread the user loop started) gets the
    process's only session, as the reference's one global gives it."""
    key = _caller()
    with _lock:
        ctx = _sessions.get(key)
        if ctx is None and not key and len(_sessions) == 1:
            ctx = next(iter(_sessions.values()))
    if ctx is None:
        # driver-side / local-mode context
        return TrainContext()
    return ctx


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().latest_checkpoint


def _stop_requested(ctx: TrainContext) -> bool:
    return bool(ctx.report_dir) and os.path.exists(
        os.path.join(ctx.report_dir, "STOP"))


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) to the trainer.

    Raises :class:`StopTrial` when the controller has placed a stop
    token in the report channel (Tune scheduler decisions).
    """
    ctx = get_context()
    if not ctx.report_dir:
        return  # local mode: nothing to deliver
    if _stop_requested(ctx):
        raise StopTrial()
    ctx._report_seq += 1
    payload: Dict[str, Any] = {"metrics": dict(metrics), "rank": ctx.rank,
                               "seq": ctx._report_seq}
    if checkpoint is not None:
        # persist into the trial dir so it outlives the worker
        dst = os.path.join(ctx.trial_dir,
                           f"checkpoint_{ctx._report_seq:06d}_r{ctx.rank}")
        if os.path.abspath(checkpoint.path) != os.path.abspath(dst):
            shutil.copytree(checkpoint.path, dst, dirs_exist_ok=True)
        payload["checkpoint_path"] = dst
    # crash-atomic (shared durable helper): the trainer's drain loop
    # must never observe a torn report file under the final name
    from ray_tpu_torch._private import durable
    name = f"report_{ctx.rank:04d}_{ctx._report_seq:08d}.pkl"
    durable.atomic_pickle(os.path.join(ctx.report_dir, name), payload)
    # AFTER the report lands: an elastic re-form happens at a
    # RANK-AGREED boundary — the RESIZE file carries the target report
    # seq (stamped ahead of every rank's progress), and each rank
    # stops at exactly that seq. Stopping at "whenever I next see the
    # file" would let ranks leave at different steps and wedge the
    # survivors' next collective.
    resize_path = os.path.join(ctx.report_dir, "RESIZE")
    if os.path.exists(resize_path):
        try:
            with open(resize_path) as f:
                target_seq = int(f.read().strip() or 0)
        except (OSError, ValueError):
            target_seq = 0
        if ctx._report_seq >= target_seq:
            raise ElasticResize()
    if ctx.sync_reports:
        # Block until the controller acks this report (or tells us to
        # stop). Bounded wait so a dead controller can't wedge the trial.
        import time
        ack = os.path.join(ctx.report_dir, name + ".ack")
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if _stop_requested(ctx):
                raise StopTrial()
            if os.path.exists(ack):
                return
            time.sleep(0.005)


def get_dataset_shard(name: str = "train"):
    """Iterator factory over this worker's dataset shard blocks."""
    from ray_tpu_torch.data import block as blib

    blocks = get_context().datasets.get(name, [])

    class _Shard:
        def iter_batches(self, *, batch_size: Optional[int] = 256,
                         batch_format: str = "numpy"):
            carry: List = []
            carry_rows = 0
            for blk in blocks:
                if blk.num_rows == 0:
                    continue
                if batch_size is None:
                    yield blib.block_to_batch(blk, batch_format)
                    continue
                carry.append(blk)
                carry_rows += blk.num_rows
                while carry_rows >= batch_size:
                    merged = blib.concat_blocks(carry)
                    out = blib.slice_block(merged, 0, batch_size)
                    rest = blib.slice_block(merged, batch_size,
                                            merged.num_rows)
                    yield blib.block_to_batch(out, batch_format)
                    carry = [rest] if rest.num_rows else []
                    carry_rows = rest.num_rows
            if carry:
                merged = blib.concat_blocks(carry)
                if merged.num_rows:
                    yield blib.block_to_batch(merged, batch_format)

        def count(self):
            return sum(b.num_rows for b in blocks)

    return _Shard()

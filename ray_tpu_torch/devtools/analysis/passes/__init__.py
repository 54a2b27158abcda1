"""graftcheck pass registry. Order is the report order."""

from __future__ import annotations

from typing import List


def load_passes() -> List:
    from ray_tpu_torch.devtools.analysis.passes import (
        async_blocking,
        blocking_under_lock,
        bounded_queue,
        chaos_coverage,
        deadline_discipline,
        durable_write,
        error_flow,
        lock_discipline,
        lock_order,
        metric_discipline,
        ref_leak,
        retry_discipline,
        rpc_surface,
        sanitizer_coverage,
        silent_exception,
        wire_shape,
    )
    return [lock_discipline, async_blocking, rpc_surface,
            silent_exception, ref_leak, retry_discipline,
            bounded_queue, deadline_discipline, durable_write,
            lock_order, blocking_under_lock, wire_shape,
            sanitizer_coverage, error_flow, metric_discipline,
            chaos_coverage]

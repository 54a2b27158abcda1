"""DataContext: process-wide execution settings for ray_tpu_torch.data.

Reference: ``python/ray/data/context.py`` (``DataContext.get_current``)
[UNVERIFIED — mount empty, SURVEY.md §0] — the knobs the streaming
executor reads: target block size for dynamic splitting, the
per-stage memory budget for byte-aware backpressure, the per-block
retry budget for data-plane reconstruction, and the prefetch depth
for the consuming iterators. Defaults come from the system config
(``data_*`` knobs, docs/data_pipeline.md §Knobs) at first use, so
``RAY_TPU_data_block_target_bytes=...`` et al. work without code.
The port's copy of ``ray_tpu/data/context.py``; it reads the port's
config, which keeps the reference's knobs and environment prefix.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import ClassVar, Optional


@dataclasses.dataclass
class DataContext:
    # Map outputs larger than this are split into multiple blocks
    # (dynamic block splitting — no single object outgrows the store's
    # comfort zone, and downstream stages parallelize over the pieces).
    target_max_block_size: int = 64 * 1024 * 1024
    # Byte budget per map stage for queued-but-unprocessed input
    # blocks. None -> derived at run time from the object store
    # capacity (25% of the store divided across the plan's map stages).
    per_stage_memory_budget: Optional[int] = None
    # Fallback count cap on concurrently running tasks per stage.
    max_in_flight: int = 8
    # Batches buffered ahead of the consumer by prefetching iterators.
    prefetch_batches: int = 2
    # Re-drives of one input block after its map worker died mid-block.
    max_block_retries: int = 3

    _current: ClassVar[Optional["DataContext"]] = None
    _lock: ClassVar[threading.Lock] = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                from ray_tpu_torch._private.config import get_config
                cfg = get_config()
                cls._current = DataContext(
                    target_max_block_size=cfg.data_block_target_bytes,
                    max_in_flight=cfg.data_max_in_flight,
                    prefetch_batches=cfg.data_prefetch_batches,
                    max_block_retries=cfg.data_max_block_retries)
            return cls._current

"""Multi-slice runtime plane: slice-gangs, hierarchical DCN
collectives, whole-slice fault recovery (docs/multislice.md).

The port's copy of ``ray_tpu.multislice``. The in-program multi-slice
mesh lives in ``ray_tpu_torch.parallel.slice_mesh``; THIS package is
its actor/collective backend: each slice is a collective gang, the
per-slice leaders form a separate DCN-tier group with a simulated
latency/bandwidth cost model, gradient sync is a hierarchical two-tier
allreduce moving only ~1/num_slices of the bytes a flat allreduce would
push across DCN, and a whole-slice failure recovers through gang
restart + gang-consistent checkpoint restore while the surviving
slices abort typed and wait at a fenced DCN epoch.
"""

from ray_tpu_torch.multislice import dcn
from ray_tpu_torch.multislice.dcn import (
    DcnCostModel,
    begin_incarnation,
    dcn_allreduce,
    dcn_epoch,
    join_dcn_group,
    reset_stats,
    stats_snapshot,
)
from ray_tpu_torch.multislice.hierarchical import hierarchical_allreduce
from ray_tpu_torch.multislice.slice_set import SliceSet

__all__ = [
    "DcnCostModel", "SliceSet", "begin_incarnation", "dcn",
    "dcn_allreduce", "dcn_epoch", "hierarchical_allreduce",
    "join_dcn_group", "reset_stats", "stats_snapshot",
]

"""Hierarchical two-tier allreduce: ICI within a slice, DCN between.

The textbook multi-slice gradient sync (SNIPPETS.md hybrid-mesh
pattern, SURVEY.md §2.5 group-spanning collectives) decomposed onto
this runtime's two collective tiers:

1. **intra-slice reduce** — a plain ``collective.allreduce`` inside
   the slice's gang (the ICI tier: every rank ends up holding the
   slice-local reduction);
2. **cross-slice exchange** — ONLY the slice's leader rank runs a
   ``dcn.dcn_allreduce`` on the separate leader group, so exactly one
   rank's payload per slice crosses the DCN tier (~1/num_slices of
   the bytes a flat allreduce would move across it);
3. **intra-slice broadcast** — the leader fans the global result back
   out over ICI.

Abort propagation: a fenced DCN tier (slice death → the sliceset
coordinator's epoch bump) surfaces in the leader's DCN op as a typed
``CollectiveAbortError`` within milliseconds. The leader then fans
that abort INTO its slice via a tiny status broadcast — header
``[flag, dcn_epoch]`` precedes the payload broadcast — so non-leader
ranks waiting on step 3 also raise typed instead of burning the slice
group's timeout, and the (healthy) slice gang's own epoch stays
untouched for the post-recovery re-drive. Call counts stay symmetric
on both paths (ok: status + payload broadcast on every rank; abort:
status broadcast on every rank), preserving both the collective
sequence alignment and the checkpoint generation contract.

``op`` applies per tier: SUM/MAX/MIN/PRODUCT compose exactly; MEAN is
the mean-of-means, which equals the global mean only for equal-size
slices — the only layout ``SliceSet`` builds.

The port's copy of ``ray_tpu/multislice/hierarchical.py``; a torch
tensor (on either device) comes to the host first, as every collective
of the port's host plane takes it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch import collective as col
from ray_tpu_torch.collective.collective import ReduceOp, _as_np
from ray_tpu_torch.exceptions import CollectiveAbortError
from ray_tpu_torch.multislice import dcn

_OK = 0.0
_ABORTED = 1.0


def hierarchical_allreduce(tensor, slice_group: str,
                           dcn_group: Optional[str] = None,
                           op: str = ReduceOp.SUM,
                           leader_rank: int = 0) -> np.ndarray:
    """Two-tier allreduce over all ranks of all slices.

    Every rank of every slice calls this with its own ``slice_group``;
    ``dcn_group`` names the leader group (the same string on every
    rank — only the rank whose intra-slice rank equals ``leader_rank``
    must actually have joined it). ``dcn_group=None`` degrades to a
    plain single-tier allreduce (the single-mesh baseline).
    """
    partial = col.allreduce(_as_np(tensor), slice_group, op)
    if dcn_group is None:
        return partial
    rank = col.get_rank(slice_group)
    if rank == leader_rank:
        try:
            total = dcn.dcn_allreduce(partial, dcn_group, op)
        except BaseException:
            # fan the DCN abort into the slice tier: peers blocked on
            # the payload broadcast below must fail typed NOW, without
            # poisoning the healthy slice gang's own epoch
            try:
                epoch = col.get_group_epoch(dcn_group)
            except Exception:
                epoch = 0    # not joined / torn down: header still fans out
            col.broadcast(np.asarray([_ABORTED, float(epoch)]),
                          leader_rank, slice_group)
            raise
        col.broadcast(np.asarray([_OK, 0.0]), leader_rank, slice_group)
        col.broadcast(total, leader_rank, slice_group)
        return total
    status = col.broadcast(np.zeros(2), leader_rank, slice_group)
    if status[0] != _OK:
        raise CollectiveAbortError(
            f"DCN tier aborted during hierarchical allreduce "
            f"(leader fan-out into {slice_group!r})",
            group=dcn_group, epoch=int(status[1]))
    return col.broadcast(partial, leader_rank, slice_group)

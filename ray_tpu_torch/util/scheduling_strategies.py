"""Public scheduling strategies.

Reference: ``python/ray/util/scheduling_strategies.py`` [UNVERIFIED —
mount empty, SURVEY.md §0].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    kind = "PLACEMENT_GROUP"


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str          # hex of the target NodeID
    soft: bool = False

    kind = "NODE_AFFINITY"


@dataclass
class NodeLabelSchedulingStrategy:
    hard: Dict[str, str]
    soft: Optional[Dict[str, str]] = None

    kind = "NODE_LABEL"


def apply_placement_group_option(opts) -> None:
    """Fold the legacy ``placement_group=`` option into a strategy."""
    if opts.placement_group is not None and opts.scheduling_strategy is None:
        opts.scheduling_strategy = PlacementGroupSchedulingStrategy(
            placement_group=opts.placement_group,
            placement_group_bundle_index=opts.placement_group_bundle_index)

"""Logical plan + optimizer for Dataset.

Reference: ``python/ray/data/_internal/logical/`` (operators, rules)
and ``_internal/planner/`` [UNVERIFIED — mount empty, SURVEY.md §0].
The one rule that matters for performance is implemented: consecutive
row/batch transforms FUSE into a single physical map stage so a block
makes one round trip through a worker for the whole chain.

The port's copy of ``ray_tpu/data/_internal/plan.py``: a map stage asks
for ``num_gpus`` (a ``GPU`` resource) where the reference's asks for
``num_tpus``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


class LogicalOp:
    """Node in the logical DAG (single-input chain + sources)."""

    def __init__(self, name: str, input_op: Optional["LogicalOp"] = None):
        self.name = name
        self.input_op = input_op

    def chain(self) -> List["LogicalOp"]:
        ops: List[LogicalOp] = []
        op: Optional[LogicalOp] = self
        while op is not None:
            ops.append(op)
            op = op.input_op
        return list(reversed(ops))

    def __repr__(self):
        return self.name


class InputData(LogicalOp):
    def __init__(self, block_refs: List):
        super().__init__("InputData")
        self.block_refs = block_refs


class Read(LogicalOp):
    def __init__(self, read_tasks: List[Callable], name: str = "Read"):
        super().__init__(name)
        self.read_tasks = read_tasks  # each: () -> Block


@dataclasses.dataclass
class MapTransform:
    """One fused step: kind in {"batches","rows","filter","flat"}."""
    kind: str
    fn: Any                      # callable or actor-class
    fn_args: Tuple = ()
    fn_kwargs: Dict = dataclasses.field(default_factory=dict)
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    zero_copy: bool = False


class AbstractMap(LogicalOp):
    def __init__(self, name: str, input_op: LogicalOp,
                 transform: MapTransform,
                 concurrency: Optional[int] = None,
                 num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None):
        super().__init__(name, input_op)
        self.transform = transform
        self.concurrency = concurrency
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus

    def resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.num_cpus:
            out["CPU"] = float(self.num_cpus)
        if self.num_gpus:
            out["GPU"] = float(self.num_gpus)
        return out


class AllToAll(LogicalOp):
    """Barrier op: repartition / shuffle / sort / groupby."""

    def __init__(self, name: str, input_op: LogicalOp, kind: str,
                 **kwargs):
        super().__init__(name, input_op)
        self.kind = kind
        self.kwargs = kwargs


class Limit(LogicalOp):
    def __init__(self, input_op: LogicalOp, n: int):
        super().__init__(f"Limit[{n}]", input_op)
        self.n = n


class Union(LogicalOp):
    def __init__(self, input_op: LogicalOp, others: List[LogicalOp]):
        super().__init__("Union", input_op)
        self.others = others


# --------------------------------------------------------------------------
# Physical plan: a list of stages the streaming executor runs.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MapStage:
    name: str
    transforms: List[MapTransform]          # fused chain
    concurrency: Optional[int] = None       # actor pool size if class fn
    resources: Dict[str, float] = dataclasses.field(default_factory=dict)
    uses_actors: bool = False


@dataclasses.dataclass
class AllToAllStage:
    name: str
    kind: str                               # repartition|shuffle|sort|groupby
    kwargs: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LimitStage:
    name: str
    n: int = 0


@dataclasses.dataclass
class PhysicalPlan:
    source_refs: List                        # pre-materialized block refs
    read_tasks: List[Callable]               # or lazy read tasks
    stages: List                             # MapStage | AllToAllStage | LimitStage
    extra_sources: List["PhysicalPlan"] = dataclasses.field(
        default_factory=list)                # union inputs


def plan(op: LogicalOp) -> PhysicalPlan:
    """Lower the logical chain; fuse adjacent map ops."""
    chain = op.chain()
    src = chain[0]
    if isinstance(src, InputData):
        p = PhysicalPlan(source_refs=list(src.block_refs), read_tasks=[],
                         stages=[])
    elif isinstance(src, Read):
        p = PhysicalPlan(source_refs=[], read_tasks=list(src.read_tasks),
                         stages=[])
    else:
        raise ValueError(f"chain must start at a source, got {src}")

    for node in chain[1:]:
        if isinstance(node, AbstractMap):
            is_actor = not callable_is_function(node.transform.fn)
            prev = p.stages[-1] if p.stages else None
            if (isinstance(prev, MapStage) and not prev.uses_actors
                    and not is_actor and node.concurrency is None
                    and not node.resources()):
                # FUSE into the previous map stage
                prev.transforms.append(node.transform)
                prev.name += f"->{node.name}"
            else:
                p.stages.append(MapStage(
                    name=node.name, transforms=[node.transform],
                    concurrency=node.concurrency,
                    resources=node.resources(),
                    uses_actors=is_actor))
        elif isinstance(node, AllToAll):
            p.stages.append(AllToAllStage(node.name, node.kind,
                                          node.kwargs))
        elif isinstance(node, Limit):
            p.stages.append(LimitStage(node.name, node.n))
        elif isinstance(node, Union):
            p.extra_sources.extend(plan(o) for o in node.others)
        else:
            raise ValueError(f"unknown logical op {node}")
    return p


def callable_is_function(fn) -> bool:
    import inspect
    return not inspect.isclass(fn)

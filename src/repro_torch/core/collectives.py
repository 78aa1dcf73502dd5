"""Collectives counted as they run (the port's counterpart of
``repro.core.hlo_analysis.collective_stats`` / ``top_collectives``).

The reference reads its collectives out of compiled HLO and multiplies
each by the trip counts of its enclosing loops; the port's layer stacks
are Python loops, so :class:`CollectiveCounter`, a ``TorchDispatchMode``,
sees every collective a step issues as it runs: the ``_c10d_functional``
ops that DTensor redistributions and ``local_map`` bodies issue, and the
``c10d`` ops of direct calls (a ring's sends), and DTensor's own
all-to-all of a re-split (``_dtensor::shard_dim_alltoall``, on a CUDA
mesh; a CPU mesh gathers instead).  Each is recorded under
the reference's kind names with the reference's byte rule
(``hlo_analysis._operand_bytes``): an all-gather counts its input, a
reduce-scatter its full input, the other kinds their operand.  A
collective is named by the innermost :func:`region` open around it.

The mode lets DTensor arguments through (``NotImplemented``), so it sees
the per-rank ops DTensor dispatches them into, collectives included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_KINDS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional_autograd::all_to_all_single": "all-to-all",
    # DTensor's Shard(i) -> Shard(j) on a CUDA mesh
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::alltoall_": "all-to-all",
    "c10d::send": "collective-permute",
}
# the argument holding each op's input: the functional ops' first, the
# c10d ops' per their schemas (output first where they take one)
_INPUT_ARG = {
    "c10d::allgather_": 1, "c10d::_allgather_base_": 1,
    "c10d::reduce_scatter_": 1, "c10d::_reduce_scatter_base_": 1,
    "c10d::alltoall_base_": 1, "c10d::alltoall_": 1,
}

_REGIONS = threading.local()


@contextlib.contextmanager
def region(name: str):
    """Names the collectives issued inside it (innermost wins), and marks
    the same range for ``torch.profiler`` (``record_function``)."""
    stack = getattr(_REGIONS, "stack", None)
    if stack is None:
        stack = _REGIONS.stack = []
    stack.append(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        stack.pop()


def _region() -> str:
    stack = getattr(_REGIONS, "stack", None)
    return stack[-1] if stack else "step"


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(y) for y in x)
    return 0


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives run under it (see the module note).
    ``records`` lists each as {"kind", "bytes", "name"} in issue order."""

    def __init__(self):
        super().__init__()
        self.records: List[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._schema.name
        kind = _KINDS.get(name)
        if kind is not None:
            arg = args[_INPUT_ARG.get(name, 0)]
            self.records.append({"kind": kind, "bytes": _bytes(arg),
                                 "name": _region()})
        return func(*args, **(kwargs or {}))

    def stats(self) -> CollectiveStats:
        by_bytes: Dict[str, float] = defaultdict(float)
        by_count: Dict[str, int] = defaultdict(int)
        for r in self.records:
            by_bytes[r["kind"]] += r["bytes"]
            by_count[r["kind"]] += 1
        return CollectiveStats(dict(by_bytes), dict(by_count))

    def top(self, n: int = 10) -> List[dict]:
        """The n largest collectives by bytes, each record once."""
        return sorted(self.records, key=lambda r: -r["bytes"])[:n]

    def top_grouped(self, n: Optional[int] = 8) -> List[dict]:
        """The reference's ``top_collectives`` records: identical
        collectives (kind, bytes, region) grouped, ``trips`` the times
        the step issued one (where the reference multiplies by its loop
        trips), ``bytes_total`` = trips x ``bytes_once``, ``op_name``
        the region; the n largest by ``bytes_total`` (all with None),
        ties in issue order."""
        trips = Counter((r["kind"], r["bytes"], r["name"])
                        for r in self.records)
        out = [{"kind": k, "bytes_once": b, "trips": t,
                "bytes_total": b * t, "op_name": name}
               for (k, b, name), t in trips.items()]
        out.sort(key=lambda r: -r["bytes_total"])
        return out if n is None else out[:n]

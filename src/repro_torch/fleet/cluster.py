"""The port's copy of ``repro.fleet.cluster``, unchanged in behaviour
(the port imports nothing of the reference package).

Fleet hardware model: pods of chips with topology-constrained slices.

Each pod is a buddy allocator over power-of-two slices (1..pod_size chips):
an ML job needs a *contiguous torus slice*, not merely free chips, so a pod
with 128 free-but-fragmented chips can still reject a 128-chip request —
this is precisely the Capacity != Availability myth of paper §4.1 (Myth 1),
and the buddy structure is the standard abstraction of TPU slice shapes
(1x1, 2x2, 4x4, ... sub-tori).

Multi-pod ("extra-large") jobs take whole pods connected over DCN.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


SLICE_SEP = "#s"     # gang-slice allocation ids: "<job_id>#s<k>"

# sentinel prefix: a failed slice's chips held out of service until its
# repair window elapses (SimConfig.slice_repair_s); unlike maintenance
# sentinels these are sub-pod and do NOT mark their pod reserved
REPAIR_TAG = "__repair__"


def owner_of(alloc_id: str) -> str:
    """Owning job of an allocation id: gang slices allocate per-slice
    under ``"<job_id>#s<k>"``; every other allocation is its own owner."""
    i = alloc_id.find(SLICE_SEP)
    return alloc_id[:i] if i >= 0 else alloc_id


@dataclasses.dataclass
class Allocation:
    job_id: str
    pod: int              # -1 for multi-pod
    offset: int           # buddy offset within pod (chips)
    chips: int
    pods: Tuple[int, ...] = ()   # for multi-pod allocations


class _BuddyPod:
    """Buddy allocator over one pod's chips."""

    def __init__(self, pod_id: int, size: int):
        assert _is_pow2(size)
        self.pod_id = pod_id
        self.size = size
        # free lists: order -> sorted list of offsets; order k = 2^k chips
        self.max_order = size.bit_length() - 1
        self.free: Dict[int, List[int]] = {k: [] for k in range(self.max_order + 1)}
        self.free[self.max_order] = [0]
        self.used: Dict[int, int] = {}   # offset -> order

    def free_chips(self) -> int:
        return sum(len(v) * (1 << k) for k, v in self.free.items())

    def largest_slice(self) -> int:
        for k in range(self.max_order, -1, -1):
            if self.free[k]:
                return 1 << k
        return 0

    def alloc(self, chips: int) -> Optional[int]:
        order = max(chips.bit_length() - 1, 0)
        if (1 << order) < chips:
            order += 1
        k = order
        while k <= self.max_order and not self.free[k]:
            k += 1
        if k > self.max_order:
            return None
        # split down
        while k > order:
            off = self.free[k].pop(0)
            k -= 1
            self.free[k].extend([off, off + (1 << k)])
            self.free[k].sort()
        off = self.free[order].pop(0)
        self.used[off] = order
        return off

    def release(self, offset: int):
        order = self.used.pop(offset)
        # coalesce buddies
        while order < self.max_order:
            buddy = offset ^ (1 << order)
            if buddy in self.free[order]:
                self.free[order].remove(buddy)
                offset = min(offset, buddy)
                order += 1
            else:
                break
        self.free[order].append(offset)
        self.free[order].sort()

    def fragmentation(self) -> float:
        """1 - largest_slice / free_chips (0 = perfectly defragmented)."""
        f = self.free_chips()
        return 1.0 - self.largest_slice() / f if f else 0.0


class Cluster:
    def __init__(self, n_pods: int = 8, pod_size: int = 256):
        self.n_pods = n_pods
        self.pod_size = pod_size
        self.pods = [_BuddyPod(i, pod_size) for i in range(n_pods)]
        self.allocations: Dict[str, Allocation] = {}

    @property
    def total_chips(self) -> int:
        return self.n_pods * self.pod_size

    def free_chips(self) -> int:
        return sum(p.free_chips() for p in self.pods)

    def can_fit(self, chips: int) -> bool:
        if chips <= self.pod_size:
            return any(p.largest_slice() >= _round_pow2(chips)
                       for p in self.pods)
        need = -(-chips // self.pod_size)
        return sum(1 for p in self.pods
                   if p.largest_slice() == self.pod_size) >= need

    def alloc(self, job_id: str, chips: int, prefer_tight: bool = True,
              exclude: Tuple[int, ...] = (),
              pod_key=None) -> Optional[Allocation]:
        """Topology-aware placement.  ``pod_key`` (a sort key over pods,
        normally supplied by a ``fleet.policies.PlacementPolicy``) orders
        the candidate pods; the default reproduces best-fit — tightest pod
        first (defragmentation-friendly, paper §5.3).  ``exclude`` pods are
        draining for a queued multi-pod job and take no new sub-pod work."""
        if chips <= self.pod_size:
            want = _round_pow2(chips)
            candidates = [p for p in self.pods
                          if p.largest_slice() >= want
                          and p.pod_id not in exclude]
            if not candidates:
                return None
            if pod_key is not None:
                candidates.sort(key=pod_key)
            elif prefer_tight:
                candidates.sort(key=lambda p: (p.largest_slice(),
                                               -len(self.pod_jobs(p.pod_id))))
            pod = candidates[0]
            off = pod.alloc(want)
            alloc = Allocation(job_id, pod.pod_id, off, want)
        else:
            need = -(-chips // self.pod_size)
            empties = [p for p in self.pods
                       if p.largest_slice() == self.pod_size]
            if len(empties) < need:
                return None
            pods = []
            for p in empties[:need]:
                p.alloc(self.pod_size)
                pods.append(p.pod_id)
            alloc = Allocation(job_id, -1, 0, need * self.pod_size,
                               tuple(pods))
        self.allocations[job_id] = alloc
        return alloc

    def release(self, job_id: str):
        alloc = self.allocations.pop(job_id, None)
        if alloc is None:
            return
        if alloc.pod >= 0:
            self.pods[alloc.pod].release(alloc.offset)
        else:
            for pid in alloc.pods:
                self.pods[pid].release(0)

    def retag(self, old_id: str, new_id: str) -> None:
        """Transfer an allocation to a sentinel owner (a failed slice held
        out of service for repair) without touching the free lists — the
        chips stay occupied, only the owning id changes."""
        a = self.allocations.pop(old_id)
        self.allocations[new_id] = dataclasses.replace(a, job_id=new_id)

    def reserve_pod(self, pod_id: int, tag: str) -> None:
        """Take a whole (empty) pod out of service under a sentinel
        allocation — a scheduled-maintenance drain.  The pod must be fully
        free (the sim drains its occupants first); ``release(tag)`` returns
        it to service."""
        off = self.pods[pod_id].alloc(self.pod_size)
        if off is None:
            raise RuntimeError(f"pod {pod_id} not drained; cannot reserve")
        self.allocations[tag] = Allocation(tag, pod_id, off, self.pod_size)

    def pod_jobs(self, pod_id: int) -> List[str]:
        return [j for j, a in self.allocations.items()
                if a.pod == pod_id or pod_id in a.pods]

    def fragmentation(self) -> float:
        f = [p.fragmentation() for p in self.pods if p.free_chips()]
        return sum(f) / len(f) if f else 0.0


def _round_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length() if n > 1 else 1

"""The port's copy of ``repro.serve.engine``, unchanged in behaviour.

Continuous-batching serve engine with SLO-aware serving goodput.

The paper's Fig. 15 shows serving Runtime Goodput trailing training
because of fluctuating demand and batch bubbles.  The legacy serve loop
(``repro.launch.serve.Server``) *creates* those losses by construction:
fixed ``range(0, len(reqs), batch)`` groups, head-of-line blocking while
a group assembles, and every request riding out ``max(r.max_new)`` of
its batch.  This engine schedules around them:

  * **prefill/decode phase split** — admission prefills new requests as
    their own op; decode iterations run over whatever is live;
  * **continuous batching** — per-iteration admission from the request
    queue; finished requests detach immediately and their slot readmits;
  * **paged KV cache** (:class:`repro.serve.kv_cache.PagedKVCache`) —
    admission is gated on block-table space, decode grows block-by-block,
    and block exhaustion preempts the youngest request (recompute
    preemption, booked as a scheduling-layer LOST);
  * **SLO-aware accounting** — decode time for a token delivered past its
    latency deadline is emitted as ``Phase.SLO_BREACH`` (a scheduling-
    layer loss, MAD-Max's batching/parallelism trade-off made visible in
    the attribution waterfall), so ``STEP`` chip-time *is* the
    within-SLO productive time and

        SLO-goodput = within-SLO decode chip-time / capacity chip-time.

Accounting model: each of the engine's ``n_slots`` batch slots is a
chip.  Queue wait is QUEUED (demand-side), prefill is INIT, on-time
decode is STEP, late decode is SLO_BREACH, preempted work is LOST, and
any slot-second not covered by an op is IDLE (the batch bubble) — so the
emitted intervals partition ``n_slots x [t_start, t_end]`` exactly (the
gap/overlap-free tiling property test).

``run_static`` is the equal-capacity reference: the legacy fixed-group
policy replayed through the identical executor, SLO, and accounting.

The engine runs in *virtual time*: every executor op returns its cost
and the engine advances its clock by it.  With the simulated executor
the whole run is deterministic bit-for-bit; with the per-slot JAX
executor costs are measured off an injectable clock (the same
``TickClock`` contract the legacy server uses).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.attribution import _SHIFT, _exact
from repro_torch.core.goodput import Layer, Phase
from repro_torch.core.ledger import GoodputLedger
from repro_torch.serve.kv_cache import OutOfBlocksError, PagedKVCache

try:
    import numpy as _np
except ModuleNotFoundError:          # pure-python percentile fallback
    _np = None


# ---------------------------------------------------------------------------
# requests and SLOs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeRequest:
    """One inference request in the engine's virtual timeline."""
    rid: int
    prompt_len: int
    max_new: int                      # total tokens incl. the prefill token
    t_submit: float = 0.0
    pg: float = 1.0                   # program goodput of the serving program
    prompt: Optional[object] = None   # token array, only the JAX executor

    # runtime state (engine-owned)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    preemptions: int = 0
    _runs: List[List] = dataclasses.field(default_factory=list)
    # queue-wait accounting restarts here after a preemption, so the span
    # [submit, first admission) is never emitted twice
    _queued_from: Optional[float] = None

    def _add_run(self, phase: Phase, t0: float, t1: float) -> None:
        """Append a [t0, t1) span, coalescing contiguous same-phase runs."""
        if self._runs and self._runs[-1][0] is phase \
                and self._runs[-1][2] == t0:
            self._runs[-1][2] = t1
        else:
            self._runs.append([phase, t0, t1])


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """Latency SLO: token ``k`` of a request is on time iff it is
    delivered by ``t_submit + ttft + k * tpot`` (k = 0 is the prefill
    token, so its deadline is the time-to-first-token target)."""
    ttft: float = math.inf            # time-to-first-token target (s)
    tpot: float = math.inf            # per-output-token target (s)

    def deadline(self, req: ServeRequest, k: int) -> float:
        return req.t_submit + self.ttft + k * self.tpot


NO_SLO = ServeSLO()


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

class SimulatedExecutor:
    """Analytic cost model standing in for the compiled program: batching
    amortizes a fixed per-op launch cost over the active slots, which is
    exactly the economy continuous batching exists to exploit.

      prefill cost = prefill_fixed + Σ prompt_len * prefill_per_token
      decode cost  = decode_fixed + n_active * decode_per_token

    Tokens are a deterministic function of (rid, position) so same-seed
    runs are bit-for-bit identical with no model in the loop — the serve
    analog of the fleet simulator.
    """

    def __init__(self, prefill_fixed: float = 5e-3,
                 prefill_per_token: float = 5e-5,
                 decode_fixed: float = 8e-3,
                 decode_per_token: float = 1e-3,
                 vocab_size: int = 50_000):
        self.prefill_fixed = prefill_fixed
        self.prefill_per_token = prefill_per_token
        self.decode_fixed = decode_fixed
        self.decode_per_token = decode_per_token
        self.vocab_size = vocab_size

    def _token(self, req: ServeRequest, k: int) -> int:
        return (req.rid * 7919 + k * 31 + 17) % self.vocab_size

    def prefill(self, reqs: Sequence[ServeRequest]) -> Tuple[List[int], float]:
        cost = self.prefill_fixed + sum(
            r.prompt_len * self.prefill_per_token for r in reqs)
        return [self._token(r, 0) for r in reqs], cost

    def decode(self, reqs: Sequence[ServeRequest]) -> Tuple[List[int], float]:
        cost = self.decode_fixed + len(reqs) * self.decode_per_token
        return [self._token(r, len(r.out_tokens)) for r in reqs], cost

    def release(self, req: ServeRequest) -> None:
        pass


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    if _np is not None:
        return float(_np.percentile(_np.asarray(xs, dtype=_np.float64), q))
    ys = sorted(xs)
    pos = (len(ys) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(ys) - 1)
    return ys[lo] + (ys[hi] - ys[lo]) * (pos - lo)


@dataclasses.dataclass
class ServeReport:
    """Serving metrics + goodput for one engine run (JSON-ready)."""
    engine: str
    n_slots: int
    requests: int
    tokens: int
    tokens_within_slo: int
    slo_token_goodput: float          # on-time tokens / tokens
    slo_goodput: float                # within-SLO STEP chip-time / capacity
    preemptions: int
    span: float
    capacity_chip_time: float
    goodput: Dict[str, float]         # SG/RG/PG/MPG from the shared ledger
    ttft_s: Dict[str, float]          # mean / p50 / p99
    tpot_s: Dict[str, float]          # mean / p50 / p99
    rg_breakdown: Dict[str, float]
    kv_cache: Optional[Dict[str, int]] = None

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _latency_stats(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p99": 0.0}
    return {"mean": sum(xs) / len(xs),
            "p50": _percentile(xs, 50.0),
            "p99": _percentile(xs, 99.0)}


# ---------------------------------------------------------------------------
# the continuous-batching engine
# ---------------------------------------------------------------------------

class ContinuousServeEngine:
    """Per-iteration admission, immediate detach, paged KV, SLO tagging.

    Parameters
    ----------
    n_slots:
        Batch width of the serving replica — the engine's chip count.
    executor:
        Object with ``prefill(reqs) -> (tokens, cost)``,
        ``decode(reqs) -> (tokens, cost)`` and ``release(req)``.
    kv_cache:
        A :class:`PagedKVCache`; defaults to one sized so every slot can
        hold a full ``prompt + max_new`` sequence (no preemption unless
        the caller under-provisions on purpose).
    """

    def __init__(self, n_slots: int, executor,
                 slo: ServeSLO = NO_SLO,
                 kv_cache: Optional[PagedKVCache] = None,
                 ledger: Optional[GoodputLedger] = None,
                 arch: str = "sim"):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = n_slots
        self.executor = executor
        self.slo = slo
        self.kv = kv_cache
        self.ledger = ledger if ledger is not None else GoodputLedger()
        self.arch = arch
        # interned segment dicts: one per (phase-role, layer) — the
        # ledger's columnar ingest resolves each only once
        self._segs = {
            name: {"phase_kind": "serve", "arch": arch, "emitter": "serve",
                   "layer": layer.value}
            for name, layer in (
                ("queued", Layer.SCHEDULING), ("init", Layer.MODEL),
                ("step", Layer.MODEL), ("breach", Layer.SCHEDULING),
                ("idle", Layer.SCHEDULING), ("lost", Layer.SCHEDULING))}
        self.t = 0.0
        self.preemptions = 0
        self._idle_run: Optional[List] = None      # [t0, t1, width]
        self._t_start = 0.0
        # exact mirror of the supply-side chip-time this engine emits, as
        # an integer scaled by 2**1074 (every finite float is a multiple
        # of 2**-1074): the intervals tile n_slots x span by construction,
        # so the engine's capacity IS this sum — but n_slots * span can
        # land ulps *below* it under re-associated float addition, which
        # would fail the attribution waterfall's exact
        # capacity-covers-allocated check.  _report rounds this mirror up
        # to the nearest float.  The float twin accumulates the same
        # values in the same order as the ledger's own allocated total,
        # so on a dedicated ledger SG is exactly 1.0 (float summation
        # drift can push the ledger's float total above the rounded-up
        # exact sum).
        self._supply_exact = 0
        self._supply_float = 0.0

    # ---- accounting helpers ----------------------------------------------
    def _advance(self, cost: float, busy: int) -> Tuple[float, float]:
        """Advance virtual time by ``cost``; slot-chips not covered by the
        op are booked into the coalesced engine IDLE run."""
        t0 = self.t
        t1 = t0 + cost
        self.t = t1
        width = self.n_slots - busy
        run = self._idle_run
        if run is not None and run[2] == width and run[1] == t0:
            run[1] = t1
        else:
            self._flush_idle()
            if width > 0:
                self._idle_run = [t0, t1, width]
        return t0, t1

    def _flush_idle(self) -> None:
        run, self._idle_run = self._idle_run, None
        if run is not None and run[1] > run[0]:
            self._supply_exact += _exact((run[1] - run[0]) * run[2])
            self._supply_float += (run[1] - run[0]) * run[2]
            self.ledger.emit(job_id="bubble", phase=Phase.IDLE,
                             t0=run[0], t1=run[1], chips=run[2],
                             segment=self._segs["idle"])

    def _flush_request(self, r: ServeRequest) -> None:
        """Columnar-ingest a detached request's QUEUED span + run list."""
        segs = self._segs
        job_ids, phases, t0s, t1s, chips, pgs, seg_col = \
            [], [], [], [], [], [], []

        def row(phase, a, b, seg, pg=1.0):
            job_ids.append(f"req{r.rid}")
            phases.append(phase)
            t0s.append(a)
            t1s.append(b)
            chips.append(1)
            pgs.append(pg)
            seg_col.append(seg)

        queued_from = (r.t_submit if r._queued_from is None
                       else r._queued_from)
        if r.t_admit > queued_from:
            row(Phase.QUEUED, queued_from, r.t_admit, segs["queued"])
        seg_of = {Phase.STEP: segs["step"],
                  Phase.SLO_BREACH: segs["breach"],
                  Phase.LOST: segs["lost"],
                  Phase.INIT: segs["init"],
                  Phase.IDLE: segs["idle"]}
        for phase, a, b in r._runs:
            if b > a:
                self._supply_exact += _exact((b - a) * 1)
                self._supply_float += (b - a) * 1
            row(phase, a, b, seg_of[phase],
                pg=r.pg if phase is Phase.STEP else 1.0)
        r._runs = []
        self.ledger.add_intervals(job_ids, phases, t0s, t1s, chips, pgs,
                                  seg_col)

    # ---- the run loop -----------------------------------------------------
    def run(self, requests: Sequence[ServeRequest]) -> ServeReport:
        reqs = sorted(requests, key=lambda r: (r.t_submit, r.rid))
        if self.kv is None:
            need = max((r.prompt_len + r.max_new for r in reqs), default=1)
            self.kv = PagedKVCache(
                n_blocks=self.n_slots * max(
                    1, -(-need // 128)), block_tokens=128)
        kv = self.kv
        for r in reqs:
            if r.max_new < 1 or r.prompt_len < 1:
                raise ValueError(
                    f"request {r.rid}: prompt_len and max_new must be >= 1")
            if kv.blocks_needed(r.prompt_len + r.max_new) > kv.n_blocks:
                raise ValueError(
                    f"request {r.rid} needs "
                    f"{kv.blocks_needed(r.prompt_len + r.max_new)} KV "
                    f"blocks but the cache holds {kv.n_blocks}")
        queue = deque(reqs)
        active: List[ServeRequest] = []
        done: List[ServeRequest] = []
        self.t = self._t_start = queue[0].t_submit if queue else 0.0
        self.preemptions = 0

        while queue or active:
            # 1) admission: drain arrived requests into free slots, gated
            #    on the paged cache fitting their full sequence right now
            admitted: List[ServeRequest] = []
            while queue and len(active) + len(admitted) < self.n_slots:
                nxt = queue[0]
                if nxt.t_submit > self.t:
                    if active or admitted:
                        break
                    # engine idle: jump to the next arrival
                    self._advance(nxt.t_submit - self.t, busy=0)
                    continue
                if not kv.can_allocate(nxt.prompt_len + nxt.max_new):
                    break             # wait for detaches to free blocks
                queue.popleft()
                kv.allocate(nxt.rid, nxt.prompt_len)
                nxt.t_admit = self.t
                admitted.append(nxt)

            # 2) prefill phase: one op for this iteration's admissions
            if admitted:
                toks, cost = self.executor.prefill(admitted)
                t0, t1 = self._advance(cost, busy=len(admitted))
                for r, tok in zip(admitted, toks):
                    r.out_tokens.append(tok)
                    r.token_times.append(t1)
                    r.t_first = t1
                    r._add_run(Phase.INIT, t0, t1)
                    if r.max_new == 1:
                        self._detach(r, done)
                    else:
                        active.append(r)
                continue              # re-check admission before decoding

            if not active:
                continue

            # 3) KV growth for this decode iteration; exhaustion preempts
            #    the youngest other request (recompute preemption)
            survivors: List[ServeRequest] = []
            for r in list(active):
                if r not in active:
                    continue          # preempted by an earlier grower
                while True:
                    try:
                        kv.append_token(r.rid)
                        survivors.append(r)
                        break
                    except OutOfBlocksError:
                        victim = self._pick_victim(active, exclude=r)
                        assert victim is not None, \
                            "sole request cannot exhaust a validated cache"
                        self._preempt(victim, active, survivors, queue)

            # 4) decode one iteration for the survivors
            toks, cost = self.executor.decode(survivors)
            t0, t1 = self._advance(cost, busy=len(survivors))
            for r, tok in zip(survivors, toks):
                k = len(r.out_tokens)          # 0-based output-token index
                r.out_tokens.append(tok)
                r.token_times.append(t1)
                on_time = t1 <= self.slo.deadline(r, k)
                r._add_run(Phase.STEP if on_time else Phase.SLO_BREACH,
                           t0, t1)
                if len(r.out_tokens) >= r.max_new:
                    active.remove(r)
                    self._detach(r, done)

        self._flush_idle()
        return self._report(done, engine="continuous")

    def _pick_victim(self, active: List[ServeRequest],
                     exclude: ServeRequest) -> Optional[ServeRequest]:
        cands = [r for r in active if r is not exclude]
        if not cands:
            return None
        return max(cands, key=lambda r: (r.t_admit, r.rid))

    def _preempt(self, victim: ServeRequest, active: List[ServeRequest],
                 survivors: List[ServeRequest],
                 queue: deque) -> None:
        """Recompute preemption: the victim's resident work is rolled back
        (its INIT/STEP/SLO_BREACH runs re-emit as scheduling-layer LOST),
        its blocks free, and it re-queues for a fresh admission."""
        self.kv.free(victim.rid)
        self.executor.release(victim)
        victim._runs = [[Phase.LOST, a, b] for _, a, b in victim._runs]
        self._flush_request(victim)
        victim.out_tokens = []
        victim.token_times = []
        victim.t_first = 0.0
        victim._queued_from = self.t
        victim.preemptions += 1
        self.preemptions += 1
        active.remove(victim)
        if victim in survivors:
            survivors.remove(victim)
        # re-admission keeps arrival order among the waiting
        queue.appendleft(victim)

    def _detach(self, r: ServeRequest, done: List[ServeRequest]) -> None:
        r.t_done = self.t
        self.kv.free(r.rid)
        self.executor.release(r)
        self._flush_request(r)
        done.append(r)

    def _report(self, done: List[ServeRequest], engine: str) -> ServeReport:
        span = max(0.0, self.t - self._t_start)
        # mathematically n_slots * span — see _supply_exact for why the
        # capacity comes from the emitted-interval mirror, rounded up to
        # the nearest float so it covers the exact allocated sum
        from fractions import Fraction

        frac = Fraction(self._supply_exact, 1 << _SHIFT)
        capacity = float(frac)
        if Fraction(capacity) < frac:
            capacity = math.nextafter(capacity, math.inf)
        capacity = max(capacity, self._supply_float)
        self.ledger.add_capacity(capacity)
        rep = self.ledger.report()
        tokens = sum(len(r.out_tokens) for r in done)
        within = sum(
            1 for r in done for k, tt in enumerate(r.token_times)
            if tt <= self.slo.deadline(r, k))
        ttfts = [r.t_first - r.t_submit for r in done if r.t_first]
        tpots = [(r.t_done - r.t_first) / (len(r.out_tokens) - 1)
                 for r in done if len(r.out_tokens) > 1]
        return ServeReport(
            engine=engine,
            n_slots=self.n_slots,
            requests=len(done),
            tokens=tokens,
            tokens_within_slo=within,
            slo_token_goodput=within / tokens if tokens else 0.0,
            slo_goodput=(rep.productive_chip_time / capacity
                         if capacity else 0.0),
            preemptions=self.preemptions,
            span=span,
            capacity_chip_time=capacity,
            goodput=rep.as_dict(),
            ttft_s=_latency_stats(ttfts),
            tpot_s=_latency_stats(tpots),
            rg_breakdown=self.ledger.rg_breakdown(),
            kv_cache=self.kv.stats.as_dict() if self.kv else None,
        )


# ---------------------------------------------------------------------------
# the static reference (equal-capacity A/B baseline)
# ---------------------------------------------------------------------------

def run_static(requests: Sequence[ServeRequest], batch: int, executor,
               slo: ServeSLO = NO_SLO,
               ledger: Optional[GoodputLedger] = None,
               arch: str = "sim") -> ServeReport:
    """The legacy fixed-group policy under the engine's accounting: groups
    of ``batch`` requests in submission order, each group waiting for its
    last member (head-of-line blocking), prefilled together, and decoded
    ``max(r.max_new)`` iterations at full compiled width — finished
    requests ride the batch out as IDLE, tail groups pad with IDLE slots.
    Identical executor, SLO, and emission shapes as the continuous
    engine, so the two reports differ only by scheduling policy.
    """
    eng = ContinuousServeEngine(batch, executor, slo=slo, ledger=ledger,
                                arch=arch)
    ledger = eng.ledger
    reqs = sorted(requests, key=lambda r: (r.t_submit, r.rid))
    eng.t = eng._t_start = reqs[0].t_submit if reqs else 0.0
    done: List[ServeRequest] = []
    for g0 in range(0, len(reqs), batch):
        group = reqs[g0:g0 + batch]
        start = max(eng.t, max(r.t_submit for r in group))
        if start > eng.t:             # whole replica waits for the group
            eng._advance(start - eng.t, busy=0)
        for r in group:
            r.t_admit = eng.t
        toks, cost = executor.prefill(group)
        t0, t1 = eng._advance(cost, busy=len(group))
        for r, tok in zip(group, toks):
            r.out_tokens.append(tok)
            r.token_times.append(t1)
            r.t_first = t1
            r._add_run(Phase.INIT, t0, t1)
        for _ in range(max(r.max_new for r in group) - 1):
            # the compiled program runs at full group width regardless of
            # how many slots still need tokens — the static bubble
            dtoks, cost = executor.decode(group)
            t0, t1 = eng._advance(cost, busy=len(group))
            for r, tok in zip(group, dtoks):
                if len(r.out_tokens) < r.max_new:
                    k = len(r.out_tokens)
                    r.out_tokens.append(tok)
                    r.token_times.append(t1)
                    on_time = t1 <= slo.deadline(r, k)
                    r._add_run(Phase.STEP if on_time else Phase.SLO_BREACH,
                               t0, t1)
                else:                 # riding out the longest request
                    r._add_run(Phase.IDLE, t0, t1)
        for r in group:
            r.t_done = r.token_times[-1]
            executor.release(r)
            eng._flush_request(r)
            done.append(r)
    eng._flush_idle()
    report = eng._report(done, engine="static")
    report.kv_cache = None            # dense per-slot reservation, unpaged
    return report


# ---------------------------------------------------------------------------
# synthetic request workloads (scenario-arrival driven)
# ---------------------------------------------------------------------------

def synthetic_requests(arrivals: Sequence[float], prompt_len: int = 128,
                       max_new: Tuple[int, int] = (16, 64),
                       seed: int = 0, pg: float = 1.0,
                       prompt_maker: Optional[Callable] = None
                       ) -> List[ServeRequest]:
    """Requests over the given arrival times (see
    ``repro_torch.fleet.scenarios.request_arrivals``) with per-request
    output lengths drawn from a seeded stream — hermetic like the fleet
    workloads."""
    import random as _random

    rng = _random.Random(seed)
    lo, hi = max_new
    out = []
    for i, t in enumerate(arrivals):
        out.append(ServeRequest(
            rid=i, prompt_len=prompt_len, max_new=rng.randint(lo, hi),
            t_submit=float(t), pg=pg,
            prompt=prompt_maker(i) if prompt_maker is not None else None))
    return out

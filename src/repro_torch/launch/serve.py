"""Serving launcher of the port (``repro.launch.serve``): the
continuous-batching engine or the static fixed-group loop, with MPG +
SLO accounting.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 16 --batch 8 --prompt-len 200 --max-new 64

runs on the GPU; add ``--device cpu`` (and ``--smoke`` for the reduced
config) to run on the host.  The flags are the reference's:

  * ``--engine continuous`` (default): ``ContinuousServeEngine`` over the
    batched paged-decode executor or the per-slot executor
    (``--executor``), as the reference picks them;
  * ``--engine static``: the legacy fixed-group batch loop (``Server``
    below), the measured baseline the reference's A/B compares against;
  * ``--span/--arrival``: request arrivals spread over ``--span`` seconds
    of the serve timeline by the fleet arrival profiles
    (``repro_torch.fleet.scenarios``), all at t=0 when ``--span`` is 0.

Prints the report as JSON: the continuous engine's ServeReport with the
executor's prefill and decode-call counts (``executor``), or the static
loop's summary with its decode graph's counts (``static_decode``); both
keys are the port's own, every other key is the reference's.

Each batch slot is accounted like a chip: queue wait is QUEUED, prefill
is INIT, decode iterations a request actually uses are STEP (or
SLO_BREACH past its deadline), and batch bubbles are IDLE.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.goodput import Layer, Phase
from repro_torch.core.ledger import GoodputLedger
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.compute_params import serving_params
from repro_torch.serve import ContinuousServeEngine, ServeRequest, ServeSLO
from repro_torch.serve.decode_graph import DecodeGraph
from repro_torch.serve.prefill_graph import PrefillGraphs, copy_inputs
from repro_torch.serve.slot_executor import cache_prefill_step, greedy_step
from repro_torch.step_graph import graph_stats


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def is_pad(self) -> bool:
        """Sentinel clones that fill a tail batch; excluded from metrics."""
        return self.rid < 0


def pad_group(group: List[Request], batch: int) -> List[Request]:
    """Pad a tail batch to full width with sentinel clones.

    The clones share prompts (the batch runs at full width on real token
    ids) but carry ``rid=-1`` and their *own* ``out_tokens`` lists, so
    ``run_batch`` neither appends generated tokens to a real request
    twice nor overwrites its ``t_first``/``t_done``.
    """
    if not group:
        # the modulo clone-source cycle below would divide by zero; an
        # all-pad batch also has no real prompts to clone from
        raise ValueError("cannot pad an empty request group")
    pads = [Request(rid=-1, prompt=group[i % len(group)].prompt,
                    max_new=group[i % len(group)].max_new)
            for i in range(batch - len(group))]
    return group + pads


class TickClock:
    """Deterministic stand-in for ``time.monotonic``: each call advances a
    fixed virtual dt (the reference's ``TickClock``)."""

    def __init__(self, dt: float = 1.0, t0: float = 0.0):
        self.dt = dt
        self.t = t0

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


class Server:
    """The static fixed-group batch loop (the reference's ``Server``).

    Clock discipline: ``run_batch`` reads ``self.clock`` exactly once per
    phase boundary (batch start, prefill end, decode end), so an injected
    ``TickClock`` advances identically on every same-seed run, and
    ``t_first``/``t_done`` land inside the emitted intervals.  Each slot's
    INIT/STEP/IDLE intervals exactly tile ``[t0, t2]`` (asserted per
    batch).

    The model runs on ``serving_params``, the weights cast to the compute
    dtype once (:func:`~repro_torch.models.compute_params.serving_params`:
    ``params=None`` draws them on the device from seed 0 and keeps only
    the cast tree), as the executors do.  A batch's prefill runs at the
    full group width (flash attention, and the scan kernels of the
    recurrent families, on CUDA).  The decode is the counterpart of the
    reference's ``jax.jit(decode_fn)`` at batch ``batch``: one
    :class:`~repro_torch.serve.decode_graph.DecodeGraph` of
    ``decode_step_inplace`` over a static ``init_cache(cfg, batch,
    max_len)`` cache and a static (batch,) token buffer, captured once
    here (``decode_impl``: "auto" = a CUDA graph on CUDA, a direct call on
    the CPU) and replayed for every group, whose prefill cache is copied
    into the static one, never rebound.  The group prefill is the
    counterpart of the reference's jitted prefill, compiled once per
    shape: a :class:`~repro_torch.serve.prefill_graph.PrefillGraphs` step
    per (batch, prompt length) that takes static tokens and writes the
    cache and the argmax straight into the decode graph's static cache
    and token (``prefill_impl``, "auto" as ``decode_impl``); both capture
    on one side stream into one memory pool.  The stubbed front ends
    (enc-dec frames, vlm patches) take zeros at the batch width, as the
    reference's server builds them: one static buffer made here.
    """

    def __init__(self, cfg, batch: int, max_len: int,
                 ledger: Optional[GoodputLedger] = None,
                 clock: Callable[[], float] = time.monotonic, *,
                 params=None, device=None, decode_impl: str = "auto",
                 prefill_impl: str = "auto"):
        if batch <= 0:
            raise ValueError(f"batch must be positive, got {batch}")
        self.cfg = cfg
        self.batch = batch
        self.clock = clock
        self.ledger = ledger if ledger is not None else GoodputLedger()
        self.device = resolve_device(device)
        self.serving_params = serving_params(cfg, params, self.device)
        # one side stream and one memory pool for both graphs
        stream = pool = None
        if self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
            pool = torch.cuda.graph_pool_handle()
        with torch.inference_mode():
            # the stub front end's zero frames / patches at the batch
            # width, one static buffer every group prefill reads
            self._frontend = model.frontend_inputs(cfg, batch, self.device)
            bufs = {"cache": model.init_cache(cfg, batch, max_len,
                                              self.device),
                    "tok": torch.zeros((batch,), dtype=torch.int64,
                                       device=self.device)}
            step = functools.partial(greedy_step,
                                     model.decode_inplace_fn(cfg),
                                     self.serving_params)
            self._graph = DecodeGraph(step, bufs, self.device, decode_impl,
                                      stream=stream, pool=pool)
        self._prefills = PrefillGraphs(
            functools.partial(cache_prefill_step,
                              model.prefill_fn(cfg, max_len=max_len),
                              self.serving_params),
            self._prefill_buffers, self.device, prefill_impl, stream, pool)
        # what a run did: batches prefilled and decode steps run
        self.batches = 0
        self.decode_steps = 0
        # ledger-time-base span of all emitted batches, for the capacity
        # denominator (SG): request wall-clock timestamps are the wrong
        # time base once a virtual clock is injected
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None

    def decode_graph_stats(self):
        """The decode graph's counts (:func:`graph_stats`)."""
        return graph_stats([self._graph])

    def prefill_graph_count(self) -> int:
        """Captured group-prefill graphs kept: one per prompt length."""
        return self._prefills.count()

    def prefill_graph_stats(self):
        """The group prefill's counts (:meth:`PrefillGraphs.stats`)."""
        return self._prefills.stats()

    def _prefill_buffers(self, shape):
        return {"tokens": torch.zeros(shape, dtype=torch.int64,
                                      device=self.device),
                **self._frontend,
                "cache": self._graph.buffers["cache"],
                "tok": self._graph.buffers["tok"]}

    def capacity_chip_time(self) -> float:
        """Slot-chips x the ledger-time span this server was serving —
        the SG denominator, derived from the same clock the emitted
        intervals use (never from request timestamps)."""
        if self._t_start is None or self._t_end is None:
            return 0.0
        return self.batch * max(0.0, self._t_end - self._t_start)

    def span(self) -> float:
        if self._t_start is None or self._t_end is None:
            return 0.0
        return max(0.0, self._t_end - self._t_start)

    def _emit(self, rid: int, phase: Phase, t0: float, t1: float,
              layer: Layer, chips: int = 1):
        self.ledger.emit(job_id=f"req{rid}" if rid >= 0 else "pad",
                         phase=phase, t0=t0, t1=t1, chips=chips,
                         segment={"phase_kind": "serve",
                                  "arch": self.cfg.name,
                                  "emitter": "serve",
                                  "layer": layer.value})

    def _prefill_batch(self, toks: np.ndarray) -> np.ndarray:
        """Prefill the group into the decode graph's static cache and
        token, and return the tokens (one device-to-host copy, which
        waits for the device)."""
        toks = toks.astype(np.int64)
        bufs = self._prefills(
            toks.shape, lambda b: copy_inputs(b, {"tokens": toks},
                                              self.device))
        self.batches += 1
        return bufs["tok"].cpu().numpy()

    def _decode(self, steps: int) -> np.ndarray:
        """``steps`` decode steps from the static buffers; each step's
        tokens are gathered on the device and read back once, (steps,
        batch)."""
        out = torch.empty((steps, self.batch), dtype=torch.int64,
                          device=self.device)
        for i in range(steps):
            self._graph()
            out[i].copy_(self._graph.buffers["tok"])
        self.decode_steps += steps
        return out.cpu().numpy()

    def run_batch(self, reqs: List[Request]) -> Tuple[float, float]:
        if len(reqs) != self.batch:
            raise ValueError(
                f"run_batch needs exactly batch={self.batch} slots, got "
                f"{len(reqs)} — pad tail groups with pad_group()")
        real = [r for r in reqs if not r.is_pad]
        n_pad = len(reqs) - len(real)
        if not real:
            raise ValueError("run_batch needs at least one real request")
        toks = np.stack([r.prompt for r in reqs])
        t0 = self.clock()                    # boundary 1: batch start
        for r in real:                       # queue wait: submit -> batch
            self._emit(r.rid, Phase.QUEUED, r.t_submit, t0,
                       layer=Layer.SCHEDULING)
        start_len = [len(r.out_tokens) for r in reqs]
        with torch.inference_mode():
            first = self._prefill_batch(toks)
        t1 = self.clock()                    # boundary 2: prefill end
        for r, t in zip(reqs, first):
            r.out_tokens.append(int(t))
            if not r.is_pad:
                r.t_first = t1               # first token lands here
        max_new = max(r.max_new for r in reqs)
        with torch.inference_mode():
            decoded = self._decode(max_new - 1)
        for row in decoded:
            for r, t in zip(reqs, row):
                if len(r.out_tokens) < r.max_new:
                    r.out_tokens.append(int(t))
        t2 = self.clock()                    # boundary 3: decode end
        t_prefill = t1 - t0
        t_decode = t2 - t1
        iters = max(max_new - 1, 1)
        gen = {id(r): len(r.out_tokens) - s for r, s in zip(reqs, start_len)}
        for r in real:
            r.t_done = t2
            # prefill is program setup for the batch: INIT for live slots;
            # STEP for the decode iterations this request consumed, IDLE
            # for the bubble riding out the batch's longest request
            frac = min(1.0, max(0, gen[id(r)] - 1) / iters)
            split = t1 + frac * t_decode
            self._assert_tiles(t0, (t0, t1, split, t2), t2)
            self._emit(r.rid, Phase.INIT, t0, t1, layer=Layer.MODEL)
            self._emit(r.rid, Phase.STEP, t1, split, layer=Layer.MODEL)
            self._emit(r.rid, Phase.IDLE, split, t2,
                       layer=Layer.SCHEDULING)
        if n_pad:
            # padded slots: a batch-shape bubble the batching policy —
            # the scheduling layer — is responsible for
            self._emit(-1, Phase.IDLE, t0, t2, layer=Layer.SCHEDULING,
                       chips=n_pad)
        if self._t_start is None:
            self._t_start = t0
        self._t_end = t2
        return t_prefill, t_decode

    @staticmethod
    def _assert_tiles(t0: float, bounds: Tuple[float, ...], t2: float):
        """Each slot's interval boundaries must tile [t0, t2]: start at
        t0, end at t2, monotone non-decreasing — no gap, no overlap
        (zero-width segments are legal boundaries, not gaps)."""
        assert bounds[0] == t0 and bounds[-1] == t2, \
            f"slot intervals do not span [{t0}, {t2}]: {bounds}"
        for a, b in zip(bounds, bounds[1:]):
            assert a <= b, f"slot interval boundaries regress: {bounds}"


def run_static_server(cfg, reqs: List[Request], batch: int, max_new: int,
                      prompt_len: int,
                      ledger: Optional[GoodputLedger] = None,
                      clock: Callable[[], float] = time.monotonic, *,
                      params=None, device=None, decode_impl: str = "auto",
                      prefill_impl: str = "auto") -> Tuple[Server, dict]:
    """Drive the static fixed-group loop and summarize it (CLI + tests):
    the reference's report, key for key."""
    ledger = ledger if ledger is not None else GoodputLedger(window=60.0)
    server = Server(cfg, batch, max_len=prompt_len + max_new,
                    ledger=ledger, clock=clock, params=params, device=device,
                    decode_impl=decode_impl, prefill_impl=prefill_impl)
    t_pre = t_dec = 0.0
    for i in range(0, len(reqs), batch):
        group = pad_group(reqs[i:i + batch], batch)
        p, d = server.run_batch(group)
        t_pre += p
        t_dec += d
    done = [r for r in reqs if r.out_tokens]
    toks = sum(len(r.out_tokens) for r in done)
    wall = server.span()
    ttft = (float(np.mean([r.t_first - r.t_submit for r in done]))
            if done else 0.0)
    rep = ledger.report(capacity_chip_time=server.capacity_chip_time())
    return server, {
        "engine": "static",
        "arch": cfg.name,
        "requests": len(done),
        "tokens_generated": toks,
        "throughput_tok_s": round(toks / wall, 2) if wall > 0 else 0.0,
        "mean_ttft_s": round(ttft, 4),
        "prefill_s": round(t_pre, 3),
        "decode_s": round(t_dec, 3),
        "capacity_chip_time": server.capacity_chip_time(),
        "serve_sg": round(rep.sg, 4),
        "serve_rg": round(rep.rg, 4),
        "rg_breakdown": {k: round(v, 4)
                         for k, v in ledger.rg_breakdown().items()},
    }


def run_continuous_server(cfg, reqs: List[ServeRequest], batch: int,
                          max_len: int, slo_ttft: float, slo_tpot: float,
                          clock: Callable[[], float] = time.monotonic,
                          executor_kind: str = "auto", device=None) -> dict:
    """Drive the continuous engine over the real model; returns the
    ServeReport dict plus the arch and the executor's counts.
    ``executor_kind``: "batched" decodes every live slot in one call over
    the paged KV pool (raises for a family without paged decode), "slot"
    runs the per-slot batch-1 executor, "auto" picks as the reference
    does (:func:`make_executor`)."""
    from repro_torch.serve.batched_executor import (TorchBatchedExecutor,
                                                    make_executor)
    from repro_torch.serve.slot_executor import (TorchSlotExecutor,
                                                 slot_kv_cache)

    slo = ServeSLO(ttft=slo_ttft if slo_ttft > 0 else float("inf"),
                   tpot=slo_tpot if slo_tpot > 0 else float("inf"))
    if executor_kind == "batched":
        executor = TorchBatchedExecutor(cfg, max_len, batch, clock=clock,
                                        device=device)
        kv = executor.kv
    elif executor_kind == "slot":
        executor = TorchSlotExecutor(cfg, max_len, clock=clock,
                                     device=device, n_slots=batch)
        kv = slot_kv_cache(max_len, batch)
    else:
        executor, kv = make_executor(cfg, max_len, batch, clock=clock,
                                     device=device)
    engine = ContinuousServeEngine(batch, executor, slo=slo, kv_cache=kv,
                                   ledger=GoodputLedger(window=60.0),
                                   arch=cfg.name)
    out = engine.run(reqs).as_dict()
    out["arch"] = cfg.name
    out["executor"] = {"prefills": executor.prefills,
                       "decode_steps": executor.decode_steps}
    if isinstance(executor, TorchBatchedExecutor):
        out["executor"]["decode_shapes"] = executor.decode_shape_count()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--span", type=float, default=0.0,
                    help="spread request arrivals over this many seconds "
                         "of the serve timeline (0 = all at t=0)")
    ap.add_argument("--arrival", default="uniform",
                    choices=("uniform", "diurnal", "bursty"),
                    help="arrival modulation over --span (the fleet "
                         "scenario processes, repro_torch.fleet.scenarios)")
    ap.add_argument("--executor", default="auto",
                    choices=("auto", "batched", "slot"),
                    help="continuous-engine executor: one batched paged "
                         "decode vs per-slot batch-1 (auto picks batched "
                         "where the family supports paged decode)")
    ap.add_argument("--slo-ttft", type=float, default=0.0,
                    help="time-to-first-token SLO in seconds (0 = none)")
    ap.add_argument("--slo-tpot", type=float, default=0.0,
                    help="per-output-token SLO in seconds (0 = none)")
    ap.add_argument("--tick-dt", type=float, default=0.0,
                    help="inject a TickClock with this dt (deterministic "
                         "virtual time; 0 = wall clock)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    clock = TickClock(dt=args.tick_dt) if args.tick_dt > 0 \
        else time.monotonic
    rng = np.random.default_rng(args.seed)
    if args.span > 0:
        from repro_torch.fleet.scenarios import SCENARIOS, request_arrivals
        mod = {"uniform": SCENARIOS["steady"],
               "diurnal": SCENARIOS["diurnal"],
               "bursty": SCENARIOS["bursty"]}[args.arrival].arrival
        arrivals = request_arrivals(args.requests, args.span,
                                    seed=args.seed, arrival=mod)
    else:
        arrivals = [0.0] * args.requests
    # Arrivals are offsets from the start of the serve timeline; anchor
    # them to the clock actually driving the server so t_submit shares a
    # time base with the emitted intervals (wall clock reads machine
    # uptime, not zero).
    t_base = clock()
    prompts = [rng.integers(0, cfg.vocab_size,
                            args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]

    if args.engine == "continuous":
        reqs = [ServeRequest(rid=i, prompt_len=args.prompt_len,
                             max_new=args.max_new,
                             t_submit=t_base + arrivals[i], prompt=p)
                for i, p in enumerate(prompts)]
        out = run_continuous_server(
            cfg, reqs, args.batch, args.prompt_len + args.max_new,
            slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot, clock=clock,
            executor_kind=args.executor, device=device)
    else:
        reqs = [Request(i, p, args.max_new, t_submit=t_base + arrivals[i])
                for i, p in enumerate(prompts)]
        server, out = run_static_server(cfg, reqs, args.batch, args.max_new,
                                        args.prompt_len, clock=clock,
                                        device=device)
        out["static_decode"] = {"batches": server.batches,
                                "decode_steps": server.decode_steps,
                                **server.decode_graph_stats()}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

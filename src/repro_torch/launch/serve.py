"""Serving launcher of the port: the continuous-batching engine over the
batched paged-decode executor or the per-slot executor, with MPG + SLO
accounting.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 16 --batch 8 --prompt-len 200 --max-new 64

runs on the GPU; add ``--device cpu`` (and ``--smoke`` for the reduced
config) to run on the host.  The flags are the reference's
(``repro.launch.serve``) that apply to this path; ``--engine static``
and ``--span/--arrival`` come with later slices.  Prints the engine's
ServeReport as JSON, with the executor's prefill and decode-call counts.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.ledger import GoodputLedger
from repro_torch.device import resolve_device
from repro_torch.serve import ContinuousServeEngine, ServeRequest, ServeSLO


class TickClock:
    """Deterministic stand-in for ``time.monotonic``: each call advances a
    fixed virtual dt (the reference's ``TickClock``)."""

    def __init__(self, dt: float = 1.0, t0: float = 0.0):
        self.dt = dt
        self.t = t0

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


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
                                     device=device)
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
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
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
    # arrivals are offsets from the start of the serve timeline, anchored
    # to the clock driving the server (all at t=0 until --span lands)
    t_base = clock()
    reqs = [ServeRequest(rid=i, prompt_len=args.prompt_len,
                         max_new=args.max_new, t_submit=t_base,
                         prompt=rng.integers(0, cfg.vocab_size,
                                             args.prompt_len).astype(np.int32))
            for i in range(args.requests)]
    out = run_continuous_server(
        cfg, reqs, args.batch, args.prompt_len + args.max_new,
        slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot, clock=clock,
        executor_kind=args.executor, device=device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

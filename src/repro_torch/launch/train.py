"""Training launcher of the port (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 20 --batch 8 --seq 2048

runs the MPG-instrumented orchestrator (checkpoint/restart, async
checkpoints, step-preparation cache) on the GPU, each step one replay of
the captured train step with the flash-attention kernels (and, for a
MoE, the grouped-matmul kernels; for the hybrid recurrentgemma-2b, the
RG-LRU scan and its reverse; for rwkv6-3b, the WKV and its reverse)
forward and backward, each chosen by ``impl="auto"``; add ``--device
cpu`` (and ``--smoke`` for the reduced config) to run on the host with
the plain versions.  The flags and the printed JSON keys are the
reference's, plus ``--device``.  Trains the dense, MoE, hybrid and ssm
families.  The enc-dec and vlm families train through
``launch.strategy.TrainStep`` (their loss is ported), but not here: the
orchestrator's pipeline yields tokens only, as the reference's does, and
the step refuses a batch without their ``frames`` / ``patches``
(``ValueError``) rather than fill them with zeros.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.goodput import compute_goodput, rg_breakdown
from repro_torch.device import resolve_device
from repro_torch.runtime.orchestrator import Orchestrator, RunConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--async-checkpoint", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--preempt-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    run = RunConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                    checkpoint_every=args.checkpoint_every,
                    async_checkpoint=args.async_checkpoint,
                    ckpt_dir=args.ckpt_dir, preempt_at_step=args.preempt_at,
                    job_id=f"train-{args.arch}", device=str(device))
    orc = Orchestrator(cfg, run)
    out = orc.run()

    total = sum(i.chip_time for i in orc.intervals)
    rep = compute_goodput(orc.intervals, total)
    report = {
        "arch": args.arch,
        "steps": [out["start_step"], out["end_step"]],
        "final_loss": out["losses"][-1] if out["losses"] else None,
        "runtime_goodput": round(rep.rg, 4),
        "rg_breakdown": {k: round(v, 4)
                         for k, v in rg_breakdown(orc.intervals).items()},
        "ckpt": out["ckpt_metrics"],
        "compile_s": round(out["compile_s"], 2),
        "ckpt_dir": orc.ckpt_dir,
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()

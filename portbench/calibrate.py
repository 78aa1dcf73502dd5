"""The readings that each limit of ``correct`` is set from, for one cell,
in one process: the program's numbers over many seeds (the lower
reading), and on a few of them the control's, the reference computed in
fp8, and the planted faults' (the upper readings).  One JSON line each.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --control 1,2 --seconds 40

Serving: each seed's weights are drawn into the one executor's tree in
place and a window of ``--seconds`` runs at the cell's own load; the
reference then reads the window's finished requests as a run does.  The
planted fault is one served token altered where it was produced.
Training: each seed starts the one captured step over from its own
weights; once every seed has run, the step is freed and the reference
follows each; the planted fault is half of each batch left out, in the
reference put in the program's place (a state left unchanged reads 1 by
the measure and needs no run).
"""
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402


def ints(s: str):
    return [int(x) for x in s.split(",") if x]


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def train(cfg, dm, mix, ref, seeds, control):
    from portbench import check, weights
    from portbench.cell import _free
    from portbench.train import TrainBench

    import torch

    tb = TrainBench(cfg, dm, mix, seeds[0], "cuda")
    progs = {}
    for i, seed in enumerate(seeds):
        if i:
            tb.reseed(seed)
        progs[seed] = ((tb.losses, tb.first_grad, tb.change),
                       list(tb.checked))
    tb.free()
    del tb
    _free("cuda")
    opt = mix["optimizer"]
    for seed in seeds:
        prog, batches = progs[seed]
        initial = weights.make(dm, seed, torch.float32, "cuda")
        t = time.perf_counter()
        base = check.reference_steps(initial, batches, dm, ref, opt)
        emit(seed=seed, who="program", reference_s=time.perf_counter() - t,
             losses=prog[0], ref_losses=base[0],
             **check.train_readings(prog, base))
        if seed in control:
            ctrl = check.reference_steps(initial, batches, dm, ref, opt,
                                         quant=True)
            emit(seed=seed, who="control_fp8",
                 **check.train_readings(ctrl, base))
            half = check.reference_steps(initial, batches, dm, ref, opt,
                                         rows=mix["batch"] // 2)
            emit(seed=seed, who="fault_half_batch",
                 **check.train_readings(half, base))
        del initial
        _free("cuda")


def serve(cfg, dm, mix, ref, seeds, control, seconds):
    import copy

    from portbench import check, traffic, weights
    from portbench.cell import warm_requests
    from portbench.program import DTYPES
    from portbench.serve import ServeBench, finished

    tree = weights.make(dm, seeds[0], DTYPES[mix["param_dtype"]], "cuda")
    sb = ServeBench(cfg, mix, tree, "cuda")
    sb.warm(warm_requests(mix, dm))
    tokens = mix["check"]["served_tokens"]
    for seed in seeds:
        weights.fill_(tree, dm, seed)
        win = sb.run(traffic.serve_requests(mix, seed, seconds, dm.vocab),
                     seconds)
        done = finished(win)
        t = time.perf_counter()
        r, n = check.serve_readings(done, tree, dm, ref, seed, tokens)
        emit(seed=seed, who="program", finished=len(done), checked_tokens=n,
             longest=max((len(x.prompt) + len(x.out_tokens) for x in done),
                         default=0),
             reference_s=time.perf_counter() - t, **r)
        if seed in control:
            r, _ = check.serve_readings(done, tree, dm, ref, seed, tokens,
                                        control=True)
            emit(seed=seed, who="control_fp8", **r)
            sample = traffic.check_sample(done, seed, tokens)
            bad = copy.copy(sample[0])
            k = len(bad.out_tokens) // 2
            bad.out_tokens = list(bad.out_tokens)
            bad.out_tokens[k] = (bad.out_tokens[k] + 1) % dm.vocab
            r, _ = check.serve_readings([bad], tree, dm, ref, seed, tokens)
            emit(seed=seed, who="fault_token_altered", **r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, required=True)
    ap.add_argument("--control", type=ints, default=[])
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args(argv)

    from portbench import cell, spec
    from portbench.dims import dims
    from portbench.program import model_config, use_src

    use_src()
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    conf, mix = spec.config(bench, w["config"]), spec.traffic(w["traffic"])
    ref = spec.reference(conf)
    ref.exact_fp32()
    dm = dims(conf)
    cfg = model_config(conf["name"], dm, mix)
    cell.build_kernels("cuda")
    if mix["kind"] == "train":
        train(cfg, dm, mix, ref, args.seeds, set(args.control))
    else:
        serve(cfg, dm, mix, ref, args.seeds, set(args.control), args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())

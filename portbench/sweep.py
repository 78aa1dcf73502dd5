"""The knee sweep of a serving cell: its mix at several fixed rates, one
window each, on one executor built once.  Prints one JSON line a rate.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 1.5,2,2.5

A rate is sustained while the backlog does not grow: the requests due
in the window's last third wait for admission about as long as those of
its first third, and none is left unadmitted at the close but the last
arrivals.  A cell's rate is then set, by hand, to about four fifths of
the highest rate sustained, and written into its mix's file.
"""
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402


def summary(win, rate: float) -> dict:
    from portbench.serve import (first_token_waits, percentile, token_gaps,
                                 tokens_done)

    W = win.seconds
    due = [r for r in win.requests if r.t_submit < W]

    def wait(r):
        return (min(r.t_admit, W) if r.token_times else W) - r.t_submit

    thirds = [[wait(r) for r in due if k * W / 3 <= r.t_submit < (k + 1) * W / 3]
              for k in range(3)]
    ttft = first_token_waits(win)
    gaps = token_gaps(win)
    dec = [op for op in win.ops if op.kind == "decode" and op.t1 <= W]
    return {"rate_per_s": rate, "due": len(due),
            "unadmitted_at_close": sum(1 for r in due if not r.token_times),
            "queue_wait_s_by_third": [sum(t) / len(t) if t else None
                                      for t in thirds],
            "ttft_p50_ms": 1e3 * percentile(ttft, 50),
            "ttft_p90_ms": 1e3 * percentile(ttft, 90),
            "itl_p50_ms": 1e3 * percentile(gaps, 50) if gaps else None,
            "itl_p99_ms": 1e3 * percentile(gaps, 99) if gaps else None,
            "serve_tokens_per_s": tokens_done(win) / W,
            "decode_step_ms": (1e3 * sum(o.t1 - o.t0 for o in dec) / len(dec)
                               if dec else None),
            "prefills": win.prefills, "captures": win.captures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import cell, spec, traffic, weights
    from portbench.dims import dims
    from portbench.program import DTYPES, model_config, use_src
    from portbench.serve import ServeBench

    use_src()
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    conf, mix = spec.config(bench, w["config"]), spec.traffic(w["traffic"])
    dm = dims(conf)
    cell.build_kernels("cuda")
    t = time.perf_counter()
    tree = weights.make(dm, args.seed, DTYPES[mix["param_dtype"]], "cuda")
    sb = ServeBench(model_config(conf["name"], dm, mix), mix, tree, "cuda")
    sb.warm(cell.warm_requests(mix, dm))
    print(json.dumps({"setup_s": time.perf_counter() - t,
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        reqs = traffic.serve_requests(mix, args.seed + i, args.seconds,
                                      dm.vocab, rate=rate)
        print(json.dumps(summary(sb.run(reqs, args.seconds), rate)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

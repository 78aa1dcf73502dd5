"""Run one cell of ``BENCHMARK.json`` once on the card and print its line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads the cell's configuration and traffic mix, makes the weights
and inputs from ``--seed`` on the card, builds and warms the program
(set-up, ``setup_s``), measures for ``--seconds`` on the wall clock,
checks what the timed path produced against the plain reference, and
prints one JSON object as the last line of standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics (from a
``torch.profiler`` sub-window) with ``--trace 1``.  The numbers compared
are also the last lines of standard error, each beside its limit.

It exits non-zero and prints no result where no card (or too few) is
present, where the program cannot be imported, or where JAX or the JAX
package was loaded into the process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this script's folder, whose module
# names (``trace``) would shadow the standard library's
sys.path[0] = str(Path(__file__).resolve().parents[1])

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is JAX,
    jaxlib, flax or the JAX package; ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import spec
    from portbench.cell import run_cell

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not (spec.ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    kind = "per_layer" if args.trace else "end_to_end"
    readers = {m["name"]: spec.metric_module(m["name"]).read
               for m in spec.metrics_of(bench, cell["name"], kind)}
    units = spec.units(spec.metrics_of(bench, cell["name"], kind))
    out = run_cell(spec.config(bench, cell["config"]),
                   spec.traffic(cell["traffic"]), spec.limits(cell["name"]),
                   args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START, readers)
    out["metrics"] = {k: {"value": v, "unit": units[k]}
                      for k, v in out["metrics"].items()}
    checked = out.pop("checked")
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": cell["chips"], **out["device"],
                     "power_limit_w": power_limit_w()}
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}, which nothing of a run "
              f"may load", file=sys.stderr)
        return 3
    out["checked"] = checked
    for name, c in checked.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

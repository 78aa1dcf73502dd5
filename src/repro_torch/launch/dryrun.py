"""Dry run of one (architecture x input-shape) cell on one device (the
port's counterpart of ``repro.launch.dryrun``'s per-cell record).

For each cell: the step's arguments as ``meta`` tensors (shapes and
dtypes; nothing is allocated on any device, and no card is needed or
used, as the reference's runs on placeholder devices) and its counted
cost (``repro_torch.core.costref``).  The record keeps the reference's
keys, for one device: ``mesh`` "1", ``chips`` 1, no collectives.

  * ``memory.argument_bytes`` is exact: the bytes of the meta trees the
    step takes (train: ``abstract_train_state`` — master params and
    AdamW's fp32 m and v — and the batch; prefill: the params and the
    batch; decode: the params, the token and the decode cache).
    ``output_bytes`` is what the step gives back at the cell's shape
    (train: the new state, its few fp32 metrics left out; prefill and
    decode: the logits and the decode cache).
  * ``temp_bytes`` and ``generated_code_bytes`` are None: PyTorch has no
    compiler memory analysis.  ``chip_smoke.py``'s measured peaks stand
    in for the cells it runs on the card.
  * ``cost`` is the cost reference's extrapolated flops and bytes (the
    eager step's ops unfused, each kernel at its byte model);
    ``lower_s`` the seconds the meta trees took, ``compile_s`` the
    count's (as it ran, also when read back from the cost reference's
    cache).

The mesh, the sharded lowering and the collective statistics of the
reference's 256 / 512-chip records come with the distribution slice.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.costref import cost_reference
from repro_torch.core.hardware import H100_SXM
from repro_torch.models import model
from repro_torch.models.config import SHAPES, SHAPES_BY_NAME, shape_applicable

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
               / "dryrun_torch")


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (dicts, tuples)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _arguments(cfg, shape):
    """(arguments, outputs) of the cell's step as meta trees."""
    from repro_torch.launch.strategy import abstract_train_state

    specs = model.input_specs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        state = abstract_train_state(cfg)
        return (state, specs), state
    logits = torch.empty((b, cfg.vocab_size), dtype=torch.float32,
                         device="meta")
    params = model.abstract_params(cfg)
    if shape.kind == "prefill":
        # the prefill's cache: prompt + 64 slots (the enc-dec ring too)
        slots = s if cfg.family == "encdec" else s + 64
        cache = model.init_cache(cfg, b, slots, device="meta")
        return (params, specs), (logits, cache)
    return (params, specs), (logits, specs["cache"])


def run_cell(arch: str, shape_name: str, save: bool = True,
             cfg_override=None, variant: str = "baseline") -> dict:
    cfg = cfg_override or get_config(arch)
    if variant != "baseline":
        from repro_torch.launch.variants import apply_variant

        cfg = apply_variant(cfg, variant)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    t0 = time.time()
    args, outs = _arguments(cfg, shape)
    arg_bytes, out_bytes = tree_bytes(args), tree_bytes(outs)
    lower_s = time.time() - t0
    cost = cost_reference(cfg, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "variant": variant,
        "mesh": "1",
        "chips": 1,
        "lower_s": round(lower_s, 2),
        "compile_s": round(cost["count_s"], 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "generated_code_bytes": None,
            "peak_bytes": arg_bytes,
            "hbm_per_chip": H100_SXM.hbm_bytes,
        },
        "cost": {
            "flops_once": cost["flops"],
            "bytes_once": cost["bytes"],
        },
        "collectives": {
            "bytes_by_kind": {},
            "count_by_kind": {},
            "total_bytes": 0,
        },
        "while_trips": [],
        "top_collectives": [],
    }
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        suffix = "" if variant == "baseline" else f"__{variant}"
        name = f"{arch}__{shape_name}__{rec['mesh']}{suffix}.json"
        (RESULTS_DIR / name).write_text(json.dumps(rec, indent=1))
    return rec


def fits(rec) -> bool:
    m = rec.get("memory", {})
    peak = (m.get("argument_bytes") or 0) + (m.get("temp_bytes") or 0)
    return peak <= H100_SXM.hbm_bytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default when neither "
                         "--arch nor --shape is given)")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch:24s} {shape:12s} 1     "
            try:
                rec = run_cell(arch, shape, variant=args.variant)
            except Exception as e:  # noqa: BLE001 — report, keep sweeping
                n_fail += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}")
                traceback.print_exc(limit=3)
                continue
            if "skipped" in rec:
                n_skip += 1
                print(f"SKIP {tag}: {rec['skipped']}")
                continue
            n_ok += 1
            m = rec["memory"]
            print(f"OK   {tag}: count={rec['compile_s']:7.1f}s "
                  f"args/chip={m['argument_bytes'] / 2**30:8.2f}GiB "
                  f"flops={rec['cost']['flops_once']:.4g} "
                  f"bytes={rec['cost']['bytes_once']:.4g} "
                  f"{'FITS' if fits(rec) else 'OVER-HBM'}")
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

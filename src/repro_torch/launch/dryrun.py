"""Dry run of one (architecture x input-shape x mesh) cell (the port's
``repro.launch.dryrun``): the record of its step, with the reference's
keys, from ``meta`` tensors only (nothing is allocated on any device,
and no card is needed or used, as the reference's runs on placeholder
devices).

**On a mesh** (``multi_pod`` False: the reference's 16 x 16, "16x16",
256 chips; True: 2 x 16 x 16, "2x16x16", 512 chips; or a ``mesh_shape``
such as (2, 2)), :func:`run_cell` starts a fake process group of the
mesh's size (``repro_torch.launch.mesh.fake_distributed``), this
process its rank 0, builds the mesh over it (device type "cuda" unless
the caller asks for "cpu": the collectives a card would issue; on a
"cpu" mesh DTensor replaces an all-to-all by all-gathers, as on gloo),
lowers the cell (``repro_torch.launch.strategy.lower_cell``: the step
each sharded step runs, its arguments meta DTensors holding rank 0's
blocks), runs the step once under its ``ParallelCtx`` and four
counters, and destroys the group.  Every figure is per rank, rank 0's
(the larger block where a dim does not divide, as XLA pads):

  * ``memory.argument_bytes``: the local bytes of the step's arguments;
    ``output_bytes``: of what it returns (train: the new state, its
    metrics left out; prefill: the whole logits and the placed cache;
    decode: the whole logits and the cache, which the step updates in
    place as the reference's is donated).
  * ``temp_bytes``: the most bytes alive at once during the step above
    the arguments (:class:`PeakMemory`: every storage a local op makes,
    from its creation until it is freed).  It counts the eager step's
    plain path unfused, every intermediate its own tensor (the plain
    attention's scores among them): not XLA's fused temp.
    ``peak_bytes`` = argument + temp, against ``hbm_per_chip`` =
    ``H100_SXM.hbm_bytes``.
  * ``generated_code_bytes``: None; the eager step generates no code.
  * ``cost.flops_once``: the flops of the local ops
    (``costref.LocalFlops``, FlopCounterMode's formulas), per device as
    the reference's partitioned ``cost_analysis`` gives them;
    ``bytes_once``: the cost reference's byte rule over the local ops
    (``costref.ByteCounter``: each op unfused, each kernel's plain
    version at its kernel's byte model).
  * ``collectives``: ``CollectiveCounter``'s count and bytes by kind;
    ``top_collectives``: its ``top_grouped(8)``, in the reference's
    keys (``trips`` the times the step issued one, ``op_name`` its
    ``region``).  The reference counts each HLO op once and multiplies
    only its bytes by its loop's trips, and its partitioner picks its
    own collectives: the two sides' tables are not comparable op for
    op.
  * ``while_trips``: [] (the port's layer stacks are Python loops).
  * ``lower_s``: the seconds the meta trees took; ``compile_s``: the
    counted run's.

A fake group runs no collective: nothing here times one, and nothing
about overlap or bandwidth is measured.  ``run_cell`` raises
(``RuntimeError``) in a process where a process group already runs.

**On one device** (``multi_pod`` None and no ``mesh_shape``; the CLI's
``--one-device``): ``mesh`` "1", ``chips`` 1, no collectives:

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

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --one-device
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.collectives import CollectiveCounter
from repro_torch.core.costref import (ByteCounter, LocalFlops, cost_reference,
                                      in_sharding_propagation, kernel_bytes)
from repro_torch.core.hardware import H100_SXM
from repro_torch.models import model
from repro_torch.models.config import (SHAPES, SHAPES_BY_NAME, ShapeConfig,
                                       shape_applicable)

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
               / "dryrun_torch")


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (dicts, tuples); of a
    DTensor, this rank's block."""
    def nbytes(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.numel() * t.element_size()

    return sum(nbytes(t) for t in tree_leaves(tree))


class PeakMemory(TorchDispatchMode):
    """Bytes of the storages alive while a step runs under it: the
    arguments' (``tree``) from the start, and every storage an op makes
    (a DTensor op's: the local ops this rank runs for it) from its
    creation until it is freed (a weak reference's callback).
    ``peak`` is the most at once; ``current`` what is alive now."""

    def __init__(self, tree):
        super().__init__()
        self._live = {}
        self.current = self.peak = 0
        for t in tree_leaves(tree):
            self._add(t.to_local() if isinstance(t, DTensor) else t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self._live.pop(key, None)
            self.current -= n

        self._live[key] = weakref.ref(st, freed)
        self.current += n
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not in_sharding_propagation():
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self._add(t)
        return out


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


def run_cell(arch: str, shape_name, multi_pod=None, save: bool = True,
             rules=None, cfg_override=None, variant: str = "baseline", *,
             mesh_shape=None, mesh_device: str = "cuda") -> dict:
    """The record of one cell (the module note): ``shape_name`` a
    ``SHAPES`` name or a ``ShapeConfig``; on the production mesh for
    ``multi_pod`` False / True, on a ("data", "model") or ("pod",
    "data", "model") mesh of ``mesh_shape`` where given (its device type
    ``mesh_device``), else on one device.  A cell the reference skips
    gives {"arch", "shape", "skipped"}.  Saved under ``RESULTS_DIR``
    with ``save``."""
    cfg = cfg_override or get_config(arch)
    if variant != "baseline":
        from repro_torch.launch.variants import apply_variant

        cfg = apply_variant(cfg, variant)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES_BY_NAME[shape_name])
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "skipped": why}

    if multi_pod is None and mesh_shape is None:
        rec = _one_device(cfg, shape)
    else:
        rec = _on_mesh(cfg, shape, multi_pod, mesh_shape, mesh_device, rules)
    rec = {"arch": arch, "shape": shape.name, "variant": variant, **rec}
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        suffix = "" if variant == "baseline" else f"__{variant}"
        name = f"{arch}__{shape.name}__{rec['mesh']}{suffix}.json"
        (RESULTS_DIR / name).write_text(json.dumps(rec, indent=1))
    return rec


def _one_device(cfg, shape) -> dict:
    t0 = time.time()
    args, outs = _arguments(cfg, shape)
    arg_bytes, out_bytes = tree_bytes(args), tree_bytes(outs)
    lower_s = time.time() - t0
    cost = cost_reference(cfg, shape)
    return {
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


def _on_mesh(cfg, shape, multi_pod, mesh_shape, mesh_device, rules) -> dict:
    from repro_torch.launch.mesh import (fake_distributed, make_dev_mesh,
                                         make_production_mesh)
    from repro_torch.launch.strategy import lower_cell
    from repro_torch.parallel.ctx import parallel_ctx

    size = ((2, 16, 16) if multi_pod else (16, 16)) if mesh_shape is None \
        else tuple(mesh_shape)
    with fake_distributed(math.prod(size)):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device=mesh_device)
        else:
            pod = size[0] if len(size) == 3 else 0
            mesh = make_dev_mesh(*size[-2:], pod=pod, device=mesh_device)
        t0 = time.perf_counter()
        step, args, ctx = lower_cell(cfg, shape, mesh, rules)
        lower_s = time.perf_counter() - t0
        coll, flops, nbytes = CollectiveCounter(), LocalFlops(), ByteCounter()
        mem = PeakMemory(args)
        t0 = time.perf_counter()
        with (torch.set_grad_enabled(shape.kind == "train"),
              parallel_ctx(ctx), coll, flops, nbytes, kernel_bytes(nbytes),
              mem):
            out = step(*args)
        compile_s = time.perf_counter() - t0
        if shape.kind == "train":
            out = out[0]            # the new state; the metrics left out
        elif shape.kind == "decode":
            out = (out, args[2])    # the logits, and the cache in place
        arg_bytes = tree_bytes(args)
        stats = coll.stats()
        return {
            "mesh": "x".join(map(str, size)),
            "chips": mesh.size(),
            "lower_s": round(lower_s, 2),
            "compile_s": round(compile_s, 2),
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": tree_bytes(out),
                "temp_bytes": mem.peak - arg_bytes,
                "generated_code_bytes": None,
                "peak_bytes": mem.peak,
                "hbm_per_chip": H100_SXM.hbm_bytes,
            },
            "cost": {
                "flops_once": flops.flops,
                "bytes_once": nbytes.bytes,
            },
            "collectives": {
                "bytes_by_kind": stats.bytes_by_kind,
                "count_by_kind": stats.count_by_kind,
                "total_bytes": stats.total_bytes,
            },
            "while_trips": [],
            "top_collectives": coll.top_grouped(8),
        }


def fits(rec) -> bool:
    m = rec.get("memory", {})
    peak = (m.get("argument_bytes") or 0) + (m.get("temp_bytes") or 0)
    return peak <= H100_SXM.hbm_bytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 mesh only")
    ap.add_argument("--single-pod-only", action="store_true",
                    help="the 16 x 16 mesh only")
    ap.add_argument("--one-device", action="store_true",
                    help="the one-device record only, no mesh")
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default when neither "
                         "--arch nor --shape is given)")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    meshes = [False, True]          # the reference's sweep: both meshes
    if args.multi_pod:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]
    if args.one_device:
        meshes = [None]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh = {None: "1", False: "16x16", True: "2x16x16"}[mp]
                tag = f"{arch:24s} {shape:12s} {mesh:7s}"
                try:
                    rec = run_cell(arch, shape, mp, variant=args.variant)
                except Exception as e:  # noqa: BLE001 — report, keep going
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
                c = rec["collectives"]
                print(f"OK   {tag}: count={rec['compile_s']:7.1f}s "
                      f"args/chip={m['argument_bytes'] / 2**30:8.2f}GiB "
                      f"peak/chip={m['peak_bytes'] / 2**30:8.2f}GiB "
                      f"coll={c['total_bytes'] / 2**30:8.2f}GiB "
                      f"({sum(c['count_by_kind'].values())} ops) "
                      f"flops={rec['cost']['flops_once']:.4g} "
                      f"bytes={rec['cost']['bytes_once']:.4g} "
                      f"{'FITS' if fits(rec) else 'OVER-HBM'}")
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

"""The dry run's mesh records (``repro_torch.launch.dryrun.run_cell`` on
a mesh over a fake process group) against the reference's
``lower_cell(...).compile()`` on SMOKE configs, both sides in a
subprocess, run side by side: the reference's with 8 host devices on
``AxisType.Auto`` meshes (``tests/_torch_mesh.auto_mesh``), the port's
as rank 0 of a fake group of the mesh's size.

* (a) per-rank ``argument_bytes`` equal the reference's
  ``memory_analysis().argument_size_in_bytes`` exactly: train for all six
  families, prefill and decode for the dense and the MoE family, on 2 x
  2, and one 2 x 2 x 2 cell; ``output_bytes`` differ from the
  reference's by exactly what :func:`_output_gap` names;
* (b) ``top_collectives`` has the reference's keys, each entry
  ``trips`` x ``bytes_once`` = ``bytes_total``, and the grouped entries
  of a whole step sum to its ``total_bytes``;
* (c) at 1 x 1 neither side issues a collective and the per-rank flops
  equal the one-device record's; at 2 x 2 the world's flops are at
  least the one-device flops;
* (d) the peak tracker gives the same peak over meta tensors as over
  real CPU tensors in the same cell;
* (e) every failure of (a) prints the per-kind collective table of both
  sides (``PERF.md`` §6 keeps it): XLA's partitioner picks its own
  collectives, so the two tables are reported, not compared;
* (f) the mesh's device type changes what DTensor issues: a "cpu" mesh
  gathers where a "cuda" mesh runs an all-to-all (a re-split, and
  smollm's decode step); both are pinned;
* ``run_cell`` refuses a process that already runs a process group.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from tests._torch_mesh import finish, save, start_subprocess  # noqa: E402

TRAIN = ("smoke_train", "train", 64, 4)
PREFILL = ("smoke_prefill", "prefill", 64, 4)
DECODE = ("smoke_decode", "decode", 128, 4)
FAMILIES = ("smollm-135m", "deepseek-moe-16b", "recurrentgemma-2b",
            "rwkv6-3b", "whisper-medium", "llava-next-mistral-7b")
# name: (arch, shape, mesh shape)
CELLS = {
    **{f"{a}/train": (a, TRAIN, (2, 2)) for a in FAMILIES},
    **{f"{a}/{s[1]}": (a, s, (2, 2))
       for a in ("smollm-135m", "deepseek-moe-16b") for s in (PREFILL,
                                                              DECODE)},
    "smollm-135m/train/2x2x2": ("smollm-135m", TRAIN, (2, 2, 2)),
    "smollm-135m/train/1x1": ("smollm-135m", TRAIN, (1, 1)),
}
MESH_NAMES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# (f): a (4, 8) fp32 tensor split on dim 0 over the 2 model ranks,
# re-split on dim 1; smollm's decode step on 2 x 2, count and bytes
REDISTRIBUTE = {"cuda": [("all-to-all", 64)], "cpu": [("all-gather", 64)]}
DECODE_COLLECTIVES = {
    "cuda": ({"all-gather": 44, "reduce-scatter": 16, "all-to-all": 11,
              "all-reduce": 13},
             {"all-gather": 30464, "reduce-scatter": 8960,
              "all-to-all": 4224, "all-reduce": 1328}),
    "cpu": ({"all-gather": 55, "reduce-scatter": 16, "all-reduce": 13},
            {"all-gather": 34688, "reduce-scatter": 8960,
             "all-reduce": 1328}),
}


def _shape(s):
    from repro_torch.models.config import ShapeConfig

    return ShapeConfig(*s)


def reference(out):
    from repro.configs import get_smoke
    from repro.core import hlo_analysis
    from repro.launch.strategy import lower_cell
    from repro.models.config import ShapeConfig
    from tests._torch_mesh import auto_mesh

    res = {}
    for name, (arch, shape, mesh_shape) in CELLS.items():
        mesh = auto_mesh(mesh_shape, MESH_NAMES[len(mesh_shape)])
        compiled = lower_cell(get_smoke(arch), ShapeConfig(*shape),
                              mesh).compile()
        mem = compiled.memory_analysis()
        stats = hlo_analysis.collective_stats(compiled.as_text())
        res[name] = {"argument_bytes": mem.argument_size_in_bytes,
                     "output_bytes": mem.output_size_in_bytes,
                     "temp_bytes": mem.temp_size_in_bytes,
                     "count_by_kind": stats.count_by_kind,
                     "bytes_by_kind": stats.bytes_by_kind}
    save(res, out)


def port(out):
    """Every cell's record, the one-device records for (c), a whole
    step's grouped collectives for (b), the peaks of (d) and the counts
    of (f)."""
    import pathlib

    from repro_torch.configs import get_smoke
    from repro_torch.core import costref
    from repro_torch.core.collectives import CollectiveCounter
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_distributed, make_dev_mesh
    from repro_torch.launch.strategy import lower_cell
    from repro_torch.parallel.ctx import parallel_ctx

    costref.CACHE_DIR = pathlib.Path(out).parent / "costref"
    res = {"cells": {}, "one_device": {}}
    for name, (arch, shape, mesh_shape) in CELLS.items():
        res["cells"][name] = dryrun.run_cell(
            arch, _shape(shape), save=False, cfg_override=get_smoke(arch),
            mesh_shape=mesh_shape)
    for arch in ("smollm-135m", "deepseek-moe-16b"):
        res["one_device"][arch] = dryrun.run_cell(
            arch, _shape(TRAIN), save=False, cfg_override=get_smoke(arch))

    cfg = get_smoke("smollm-135m")
    with fake_distributed(4):
        mesh = make_dev_mesh(2, 2)
        step, args, ctx = lower_cell(cfg, _shape(TRAIN), mesh)
        counter = CollectiveCounter()
        with parallel_ctx(ctx), counter:
            step(*args)
        res["grouped"] = counter.top_grouped(None)
        res["grouped_total"] = counter.stats().total_bytes
        # (d): the same cell's peak over meta and over CPU zeros
        for device in ("meta", "cpu"):
            mesh = make_dev_mesh(2, 2, device="cpu")
            step, args, ctx = lower_cell(cfg, _shape(TRAIN), mesh,
                                         device=device)
            mem = dryrun.PeakMemory(args)
            with parallel_ctx(ctx), mem:
                step(*args)
            res["peak", device] = mem.peak
        # (f): one Shard -> Shard re-split on either mesh type
        from torch.distributed.tensor import Replicate, Shard

        from repro_torch.launch.strategy import local_block

        for dev_type in ("cuda", "cpu"):
            mesh = make_dev_mesh(2, 2, device=dev_type)
            x = local_block(torch.empty(4, 8, device="meta"),
                            (Replicate(), Shard(0)), mesh)
            counter = CollectiveCounter()
            with counter:
                x.redistribute(mesh, (Replicate(), Shard(1)))
            res["redistribute", dev_type] = [
                (r["kind"], r["bytes"]) for r in counter.records]
    rec = dryrun.run_cell("smollm-135m", _shape(DECODE), save=False,
                          cfg_override=cfg, mesh_shape=(2, 2),
                          mesh_device="cpu")
    res["decode", "cpu"] = rec["collectives"]
    save(res, out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_mesh")
    ref = start_subprocess("test_torch_dryrun_mesh", "reference",
                           tmp / "ref.pkl", devices=8)
    ours = start_subprocess("test_torch_dryrun_mesh", "port",
                            tmp / "port.pkl")
    return finish(ref, tmp / "ref.pkl"), finish(ours, tmp / "port.pkl")


def _table(ref, rec) -> str:
    """The per-kind collective table of both sides, count / bytes."""
    c = rec["collectives"]
    kinds = sorted(set(ref["count_by_kind"]) | set(c["count_by_kind"]))
    rows = [f"{'kind':20s} {'reference':>22s} {'port':>22s}"]
    for k in kinds:
        rows.append(f"{k:20s} "
                    f"{ref['count_by_kind'].get(k, 0):6d} / "
                    f"{ref['bytes_by_kind'].get(k, 0):13,.0f} "
                    f"{c['count_by_kind'].get(k, 0):6d} / "
                    f"{c['bytes_by_kind'].get(k, 0):13,.0f}")
    return "\n".join(rows)


@pytest.mark.parametrize("cell", list(CELLS))
def test_argument_bytes_equal_reference(results, cell):
    ref, ours = results
    r, rec = ref[cell], ours["cells"][cell]
    m = rec["memory"]
    assert m["argument_bytes"] == r["argument_bytes"], _table(r, rec)
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["temp_bytes"] > 0
    assert rec["mesh"] == "x".join(map(str, CELLS[cell][2]))


def _output_gap(cell) -> int:
    """The reference's output bytes less the port's, per rank:

    * XLA's output is a tuple, and its size counts the tuple's index
      table, 8 bytes a leaf;
    * train: the reference also returns its fp32 scalar metrics (loss,
      xent, grad_norm, lr, and aux but for the enc-dec family), which
      the record leaves out (as the one-device record does);
    * prefill and decode: the port gives every rank the whole (b, V)
      fp32 logits, as its sharded steps keep them, where XLA leaves them
      split over data and model (a quarter on 2 x 2);
    * prefill: XLA keeps the new cache's ``pos`` whole, the port splits
      it on the batch over data (``cache_placements``, the decode
      step's input layout)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.strategy import abstract_train_state
    from repro_torch.models import model
    from repro_torch.tree import flatten

    arch, (_, kind, seq, b), _ = CELLS[cell]
    cfg = get_smoke(arch)
    if kind == "train":
        metrics = 4 if cfg.family == "encdec" else 5
        leaves = len(flatten(abstract_train_state(cfg))[0]) + metrics
        return 8 * leaves + 4 * metrics
    cache_len = seq + 64 if kind == "prefill" else seq
    leaves = 1 + len(flatten(model.init_cache(cfg, b, cache_len,
                                              device="meta"))[0])
    logits = b * cfg.vocab_size * 4
    gap = 8 * leaves - (logits - logits // 4)
    return gap + (b // 2) * 4 if kind == "prefill" else gap


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if CELLS[c][2] == (2, 2)])
def test_output_bytes_differ_by_the_named_gap(results, cell):
    ref, ours = results
    got = ours["cells"][cell]["memory"]["output_bytes"]
    assert ref[cell]["output_bytes"] - got == _output_gap(cell)


@pytest.mark.parametrize("cell", list(CELLS))
def test_top_collectives_have_reference_keys(results, cell):
    _, ours = results
    rec = ours["cells"][cell]
    tops = rec["top_collectives"]
    assert len(tops) <= 8
    for t in tops:
        assert set(t) == {"kind", "bytes_once", "trips", "bytes_total",
                          "op_name"}
        assert t["trips"] * t["bytes_once"] == t["bytes_total"]
    assert [t["bytes_total"] for t in tops] == sorted(
        (t["bytes_total"] for t in tops), reverse=True)
    assert sum(t["bytes_total"] for t in tops) <= \
        rec["collectives"]["total_bytes"]


def test_grouped_collectives_sum_to_the_total(results):
    _, ours = results
    grouped = ours["grouped"]
    assert all(g["trips"] * g["bytes_once"] == g["bytes_total"]
               for g in grouped)
    assert sum(g["bytes_total"] for g in grouped) == ours["grouped_total"]
    assert sum(g["trips"] for g in grouped) == sum(
        ours["cells"]["smollm-135m/train"]["collectives"][
            "count_by_kind"].values())


def test_one_by_one_issues_nothing_and_counts_the_one_device_flops(
        results):
    ref, ours = results
    rec = ours["cells"]["smollm-135m/train/1x1"]
    assert ref["smollm-135m/train/1x1"]["count_by_kind"] == {}
    assert rec["collectives"]["count_by_kind"] == {}
    assert rec["top_collectives"] == []
    one = ours["one_device"]["smollm-135m"]
    assert rec["cost"]["flops_once"] == one["cost"]["flops_once"]
    assert rec["memory"]["argument_bytes"] == \
        one["memory"]["argument_bytes"]


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b"])
def test_world_flops_cover_the_one_device_flops(results, arch):
    _, ours = results
    rec = ours["cells"][f"{arch}/train"]
    assert rec["chips"] == 4
    assert rec["collectives"]["total_bytes"] > 0
    assert 4 * rec["cost"]["flops_once"] >= \
        ours["one_device"][arch]["cost"]["flops_once"]


def test_peak_over_meta_equals_peak_over_cpu_tensors(results):
    _, ours = results
    assert ours["peak", "meta"] == ours["peak", "cpu"] > 0


@pytest.mark.parametrize("dev_type", ["cuda", "cpu"])
def test_mesh_device_type_changes_what_dtensor_issues(results, dev_type):
    _, ours = results
    assert ours["redistribute", dev_type] == REDISTRIBUTE[dev_type]
    rec = (ours["cells"]["smollm-135m/decode"]["collectives"]
           if dev_type == "cuda" else ours["decode", "cpu"])
    assert (rec["count_by_kind"], rec["bytes_by_kind"]) == \
        DECODE_COLLECTIVES[dev_type]


def _run_cell_in_a_group(tmp):
    """run_cell where a gloo group already runs: the error's text."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_distributed

    init_distributed("cpu", f"file://{tmp}/store")
    try:
        dryrun.run_cell("smollm-135m", _shape(TRAIN), save=False,
                        cfg_override=get_smoke("smollm-135m"),
                        mesh_shape=(2, 2))
    except RuntimeError as e:
        return str(e)
    finally:
        assert dist.get_backend() == "gloo"
        dist.destroy_process_group()
    return None


def test_run_cell_refuses_a_running_group(tmp_path):
    err = _run_cell_in_a_group(tmp_path)
    assert err is not None and "gloo process group already runs" in err


if __name__ == "__main__":
    # PYTHONPATH=src:. python tests/test_torch_dryrun_mesh.py DIR: both
    # sides' records into DIR, then each cell's per-kind table (PERF.md
    # §6 keeps it)
    import pathlib
    import sys

    out = pathlib.Path(sys.argv[1])
    out.mkdir(parents=True, exist_ok=True)
    procs = [start_subprocess("test_torch_dryrun_mesh", "reference",
                              out / "ref.pkl", devices=8),
             start_subprocess("test_torch_dryrun_mesh", "port",
                              out / "port.pkl")]
    ref, ours = (finish(p, out / f) for p, f in zip(procs, ("ref.pkl",
                                                           "port.pkl")))
    for cell in CELLS:
        m = ours["cells"][cell]["memory"]
        print(f"\n{cell}: argument {m['argument_bytes']:,} B (reference "
              f"{ref[cell]['argument_bytes']:,}), temp {m['temp_bytes']:,}"
              f" B (XLA's {ref[cell]['temp_bytes']:,})")
        print(_table(ref[cell], ours["cells"][cell]))

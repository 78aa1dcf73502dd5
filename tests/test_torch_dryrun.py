"""The port's one-device dry run (``repro_torch.launch.dryrun``) on the
CPU, no card: its record keeps the reference's keys (read from
``repro.launch.dryrun``'s source: importing that module would set XLA's
host-device count for the whole process), its argument bytes equal the
reference's abstract arguments' bytes for the same SMOKE config (train:
``abstract_train_state`` and the batch; prefill: the params and the
batch; decode: the params, the token and the cache; the enc-dec
cache's 64 more slots and per-row ``ring`` / ``pos`` added), its skip reasons
are the reference's, a refused variant fails the cell, and the CLI exits
0 on a cheap cell with one ``OK`` line.  Exact equality throughout.
"""
import ast
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jconfig  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.launch.strategy import abstract_train_state  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke  # noqa: E402
from repro_torch.core import costref  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(costref, "CACHE_DIR", tmp_path / "costref")
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path / "dryrun")


def _dict_keys(node):
    """{key: nested keys or None} of a dict literal's AST."""
    return {k.value: (_dict_keys(v) if isinstance(v, ast.Dict) else None)
            for k, v in zip(node.keys, node.values)}


def _reference_record_keys():
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "rec"
                        for t in node.targets)):
            return _dict_keys(node.value)
    raise AssertionError("no rec = {...} in the reference's dryrun")


def _record_keys(rec):
    """{key: nested keys or None}; an empty dict (no collectives) is a
    value, as the reference's parsed statistics are."""
    return {k: (_record_keys(v) if isinstance(v, dict) and v else None)
            for k, v in rec.items()}


def test_record_has_the_reference_keys():
    rec = dryrun.run_cell("smollm-135m", "prefill_32k", save=True,
                          cfg_override=get_smoke("smollm-135m"))
    assert _record_keys(rec) == _reference_record_keys()
    assert (rec["mesh"], rec["chips"]) == ("1", 1)
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["generated_code_bytes"] is None
    assert rec["memory"]["hbm_per_chip"] == H100_SXM.hbm_bytes
    assert rec["collectives"]["total_bytes"] == 0
    assert rec["cost"]["flops_once"] > 0 and rec["cost"]["bytes_once"] > 0
    saved = json.loads((dryrun.RESULTS_DIR
                        / "smollm-135m__prefill_32k__1.json").read_text())
    assert saved == rec


def _bytes(tree):
    return sum(int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize
               for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "whisper-medium", "llava-next-mistral-7b"])
def test_argument_bytes_equal_reference_abstract_arguments(arch, shape_name,
                                                          monkeypatch):
    monkeypatch.setattr(dryrun, "cost_reference",
                        lambda cfg, shape: {"flops": 0.0, "bytes": 0.0,
                                            "count_s": 0.0})
    jcfg, tcfg = jsmoke(arch), get_smoke(arch)
    shape = jmc.SHAPES_BY_NAME[shape_name]
    specs = jmodel.input_specs(jcfg, shape)
    if shape.kind == "train":
        ref = _bytes(abstract_train_state(jcfg)) + _bytes(specs)
    else:
        ref = _bytes(jmodel.abstract_params(jcfg)) + _bytes(specs)
    if arch == "whisper-medium" and shape.kind == "decode":
        # the port's enc-dec cache: the reference's ring of prompt + 64
        # slots inside a buffer of seq_len + 64, and pos / ring per row
        # where the reference keeps one scalar pos
        b = shape.global_batch
        ref += (2 * tcfg.num_layers * b * 64 * tcfg.num_kv_heads
                * tcfg.head_dim * 4 + (b - 1) * 4 + b * 4)
    rec = dryrun.run_cell(arch, shape_name, save=False, cfg_override=tcfg)
    assert rec["memory"]["argument_bytes"] == ref
    assert rec["memory"]["peak_bytes"] == ref
    args, _ = dryrun._arguments(tcfg, dryrun.SHAPES_BY_NAME[shape_name])
    assert dryrun.tree_bytes(args) == ref


# the archs whose long_500k cell the reference skips (full attention)
QUADRATIC = [a for a in ARCH_IDS if not jmc.shape_applicable(
    jconfig(a), jmc.SHAPES_BY_NAME["long_500k"])[0]]


@pytest.mark.parametrize("arch", QUADRATIC)
def test_skip_reasons_equal_reference(arch, monkeypatch):
    monkeypatch.setattr(dryrun, "cost_reference", None)    # never counted
    _, why = jmc.shape_applicable(jconfig(arch),
                                  jmc.SHAPES_BY_NAME["long_500k"])
    rec = dryrun.run_cell(arch, "long_500k")
    assert rec == {"arch": arch, "shape": "long_500k", "skipped": why}


def test_refused_variant_fails_the_cell():
    with pytest.raises(ValueError, match="attn_chunk"):
        dryrun.run_cell("smollm-135m", "train_4k",
                        cfg_override=get_smoke("smollm-135m"),
                        variant="lc_ac512")


def test_fits_against_the_h100():
    assert dryrun.fits({"memory": {"argument_bytes": 80 * 2**30,
                                   "temp_bytes": None}})
    assert not dryrun.fits({"memory": {"argument_bytes": 80 * 2**30 + 1,
                                       "temp_bytes": None}})


def test_cli_exits_zero_on_one_cell(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                     "--one-device"])
    assert e.value.code == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    ok = [ln for ln in lines if ln.startswith("OK")]
    assert len(ok) == 1
    assert "count=" in ok[0] and "args/chip=" in ok[0]
    assert ok[0].endswith("OVER-HBM")      # a 32k cache of 128 rows
    assert lines[-1] == "dry-run: 1 ok, 0 skipped, 0 failed"

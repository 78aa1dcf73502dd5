"""The port's compile-time analysis formulas against the reference's, on
the CPU: the ``SHAPES`` table and ``shape_applicable``
(``repro_torch.models.config``), ``model_flops`` / ``model_bytes_min``
(``repro_torch.core.flops``), ``ChipSpec`` / ``ideal_step_time``
(``repro_torch.core.hardware``) and ``RooflineCell`` / ``make_cell`` /
``fit_poly_and_eval`` (``repro_torch.core.roofline``), the last mirroring
``tests/test_roofline.py`` on a ``ChipSpec`` built from the reference's
``TPU_V5E`` fields.

Tolerance: exact equality for the tables, the skip reasons and the flop
and byte formulas (the same integer arithmetic in float64 on both
sides); ``pytest.approx`` (1e-6 relative) for the roofline terms, as
the reference's own test.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as J_ARCHS  # noqa: E402
from repro.configs import get_config as jconfig  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.core import flops as jflops  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core import roofline as jroof  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.core import flops as tflops  # noqa: E402
from repro_torch.core import hardware as thw  # noqa: E402
from repro_torch.core import roofline as troof  # noqa: E402
from repro_torch.models import config as tmc  # noqa: E402

CONFIGS = [(a, smoke) for a in ARCH_IDS for smoke in (False, True)]
SHAPE_NAMES = [s.name for s in jmc.SHAPES]
# the reference's v5e, as the port's ChipSpec (the port states no TPU)
V5E = thw.ChipSpec(**dataclasses.asdict(jhw.TPU_V5E))


def _cfgs(arch, smoke):
    return ((jsmoke(arch), get_smoke(arch)) if smoke
            else (jconfig(arch), get_config(arch)))


def test_arch_ids_match_reference():
    assert sorted(ARCH_IDS) == sorted(J_ARCHS)


def test_shapes_match_reference():
    assert [dataclasses.astuple(s) for s in tmc.SHAPES] == [
        dataclasses.astuple(s) for s in jmc.SHAPES]
    assert list(tmc.SHAPES_BY_NAME) == list(jmc.SHAPES_BY_NAME)
    for name, s in tmc.SHAPES_BY_NAME.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(
            jmc.SHAPES_BY_NAME[name])
        assert s.tokens == jmc.SHAPES_BY_NAME[name].tokens


@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_shape_applicable_matches_reference(arch, smoke):
    jcfg, tcfg = _cfgs(arch, smoke)
    for name in SHAPE_NAMES:
        assert tmc.shape_applicable(tcfg, tmc.SHAPES_BY_NAME[name]) == \
            jmc.shape_applicable(jcfg, jmc.SHAPES_BY_NAME[name]), name


@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_model_flops_and_bytes_match_reference(arch, smoke):
    jcfg, tcfg = _cfgs(arch, smoke)
    assert tcfg.num_active_params() == jcfg.num_active_params()
    shapes = [(tmc.SHAPES_BY_NAME[n], jmc.SHAPES_BY_NAME[n])
              for n in SHAPE_NAMES]
    # and the smoke's training cells' kind of shape, off the table
    shapes.append((tmc.ShapeConfig("smoke_train", "train", 448, 8),
                   jmc.ShapeConfig("smoke_train", "train", 448, 8)))
    for ts, js in shapes:
        assert tflops.model_flops(tcfg, ts) == jflops.model_flops(jcfg, js)
        assert tflops.model_bytes_min(tcfg, ts) == \
            jflops.model_bytes_min(jcfg, js)


def test_whisper_model_flops_count_the_pos_dec_table():
    # the reference's N holds all 32,768 learned decoder positions
    cfg = get_config("whisper-medium")
    shape = tmc.SHAPES_BY_NAME["train_4k"]
    assert tflops.model_flops(cfg, shape) == \
        6.0 * cfg.num_params() * shape.tokens
    assert cfg.num_params() > 32_768 * cfg.d_model


def test_h100_spec():
    h = thw.H100_SXM
    assert (h.peak_flops_bf16, h.hbm_bw, h.hbm_bytes, h.ici_link_bw,
            h.ici_links) == (989e12, 3.35e12, 80 * 1024 ** 3, 25e9, 18)
    assert thw.GENERATIONS == {h.name: h}
    assert [f.name for f in dataclasses.fields(thw.ChipSpec)] == [
        f.name for f in dataclasses.fields(jhw.ChipSpec)]


@pytest.mark.parametrize("flops,chips", [(197e12 * 256, 256), (3.3e15, 1),
                                         (1.0, 512)])
def test_ideal_step_time_matches_reference(flops, chips):
    assert thw.ideal_step_time(flops, chips, V5E) == \
        jhw.ideal_step_time(flops, chips, jhw.TPU_V5E)
    assert thw.ideal_step_time(flops, chips) == \
        flops / (chips * thw.H100_SXM.peak_flops_bf16)


def test_ideal_step_time_is_paper_pg_numerator():
    assert thw.ideal_step_time(197e12 * 256, 256, V5E) == pytest.approx(1.0)
    assert thw.ideal_step_time(989e12, 1) == pytest.approx(1.0)


def test_roofline_terms_and_dominance():
    cell = troof.RooflineCell(
        arch="x", shape="train_4k", mesh="16x16", chips=256,
        hlo_flops=256 * 197e12 * 1.0,          # exactly 1 s of compute
        hlo_bytes=256 * 819e9 * 0.5,           # 0.5 s of memory
        collective_bytes_per_chip=50e9 * 2.0,  # 2 s of collectives
        model_flops=256 * 197e12 * 0.7, chip=V5E,
    )
    assert cell.t_compute == pytest.approx(1.0)
    assert cell.t_memory == pytest.approx(0.5)
    assert cell.t_collective == pytest.approx(2.0)
    assert cell.dominant == "collective"
    assert cell.t_lower_bound == pytest.approx(2.0)
    assert cell.t_no_overlap == pytest.approx(3.5)
    assert cell.useful_ratio == pytest.approx(0.7)
    assert cell.pg_optimistic == pytest.approx(0.7 / 2.0)


CELLS = [  # (chips, hlo_flops, hlo_bytes, collective bytes, model_flops)
    (256, 256 * 197e12, 256 * 819e9 * 0.5, 100e9, 256 * 197e12 * 0.7),
    (1, 4.2e13, 9.5e11, 0.0, 3.3e13),          # compute-bound, one chip
    (1, 1.0e9, 8.0e12, 0.0, 2.0e9),            # memory-bound
    (4, 0.0, 0.0, 0.0, 1.0e12),                # nothing counted
]


@pytest.mark.parametrize("chips,hf,hb,cb,mf", CELLS)
def test_roofline_cell_matches_reference(chips, hf, hb, cb, mf):
    kw = dict(arch="x", shape="s", mesh="m", chips=chips, hlo_flops=hf,
              hlo_bytes=hb, collective_bytes_per_chip=cb, model_flops=mf)
    t, j = troof.RooflineCell(**kw, chip=V5E), jroof.RooflineCell(**kw)
    for prop in ("t_compute", "t_memory", "t_collective", "dominant",
                 "t_ideal", "t_lower_bound", "t_no_overlap", "useful_ratio",
                 "pg_optimistic", "pg_pessimistic"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.row() == j.row()
    # the port's default chip is the H100
    h = troof.RooflineCell(**kw)
    assert h.chip == thw.H100_SXM
    assert h.t_ideal == mf / (chips * 989e12)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "whisper-medium"])
def test_make_cell_matches_reference(arch):
    jcfg, tcfg = jconfig(arch), get_config(arch)
    for name in SHAPE_NAMES:
        t = troof.make_cell(tcfg, tmc.SHAPES_BY_NAME[name], "1", 1, 3.1e15,
                            2.5e12, 0.0)
        assert t.chip == thw.H100_SXM
        t = dataclasses.replace(t, chip=V5E)
        j = jroof.make_cell(jcfg, jmc.SHAPES_BY_NAME[name], "1", 1, 3.1e15,
                            2.5e12, 0.0)
        assert t.row() == j.row()


def test_model_flops_moe_uses_active_params():
    mix = get_config("mixtral-8x7b")
    shape = tmc.SHAPES_BY_NAME["train_4k"]
    mf = tflops.model_flops(mix, shape)
    assert mf == pytest.approx(6.0 * mix.num_active_params() * shape.tokens)
    assert mf < 6.0 * mix.num_params() * shape.tokens * 0.5


def test_model_flops_decode_counts_batch_tokens():
    cfg = get_config("granite-3-8b")
    d = tmc.SHAPES_BY_NAME["decode_32k"]
    assert tflops.model_flops(cfg, d) == pytest.approx(
        2.0 * cfg.num_active_params() * 128)


@pytest.mark.parametrize("xs,target", [([2, 4, 6], 80), ([1, 2], 256),
                                       ([16, 32, 48], 4096), ([5], 9)])
def test_poly_fit_matches_reference(xs, target):
    f = lambda x: 3.0 + 2.0 * x + 0.5 * x * x  # noqa: E731
    ys = [f(x) for x in xs]
    assert troof.fit_poly_and_eval(xs, ys, target) == \
        jroof.fit_poly_and_eval(xs, ys, target)


def test_poly_fit_exact_for_quadratic():
    f = lambda x: 3.0 + 2.0 * x + 0.5 * x * x  # noqa: E731
    xs = [2, 4, 6]
    assert troof.fit_poly_and_eval(xs, [f(x) for x in xs], 80) == \
        pytest.approx(f(80))


def test_poly_fit_linear_with_two_points():
    f = lambda x: 7.0 + 3.0 * x  # noqa: E731
    assert troof.fit_poly_and_eval([1, 2], [f(1), f(2)], 256) == \
        pytest.approx(f(256))

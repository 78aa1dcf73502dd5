"""The port's attribution waterfall, what-if advisor, adaptive controller
and adversarial search against the reference's, exactly, at the
reference tests' tiny size (``GOLDEN_SIZE_MIX`` + ``GOLDEN_KNOBS``).

* ``waterfall_from_trace`` of each committed golden trace gives the
  reference's ``report()`` and conserves.
* ``what_if("steady")``, ``what_if("hetero_fleet",
  knobs=["generation_upgrade"])`` and ``what_if`` on a trace recorded in
  this process give equal dicts on both sides.
* A controlled run (``AdaptiveController``) of each preset gives the
  same trace bytes on both sides and on both event cores.
* ``search_worst`` over ``scenario_from`` gives equal lists.
"""
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.core import attribution as jattr  # noqa: E402
from repro.fleet import adversary as jadv  # noqa: E402
from repro.fleet import advisor as jadvisor  # noqa: E402
from repro.fleet import controller as jctrl  # noqa: E402
from repro.fleet import scenarios as jscen  # noqa: E402
from repro.fleet import trace as jtrace  # noqa: E402
from repro_torch.core import attribution as tattr  # noqa: E402
from repro_torch.fleet import adversary as tadv  # noqa: E402
from repro_torch.fleet import advisor as tadvisor  # noqa: E402
from repro_torch.fleet import controller as tctrl  # noqa: E402
from repro_torch.fleet import scenarios as tscen  # noqa: E402
from repro_torch.fleet import trace as ttrace  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = sorted((ROOT / "tests" / "golden").glob("*.jsonl"))
PRESETS = sorted(jscen.SCENARIOS)
TINY = dict(size_mix=jscen.GOLDEN_SIZE_MIX, **jscen.GOLDEN_KNOBS)


@pytest.mark.parametrize("path", GOLDEN, ids=[p.stem for p in GOLDEN])
def test_waterfall_of_golden_trace_is_the_reference(path):
    text = path.read_text()
    twf, tled = tattr.waterfall_from_trace(ttrace.Trace.loads(text))
    jwf, _ = jattr.waterfall_from_trace(jtrace.Trace.loads(text))
    twf.assert_conserves(tled)
    assert twf.report() == jwf.report()
    assert twf.bucket_totals() == jwf.bucket_totals()
    assert twf.state_size() == jwf.state_size()


def test_knob_catalog_is_the_reference():
    assert tadvisor.knob_names() == jadvisor.knob_names()
    for name, knob in tadvisor.KNOBS.items():
        ref = jadvisor.KNOBS[name]
        assert (knob.description, knob.targets, knob.addresses) == (
            ref.description, ref.targets, ref.addresses)
    assert tadvisor.SATURATED_LOAD == jadvisor.SATURATED_LOAD


@pytest.mark.parametrize("preset, knobs", [
    ("steady", None), ("hetero_fleet", ["generation_upgrade"])])
def test_what_if_is_the_reference(preset, knobs):
    assert (tadvisor.what_if(preset, knobs=knobs, **TINY)
            == jadvisor.what_if(preset, knobs=knobs, **TINY))


def test_what_if_on_a_recorded_trace_is_the_reference():
    text = jtrace.record(jscen.build_sim(jscen.SCENARIOS["failure_storm"],
                                         **TINY)).dumps()
    knobs = ["async_checkpointing", "elastic_resize"]
    got = tadvisor.what_if(ttrace.Trace.loads(text), knobs=knobs)
    assert got["baseline"]["reproduces_trace"]
    assert got == jadvisor.what_if(jtrace.Trace.loads(text), knobs=knobs)
    tcase = tadvisor.from_trace(ttrace.Trace.loads(text))
    jcase = jadvisor.from_trace(jtrace.Trace.loads(text))
    assert repr(tcase.scenario) == repr(jcase.scenario)
    assert tcase.kwargs == jcase.kwargs


def _controlled(scen, ctrl, trace, preset, engine):
    c = ctrl.AdaptiveController()
    sim = scen.build_sim(scen.SCENARIOS[preset], engine=engine,
                         controller=c, **TINY)
    return trace.record(sim).dumps(), c


@pytest.mark.parametrize("preset", PRESETS)
def test_controlled_run_is_the_reference_on_both_engines(preset):
    want, jc = _controlled(jscen, jctrl, jtrace, preset, "reference")
    for engine in ("reference", "vectorized"):
        got, tc = _controlled(tscen, tctrl, ttrace, preset, engine)
        assert got == want
        assert (tc.mode, tc.switches) == (jc.mode, jc.switches)
        assert tc.waterfall.report() == jc.waterfall.report()


def _evaluator(scen, ctrl, adv):
    def evaluate(genome):
        sim = scen.build_sim(adv.scenario_from(genome),
                             controller=ctrl.AdaptiveController(),
                             slice_repair_s=genome["repair_hours"] * 3600,
                             **TINY)
        sim.run()
        return sim.report().mpg
    return evaluate


def test_search_worst_is_the_reference():
    got = tadv.search_worst(_evaluator(tscen, tctrl, tadv), seed=7,
                            restarts=2, steps=3)
    want = jadv.search_worst(_evaluator(jscen, jctrl, jadv), seed=7,
                             restarts=2, steps=3)
    assert got == want
    assert len(got) == 3

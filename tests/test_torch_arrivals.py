"""The port's arrival-shaped request streams and static engine against
the reference's.

* ``make_warp`` and ``request_arrivals`` (``repro_torch.fleet``) give the
  reference's floats exactly, for the steady, diurnal and bursty
  profiles, several seeds and spans, ``n == 0``, and the same errors.
* ``run_static`` over ``synthetic_requests`` and ``SimulatedExecutor``
  gives the reference's ``ServeReport.as_dict()``; its intervals
  partition batch x span (fixed examples of the reference's hypothesis
  property ``test_static_intervals_partition_capacity``).
* ``run_static`` over ``TorchSlotExecutor`` on smollm-135m SMOKE (the
  reference's weights) gives ``JaxSlotExecutor``'s tokens and report.
* The CLI's continuous engine with ``--span 3 --arrival bursty|diurnal|
  uniform --tick-dt 1`` prints the reference CLI's report (the port's
  ``executor`` key popped).
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.fleet import scenarios as jscen  # noqa: E402
from repro.fleet import workload as jwork  # noqa: E402
from repro.launch import serve as jserve_cli  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.jax_executor import JaxSlotExecutor  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.core.goodput import Phase  # noqa: E402
from repro_torch.core.ledger import GoodputLedger  # noqa: E402
from repro_torch.fleet import scenarios as tscen  # noqa: E402
from repro_torch.fleet import workload as twork  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.slot_executor import TorchSlotExecutor  # noqa: E402

PRESETS = ["steady", "diurnal", "bursty"]


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_carry_the_reference_arrival_profiles(preset):
    j, t = jscen.SCENARIOS[preset].arrival, tscen.SCENARIOS[preset].arrival
    assert {f: getattr(t, f) for f in j.__dataclass_fields__} == \
        {f: getattr(j, f) for f in j.__dataclass_fields__}
    for x in np.linspace(0.0, 2 * 86400.0, 97):
        assert t.intensity(float(x)) == j.intensity(float(x))


@pytest.mark.parametrize("span", [0.0, 3.0, 7200.0, 86400.0])
@pytest.mark.parametrize("preset", PRESETS)
def test_make_warp_matches_reference(preset, span):
    prof = jscen.SCENARIOS[preset].arrival
    jw = jwork.make_warp(prof.intensity, span)
    tw = twork.make_warp(tscen.SCENARIOS[preset].arrival.intensity, span)
    us = np.linspace(0.0, span, 41).tolist() if span else [0.0, 1.0]
    assert [tw(u) for u in us] == [jw(u) for u in us]
    zero = lambda t: 0.0    # noqa: E731 -- no intensity: the identity
    assert twork.make_warp(zero, 5.0, grid=16)(2.5) == \
        jwork.make_warp(zero, 5.0, grid=16)(2.5) == 2.5


@pytest.mark.parametrize("n,span,seed", [(0, 3.0, 0), (0, 0.0, 0),
                                         (1, 3.0, 0), (16, 3.0, 0),
                                         (16, 3.0, 7), (64, 2.0, 1),
                                         (200, 86400.0, 3)])
@pytest.mark.parametrize("preset", PRESETS)
def test_request_arrivals_match_reference(preset, n, span, seed):
    got = tscen.request_arrivals(n, span, seed=seed,
                                 arrival=tscen.SCENARIOS[preset].arrival)
    ref = jscen.request_arrivals(n, span, seed=seed,
                                 arrival=jscen.SCENARIOS[preset].arrival)
    assert got == ref
    assert len(got) == n and got == sorted(got)
    assert all(0.0 <= t <= span for t in got)


def test_request_arrivals_errors_match_reference():
    for args in ((-1, 3.0), (4, 0.0), (4, -2.0)):
        with pytest.raises(ValueError) as jerr:
            jscen.request_arrivals(*args)
        with pytest.raises(ValueError) as terr:
            tscen.request_arrivals(*args)
        assert str(terr.value) == str(jerr.value)


def _static_sim(eng, arrivals, batch, seed, slo=None, ledger=None):
    reqs = eng.synthetic_requests(arrivals, prompt_len=32, max_new=(2, 12),
                                  seed=seed)
    kw = {"slo": slo} if slo is not None else {}
    return reqs, eng.run_static(reqs, batch, eng.SimulatedExecutor(),
                                ledger=ledger, arch="sim", **kw)


@pytest.mark.parametrize("preset,batch,slo", [
    ("steady", 1, None), ("diurnal", 3, None), ("bursty", 4, (0.3, 0.02)),
    ("bursty", 2, None)])
def test_run_static_over_simulated_executor_matches_reference(preset, batch,
                                                              slo):
    arrivals = jscen.request_arrivals(
        11, 3.0, seed=2, arrival=jscen.SCENARIOS[preset].arrival)
    jreqs, jrep = _static_sim(jeng, arrivals, batch, 4,
                              jeng.ServeSLO(*slo) if slo else None)
    treqs, trep = _static_sim(teng, arrivals, batch, 4,
                              teng.ServeSLO(*slo) if slo else None)
    assert [r.max_new for r in treqs] == [r.max_new for r in jreqs]
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert trep.as_dict() == jrep.as_dict()
    assert trep.engine == "static" and trep.kv_cache is None


def _assert_partition(events, n_slots, span):
    """Supply-side intervals (everything but the demand-side QUEUED)
    cover every elementary segment of the span with exactly n_slots
    chips: no gap, no overlap."""
    supply = [iv for iv in events if iv.phase is not Phase.QUEUED]
    cuts = sorted({*(iv.t0 for iv in supply), *(iv.t1 for iv in supply)})
    assert cuts[-1] - cuts[0] == pytest.approx(span)
    for lo, hi in zip(cuts, cuts[1:]):
        if hi <= lo:
            continue
        mid = (lo + hi) / 2
        cover = sum(iv.chips for iv in supply if iv.t0 <= mid < iv.t1)
        assert cover == n_slots, (
            f"[{lo}, {hi}) covered by {cover} chips, want {n_slots}")


@pytest.mark.parametrize("jobs,batch", [
    ([(0.0, 1)], 1),
    ([(0.0, 5), (0.0, 5), (0.0, 5)], 2),
    ([(0.0, 8), (0.3, 2), (0.31, 6), (4.0, 3)], 2),
    ([(0.0, 4), (0.0, 12), (0.1, 1), (2.5, 7), (2.5, 7)], 4),
    ([(0.2, 3), (0.2, 1), (1.7, 8), (1.7, 8), (1.9, 2), (4.5, 6)], 3),
])
def test_static_intervals_partition_capacity(jobs, batch):
    ledger = GoodputLedger(window=60.0)
    events = []
    ledger.subscribe_events(lambda iv, pg: events.append(iv))
    reqs = [teng.ServeRequest(rid=i, prompt_len=16, max_new=m, t_submit=t)
            for i, (t, m) in enumerate(sorted(jobs))]
    rep = teng.run_static(reqs, batch, teng.SimulatedExecutor(),
                          ledger=ledger)
    _assert_partition(events, batch, rep.span)
    assert math.isclose(ledger.totals()["allocated_chip_time"],
                        rep.capacity_chip_time, rel_tol=1e-9)


def test_run_static_over_slot_executor_matches_reference():
    """The static policy over the per-slot executors: ``run_static`` with
    ``TorchSlotExecutor`` (the reference's weights) gives the tokens and
    the report of ``run_static`` with ``JaxSlotExecutor``, both under
    ``TickClock(1.0)``; prompts from a seeded stream, arrivals bursty."""
    jcfg, tcfg = jsmoke("smollm-135m"), tsmoke("smollm-135m")
    arrivals = jscen.request_arrivals(
        7, 3.0, seed=1, arrival=jscen.SCENARIOS["bursty"].arrival)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, 10).astype(np.int32)
               for _ in arrivals]

    def stream(eng):
        return eng.synthetic_requests(arrivals, prompt_len=10,
                                      max_new=(2, 6), seed=5,
                                      prompt_maker=prompts.__getitem__)

    jex = JaxSlotExecutor(jcfg, 16, clock=jserve_cli.TickClock(1.0))
    jreqs = stream(jeng)
    jrep = jeng.run_static(jreqs, 3, jex, slo=jeng.ServeSLO(ttft=4.0))
    params = params_from_numpy(jax.tree.map(np.asarray, jex.params), "cpu")
    tex = TorchSlotExecutor(tcfg, 16, clock=tserve_cli.TickClock(1.0),
                            device="cpu", params=params)
    treqs = stream(teng)
    trep = teng.run_static(treqs, 3, tex, slo=teng.ServeSLO(ttft=4.0))
    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, f"request {tr.rid}"
    assert trep.as_dict() == jrep.as_dict()
    assert tex.prefills == 7 and not tex._caches    # every slot released


@pytest.mark.parametrize("arch,arrival", [
    ("smollm-135m", "bursty"), ("smollm-135m", "diurnal"),
    ("smollm-135m", "uniform"), ("granite-3-8b", "bursty")])
def test_cli_arrivals_match_reference_cli(capsys, arch, arrival):
    argv = ["--arch", arch, "--smoke", "--requests", "9", "--batch", "3",
            "--prompt-len", "12", "--max-new", "5", "--tick-dt", "1",
            "--span", "3", "--arrival", arrival, "--seed", "2"]
    out = tserve_cli.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    jserve_cli.main(argv)
    ref = json.loads(capsys.readouterr().out)
    assert out.pop("executor")["prefills"] == 9
    assert out == ref
    assert out["tokens"] == 9 * 5

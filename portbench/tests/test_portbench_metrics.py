"""The metrics' arithmetic on made-up windows and traces: tails over every
request and gap, rates over the whole window, the copied model-flops
formula, and rooflines that read the work whatever kernels their files
name; and ``BENCHMARK.json`` against the harness's files."""
import dataclasses
import json
import re
from types import SimpleNamespace
from typing import List

import numpy as np
import pytest

from portbench import flops, spec
from portbench.cell import Run
from portbench.dims import dims
from portbench.serve import Op, Window
from portbench.train import Steps


@dataclasses.dataclass
class Req:
    rid: int
    t_submit: float
    token_times: List[float]
    prompt_len: int = 100
    max_new: int = 4
    t_admit: float = 0.0

    @property
    def out_tokens(self):
        return [0] * len(self.token_times)


def _conf(name):
    """A configuration's file, whether or not a cell uses it yet."""
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def _serve_run(reqs, seconds=10.0, ops=(), mix=None):
    w = Window(seconds, reqs, list(ops), prefills=4, captures=1,
               decode_steps=0)
    dm = dims(_conf("deepseek-moe-16b"))
    return Run("serve", dm, mix or {"engine": {"n_slots": 32}}, seconds,
               1.0, w)


def _read(name, run):
    return spec.metric_module(name).read(run)


def test_ttft_tail_counts_every_due_request():
    # 10 requests due in the window: 9 served after 0.1 s, one never
    # served by the close at 10 s (its wait so far: 10 - 5 = 5 s); one
    # due after the close, left out
    reqs = [Req(i, 0.5 * i, [0.5 * i + 0.1, 0.5 * i + 0.2]) for i in range(9)]
    reqs.append(Req(9, 5.0, []))
    reqs.append(Req(10, 11.0, [11.5]))
    run = _serve_run(reqs)
    waits = [0.1] * 9 + [5.0]
    assert _read("ttft_p90_ms", run) == pytest.approx(
        1e3 * np.percentile(waits, 90))
    # a first token after the close counts as the wait to the close
    reqs[0].token_times = [10.5]
    assert _read("ttft_p90_ms", _serve_run(reqs)) == pytest.approx(
        1e3 * np.percentile([10.0] + [0.1] * 8 + [5.0], 90))


def test_itl_tail_counts_every_gap_in_the_window():
    reqs = [Req(0, 0.0, [0.1, 0.2, 0.3, 0.4]),     # gaps 0.1 x 3
            Req(1, 0.0, [1.0, 3.0, 3.5, 12.0])]   # 2.0, 0.5; 8.5 after close
    gaps = [0.1, 0.1, 0.1, 2.0, 0.5]
    assert _read("itl_p99_ms", _serve_run(reqs)) == pytest.approx(
        1e3 * np.percentile(gaps, 99))


def test_serve_rate_over_the_whole_window():
    # a request counts its prompt and its tokens inside the window,
    # partial ones too; one with no token in the window counts nothing
    reqs = [Req(0, 0.0, [1.0, 2.0, 3.0], prompt_len=50),
            Req(1, 0.0, [9.0, 11.0], prompt_len=70),
            Req(2, 9.5, [], prompt_len=500)]
    assert _read("serve_tokens_per_s", _serve_run(reqs, 10.0)) == \
        pytest.approx((50 + 3 + 70 + 1) / 10.0)


def test_train_rate_over_the_whole_window():
    steps = Steps(seconds=10.4, steps=35, tokens_per_step=8192,
                  spans=[(0.3 * i, 0.3 * i + 0.29) for i in range(35)])
    dm = dims(spec.config(spec.benchmark(), "deepseek-moe-16b-d2"))
    run = Run("train", dm, {"batch": 4, "seq": 2048}, 10.0, 1.0, steps)
    assert _read("train_tokens_per_s", run) == pytest.approx(
        35 * 8192 / 10.4)
    assert _read("mfu.train", run) == pytest.approx(
        100 * 35 * flops.train_model_flops(dm, 4, 2048)
        / (10.4 * flops.PEAK_BF16))


def test_train_model_flops_is_the_programs_formula():
    """PERF.md's deepseek d2 row at 4 x 2048 (the program's dense layer
    of 11,264): 6 N_active tokens = 2.908e13, and with the attention
    term the 10.03% MFU of a 297.26 ms step."""
    conf = spec.config(spec.benchmark(), "deepseek-moe-16b-d2")
    dm = dataclasses.replace(dims(conf), ff_dense=11264)
    assert flops.n_active(dm) == 591_538_176
    assert 6.0 * flops.n_active(dm) * 4 * 2048 == pytest.approx(2.908e13,
                                                                rel=1e-3)
    f = flops.train_model_flops(dm, 4, 2048)
    assert f - 6.0 * flops.n_active(dm) * 8192 == \
        12.0 * 4 * 16 * 128 * 2 * (2048 * 2049 // 2)
    assert 100 * f / (0.29726 * flops.PEAK_BF16) == pytest.approx(10.03,
                                                                  abs=0.005)


def test_parameter_counts_of_the_configurations():
    ds = dims(_conf("deepseek-moe-16b"))
    gr = dims(_conf("granite-3-8b"))
    # 16.4 B (the release's 16.4 B) and granite's 8.17 B (tied head)
    assert flops.n_params(ds) == pytest.approx(16.38e9, rel=1e-2)
    assert flops.n_params(gr) == pytest.approx(8.17e9, rel=1e-2)


class _Trace:
    """A trace in which every kernel name matches and takes ``t``."""

    def __init__(self, t):
        self.t, self.window_s, self.busy_s = t, 1.0, 0.5

    def kernel_s(self, names):
        return self.t


class _Tracer:
    def inside(self, t0, t1):
        return True

    def outside(self, t0, t1):
        return False


ROOFLINES = [m["name"] for m in spec.benchmark()["per_layer"]
             if "_roofline" in m["name"]]


def _roofline_run(name):
    bench = spec.benchmark()
    cell = next(w for w in bench["workloads"]
                if w["name"] in next(m for m in bench["per_layer"]
                                     if m["name"] == name)["workloads"])
    conf = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    dm = dims(conf)
    if mix["kind"] == "train":
        win = Steps(3.0, 10, mix["batch"] * mix["seq"],
                    [(0.3 * i, 0.3 * i + 0.29) for i in range(10)])
    else:
        ops = [Op("prefill", 0.0, 0.2, [700, 3000]),
               Op("decode", 0.2, 0.23, [800] * 20)]
        win = Window(3.0, [], ops, 2, 2, 1)
    tracer = _Tracer()
    tracer.trace = _Trace(0.5)
    return Run(mix["kind"], dm, mix, 3.0, 1.0, win, tracer)


@pytest.mark.parametrize("name", ROOFLINES)
def test_roofline_reads_the_work_whatever_kernels_it_names(name,
                                                           monkeypatch):
    mod = spec.metric_module(name)
    run = _roofline_run(name)
    base = mod.read(run)
    assert base is not None and 0 < base
    monkeypatch.setattr(mod, "KERNELS", ("some_other_kernel",))
    assert mod.read(run) == base
    # the same work over twice the kernel time reads half the share
    run.tracer.trace.t = 1.0
    assert mod.read(run) == pytest.approx(base / 2)


@pytest.mark.parametrize("name", ROOFLINES)
def test_roofline_reads_nothing_without_kernel_time(name):
    run = _roofline_run(name)
    run.tracer.trace.t = 0.0
    assert spec.metric_module(name).read(run) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_names_files_that_exist():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        conf = spec.config(bench, c["name"])
        assert spec.reference(conf).final_hidden
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert spec.traffic(w["traffic"])["kind"] in ("train", "serve")
        spec.config(bench, w["config"])
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert callable(spec.metric_module(m["name"]).read)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    bench = spec.benchmark()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        mine = {m["name"] for m in spec.metrics_of(bench, w["name"],
                                                    "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        layer = spec.metrics_of(bench, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]


def test_limits_are_set_for_every_cell():
    for w in spec.benchmark()["workloads"]:
        lim = spec.limits(w["name"])
        assert lim, w["name"]
        for name, v in spec.load_json(
                spec.HERE / "limits" / f"{w['name']}.json").items():
            assert v["lower"] < v["limit"] < v["upper"], (w["name"], name)


def test_device_idle_is_the_traced_span_less_busy():
    run = _serve_run([])
    run.tracer = SimpleNamespace(trace=SimpleNamespace(busy_s=0.75,
                                                       window_s=1.0))
    assert _read("device_idle.serve", run) == pytest.approx(25.0)


def test_traced_tails_leave_out_the_profiled_span():
    """In a traced run the waits and gaps that overlap the profiled span
    (here 2-4 s) are left out; the rest count as in an untraced run."""
    reqs = [Req(0, 0.0, [0.1, 0.2]),       # before the span
            Req(1, 1.5, [3.0, 3.1]),       # wait overlaps it
            Req(2, 5.0, [5.3, 5.5])]       # after it
    run = _serve_run(reqs)
    run.tracer = SimpleNamespace(
        trace=None, outside=lambda t0, t1: t1 <= 2.0 or t0 >= 4.0)
    assert _read("ttft_p90_ms", run) == pytest.approx(
        1e3 * np.percentile([0.1, 0.3], 90))
    assert _read("itl_p99_ms", run) == pytest.approx(
        1e3 * np.percentile([0.1, 0.2], 99))


def test_departures_are_run_and_unmodelled_scalings_refused():
    """A file keeps the published values; the sizes are read with the
    departures' values in place, and a Granite scaling left at its
    published value (which neither side models) is refused."""
    bench = spec.benchmark()
    conf = spec.config(bench, "granite-3-8b")
    assert conf["logits_scaling"] == 16.0
    assert dims(conf).hd == 128
    published = {k: v for k, v in conf.items() if k != "departures"}
    with pytest.raises(ValueError, match="logits_scaling"):
        dims(published)
    ds = spec.config(bench, "deepseek-moe-16b-d2")
    assert ds["aux_loss_alpha"] == 0.001 and dims(ds).aux_alpha == 0.01

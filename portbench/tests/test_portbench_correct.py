"""How ``correct`` is decided, at small sizes on the CPU: the program and
the plain reference agree within each cell's own limits; the control
(the reference in fp8 put in the program's place) fails them; and a run
whose timed path is broken underneath comes out not correct, once for
each fault a cell can have."""
import numpy as np
import pytest
import torch

from conftest import CELLS, SEED, run_small, small_mix
from portbench import check, spec, traffic, weights
from portbench.cell import warm_requests
from portbench.dims import dims
from portbench.program import model_config
from portbench.serve import ServeBench, finished

TRAIN = "deepseek-moe-16b.train-4x2048"
SERVE = ("deepseek-moe-16b.serve-chat", "granite-3-8b.serve-docs")


@pytest.mark.parametrize("cell", [TRAIN, *SERVE])
def test_program_and_reference_agree(cell):
    out = run_small(cell)
    assert out["correct"], out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, c in out["checked"].items():
        # fp32 on both sides: only the order of sums differs
        assert c["value"] < 1e-4, (name, c)


def test_train_control_fails_the_limits():
    """The reference in fp8 against the reference in fp32, from the same
    weights over the same batches, as the card's control is read."""
    mix = small_mix(TRAIN)
    conf = CELLS[TRAIN]
    ref = spec.reference(conf)
    ref.exact_fp32()
    dm = dims(conf)
    stream = traffic.train_batches(SEED, mix["batch"], mix["seq"], dm.vocab)
    batches = [next(stream) for _ in range(mix["checked_steps"])]
    ok = []
    for seed in (SEED, SEED + 1, SEED + 2):
        initial = weights.make(dm, seed, torch.float32, "cpu")
        opt = mix["optimizer"]
        base = check.reference_steps(initial, batches, dm, ref, opt)
        ctrl = check.reference_steps(initial, batches, dm, ref, opt,
                                     quant=True)
        readings = check.train_readings(ctrl, base)
        ok.append(check.compare(readings, spec.limits(TRAIN))[0])
    assert not any(ok)


def _served(cell):
    mix = small_mix(cell)
    conf = CELLS[cell]
    ref = spec.reference(conf)
    ref.exact_fp32()
    dm = dims(conf)
    tree = weights.make(dm, SEED, torch.float32, "cpu")
    sb = ServeBench(model_config(conf["name"], dm, mix), mix, tree, "cpu")
    sb.warm(warm_requests(mix, dm))
    win = sb.run(traffic.serve_requests(mix, SEED, 3.0, dm.vocab), 3.0)
    return finished(win), tree, dm, ref, mix


@pytest.mark.parametrize("cell", SERVE)
def test_serve_control_fails_the_limits(cell):
    done, tree, dm, ref, mix = _served(cell)
    assert done
    tokens = mix["check"]["served_tokens"]
    prog, _ = check.serve_readings(done, tree, dm, ref, SEED, tokens)
    ctrl, _ = check.serve_readings(done, tree, dm, ref, SEED, tokens,
                                   control=True)
    assert check.compare(prog, spec.limits(cell))[0]
    assert not check.compare(ctrl, spec.limits(cell))[0]


# ---- faults planted in the timed path --------------------------------------

def _state_unchanged(monkeypatch):
    from repro_torch.launch.strategy import TrainStep

    orig = TrainStep.__call__

    def call(self, batch):
        before = {n: t.clone() for n, t in weights.flat(self.state).items()}
        out = orig(self, batch)
        with torch.no_grad():
            for n, t in weights.flat(self.state).items():
                t.copy_(before[n])
        return out

    monkeypatch.setattr(TrainStep, "__call__", call)


def _half_batch(monkeypatch):
    from repro_torch.launch.strategy import TrainStep

    orig = TrainStep.__call__

    def call(self, batch):
        t = batch["tokens"]
        h = t.shape[0] // 2
        # the first half twice: the loss is the mean over it alone
        return orig(self, {"tokens": torch.cat([t[:h], t[:h]])})

    monkeypatch.setattr(TrainStep, "__call__", call)


def _token_altered(monkeypatch):
    from repro_torch.serve.batched_executor import TorchBatchedExecutor

    orig = TorchBatchedExecutor.decode

    def decode(self, reqs):
        toks, cost = orig(self, reqs)
        if self.decode_steps % 3 == 0:
            toks = [(t + 1) % self.cfg.vocab_size for t in toks]
        return toks, cost

    monkeypatch.setattr(TorchBatchedExecutor, "decode", decode)


def _cache_unwritten(monkeypatch):
    from repro_torch.serve.batched_executor import TorchBatchedExecutor

    orig = TorchBatchedExecutor.decode

    def decode(self, reqs):
        k, v = self._kp.clone(), self._vp.clone()
        out = orig(self, reqs)
        with torch.inference_mode():
            self._kp.copy_(k)
            self._vp.copy_(v)
        return out

    monkeypatch.setattr(TorchBatchedExecutor, "decode", decode)


FAULTS = [(TRAIN, _state_unchanged), (TRAIN, _half_batch)] + [
    (cell, fault) for cell in SERVE
    for fault in (_token_altered, _cache_unwritten)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(cell)
    assert not out["correct"], out["checked"]
    assert out["failed"] >= 1
    assert all(np.isfinite(c["value"]) for c in out["checked"].values())


HOST_METRICS = {"mfu.train", "ttft_p90_ms", "itl_p99_ms", "queue_wait_ms",
                "prefill_ms", "first_sight_share", "step_mfu.prefill",
                "decode_step_ms", "step_mfu.decode", "mfu.serve"}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_a_traced_run_reads_its_host_metrics(cell):
    """A traced run on the CPU: the profiler starts and stops inside the
    window, the result stays correct, and every per-layer metric read
    from the host clock or the program's counters has a value (the
    device's need the card)."""
    out = run_small(cell, seconds=4.0, traced=True)
    assert out["correct"], out["checked"]
    names = {m["name"] for m in spec.metrics_of(spec.benchmark(), cell,
                                                 "per_layer")}
    assert names & HOST_METRICS <= set(out["metrics"]) <= names
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}

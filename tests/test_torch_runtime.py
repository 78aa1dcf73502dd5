"""The port's runtime layer on the CPU: the reference's
``tests/test_runtime.py`` mirrored on ``repro_torch.runtime`` and
``repro_torch.data`` (checkpoint protocol, crash points, streaming and
async restore, pipeline bottleneck analysis, orchestrator preempt /
resume, failure kind -> LOST layer, compile clock -> compiler-layer
INIT, measured DATA_STALL, interval opt-out), ``tests/test_system.py``'s
MPG accounting on smollm, and the port against the reference package:

* the port's ``DataPipeline`` gives the reference's arrays for a seed;
* a checkpoint the port writes restores in the reference's
  ``CheckpointManager`` to the same arrays (the leaves' sorted-key order);
* from the reference's params, a 6-step port ``Orchestrator`` run gives
  the reference ``Orchestrator``'s losses (1e-5);
* ``python -m repro_torch.launch.train --device cpu`` prints the reference
  launcher's keys, and without ``--device cpu`` raises where there is no
  CUDA.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.goodput import Layer, Phase  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.runtime.checkpoint import (CheckpointManager,  # noqa: E402
                                            FaultInjector, SimulatedCrash)
from repro_torch.runtime.compile_cache import AotCache  # noqa: E402
from repro_torch.runtime.orchestrator import (Orchestrator,  # noqa: E402
                                              RunConfig)

CFG = get_smoke("smollm-135m")


def _state(x=0.0):
    return {"w": torch.full((4, 4), x), "step": torch.tensor(int(x))}


def _run(**kw):
    """A RunConfig on the CPU with the reference tests' shape."""
    base = dict(steps=12, checkpoint_every=4, batch=2, seq=32,
                device="cpu")
    base.update(kw)
    return RunConfig(**base)


# ---------------------------------------------------------------------------
# checkpoint protocol
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(_state(3.0), step=3)
    restored, step = m.restore(_state())
    assert step == 3
    np.testing.assert_array_equal(restored["w"].numpy(), np.full((4, 4), 3.0))
    assert restored["step"].dtype == torch.int64


def test_checkpoint_gc_keeps_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        m.save(_state(float(s)), step=s)
    assert m.committed_steps() == [3, 4]


def test_checkpoint_torn_write_invisible(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(_state(1.0), step=1)
    bad = tmp_path / "step_0000000009"   # a directory without a manifest
    bad.mkdir()
    (bad / "arr_00000.npy").write_bytes(b"garbage")
    restored, step = m.restore(_state())
    assert step == 1


@pytest.mark.parametrize("point,good,bad", [("after_arrays", 1, 2),
                                            ("before_commit", 3, 4)])
def test_crash_before_commit_falls_back(tmp_path, point, good, bad):
    """A kill after the array writes (manifest not written) or after the
    manifest lands in the tmp dir (rename pending) leaves the previous
    committed step as the restore target."""
    m = CheckpointManager(str(tmp_path),
                          fault_injector=FaultInjector(point, skip=1))
    m.save(_state(float(good)), step=good)
    with pytest.raises(SimulatedCrash):
        m.save(_state(float(bad)), step=bad)
    restored, step = CheckpointManager(str(tmp_path)).restore(_state())
    assert step == good
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  np.full((4, 4), float(good)))


@pytest.mark.parametrize("torn", ["manifest", "array"])
def test_corrupt_step_is_skipped_not_raised(tmp_path, torn):
    m = CheckpointManager(str(tmp_path))
    m.save(_state(1.0), step=1)
    m.save(_state(2.0), step=2)
    d = tmp_path / "step_0000000002"
    if torn == "manifest":
        (d / "manifest.json").write_text('{"step": 2')
    else:
        (d / "arr_00000.npy").write_bytes(b"torn")
    restored, step = m.restore(_state())
    assert step == 1
    np.testing.assert_array_equal(restored["w"].numpy(), np.full((4, 4), 1.0))


def test_kill_mid_restore_then_clean_retry(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(_state(5.0), step=5)
    dying = CheckpointManager(str(tmp_path),
                              fault_injector=FaultInjector("mid_restore"))
    with pytest.raises(SimulatedCrash):
        dying.restore(_state())
    restored, step = CheckpointManager(str(tmp_path)).restore(_state())
    assert step == 5


def test_streaming_restore_matches_blocking_restore(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(_state(9.0), step=9)
    restored, step, stats = m.finish_restore(m.start_restore(), _state())
    assert step == 9
    np.testing.assert_array_equal(restored["w"].numpy(), np.full((4, 4), 9.0))
    assert set(stats) == {"read_s", "exposed_s", "overlap_s"}
    assert stats["overlap_s"] == pytest.approx(
        max(0.0, stats["read_s"] - stats["exposed_s"]))
    state, step, _ = CheckpointManager(str(tmp_path / "empty")).finish_restore(
        CheckpointManager(str(tmp_path / "empty")).start_restore(), _state())
    assert state is None and step == -1


def test_async_checkpoint_commits_a_snapshot(tmp_path):
    """Async save writes the host snapshot taken at save time, not the
    live tensor: changing the state after ``save`` changes nothing."""
    m = CheckpointManager(str(tmp_path), async_mode=True)
    s = _state(7.0)
    m.save(s, step=7)
    s["w"].fill_(-1.0)
    m.wait()
    restored, step = m.restore(_state())
    assert step == 7
    np.testing.assert_array_equal(restored["w"].numpy(), np.full((4, 4), 7.0))
    assert m.metrics["device_pause_s"] < m.metrics["write_s"] + 1.0


def test_bf16_leaves_round_trip_exactly(tmp_path):
    w = torch.randn(5, 3).to(torch.bfloat16)
    m = CheckpointManager(str(tmp_path))
    m.save({"w": w}, step=0)
    restored, _ = m.restore({"w": torch.zeros(5, 3, dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], w)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_pipeline_prefetch_and_plumber():
    p = DataPipeline(100, batch=2, seq=16, prefetch=2,
                     extra_stage_cost_s=0.002).start()
    for _ in range(10):
        assert next(p)["tokens"].shape == (2, 16)
    p.stop()
    stage, frac = p.analyze().bottleneck()
    assert stage == "augment"
    assert frac > 0.5


@pytest.mark.parametrize("threaded", [False, True], ids=["sync", "prefetch"])
def test_pipeline_gives_the_reference_arrays(threaded):
    from repro.data.pipeline import DataPipeline as JaxPipeline

    ours = DataPipeline(CFG.vocab_size, 3, 24, seed=11)
    ref = JaxPipeline(CFG.vocab_size, 3, 24, seed=11)
    if threaded:
        ours.start()
    try:
        for _ in range(6):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            assert a["tokens"].dtype == np.int32
    finally:
        ours.stop()


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

def test_orchestrator_resume(tmp_path):
    out1 = Orchestrator(CFG, _run(ckpt_dir=str(tmp_path),
                                  preempt_at_step=9)).run()
    assert out1["preempted"]
    assert all(np.isfinite(out1["losses"]))
    out2 = Orchestrator(CFG, _run(ckpt_dir=str(tmp_path))).run()
    assert out2["start_step"] == 8       # last commit at step 7
    assert not out2["preempted"]
    assert out2["end_step"] == 12


def _lost_chip_time_by_layer(ledger):
    by_layer = ledger.segment_phase_chip_time("layer")
    return {layer: phases.get(Phase.LOST.value, 0.0)
            for layer, phases in by_layer.items()}


@pytest.mark.parametrize("kind,layer", [("preemption", "scheduling"),
                                        ("hardware", "hardware")])
def test_failure_kind_moves_the_lost_waterfall_cell(tmp_path, kind, layer):
    orc = Orchestrator(CFG, _run(ckpt_dir=str(tmp_path), preempt_at_step=9,
                                 failure_kind=kind))
    assert orc.run()["preempted"]
    lost = _lost_chip_time_by_layer(orc.ledger)
    other = "hardware" if layer == "scheduling" else "scheduling"
    assert lost.get(layer, 0.0) > 0.0
    assert lost.get(other, 0.0) == 0.0


def test_failure_kind_validated():
    with pytest.raises(ValueError, match="failure_kind"):
        RunConfig(failure_kind="cosmic_ray")


def test_default_ckpt_dir_is_fresh_per_orchestrator(tmp_path, monkeypatch):
    """With no ``ckpt_dir`` every Orchestrator writes to a temporary
    directory of its own, so two runs never share checkpoints."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert RunConfig().ckpt_dir is None
    a, b = (Orchestrator(CFG, _run()).ckpt_dir for _ in range(2))
    assert a != b
    assert {Path(a).parent, Path(b).parent} == {tmp_path}


def test_async_restore_overlap_in_summary(tmp_path):
    def preempted_dir(name):
        d = str(tmp_path / name)
        Orchestrator(CFG, _run(ckpt_dir=d, preempt_at_step=9)).run()
        return d

    out = Orchestrator(CFG, _run(ckpt_dir=preempted_dir("a"),
                                 async_restore=True)).run()
    assert out["start_step"] == 8
    assert set(out["restore"]) == {"read_s", "exposed_s", "overlap_s"}
    assert out["restore"]["read_s"] > 0.0
    assert out["restore"]["overlap_s"] == pytest.approx(
        max(0.0, out["restore"]["read_s"] - out["restore"]["exposed_s"]))
    out2 = Orchestrator(CFG, _run(ckpt_dir=preempted_dir("b"),
                                  async_restore=False)).run()
    assert out2["start_step"] == 8
    assert out2["restore"]["overlap_s"] == 0.0


def _compiler_init_chip_time(ledger):
    by_layer = ledger.segment_phase_chip_time("layer")
    return by_layer.get(Layer.COMPILER.value, {}).get(Phase.INIT.value, 0.0)


def test_compile_clock_feeds_compiler_layer_init(tmp_path):
    """A cold AOT cache books the step's preparation (the warm-up) as
    compiler-layer INIT; a warm one books none and records a hit."""
    aot = AotCache()
    cold = Orchestrator(CFG, _run(steps=3, checkpoint_every=2,
                                  ckpt_dir=str(tmp_path / "a")), aot=aot)
    out_cold = cold.run()
    assert out_cold["compile_s"] > 0
    assert _compiler_init_chip_time(cold.ledger) > 0.0
    warm = Orchestrator(CFG, _run(steps=3, checkpoint_every=2,
                                  ckpt_dir=str(tmp_path / "b")), aot=aot)
    warm.run()
    assert _compiler_init_chip_time(warm.ledger) == 0.0
    key = (CFG.name, 2, 32, "train")
    assert aot.clock.events[key] == {"seconds": 0.0, "hit": 1.0}
    fw = warm.ledger.segment_phase_chip_time("layer")
    assert fw[Layer.FRAMEWORK.value][Phase.INIT.value] > 0.0


def test_aot_cache_hit_semantics():
    aot, calls = AotCache(), []

    def build():
        calls.append(1)
        return "ready"

    assert aot.get_or_compile("k", build) == "ready"
    assert aot.clock.events["k"]["hit"] == 0.0
    assert aot.get_or_compile("k", build) == "ready"
    assert aot.clock.events["k"] == {"seconds": 0.0, "hit": 1.0}
    assert len(calls) == 1 and "k" in aot


def test_orchestrator_emits_measured_data_stall(tmp_path):
    orc = Orchestrator(CFG, _run(steps=4, checkpoint_every=10,
                                 ckpt_dir=str(tmp_path)))
    out = orc.run()
    assert set(out["data"]) == {"bottleneck_stage", "bottleneck_share",
                                "input_bound", "consumer_wait_s"}
    stall = orc.ledger.phase_chip_time(Phase.DATA_STALL)
    assert stall == pytest.approx(out["data"]["consumer_wait_s"]
                                  * orc.run_cfg.chips)
    if stall > 0:
        by_layer = orc.ledger.segment_phase_chip_time("layer")
        assert by_layer[Layer.DATA.value][Phase.DATA_STALL.value] == \
            pytest.approx(stall)


def test_orchestrator_keep_intervals_opt_out(tmp_path):
    orc = Orchestrator(CFG, _run(steps=3, checkpoint_every=2,
                                 ckpt_dir=str(tmp_path)),
                       keep_intervals=False)
    orc.run()
    assert orc.ledger.intervals is None
    with pytest.raises(AttributeError):
        orc.intervals
    assert orc.ledger.phase_chip_time(Phase.STEP) > 0.0


def test_orchestrator_mpg_accounting(tmp_path):
    """``tests/test_system.py``'s MPG check, on smollm."""
    from repro_torch.core.goodput import compute_goodput

    orc = Orchestrator(CFG, _run(steps=6, checkpoint_every=3,
                                 ckpt_dir=str(tmp_path)))
    orc.run()
    total = sum(i.chip_time for i in orc.intervals)
    rep = compute_goodput(orc.intervals, total)
    assert 0 < rep.rg <= 1
    assert total > 0
    steps = [i for i in orc.intervals if i.phase == Phase.STEP]
    assert len(steps) == 6


# ---------------------------------------------------------------------------
# against the reference package
# ---------------------------------------------------------------------------

def _ref_train_state():
    """A reference train state (SMOKE smollm) after 2 of its steps."""
    from repro.configs import get_smoke as jsmoke
    from repro.data.pipeline import DataPipeline as JaxPipeline
    from repro.launch.strategy import make_train_step
    from repro.models import model as jmodel
    from repro.optim import AdamWConfig, adamw_init

    jcfg = jsmoke("smollm-135m")
    params = jmodel.init_params(jcfg, jax.random.key(0))
    state = {"params": params, "opt": adamw_init(params)}
    step = jax.jit(make_train_step(jcfg, AdamWConfig(lr=1e-3)))
    pipe = JaxPipeline(jcfg.vocab_size, 2, 16, seed=0)
    for _ in range(2):
        state, _ = step(state, jax.tree.map(jnp.asarray, next(pipe)))
    return state


def test_port_checkpoint_restores_in_reference_manager(tmp_path):
    """The port writes a train state (params, moments, the int32 step);
    the reference's manager reads it into the reference's state structure
    and gets the same arrays, leaf for leaf."""
    from repro.runtime.checkpoint import CheckpointManager as JaxManager
    from repro_torch.launch.strategy import init_train_state
    from repro_torch.tree import flatten

    state = init_train_state(CFG, torch.Generator().manual_seed(3),
                             device="cpu")
    state["opt"]["m"] = {**state["opt"]["m"],
                         "final_norm": torch.arange(CFG.d_model) * 0.5}
    state["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    CheckpointManager(str(tmp_path)).save(state, step=7)
    example = _ref_train_state()
    restored, step = JaxManager(str(tmp_path)).restore(example)
    assert step == 7
    ours = flatten(state)[0]
    theirs = jax.tree.leaves(restored)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
    assert int(restored["opt"]["step"]) == 7
    # and the other way: the reference's state restores in the port's
    JaxManager(str(tmp_path / "ref")).save(example, step=1)
    back, _ = CheckpointManager(str(tmp_path / "ref")).restore(state)
    for a, b in zip(flatten(back)[0], jax.tree.leaves(example)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_orchestrator_losses_match_reference(tmp_path, monkeypatch):
    """From the reference's params, the port's orchestrator takes the
    reference orchestrator's 6 steps: the same DataPipeline batches (seed
    = start step), the same AdamW (lr 1e-3), losses within 1e-5."""
    from repro.configs import get_smoke as jsmoke
    from repro.models import model as jmodel
    from repro.runtime.orchestrator import Orchestrator as JaxOrchestrator
    from repro.runtime.orchestrator import RunConfig as JaxRunConfig
    from repro_torch.models.init import params_from_numpy
    from repro_torch.optim import adamw_init

    jcfg = jsmoke("smollm-135m")
    jout = JaxOrchestrator(jcfg, JaxRunConfig(
        steps=6, batch=2, seq=32, checkpoint_every=3,
        ckpt_dir=str(tmp_path / "jax"))).run()
    jparams = jax.tree.map(np.asarray,
                           jmodel.init_params(jcfg, jax.random.key(0)))

    def ref_params_state():
        params = params_from_numpy(jparams, device="cpu")
        return {"params": params, "opt": adamw_init(params)}

    orc = Orchestrator(CFG, _run(steps=6, checkpoint_every=3,
                                 ckpt_dir=str(tmp_path / "torch")))
    monkeypatch.setattr(orc, "_init_state", ref_params_state)
    out = orc.run()
    assert len(out["losses"]) == len(jout["losses"]) == 6
    np.testing.assert_allclose(out["losses"], jout["losses"],
                               atol=1e-5, rtol=1e-5)


def test_moe_orchestrator_losses_match_reference(tmp_path, monkeypatch):
    """deepseek-moe-16b SMOKE, as ``test_orchestrator_losses_match_
    reference``: from the reference's params the port's orchestrator
    takes the reference orchestrator's 6 steps (its loss with the
    ``0.01 * aux`` term), losses within 1e-5."""
    from repro.configs import get_smoke as jsmoke
    from repro.models import model as jmodel
    from repro.runtime.orchestrator import Orchestrator as JaxOrchestrator
    from repro.runtime.orchestrator import RunConfig as JaxRunConfig
    from repro_torch.models.init import params_from_numpy
    from repro_torch.optim import adamw_init

    arch = "deepseek-moe-16b"
    jcfg = jsmoke(arch)
    jout = JaxOrchestrator(jcfg, JaxRunConfig(
        steps=6, batch=2, seq=32, checkpoint_every=3,
        ckpt_dir=str(tmp_path / "jax"))).run()
    jparams = jax.tree.map(np.asarray,
                           jmodel.init_params(jcfg, jax.random.key(0)))

    def ref_params_state():
        params = params_from_numpy(jparams, device="cpu")
        return {"params": params, "opt": adamw_init(params)}

    orc = Orchestrator(get_smoke(arch), _run(
        steps=6, checkpoint_every=3, ckpt_dir=str(tmp_path / "torch")))
    monkeypatch.setattr(orc, "_init_state", ref_params_state)
    out = orc.run()
    assert len(out["losses"]) == len(jout["losses"]) == 6
    np.testing.assert_allclose(out["losses"], jout["losses"],
                               atol=1e-5, rtol=1e-5)


REF_ARGS = ["--smoke", "--steps", "12", "--batch", "2", "--seq", "32",
            "--checkpoint-every", "4", "--preempt-at", "9"]


def test_train_cli_prints_the_reference_keys(tmp_path, capsys):
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main

    jmain(REF_ARGS + ["--ckpt-dir", str(tmp_path / "jax")])
    ref = json.loads(capsys.readouterr().out)
    out = main(REF_ARGS + ["--ckpt-dir", str(tmp_path / "torch"),
                           "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert set(printed) == set(ref)
    assert set(printed["rg_breakdown"]) == set(ref["rg_breakdown"])
    assert set(printed["ckpt"]) == set(ref["ckpt"])
    assert printed["steps"] == ref["steps"] == [0, 9]
    assert np.isfinite(printed["final_loss"])
    assert 0 < printed["runtime_goodput"] <= 1


def test_moe_train_cli_prints_the_reference_keys(tmp_path, capsys):
    """``--arch deepseek-moe-16b --smoke --device cpu`` prints the
    reference CLI's keys and steps and a finite loss (each side draws
    its own weights, so the losses are not compared)."""
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main

    args = ["--arch", "deepseek-moe-16b"] + REF_ARGS
    jmain(args + ["--ckpt-dir", str(tmp_path / "jax")])
    ref = json.loads(capsys.readouterr().out)
    out = main(args + ["--ckpt-dir", str(tmp_path / "torch"),
                       "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert set(printed) == set(ref)
    assert printed["arch"] == ref["arch"] == "deepseek-moe-16b"
    assert printed["steps"] == ref["steps"] == [0, 9]
    assert np.isfinite(printed["final_loss"])
    assert 0 < printed["runtime_goodput"] <= 1


def test_hybrid_train_cli_prints_the_reference_keys(tmp_path, capsys):
    """``--arch recurrentgemma-2b --smoke --device cpu`` as the MoE case:
    the reference CLI's keys and steps and a finite loss."""
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main

    args = ["--arch", "recurrentgemma-2b"] + REF_ARGS
    jmain(args + ["--ckpt-dir", str(tmp_path / "jax")])
    ref = json.loads(capsys.readouterr().out)
    out = main(args + ["--ckpt-dir", str(tmp_path / "torch"),
                       "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert set(printed) == set(ref)
    assert printed["arch"] == ref["arch"] == "recurrentgemma-2b"
    assert printed["steps"] == ref["steps"] == [0, 9]
    assert np.isfinite(printed["final_loss"])
    assert 0 < printed["runtime_goodput"] <= 1


def test_ssm_train_cli_prints_the_reference_keys(tmp_path, capsys):
    """``--arch rwkv6-3b --smoke --device cpu`` as the MoE case: the
    reference CLI's keys and steps and a finite loss."""
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main

    args = ["--arch", "rwkv6-3b"] + REF_ARGS
    jmain(args + ["--ckpt-dir", str(tmp_path / "jax")])
    ref = json.loads(capsys.readouterr().out)
    out = main(args + ["--ckpt-dir", str(tmp_path / "torch"),
                       "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert set(printed) == set(ref)
    assert printed["arch"] == ref["arch"] == "rwkv6-3b"
    assert printed["steps"] == ref["steps"] == [0, 9]
    assert np.isfinite(printed["final_loss"])
    assert 0 < printed["runtime_goodput"] <= 1


def test_train_cli_raises_without_cuda(tmp_path, monkeypatch):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(REF_ARGS + ["--ckpt-dir", str(tmp_path)])

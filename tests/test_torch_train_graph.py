"""The captured train step (``launch.strategy.TrainStep``) and the bf16
logits head (``models.layers.HeadFn``) on the CPU, SMOKE configs.

On the CPU ``step_impl="auto"`` is a direct call over the same static
state and batch the graph replays on the card, so this file holds what
does not need the card:

* the ``step_impl`` choices: "graph" and an unknown name raise;
* over 3 steps the step object gives, bit for bit, the params, m, v,
  step and metrics of ``make_train_step`` (1 and 2 microbatches, fp32;
  one microbatch in bf16 compute; deepseek-moe-16b SMOKE in fp32 and
  bf16, its aux loss among the metrics; recurrentgemma-2b SMOKE in fp32
  and bf16, its RG-LRU scans and their reverse inside the step;
  rwkv6-3b SMOKE in fp32 and bf16, its WKV and its reverse), its
  state at the same
  addresses, also when built from a state on another device than the
  step's (here the same CPU, named);
* ``load_state`` copies and refuses another tree, shape or dtype, copying
  nothing; a batch of another shape is refused;
* the warm-up (the step's "compile", which advances the state) leaves
  the state it was built from, and no reference cycle keeps a dropped
  step alive;
* an ``AotCache`` hit returns the same step object, and a preempted
  ``Orchestrator`` and its resume on one cache give the losses of two
  runs on fresh caches, exactly;
* ``HeadFn`` with bf16 ``x`` and head: logits against the reference's
  ``lm_logits`` (bf16 operands, fp32 accumulation) within 1e-5 (the same
  exact products summed in another order), and both gradients against
  ``jax.grad`` of it within one bf16 ulp (rtol 2**-7, the most one ulp
  can be of a value; each is an fp32 sum rounded to bf16, and two orders
  of that sum may round apart) plus 1e-6 absolute, for a tied head, an
  untied head of odd width and a softcapped one.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.launch.strategy import (TrainStep,  # noqa: E402
                                         init_train_state, make_train_step)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.compile_cache import AotCache  # noqa: E402
from repro_torch.runtime.orchestrator import (Orchestrator,  # noqa: E402
                                              RunConfig)
from repro_torch.tree import flatten  # noqa: E402

ARCH = "smollm-135m"
B, S = 4, 32
OPT = AdamWConfig(lr=1e-3)


def _cfg(**kw):
    return dataclasses.replace(get_smoke(ARCH), **kw)


def _state(cfg):
    return init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")


def _batches(cfg, n, seed=0):
    pipe = DataPipeline(cfg.vocab_size, B, S, seed=seed)
    return [{k: torch.from_numpy(v) for k, v in next(pipe).items()}
            for _ in range(n)]


def _assert_identical(a, b):
    la, sa = flatten(a)
    lb, sb = flatten(b)
    assert sa == sb
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


@pytest.mark.parametrize("impl,match", [("graph", "needs a CUDA device"),
                                        ("jit", "unknown step_impl")])
def test_step_impl_graph_raises_on_cpu_and_unknown_raises(impl, match):
    cfg = _cfg()
    with pytest.raises(ValueError, match=match):
        TrainStep(cfg, OPT, _state(cfg), B, S, step_impl=impl)


@pytest.mark.parametrize("kw", [dict(), dict(microbatches=2),
                                dict(compute_dtype=torch.bfloat16)],
                         ids=["mb1", "mb2", "bf16"])
def test_step_object_matches_make_train_step_bit_for_bit(kw):
    cfg = _cfg(**kw)
    state = _state(cfg)
    ts = TrainStep(cfg, OPT, state, B, S)
    assert ts.graph.mode == "eager"
    ptrs = [t.data_ptr() for t in flatten(ts.state)[0]]
    step = make_train_step(cfg, OPT)
    want = state
    for batch in _batches(cfg, 3):
        want, metrics = step(want, batch)
        got = ts(batch)
        assert got is ts.metrics and got.keys() == metrics.keys()
        for k, v in metrics.items():
            assert torch.equal(got[k], v), k
        _assert_identical(ts.state, want)
    assert int(ts.state["opt"]["step"]) == 3
    assert [t.data_ptr() for t in flatten(ts.state)[0]] == ptrs
    assert set(ts.metrics) == ({"loss", "grad_norm", "lr"}
                               | ({"xent", "aux"}
                                  if cfg.microbatches <= 1 else set()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_moe_step_object_matches_make_train_step_bit_for_bit(dtype):
    cfg = dataclasses.replace(get_smoke("deepseek-moe-16b"),
                              compute_dtype=dtype)
    state = _state(cfg)
    ts = TrainStep(cfg, OPT, state, B, S, device="cpu")
    step = make_train_step(cfg, OPT)
    want = state
    for batch in _batches(cfg, 3):
        want, metrics = step(want, batch)
        got = ts(batch)
        assert got.keys() == metrics.keys() >= {"xent", "aux"}
        for k, v in metrics.items():
            assert torch.equal(got[k], v), k
        assert float(got["aux"]) > 0
        _assert_identical(ts.state, want)
    assert int(ts.state["opt"]["step"]) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_hybrid_step_object_matches_make_train_step_bit_for_bit(dtype):
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                              compute_dtype=dtype)
    state = _state(cfg)
    ts = TrainStep(cfg, OPT, state, B, S, device="cpu")
    step = make_train_step(cfg, OPT)
    want = state
    for batch in _batches(cfg, 3):
        want, metrics = step(want, batch)
        got = ts(batch)
        assert got.keys() == metrics.keys() >= {"xent", "aux"}
        for k, v in metrics.items():
            assert torch.equal(got[k], v), k
        _assert_identical(ts.state, want)
    assert int(ts.state["opt"]["step"]) == 3
    # the recurrent layers moved: their gradients came through the scan
    assert not torch.equal(ts.state["params"]["layers"]["0"]["rec"]["lru_a"],
                           state["params"]["layers"]["0"]["rec"]["lru_a"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssm_step_object_matches_make_train_step_bit_for_bit(dtype):
    cfg = dataclasses.replace(get_smoke("rwkv6-3b"), compute_dtype=dtype)
    state = _state(cfg)
    ts = TrainStep(cfg, OPT, state, B, S, device="cpu")
    step = make_train_step(cfg, OPT)
    want = state
    for batch in _batches(cfg, 3):
        want, metrics = step(want, batch)
        got = ts(batch)
        assert got.keys() == metrics.keys() >= {"xent", "aux"}
        for k, v in metrics.items():
            assert torch.equal(got[k], v), k
        _assert_identical(ts.state, want)
    assert int(ts.state["opt"]["step"]) == 3
    # the time mix moved: its gradients came through the WKV's reverse
    assert not torch.equal(ts.state["params"]["blocks"]["tm"]["bonus"],
                           state["params"]["blocks"]["tm"]["bonus"])


def test_warm_up_leaves_the_state_it_was_built_from():
    cfg = _cfg()
    state = _state(cfg)
    kept = [t.clone() for t in flatten(state)[0]]
    ts = TrainStep(cfg, OPT, state, B, S)
    # the warm-up ran a whole step (its metrics are there) ...
    assert ts.graph.calls == 1 and "loss" in ts.metrics
    # ... and the state is the one it was built from, in its own tensors
    _assert_identical(ts.state, state)
    for i, (a, b) in enumerate(zip(flatten(ts.state)[0],
                                   flatten(state)[0])):
        assert a.data_ptr() != b.data_ptr()
        assert torch.equal(b, kept[i])


def test_load_state_copies_into_the_static_state():
    cfg = _cfg()
    ts = TrainStep(cfg, OPT, _state(cfg), B, S)
    ts(_batches(cfg, 1)[0])
    ptrs = [t.data_ptr() for t in flatten(ts.state)[0]]
    other = init_train_state(cfg, torch.Generator().manual_seed(7), "cpu")
    ts.load_state(other)
    _assert_identical(ts.state, other)
    assert [t.data_ptr() for t in flatten(ts.state)[0]] == ptrs


def _mismatch(state, kind):
    if kind == "shape":
        state["params"]["final_norm"] = torch.zeros(3)
    elif kind == "dtype":
        state["opt"]["step"] = state["opt"]["step"].long()
    else:
        del state["opt"]["v"]
    return state


@pytest.mark.parametrize("kind,match", [
    ("shape", "params/final_norm"), ("dtype", "opt/step"),
    ("keys", "train state /opt: keys")])
def test_load_state_refuses_a_mismatch_and_copies_nothing(kind, match):
    cfg = _cfg()
    ts = TrainStep(cfg, OPT, _state(cfg), B, S)
    before = [t.clone() for t in flatten(ts.state)[0]]
    bad = _mismatch(init_train_state(cfg, torch.Generator().manual_seed(7),
                                     "cpu"), kind)
    with pytest.raises(ValueError, match=match):
        ts.load_state(bad)
    for a, b in zip(flatten(ts.state)[0], before):
        assert torch.equal(a, b)


def test_a_batch_of_another_shape_is_refused():
    cfg = _cfg()
    ts = TrainStep(cfg, OPT, _state(cfg), B, S)
    with pytest.raises(ValueError, match="batch /tokens"):
        ts({"tokens": torch.zeros((B, S // 2), dtype=torch.int32)})
    assert ts.graph.calls == 1


def test_a_dropped_step_is_freed_without_a_collection():
    """No reference cycle holds a step (on the card it holds its graph's
    memory pool): dropping the last reference frees it at once."""
    cfg = _cfg()
    ts = TrainStep(cfg, OPT, _state(cfg), B, S)
    refs = (weakref.ref(ts), weakref.ref(ts.graph))
    collecting = gc.isenabled()
    gc.disable()
    try:
        del ts
        assert all(r() is None for r in refs)
    finally:
        if collecting:
            gc.enable()


def _orc(tmp_path, aot, name, **kw):
    run = RunConfig(steps=12, checkpoint_every=4, batch=2, seq=32,
                    device="cpu", ckpt_dir=str(tmp_path / name), **kw)
    return Orchestrator(_cfg(), run, aot=aot)


def test_aot_cache_hit_returns_the_same_step(tmp_path):
    aot = AotCache()
    first = _orc(tmp_path, aot, "a")
    example = first._init_state()
    step = first._build(example)
    assert isinstance(step, TrainStep)
    assert _orc(tmp_path, aot, "b")._build(example) is step
    key = (ARCH, 2, 32, "train")
    assert aot.clock.events[key] == {"seconds": 0.0, "hit": 1.0}


def test_preempted_and_resumed_runs_on_one_cache_match_fresh_runs(tmp_path):
    aot = AotCache()
    out1 = _orc(tmp_path, aot, "one", preempt_at_step=9).run()
    out2 = _orc(tmp_path, aot, "one").run()
    assert (out1["start_step"], out1["end_step"]) == (0, 9)
    assert (out2["start_step"], out2["end_step"]) == (8, 12)
    fresh1 = _orc(tmp_path, AotCache(), "two", preempt_at_step=9).run()
    fresh2 = _orc(tmp_path, AotCache(), "two").run()
    assert out1["losses"] == fresh1["losses"]
    assert out2["losses"] == fresh2["losses"]
    assert len(out2["losses"]) == 4


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-3-8b",
                                  "recurrentgemma-2b"])
def test_bf16_head_matches_the_reference_and_jax_grad(arch):
    jcfg, tcfg = jsmoke(arch), get_smoke(arch)
    d, v = tcfg.d_model, tcfg.vocab_size
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    w = (0.2 * rng.standard_normal((v, d) if tcfg.tie_embeddings
                                   else (d, v))).astype(np.float32)
    cot = rng.standard_normal((2, 7, v)).astype(np.float32)
    name = "tok" if tcfg.tie_embeddings else "lm_head"

    def jtree(wj):
        return {"embed": {"tok": wj}} if name == "tok" else {"lm_head": wj}

    def jloss(xj, wj):
        return jnp.sum(jlayers.lm_logits(xj, jtree(wj), jcfg) * cot)

    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jlog = jlayers.lm_logits(xj, jtree(wj), jcfg)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(xj, wj)

    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    tree = {"embed": {"tok": wt}} if name == "tok" else {"lm_head": wt}
    tlog = tlayers.lm_logits(xt, tree, tcfg)
    assert tlog.dtype == torch.float32
    (tlog * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               atol=1e-5, rtol=1e-5)
    for got, want in ((xt.grad, jdx), (wt.grad, jdw)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=1e-6, rtol=2.0 ** -7)

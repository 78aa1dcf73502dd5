"""Card-only: the train step as one captured CUDA graph
(``launch.strategy.TrainStep``) and the bf16 logits head on CUDA.

At SMOKE widths with head_dim 64 (the flash backward's), on the same
initial state and batches:

* the graph and eager steps give bit-identical params, m, v, step and
  metrics after 3 steps, fp32 and bf16 compute, also for whisper-medium
  (frames) and llava-next-mistral-7b (patches), with their flash
  launches counted exactly;
* the counters see the warm-up and capture calls only (per call one
  flash forward per layer, again in remat's recompute, one backward per
  layer, bf16 on the tensor cores), replays add none, and a profiled
  replay runs every flash forward and both backward kernels of a step;
* no garbage collection runs inside the capture;
* ``HeadFn``'s ``aten::mm.dtype`` product (bf16 operands, fp32 output)
  matches the fp32 GEMM of the operands cast up within fp32
  summation-order error, ``d x 2**-24 x (|x| @ |w|)`` per element, for a
  tied (transposed) head and an untied one of odd width.

Every test carries the ``cuda`` marker and skips without a card.  On a
machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_train_graph_cuda.py
"""
import dataclasses
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.launch.strategy import (TrainStep,  # noqa: E402
                                         init_train_state)
from repro_torch.models.layers import HeadFn  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.step_graph import WARMUP  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

pytestmark = pytest.mark.cuda

B, S = 4, 128
OPT = AdamWConfig(lr=1e-3)


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _cfg(dtype):
    return dataclasses.replace(get_smoke("smollm-135m"), head_dim=64,
                               compute_dtype=dtype)


def _state(cfg, card):
    return init_train_state(cfg, torch.Generator(card).manual_seed(0), card)


def _batches(cfg, n):
    pipe = DataPipeline(cfg.vocab_size, B, S, seed=3)
    return [{k: torch.from_numpy(v) for k, v in next(pipe).items()}
            for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_graph_and_eager_steps_give_identical_state(card, dtype):
    cfg = _cfg(dtype)
    state = _state(cfg, card)
    graph = TrainStep(cfg, OPT, state, B, S, step_impl="graph")
    eager = TrainStep(cfg, OPT, state, B, S, step_impl="eager")
    for batch in _batches(cfg, 3):
        mg, me = graph(batch), eager(batch)
        torch.cuda.synchronize()
        assert mg.keys() == me.keys()
        for k in mg:
            assert torch.equal(mg[k], me[k]), k
        for i, (a, b) in enumerate(zip(flatten(graph.state)[0],
                                       flatten(eager.state)[0])):
            assert torch.equal(a, b), i
    assert int(graph.state["opt"]["step"]) == 3
    g, e = graph.graph, eager.graph
    assert (g.captures, g.replays, g.calls) == (1, 3, WARMUP + 1)
    assert (e.captures, e.replays, e.calls) == (0, 0, 1 + 3)
    assert g.capture_bytes > 0


def _family_batches(cfg, n):
    """n batches of ``input_specs``'s training shape (B x S): random
    tokens, and the enc-dec family's frames or the vlm's patches drawn
    from a seeded normal in bf16 (rows that differ)."""
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import input_specs

    g = torch.Generator().manual_seed(4)
    specs = input_specs(cfg, ShapeConfig("t", "train", S, B))
    return [{k: (torch.randn(x.shape, generator=g).to(x.dtype)
                 if x.dtype.is_floating_point
                 else torch.randint(0, cfg.vocab_size, x.shape, generator=g,
                                    dtype=x.dtype))
             for k, x in specs.items()} for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_graph_and_eager_steps_identical_encdec_vlm(card, arch, dtype):
    """The enc-dec (frames) and vlm (patches) families' SMOKE configs at
    head_dim 64: graph and eager steps bit for bit over 3 batches, and
    the flash launches counted exactly: per direct call, one forward per
    attention (whisper: each encoder layer and each decoder layer's self
    and cross attention), again in remat's recompute, and one backward,
    bf16 on the tensor cores."""
    cfg = dataclasses.replace(get_smoke(arch), head_dim=64,
                              compute_dtype=dtype)
    n_attn = (cfg.encoder_layers + 2 * cfg.num_layers
              if cfg.family == "encdec" else cfg.num_layers)
    state = _state(cfg, card)
    n0, b0 = fa.LAUNCHES, fa.LAUNCHES_BWD
    tc0, tcb0 = fa.LAUNCHES_TC, fa.LAUNCHES_BWD_TC
    graph = TrainStep(cfg, OPT, state, B, S, step_impl="graph")
    eager = TrainStep(cfg, OPT, state, B, S, step_impl="eager")
    for batch in _family_batches(cfg, 3):
        mg, me = graph(batch), eager(batch)
        torch.cuda.synchronize()
        assert mg.keys() == me.keys()
        for k in mg:
            assert torch.equal(mg[k], me[k]), k
        for i, (a, b) in enumerate(zip(flatten(graph.state)[0],
                                       flatten(eager.state)[0])):
            assert torch.equal(a, b), i
    calls = graph.graph.calls + eager.graph.calls
    assert calls == WARMUP + 1 + 1 + 3
    assert fa.LAUNCHES - n0 == 2 * n_attn * calls
    assert fa.LAUNCHES_BWD - b0 == n_attn * calls
    tc = dtype == torch.bfloat16
    assert fa.LAUNCHES_TC - tc0 == 2 * n_attn * calls * tc
    assert fa.LAUNCHES_BWD_TC - tcb0 == n_attn * calls * tc


def test_replays_add_no_counted_launch_and_the_backward_is_captured(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg(torch.bfloat16)
    names = ("LAUNCHES", "LAUNCHES_TC", "LAUNCHES_BWD", "LAUNCHES_BWD_TC")
    n0 = {k: getattr(fa, k) for k in names}
    step = TrainStep(cfg, OPT, _state(cfg, card), B, S, step_impl="graph")
    calls = WARMUP + 1
    fwd, bwd = 2 * cfg.num_layers * calls, cfg.num_layers * calls
    want = dict(zip(names, (fwd, fwd, bwd, bwd)))
    assert {k: getattr(fa, k) - n0[k] for k in names} == want
    batch = _batches(cfg, 1)[0]
    step(batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    assert step.graph.replays == 2
    assert {k: getattr(fa, k) - n0[k] for k in names} == want
    # the one replay ran every flash kernel of a step, from no Python call
    ran = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for kernel in ("flash_fwd_tc", "flash_bwd_dq_tc",
                           "flash_bwd_dkdv_tc"):
                if kernel + "<" in e.key:
                    ran[kernel] = ran.get(kernel, 0) + e.count
    assert ran == {"flash_fwd_tc": 2 * cfg.num_layers,
                   "flash_bwd_dq_tc": cfg.num_layers,
                   "flash_bwd_dkdv_tc": cfg.num_layers}


def test_capture_collects_no_garbage_inside(card):
    """With a collection due at every allocation, collections run
    during the warm-ups and none during the capture."""
    cfg = _cfg(torch.bfloat16)
    state = _state(cfg, card)
    threshold = gc.get_threshold()
    seen = []

    def watch(phase, info):
        if phase == "start":
            seen.append(torch.cuda.is_current_stream_capturing())

    gc.callbacks.append(watch)
    gc.set_threshold(1, 1, 1)
    try:
        TrainStep(cfg, OPT, state, B, S, step_impl="graph")
    finally:
        gc.set_threshold(*threshold)
        gc.callbacks.remove(watch)
    assert seen and not any(seen), "a collection ran inside the capture"


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_bf16_head_matches_the_fp32_form(card, tied):
    n, d, v = 1000, 576, 4099
    g = torch.Generator(card).manual_seed(1)
    x = torch.randn((n, d), generator=g, device=card).bfloat16()
    w = (torch.randn((v, d), generator=g, device=card).bfloat16().T if tied
         else torch.randn((d, v), generator=g, device=card).bfloat16())
    got = HeadFn.apply(x, w)
    want = torch.mm(x.float(), w.float())
    assert got.dtype == torch.float32 and got.shape == (n, v)
    bound = d * 2.0 ** -24 * torch.mm(x.float().abs(), w.float().abs())
    assert bool(((got - want).abs() <= bound).all())

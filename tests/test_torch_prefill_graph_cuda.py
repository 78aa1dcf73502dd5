"""Card-only: the prefill as a captured CUDA graph, one per prompt shape.

At SMOKE size (fp32) for smollm-135m, deepseek-moe-16b,
recurrentgemma-2b, rwkv6-3b, llava-next-mistral-7b and whisper-medium
(their zero patches / frames in static buffers, as the owners hold
them):

* a prefill captured by ``PrefillGraphs`` gives the logits of the same
  step called directly, ``torch.equal``, at a first length (captured
  after the warm-ups), a second one (captured with none) and the first
  again with new tokens (a replay);
* the kernels' counters see the warm-up and capture calls only, and a
  profiled replay runs every kernel of a prefill (flash, the grouped
  matmul, the RG-LRU scan, the WKV) from no Python call;
* the executors and the static server with ``prefill_impl="graph"``
  give the tokens of ``prefill_impl="eager"``, one capture per length
  and one replay per prefill;
* the RG-LRU scan and the WKV, which no decode graph holds, replay
  bit-identically to a direct call on new inputs;
* no garbage collection runs inside a prefill capture, also one without
  warm-up;
* an evicted graph is freed at its eviction.

Every test carries the ``cuda`` marker and skips without a card.  On a
machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_prefill_graph_cuda.py
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as mg  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan as rs  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as wk  # noqa: E402
from repro_torch.launch.serve import Request, run_static_server  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serve.batched_executor import make_executor  # noqa: E402
from repro_torch.serve.engine import (NO_SLO,  # noqa: E402
                                      ContinuousServeEngine, ServeRequest)
from repro_torch.serve.prefill_graph import PrefillGraphs  # noqa: E402
from repro_torch.step_graph import WARMUP, StepGraph  # noqa: E402

pytestmark = pytest.mark.cuda

FAMILIES = ["smollm-135m", "deepseek-moe-16b", "recurrentgemma-2b",
            "rwkv6-3b", "llava-next-mistral-7b", "whisper-medium"]
MODULES = {"flash_fwd": fa, "grouped_matmul": mg, "rglru_scan_fwd": rs,
           "wkv_fwd": wk}


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


def _per_prefill(cfg):
    """Each kernel's launches in one prefill, by the kernel's name."""
    if cfg.family == "hybrid":
        n_attn = sum(cfg.is_attention_layer(i)
                     for i in range(cfg.num_layers))
        return {"flash_fwd": n_attn,
                "rglru_scan_fwd": cfg.num_layers - n_attn}
    if cfg.family == "ssm":
        return {"wkv_fwd": cfg.num_layers}
    if cfg.family == "encdec":     # encoder, decoder self, cross
        return {"flash_fwd": cfg.encoder_layers + 2 * cfg.num_layers}
    out = {"flash_fwd": cfg.num_layers}
    if cfg.num_experts:
        out["grouped_matmul"] = 3 * (cfg.num_layers - cfg.first_k_dense)
    return out


def _counts():
    return {k: m.LAUNCHES for k, m in MODULES.items()}


def _logit_graphs(cfg, params, device, impl):
    prefill = model.prefill_fn(cfg, max_len=40)
    frontend = model.frontend_inputs(cfg, 1, device)

    def step(b):
        b["logits"].copy_(prefill(params, {"tokens": b["tokens"],
                                           **frontend})[0])

    def buffers(shape):
        return {"tokens": torch.zeros(shape, dtype=torch.int64,
                                      device=device),
                "logits": torch.zeros((shape[0], cfg.vocab_size),
                                      device=device)}

    return PrefillGraphs(step, buffers, device, impl)


def _tokens(cfg, n, seed, device):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (1, n), generator=g,
                         device=device)


@pytest.mark.parametrize("arch", FAMILIES)
def test_graph_and_eager_prefill_logits_are_equal(card, arch):
    cfg = get_smoke(arch)
    params = init_params(cfg, torch.Generator(card).manual_seed(0), card)
    per = _per_prefill(cfg)
    got = {}
    with torch.inference_mode():
        for impl in ("graph", "eager"):
            graphs = _logit_graphs(cfg, params, card, impl)
            n0 = _counts()
            for i, n in enumerate((24, 17, 24)):
                t = _tokens(cfg, n, i, card)
                out = graphs((1, n), lambda b, t=t: b["tokens"].copy_(t))
                got[impl, i] = out["logits"].clone()
            torch.cuda.synchronize()
            calls = WARMUP + 2 if impl == "graph" else 3
            assert {k: _counts()[k] - n0[k] for k in per} == {
                k: v * calls for k, v in per.items()}
            stats = graphs.stats()
            if impl == "graph":
                assert (stats["captures"], stats["replays"],
                        stats["calls"]) == (2, 3, WARMUP + 2)
                assert graphs.count() == 2
                assert graphs._graphs[(1, 24)].warmup == WARMUP
                assert graphs._graphs[(1, 17)].warmup == 0
    for i in range(3):
        assert torch.equal(got["graph", i], got["eager", i]), i


@pytest.mark.parametrize("arch", FAMILIES)
def test_replays_run_every_kernel_without_a_counted_launch(card, arch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_smoke(arch)
    params = init_params(cfg, torch.Generator(card).manual_seed(0), card)
    per = _per_prefill(cfg)
    t = _tokens(cfg, 20, 0, card)
    with torch.inference_mode():
        graphs = _logit_graphs(cfg, params, card, "graph")
        graphs((1, 20), lambda b: b["tokens"].copy_(t))
        n0 = _counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graphs((1, 20), lambda b: None)
            torch.cuda.synchronize()
    assert _counts() == n0
    ran = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for kernel in per:
                if f"{kernel}<" in e.key:
                    ran[kernel] = ran.get(kernel, 0) + e.count
    assert ran == per


def _serve(cfg, params, prefill_impl, lens):
    ex, kv = make_executor(cfg, 64, 3, device="cuda", params=params,
                           prefill_impl=prefill_impl)
    rng = np.random.default_rng(1)
    reqs = [ServeRequest(rid=i, prompt_len=n, max_new=4,
                         prompt=rng.integers(0, cfg.vocab_size, n)
                         .astype(np.int32))
            for i, n in enumerate(lens)]
    ContinuousServeEngine(3, ex, slo=NO_SLO, kv_cache=kv).run(reqs)
    return ex, [r.out_tokens for r in reqs]


@pytest.mark.parametrize("arch", FAMILIES)
def test_graph_and_eager_owners_give_identical_tokens(card, arch):
    cfg = get_smoke(arch)
    params = init_params(cfg, torch.Generator(card).manual_seed(0), card)
    lens = [9, 30, 9, 17, 30, 9]
    ex_g, toks_g = _serve(cfg, params, "graph", lens)
    ex_e, toks_e = _serve(cfg, params, "eager", lens)
    assert toks_g == toks_e
    g, e = ex_g.prefill_graph_stats(), ex_e.prefill_graph_stats()
    assert (g["captures"], g["replays"], g["calls"]) == (3, 6, WARMUP + 3)
    assert (e["captures"], e["replays"], e["calls"]) == (0, 0, 6)
    assert ex_g.prefill_graph_count() == 3 and ex_e.prefill_graph_count() == 0
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(5)]
    toks, servers = {}, {}
    for impl in ("graph", "eager"):
        reqs = [Request(i, p, 4) for i, p in enumerate(prompts)]
        servers[impl], _ = run_static_server(cfg, reqs, 2, 4, 12,
                                             params=params, device=card,
                                             prefill_impl=impl)
        toks[impl] = [r.out_tokens for r in reqs]
    assert toks["graph"] == toks["eager"]
    g = servers["graph"].prefill_graph_stats()
    assert (g["captures"], g["replays"], g["calls"]) == (1, 3, WARMUP + 1)


@pytest.mark.parametrize("kernel", ["rglru_scan", "rwkv6_wkv"])
def test_scans_replay_bit_identically(card, kernel):
    """A captured scan, replayed on new inputs, gives a direct call's
    output bit for bit; the counter moves by the direct calls only."""
    g = torch.Generator(card).manual_seed(0)
    if kernel == "rglru_scan":
        shape = (1, 300, 256)
        run = rs.rglru_scan

        def draw():
            return (torch.rand(shape, generator=g, device=card),
                    torch.randn(shape, generator=g, device=card))
    else:
        shape = (1, 300, 4, 64)
        u = torch.randn((4, 64), generator=g, device=card)

        def run(r, k, v, logw):
            return wk.rwkv6_wkv(r, k, v, logw, u)

        def draw():
            r, k, v = (torch.randn(shape, generator=g, device=card)
                       for _ in range(3))
            logw = -torch.exp(torch.randn(shape, generator=g, device=card))
            return r, k, v, logw

    def outs(out):
        return out if isinstance(out, tuple) else (out,)

    ins = draw()
    bufs = {"in": [x.clone() for x in ins],
            "out": [torch.empty_like(o) for o in outs(run(*ins))]}

    def step(b):
        for o, x in zip(outs(run(*b["in"])), b["out"]):
            x.copy_(o)

    mod = rs if kernel == "rglru_scan" else wk
    n0 = mod.LAUNCHES
    graph = StepGraph(step, bufs, card, "graph")
    assert mod.LAUNCHES == n0 + WARMUP + 1
    for _ in range(2):
        ins = draw()
        for buf, x in zip(bufs["in"], ins):
            buf.copy_(x)
        want = outs(run(*ins))
        graph()
        torch.cuda.synchronize()
        for got, w in zip(bufs["out"], want):
            assert torch.equal(got, w)
    assert mod.LAUNCHES == n0 + WARMUP + 1 + 2 and graph.replays == 2


def test_capture_collects_no_garbage_inside(card):
    """A second shape, captured with no warm-up: garbage that becomes
    collectable inside its capture, with a collection due at every
    allocation there, is collected after it, not inside."""
    threshold = gc.get_threshold()
    inside = []

    def buffers(shape):
        return {"x": torch.ones(shape, device=card),
                "out": torch.zeros(shape, device=card)}

    holder = []

    def step(b):
        if torch.cuda.is_current_stream_capturing() and holder:
            holder.clear()              # the cycle is garbage from here on
            gc.set_threshold(1, 1, 1)   # and a collection is due at once
        keep = [b["x"] * 2.0 for _ in range(8)]
        b["out"].copy_(keep[-1])

    def watch(phase, info):
        if phase == "start":
            inside.append(torch.cuda.is_current_stream_capturing())

    graphs = PrefillGraphs(step, buffers, card, "graph")
    graphs((1, 4), lambda b: None)
    junk = {"graph": StepGraph(lambda b: b["y"].add_(1.0),
                               {"y": torch.zeros(1 << 20, device=card)},
                               card, "graph")}
    junk["self"] = junk
    freed = weakref.ref(junk["graph"])
    holder.append(junk)
    del junk
    gc.set_threshold(1 << 30)
    gc.callbacks.append(watch)
    try:
        out = graphs((1, 8), lambda b: b["x"].fill_(3.0))
    finally:
        gc.set_threshold(*threshold)
        gc.callbacks.remove(watch)
    assert graphs._graphs[(1, 8)].warmup == 0
    assert not any(inside), "a collection ran inside the capture"
    gc.collect()
    assert freed() is None
    torch.cuda.synchronize()
    assert bool((out["out"] == 6.0).all())


def test_evicted_graph_is_freed(card):
    def buffers(shape):
        return {"x": torch.ones(shape, device=card),
                "out": torch.zeros((), device=card)}

    def step(b):
        b["out"].copy_((b["x"] * 2.0).sum())

    graphs = PrefillGraphs(step, buffers, card, "graph", max_graphs=1)
    graphs((1, 4), lambda b: None)
    old = weakref.ref(graphs._graphs[(1, 4)])
    old_graph = weakref.ref(graphs._graphs[(1, 4)].graph)
    out = graphs((1, 6), lambda b: None)
    assert old() is None and old_graph() is None
    assert graphs.stats()["evictions"] == 1 and graphs.count() == 1
    torch.cuda.synchronize()
    assert float(out["out"]) == 12.0

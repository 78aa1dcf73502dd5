"""Card-only: the executors' decode step as a captured CUDA graph.

For all six families at SMOKE size (fp32), on the same weights and the
same request stream (rows admitting and detaching mid-flight), the
executors with ``decode_impl="graph"`` give the per-request tokens of
the same executors with ``decode_impl="eager"``; the batched executor
captures one graph and replays it once per decode step, the per-slot
executor captures no more graphs than requests were live at once and
replays one per live request per step.  A replay launches nothing from
Python, so the kernels' counters see the warm-up and capture calls only.

Every test carries the ``cuda`` marker and skips without a card.  On a
machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_decode_graph_cuda.py
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.paged_attention import \
    paged_attention as pmod  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serve.batched_executor import (  # noqa: E402
    TorchBatchedExecutor, make_executor)
from repro_torch.serve.decode_graph import WARMUP, DecodeGraph  # noqa: E402
from repro_torch.serve.engine import (NO_SLO,  # noqa: E402
                                      ContinuousServeEngine, ServeRequest)

pytestmark = pytest.mark.cuda

SHAPES = [(5, 9), (130, 20), (60, 4), (17, 12), (99, 30), (3, 2), (40, 7)]


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


def _serve(cfg, params, decode_impl):
    ex, kv = make_executor(cfg, 160, 4, device="cuda", params=params,
                           decode_impl=decode_impl)
    rng = np.random.default_rng(1)
    reqs = [ServeRequest(rid=i, prompt_len=n, max_new=m,
                         prompt=rng.integers(0, cfg.vocab_size, n)
                         .astype(np.int32))
            for i, (n, m) in enumerate(SHAPES)]
    live = []
    orig = ex.decode

    def decode(rs):
        live.append(len(rs))
        return orig(rs)

    ex.decode = decode
    ContinuousServeEngine(4, ex, slo=NO_SLO, kv_cache=kv).run(reqs)
    return ex, [r.out_tokens for r in reqs], live


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "recurrentgemma-2b", "rwkv6-3b",
                                  "llava-next-mistral-7b", "whisper-medium"])
def test_graph_and_eager_executors_give_identical_tokens(card, arch):
    cfg = get_smoke(arch)
    params = init_params(cfg, torch.Generator(card).manual_seed(0), card)
    ex_g, toks_g, live = _serve(cfg, params, "graph")
    ex_e, toks_e, live_e = _serve(cfg, params, "eager")
    assert toks_g == toks_e and live == live_e
    assert max(live) == 4 and min(live) < 4          # rows churned
    g, e = ex_g.decode_graph_stats(), ex_e.decode_graph_stats()
    assert ex_e.decode_graph_count() == 0 and e["replays"] == 0
    batched = isinstance(ex_g, TorchBatchedExecutor)
    assert e["calls"] == (ex_e.decode_steps if batched else sum(live))
    if batched:
        assert ex_g.decode_graph_count() == 1
        assert g["replays"] == ex_g.decode_steps == len(live)
        assert g["calls"] == WARMUP + 1
    else:
        assert 1 <= ex_g.decode_graph_count() <= max(live)
        assert g["replays"] == sum(live)
        assert g["calls"] == (WARMUP + 1) * ex_g.decode_graph_count()


@pytest.mark.parametrize("arch", ["smollm-135m", "llava-next-mistral-7b",
                                  "whisper-medium"])
def test_static_server_graph_and_eager_give_identical_tokens(card, arch):
    """The static server's decode (one graph at the full batch, captured
    once, replayed for every group after its prefill cache is copied in)
    gives the tokens of the same server eager, on SMOKE in bf16 at batch
    4, six requests (a padded tail group): smollm-135m, llava (patches
    before the prompt, the ring dropping them) and whisper (flash
    cross-attention in every decode step)."""
    import dataclasses

    from repro_torch.launch.serve import Request, run_static_server

    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(card).manual_seed(0), card)
    rng = np.random.default_rng(2)
    shapes = [(rng.integers(0, cfg.vocab_size, 24).astype(np.int32),
               int(rng.integers(2, 9))) for _ in range(6)]
    toks, servers = {}, {}
    for mode in ("graph", "eager"):
        reqs = [Request(i, p, m) for i, (p, m) in enumerate(shapes)]
        servers[mode], out = run_static_server(
            cfg, reqs, 4, 8, 24, params=params, device=card,
            decode_impl=mode)
        assert out["tokens_generated"] == sum(m for _, m in shapes)
        toks[mode] = [r.out_tokens for r in reqs]
    assert toks["graph"] == toks["eager"]
    g = servers["graph"].decode_graph_stats()
    e = servers["eager"].decode_graph_stats()
    steps = servers["graph"].decode_steps
    assert (g["captures"], g["replays"], g["calls"]) == (1, steps,
                                                         WARMUP + 1)
    assert (e["captures"], e["replays"], e["calls"]) == (0, 0, steps)


def test_graph_replays_add_no_counted_launch(card):
    """A replay of a captured paged-attention call launches the kernel
    without a Python call: the counter moves by the warm-up and capture
    calls, the output by every replay."""
    b, hq, hkv, d, bt, nb = 2, 4, 2, 64, 16, 2
    g = torch.Generator(card).manual_seed(0)
    kp = torch.randn((hkv, b * nb + 1, bt, d), generator=g, device=card)
    bufs = {"q": torch.randn((b, hq, d), generator=g, device=card),
            "out": torch.zeros((b, hq, d), device=card)}
    tables = torch.arange(b * nb, device=card,
                          dtype=torch.int32).reshape(b, nb)
    lengths = torch.tensor([5, 20], device=card, dtype=torch.int32)

    def step(bf):
        bf["out"].copy_(pmod.paged_attention(bf["q"], kp, kp, tables,
                                             lengths))

    n0 = pmod.LAUNCHES
    graph = DecodeGraph(step, bufs, card, "graph")
    assert pmod.LAUNCHES == n0 + WARMUP + 1
    for scale in (2.0, -1.0):
        bufs["q"].mul_(scale)
        want = pmod.paged_attention(bufs["q"], kp, kp, tables, lengths)
        graph()
        torch.cuda.synchronize()
        assert torch.equal(bufs["out"], want)
    assert graph.replays == 2 and pmod.LAUNCHES == n0 + WARMUP + 1 + 2


def test_capture_collects_no_garbage_inside(card):
    """Garbage that becomes collectable during a capture — a reference
    cycle holding a captured graph and a pinned host tensor that fed a
    non-blocking copy, as an executor its caller dropped does — is not
    collected inside the capture, even with a collection due at every
    allocation there (freeing it makes CUDA calls that may end the
    capture); it is collected after, and the graph captures and
    replays."""
    threshold = gc.get_threshold()
    gc.set_threshold(1 << 30)       # no collection until the capture
    pinned = torch.ones(1 << 16, pin_memory=True)
    freed = weakref.ref(pinned)
    bufs = {"x": torch.empty(1 << 16, device=card)}
    bufs["x"].copy_(pinned, non_blocking=True)
    old = DecodeGraph(lambda b: b["y"].add_(1.0),
                      {"y": torch.zeros(1 << 20, device=card)}, card,
                      "graph")
    junk = {"pinned": pinned, "graph": old}
    junk["self"] = junk
    holder = [junk]
    del junk, pinned, old
    inside = []

    def watch(phase, info):
        if phase == "start":
            inside.append(torch.cuda.is_current_stream_capturing())

    def step(b):
        if torch.cuda.is_current_stream_capturing():
            holder.clear()              # the cycle is garbage from here on
            gc.set_threshold(1, 1, 1)   # and a collection is due at once
        keep = [b["x"] * 2.0 for _ in range(8)]
        b["x"].copy_(keep[-1])

    gc.callbacks.append(watch)
    try:
        graph = DecodeGraph(step, bufs, card, "graph")
    finally:
        gc.set_threshold(*threshold)
        gc.callbacks.remove(watch)
    assert not any(inside), "a collection ran inside the capture"
    gc.collect()
    assert freed() is None              # it was garbage, collected after
    graph()
    torch.cuda.synchronize()
    # the two warm-ups and the replay each doubled x
    assert bool((bufs["x"] == 8.0).all())

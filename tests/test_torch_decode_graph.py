"""The executors' decode step over static buffers, on the CPU.

On the CPU both executors run the graph path's bookkeeping — static
device buffers filled from host arrays, the per-slot pool of static
caches — with a direct call of the step in place of a replay
(``decode_impl="auto"`` is "eager" here).  These tests hold that
bookkeeping to what the graph needs, at SMOKE size:

* the in-place decode step gives ``decode_step``'s logits and cache bit
  for bit, with every cache leaf at its old address, for all six
  families (enc-dec through ``whisper``, with random frames);
* the batched executor's buffers and page pools, and every leaf of every
  per-slot entry, keep their addresses across admission and detach;
* a request admitted into an entry that a longer request left gives the
  tokens it gets in a fresh executor (for whisper the entry's ring
  length changes too);
* ``decode_impl`` accepts "auto", "graph" and "eager", and "graph" raises
  without CUDA.

The token identity with the reference (the engine over
``JaxBatchedExecutor`` / ``JaxSlotExecutor``) is held by
``test_torch_serve.py`` and ``test_torch_slot_executor.py``; the graph
itself by the card-only ``test_torch_decode_graph_cuda.py``.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serve.batched_executor import (  # noqa: E402
    TorchBatchedExecutor, make_executor)
from repro_torch.serve.decode_graph import (  # noqa: E402
    DecodeGraph, resolve_decode_impl)
from repro_torch.serve.engine import (NO_SLO,  # noqa: E402
                                      ContinuousServeEngine, ServeRequest)
from repro_torch.serve.slot_executor import (  # noqa: E402
    TorchSlotExecutor, slot_kv_cache)

FAMILIES = ["smollm-135m", "deepseek-moe-16b", "recurrentgemma-2b",
            "rwkv6-3b", "llava-next-mistral-7b", "whisper-medium"]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _ptrs(tree):
    return {p: t.data_ptr() for p, t in _leaves(tree)}


def _requests(vocab, shapes, seed=2):
    rng = np.random.default_rng(seed)
    return [ServeRequest(rid=i, prompt_len=n, max_new=m,
                         prompt=rng.integers(0, vocab, n).astype(np.int32))
            for i, (n, m) in enumerate(shapes)]


# a stream whose requests admit and detach while others decode
CHURN = [(5, 6), (12, 3), (7, 9), (3, 2), (10, 5), (6, 7), (9, 4)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_inplace_matches_decode_step(arch):
    """Three steps from a prefill cache: logits and every cache leaf
    bit-identical to ``decode_step``'s, each leaf of the in-place cache
    at the address it had before the first step."""
    cfg = get_smoke(arch)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (1, 9))),
             **{k: torch.randn(v.shape, generator=gen)
                for k, v in model.frontend_inputs(cfg, 1).items()}}
    with torch.inference_mode():
        logits, cache = model.prefill_fn(cfg, max_len=24)(params, batch)
        ref_cache = copy.deepcopy(cache)
        before = _ptrs(cache)
        tok = torch.argmax(logits, -1)
        for _ in range(3):
            want, ref_cache = model.decode_fn(cfg)(params, tok, ref_cache)
            got = model.decode_inplace_fn(cfg)(params, tok, cache)
            assert torch.equal(got, want)
            tok = torch.argmax(want, -1)
    assert _ptrs(cache) == before
    ref = dict(_leaves(ref_cache))
    for path, leaf in _leaves(cache):
        assert torch.equal(leaf, ref[path]), path
    assert int(cache["pos"][0]) == 9 + 3 + cfg.num_patches


def _run_engine(ex, kv, reqs, n_slots, on_decode=None):
    if on_decode is not None:
        orig = ex.decode

        def decode(rs):
            on_decode(rs)
            return orig(rs)
        ex.decode = decode
    ContinuousServeEngine(n_slots, ex, slo=NO_SLO, kv_cache=kv).run(reqs)
    return [r.out_tokens for r in reqs]


def test_batched_buffers_keep_their_addresses():
    cfg = get_smoke("smollm-135m")
    ex = TorchBatchedExecutor(cfg, 32, 3, device="cpu")
    # built with every row inactive, as the graph is captured
    assert not ex._len.any() and (ex._tables == ex.null_page).all()
    bufs = ex._graph.buffers
    before = {**_ptrs(bufs), "kp": ex._kp.data_ptr(),
              "vp": ex._vp.data_ptr()}
    seen = []

    def check(rs):
        seen.append(len(rs))
        assert {**_ptrs(bufs), "kp": ex._kp.data_ptr(),
                "vp": ex._vp.data_ptr()} == before

    reqs = _requests(cfg.vocab_size, CHURN)
    _run_engine(ex, ex.kv, reqs, 3, check)
    assert max(seen) == 3 and min(seen) < 3            # rows churned
    check([])
    assert all(len(r.out_tokens) == r.max_new for r in reqs)
    stats = ex.decode_graph_stats()
    assert ex.decode_graph_count() == 0 == stats["captures"]
    assert stats["replays"] == 0
    assert stats["calls"] == ex.decode_steps == len(seen) - 1
    assert ex.decode_shape_count() == 1


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b",
                                  "llava-next-mistral-7b", "whisper-medium"])
def test_slot_entries_keep_their_addresses(arch):
    """Every entry's leaves stay where they were made; a live request's
    cache is its entry's; the pool holds the ``n_slots`` entries
    ``make_executor`` has the executor make when built, and no more."""
    cfg = get_smoke(arch)
    ex, kv = make_executor(cfg, 24, 3, device="cpu")
    assert isinstance(ex, TorchSlotExecutor)
    assert len(ex._pool) == 3 == len(ex._spare)
    made = {}
    peak = [0]

    def check(rs):
        peak[0] = max(peak[0], len(rs))
        for e in ex._pool:
            made.setdefault(id(e), _ptrs(e.buffers))
            assert _ptrs(e.buffers) == made[id(e)]
        for r in rs:
            entry = ex._entries[r.rid]
            assert ex._caches[r.rid] is entry.buffers["cache"]
            assert ex._tok[r.rid] is entry.buffers["tok"]

    reqs = _requests(cfg.vocab_size, CHURN)
    _run_engine(ex, kv, reqs, 3, check)
    check([])
    assert peak[0] == 3
    assert len(ex._pool) == 3 == len(ex._spare) and not ex._entries
    stats = ex.decode_graph_stats()
    assert ex.decode_graph_count() == 0 == stats["replays"]
    assert stats["calls"] == sum(r.max_new - 1 for r in reqs)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b",
                                  "mixtral-8x7b", "llava-next-mistral-7b",
                                  "whisper-medium"])
def test_reused_entry_gives_a_fresh_executors_tokens(arch):
    """One slot: a 12-token prompt decodes 9 steps, then a 5-token prompt
    takes the entry it left (its pos, states and ring all further on);
    the second request's tokens equal those of a fresh executor."""
    cfg = get_smoke(arch)
    long_, short = _requests(cfg.vocab_size, [(12, 10), (5, 6)])
    ex = TorchSlotExecutor(cfg, 24, device="cpu")
    _run_engine(ex, slot_kv_cache(24, 1), [long_, short], 1)
    assert len(ex._pool) == 1 and ex.prefills == 2
    fresh = TorchSlotExecutor(cfg, 24, device="cpu")
    alone = _requests(cfg.vocab_size, [(12, 10), (5, 6)])[1]
    _run_engine(fresh, slot_kv_cache(24, 1), [alone], 1)
    assert short.out_tokens == alone.out_tokens
    assert len(short.out_tokens) == 6


def test_slot_prefill_refuses_a_cache_of_another_layout():
    cfg = get_smoke("rwkv6-3b")
    ex = TorchSlotExecutor(cfg, 16, device="cpu")
    ex.prefill(_requests(cfg.vocab_size, [(4, 2)]))
    entry = ex._entries[0]
    ex.release(ServeRequest(rid=0, prompt_len=4, max_new=2))
    # an entry whose state leaf has another dtype: the prefill raises
    # rather than cast
    entry.buffers["cache"]["blocks"]["tm"]["s"] = \
        entry.buffers["cache"]["blocks"]["tm"]["s"].double()
    with pytest.raises(ValueError, match="blocks/tm/s"):
        ex.prefill(_requests(cfg.vocab_size, [(4, 2)]))


@pytest.mark.parametrize("impl,device,want", [
    ("auto", "cpu", "eager"), ("eager", "cpu", "eager"),
    ("auto", "cuda", "graph"), ("graph", "cuda", "graph"),
    ("eager", "cuda", "eager")])
def test_resolve_decode_impl(impl, device, want):
    assert resolve_decode_impl(impl, torch.device(device)) == want


def test_decode_impl_graph_raises_on_cpu_and_unknown_raises():
    cfg = get_smoke("smollm-135m")
    for impl, match in (("graph", "needs a CUDA device"),
                        ("jit", "unknown decode_impl")):
        with pytest.raises(ValueError, match=match):
            DecodeGraph(lambda b: None, {}, torch.device("cpu"), impl)
        with pytest.raises(ValueError, match=match):
            TorchBatchedExecutor(cfg, 32, 2, device="cpu", decode_impl=impl)
        with pytest.raises(ValueError, match=match):
            TorchSlotExecutor(cfg, 32, device="cpu", decode_impl=impl)
        with pytest.raises(ValueError, match=match):
            make_executor(get_smoke("rwkv6-3b"), 32, 2, device="cpu",
                          decode_impl=impl)


def test_decode_graph_direct_calls_on_cpu():
    buf = {"x": torch.zeros(3)}
    g = DecodeGraph(lambda b: b["x"].add_(1.0), buf, torch.device("cpu"))
    assert g.mode == "eager" and g.graph is None
    for _ in range(4):
        g()
    assert buf["x"].tolist() == [4.0] * 3
    assert (g.calls, g.replays, g.captures) == (4, 0, 0)

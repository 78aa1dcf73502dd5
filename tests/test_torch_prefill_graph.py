"""The compiled prefill's static buffers, on the CPU.

On the CPU ``prefill_impl="auto"`` is "eager": the same static buffers
as the graph path — one set per prompt shape, filled from host arrays —
with a direct call of the step in place of a replay.  These tests hold
that bookkeeping to what the graph needs, at SMOKE size in fp32, for
smollm-135m, deepseek-moe-16b, recurrentgemma-2b and rwkv6-3b, and for
the owners the reference gives them (the per-slot executor, the static
server) llava-next-mistral-7b and whisper-medium, whose stub front ends
read the owners' static zero patches / frames:

* each owner's prefill through its static buffers — the batched
  executor's (cache scattered into the page pools), the per-slot
  executor's (landing cache copied into the request's entry) and the
  static ``Server``'s (written into the decode graph's cache) — gives a
  direct ``model.prefill_fn``'s token and cache bit for bit, and the
  reference's prefill (``transformer.prefill``, or ``whisper.prefill``
  whose prompt + 64 ring fills the first slots of the port's buffer;
  the same weights through
  ``params_from_numpy``) within ``tests/test_torch_model.py``'s prefill
  tolerance: cache atol/rtol 1e-5, 1e-4 for the ssm family's WKV states
  (hundreds of summed outer products, in another order);
* the engine over both executors, with a bound of 2 graphs over three
  prompt lengths, gives the reference executors' tokens and report;
* static inputs keep their addresses across prefills of one length;
* ``PrefillGraphs`` evicts the least recently used shape at its bound,
  and a length seen again after its eviction is built anew;
* ``prefill_impl`` accepts "auto", "graph" and "eager", and "graph"
  raises without CUDA;
* a per-slot executor given ``n_slots`` makes its entries when built and
  none in ``prefill``.

The graph itself (capture, replay, launch counts, eviction freeing the
graph) is held by the card-only ``test_torch_prefill_graph_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models import whisper as jw  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.batched_executor import JaxBatchedExecutor  # noqa: E402
from repro.serve.jax_executor import JaxSlotExecutor  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as JPagedKVCache  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.serve import (Request, Server,  # noqa: E402
                                      TickClock, run_static_server)
from repro_torch.models import model, transformer  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.batched_executor import (  # noqa: E402
    TorchBatchedExecutor, make_executor)
from repro_torch.serve.prefill_graph import (  # noqa: E402
    MAX_PREFILL_GRAPHS, PrefillGraphs, resolve_prefill_impl)
from repro_torch.serve.slot_executor import TorchSlotExecutor  # noqa: E402
from repro_torch.step_graph import StepGraph  # noqa: E402

FAMILIES = ["smollm-135m", "deepseek-moe-16b", "recurrentgemma-2b",
            "rwkv6-3b"]
# the per-slot and static owners also serve these
SLOT_FAMILIES = FAMILIES + ["llava-next-mistral-7b", "whisper-medium"]
PAGED = ["smollm-135m", "deepseek-moe-16b"]
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
SSM_TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 24


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        assert torch.equal(got[path], leaf), path


def _direct_prefill(params, cfg, toks):
    """A direct prefill of the prompts ``toks`` (b, s) with the owners'
    zero front-end inputs, into a cache of the owners' length."""
    batch = {"tokens": torch.from_numpy(toks.astype(np.int64)),
             **model.frontend_inputs(cfg, toks.shape[0])}
    prefill = model.prefill_fn(cfg, max_len=MAX_LEN)
    with torch.inference_mode():
        return prefill(params, batch)


def _reference_prefill(jp, jcfg, toks):
    """The reference's prefill as its executors and static server call
    it: zero patches / frames; whisper's without ``max_len``."""
    batch = {"tokens": jnp.asarray(toks)}
    b, d = toks.shape[0], jcfg.d_model
    if jcfg.family == "vlm":
        batch["patches"] = jnp.zeros((b, jcfg.num_patches, d),
                                     jcfg.compute_dtype)
    if jcfg.family == "encdec":
        batch["frames"] = jnp.zeros((b, jcfg.encoder_positions, d),
                                    jcfg.compute_dtype)
        return jw.prefill(jp, batch, jcfg)
    return jtf.prefill(jp, batch, jcfg, max_len=MAX_LEN)


def _assert_close_to_reference(got, jwant, cfg):
    tol = SSM_TOL if cfg.family == "ssm" else CACHE_TOL
    if cfg.family == "encdec":
        # the reference's ring in the first slots of the port's buffer
        ring = jwant["blocks"]["k"].shape[2]
        assert (got["pos"].numpy() == int(jwant["pos"])).all()
        assert (got["ring"].numpy() == ring).all()
        got = {"blocks": {k: v[:, :, :ring]
                          for k, v in got["blocks"].items()},
               "enc_out": got["enc_out"]}
        jwant = {"blocks": jwant["blocks"], "enc_out": jwant["enc_out"]}
    got, want = dict(_leaves(got)), dict(_leaves(jwant))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path].numpy(), np.asarray(leaf),
                                   err_msg=path, **tol)


def _setup(arch):
    jcfg, cfg = jsmoke(arch), get_smoke(arch)
    jp = jinit.init_params(jcfg, jax.random.key(0))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _requests(mod, cfg, lens, max_new=3, seed=3):
    return [mod.ServeRequest(rid=i, prompt_len=len(p), max_new=max_new,
                             prompt=p)
            for i, p in enumerate(_prompts(cfg, lens, seed))]


def _pages(jc, jcfg, cfg, n_pages, block_tokens, table, s):
    """The reference's pools after scattering its prefill cache ``jc`` at
    the page ids / offsets of ``table`` for ``s`` positions."""
    shape = transformer.paged_kv_shape(cfg, n_pages, block_tokens)
    pos = np.arange(s)
    page_ids = jnp.asarray(np.asarray(table, np.int32)[pos // block_tokens])
    offs = jnp.asarray((pos % block_tokens).astype(np.int32))
    zeros = jnp.zeros(shape, jnp.float32)
    return jtf.scatter_prefill_pages(jc, jcfg, zeros, zeros, page_ids, offs)


@pytest.mark.parametrize("arch", PAGED)
def test_batched_prefill_matches_direct_and_reference(arch):
    """Two prompt lengths, one seen twice: each request's token and its
    pages bit for bit as a direct prefill scattered into fresh pools,
    and within the cache tolerance of the reference's."""
    jcfg, cfg, jp, params = _setup(arch)
    ex = TorchBatchedExecutor(cfg, MAX_LEN, 3, device="cpu", params=params)
    reqs = _requests(teng, cfg, [9, 13, 9])
    for r in reqs:
        ex.kv.allocate(r.rid, r.prompt_len)
    toks, _ = ex.prefill(reqs)
    assert ex.prefill_graph_stats()["calls"] == 3
    assert list(ex._prefills._graphs) == [(1, 13), (1, 9)]
    kp, vp = torch.zeros_like(ex._kp), torch.zeros_like(ex._vp)
    bt = ex.block_tokens
    with torch.inference_mode():
        for r, tok in zip(reqs, toks):
            tokens = torch.from_numpy(r.prompt[None].astype(np.int64))
            logits, cache = transformer.prefill(params, {"tokens": tokens},
                                                cfg, max_len=MAX_LEN)
            assert tok == int(torch.argmax(logits, -1)[0])
            table = np.asarray(ex.kv.block_table(r.rid), np.int64)
            pos = np.arange(r.prompt_len)
            transformer.scatter_prefill_pages(
                cache, cfg, kp, vp, torch.from_numpy(table[pos // bt]),
                torch.from_numpy(pos % bt))
            jl, jc = jtf.prefill(jp, {"tokens": jnp.asarray(r.prompt[None])},
                                 jcfg, max_len=MAX_LEN)
            assert tok == int(jnp.argmax(jl, -1)[0])
            jkp, jvp = _pages(jc, jcfg, cfg, ex._kp.shape[2], bt, table,
                              r.prompt_len)
            pages = sorted(set(table[pos // bt].tolist()))
            for got, want in ((ex._kp, jkp), (ex._vp, jvp)):
                np.testing.assert_allclose(
                    got[:, :, pages].numpy(),
                    np.asarray(want)[:, :, pages], **CACHE_TOL)
    assert torch.equal(ex._kp, kp) and torch.equal(ex._vp, vp)


@pytest.mark.parametrize("arch", SLOT_FAMILIES)
def test_slot_prefill_matches_direct_and_reference(arch):
    """Each request's entry holds a direct prefill's cache and token bit
    for bit, and the reference's within the cache tolerance; the landing
    cache is one tree for every length."""
    jcfg, cfg, jp, params = _setup(arch)
    ex = TorchSlotExecutor(cfg, MAX_LEN, device="cpu", params=params,
                           n_slots=3)
    reqs = _requests(teng, cfg, [7, 12, 7])
    toks, _ = ex.prefill(reqs)
    assert list(ex._prefills._graphs) == [(1, 12), (1, 7)]
    for (_, b1), (_, b2) in zip(
            _leaves(ex._prefills._graphs[(1, 7)].buffers["cache"]),
            _leaves(ex._prefills._graphs[(1, 12)].buffers["cache"])):
        assert b1 is b2
    for r, tok in zip(reqs, toks):
        logits, cache = _direct_prefill(params, cfg, r.prompt[None])
        assert tok == int(torch.argmax(logits, -1)[0])
        assert torch.equal(ex._tok[r.rid], torch.argmax(logits, -1))
        _assert_trees_equal(ex._caches[r.rid], cache)
        jl, jc = _reference_prefill(jp, jcfg, r.prompt[None])
        assert tok == int(jnp.argmax(jl, -1)[0])
        _assert_close_to_reference(ex._caches[r.rid], jc, cfg)


@pytest.mark.parametrize("arch", SLOT_FAMILIES)
def test_static_server_prefill_matches_direct_and_reference(arch):
    """The group prefill at batch 3 writes a direct batch-3 prefill's
    cache and tokens into the decode graph's static buffers, bit for
    bit, and the reference's within the cache tolerance."""
    jcfg, cfg, jp, params = _setup(arch)
    server = Server(cfg, 3, MAX_LEN, params=params, device="cpu")
    toks = np.stack(_prompts(cfg, [10, 10, 10]))
    with torch.inference_mode():
        first = server._prefill_batch(toks)
    logits, cache = _direct_prefill(params, cfg, toks)
    bufs = server._graph.buffers
    assert first.tolist() == torch.argmax(logits, -1).tolist()
    assert torch.equal(bufs["tok"], torch.argmax(logits, -1))
    _assert_trees_equal(bufs["cache"], cache)
    jl, jc = _reference_prefill(jp, jcfg, toks)
    assert first.tolist() == np.asarray(jnp.argmax(jl, -1)).tolist()
    _assert_close_to_reference(bufs["cache"], jc, cfg)
    assert server.prefill_graph_stats()["calls"] == 1
    assert server.prefill_graph_count() == 0


# three prompt lengths over seven requests through three slots: lengths
# repeat, and a bound of 2 evicts (a length comes back after its eviction)
ENGINE_LENS = [7, 12, 9, 7, 12, 9, 7]


@pytest.mark.parametrize("arch", SLOT_FAMILIES)
def test_engine_with_bounded_prefill_graphs_matches_reference(arch):
    jcfg, cfg = jsmoke(arch), get_smoke(arch)
    n_slots, max_len = 3, 20
    batched = arch in PAGED
    if batched:
        jex = JaxBatchedExecutor(jcfg, max_len, n_slots,
                                 clock=jserve.TickClock(1.0),
                                 attn_impl="ref")
        jkv = jex.kv
    else:
        jex = JaxSlotExecutor(jcfg, max_len, clock=jserve.TickClock(1.0))
        bt = min(128, max_len)
        jkv = JPagedKVCache(n_slots * -(-max_len // bt), bt)
    slo = dict(ttft=6.0, tpot=2.0)
    jreqs = _requests(jeng, jcfg, ENGINE_LENS, max_new=4)
    jrep = jeng.ContinuousServeEngine(n_slots, jex, slo=jeng.ServeSLO(**slo),
                                      kv_cache=jkv).run(jreqs)
    params = params_from_numpy(jax.tree.map(np.asarray, jex.params), "cpu")
    tex, kv = make_executor(cfg, max_len, n_slots, clock=TickClock(1.0),
                            device="cpu", params=params,
                            max_prefill_graphs=2)
    assert isinstance(tex, TorchBatchedExecutor) == batched
    treqs = _requests(teng, cfg, ENGINE_LENS, max_new=4)
    trep = teng.ContinuousServeEngine(n_slots, tex, slo=teng.ServeSLO(**slo),
                                      kv_cache=kv).run(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, f"request {tr.rid}"
    assert trep.as_dict() == jrep.as_dict()
    stats = tex.prefill_graph_stats()
    assert stats["calls"] == tex.prefills == len(ENGINE_LENS)
    assert stats["evictions"] >= 1 and stats["replays"] == 0
    assert len(tex._prefills._graphs) == 2


def _ptrs(tree):
    return {p: t.data_ptr() for p, t in _leaves(tree)}


def test_static_inputs_keep_their_addresses():
    """Three prefills of one length through each owner: every static
    buffer of that shape stays where it was made, and the per-slot and
    static owners' caches are the owner's own tensors."""
    cfg = get_smoke("smollm-135m")
    ex = TorchBatchedExecutor(cfg, MAX_LEN, 3, device="cpu")
    sl = TorchSlotExecutor(get_smoke("rwkv6-3b"), MAX_LEN, device="cpu",
                           n_slots=3)
    server = Server(cfg, 2, MAX_LEN, device="cpu")
    seen = {}
    for i in range(3):
        reqs = _requests(teng, cfg, [8], seed=i)
        reqs[0].rid = i
        ex.kv.allocate(i, 8)
        ex.prefill(reqs)
        ex.release(reqs[0])
        ex.kv.free(i)
        sl.prefill(reqs)
        sl.release(reqs[0])
        with torch.inference_mode():
            server._prefill_batch(np.stack(_prompts(cfg, [8, 8], seed=i)))
        now = {"batched": _ptrs(ex._prefills._graphs[(1, 8)].buffers),
               "slot": _ptrs(sl._prefills._graphs[(1, 8)].buffers),
               "static": _ptrs(server._prefills._graphs[(2, 8)].buffers)}
        assert now == seen.setdefault("first", now)
    assert (sl._prefills._graphs[(1, 8)].buffers["cache"]
            is sl._landing["cache"])
    bufs = server._prefills._graphs[(2, 8)].buffers
    assert bufs["cache"] is server._graph.buffers["cache"]
    assert bufs["tok"] is server._graph.buffers["tok"]


def test_lru_evicts_least_recently_used_and_rebuilds():
    """A bound of 2 over lengths 3, 5, 3, 7, 5: 7 evicts 5 (3 was used
    more recently), and 5 then evicts 3 and is built anew with fresh
    buffers that give the right output."""
    made = []

    def buffers(shape):
        made.append(shape)
        return {"x": torch.zeros(shape), "out": torch.zeros(())}

    def step(b):
        b["out"].copy_(b["x"].sum())

    graphs = PrefillGraphs(step, buffers, torch.device("cpu"),
                           max_graphs=2)
    assert graphs.mode == "eager" and graphs.max_graphs == 2
    for n in (3, 5, 3, 7, 5):
        out = graphs((1, n), lambda b, n=n: b["x"].fill_(float(n)))
        assert float(out["out"]) == n * n
    assert made == [(1, 3), (1, 5), (1, 7), (1, 5)]
    assert list(graphs._graphs) == [(1, 7), (1, 5)]
    stats = graphs.stats()
    assert stats["evictions"] == 2 and stats["calls"] == 5
    assert stats["captures"] == stats["replays"] == graphs.count() == 0
    with pytest.raises(ValueError, match="max_prefill_graphs"):
        PrefillGraphs(step, buffers, torch.device("cpu"), max_graphs=0)
    assert MAX_PREFILL_GRAPHS == 32


@pytest.mark.parametrize("impl,device,want", [
    ("auto", "cpu", "eager"), ("eager", "cpu", "eager"),
    ("auto", "cuda", "graph"), ("graph", "cuda", "graph"),
    ("eager", "cuda", "eager")])
def test_resolve_prefill_impl(impl, device, want):
    assert resolve_prefill_impl(impl, torch.device(device)) == want


def test_prefill_impl_graph_raises_on_cpu_and_unknown_raises():
    cfg, rw = get_smoke("smollm-135m"), get_smoke("rwkv6-3b")
    for impl, match in (("graph", "needs a CUDA device"),
                        ("jit", "unknown prefill_impl")):
        with pytest.raises(ValueError, match=match):
            PrefillGraphs(lambda b: None, dict, torch.device("cpu"), impl)
        with pytest.raises(ValueError, match=match):
            TorchBatchedExecutor(cfg, 32, 2, device="cpu",
                                 prefill_impl=impl)
        with pytest.raises(ValueError, match=match):
            TorchSlotExecutor(rw, 32, device="cpu", prefill_impl=impl)
        with pytest.raises(ValueError, match=match):
            make_executor(rw, 32, 2, device="cpu", prefill_impl=impl)
        with pytest.raises(ValueError, match=match):
            Server(cfg, 2, 32, device="cpu", prefill_impl=impl)
        with pytest.raises(ValueError, match=match):
            run_static_server(cfg, [Request(0, np.zeros(4, np.int32), 2)],
                              2, 2, 4, device="cpu", prefill_impl=impl)


def test_step_graph_warmup_argument():
    with pytest.raises(ValueError, match="warmup"):
        StepGraph(lambda b: None, {}, torch.device("cpu"), warmup=-1)
    g = StepGraph(lambda b: b["x"].add_(1.0), {"x": torch.zeros(2)},
                  torch.device("cpu"), warmup=0)
    g()
    assert (g.calls, g.replays, g.captures, g.warmup) == (1, 0, 0, 0)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_slot_entries_are_made_at_construction(arch):
    """``n_slots`` entries when built (make_executor passes its slots),
    none made in ``prefill``; without ``n_slots`` the pool grows."""
    cfg = get_smoke(arch)
    ex, kv = make_executor(cfg, MAX_LEN, 3, device="cpu")
    assert ex.n_slots == 3 and len(ex._pool) == len(ex._spare) == 3
    pool = list(ex._pool)
    made = ex._new_entry

    def refuse():
        raise AssertionError("an entry made in prefill")

    ex._new_entry = refuse
    reqs = _requests(teng, cfg, [5, 9, 5, 9, 6], max_new=3)
    teng.ContinuousServeEngine(3, ex, slo=teng.NO_SLO, kv_cache=kv).run(reqs)
    assert ex._pool == pool and len(ex._spare) == 3
    ex._new_entry = made
    grow = TorchSlotExecutor(cfg, MAX_LEN, device="cpu")
    assert grow.n_slots is None and not grow._pool
    grow.prefill(_requests(teng, cfg, [5, 6]))
    assert len(grow._pool) == 2

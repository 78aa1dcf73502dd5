"""The port's sharded steps for the hybrid and ssm families
(``launch.strategy.ShardedTrainStep``, ``ShardedPrefillStep``,
``ShardedDecodeStep``) on 4 gloo ranks, a (2, 2) ("data", "model")
mesh, against the reference's ``jit_train_step``, ``jit_prefill_step``
and ``jit_decode_step`` on a 4-device CPU mesh of Auto axes, their
inputs ``device_put`` to the jits' shardings: recurrentgemma-2b SMOKE
(the RG-LRU scan on each rank's channels, MQA local attention over a
16-slot window ring split over model) and rwkv6-3b SMOKE (the WKV on
each rank's heads, 4 heads of 16: two a model rank), (4, 32) tokens from
``np.random.default_rng(3)``, 2 train steps from the reference's
initial state, a prefill into the reference's default 96-slot cache and
4 greedy decode steps, fp32:

* hybrid: losses within TOL and every parameter and AdamW moment within
  PARAM_ATOL (``tests/test_torch_sharded_train.py``'s bounds), the
  gradients at the first batch within TOL; prefill and decode logits
  and every cache leaf within TOL, greedy tokens equal;
* ssm: the bounds of its one-process parity tests
  (``tests/test_torch_train_step.py``: losses SSM_LOSS_ATOL, each leaf's
  update SSM_UPDATE_RTOL, gradients SSM_GRAD_SHARE of each leaf's
  largest element; ``tests/test_torch_rwkv.py``'s logits TOL for the
  serving steps): the reference's chunked WKV drifts from the exact
  recurrence the port computes;
* the replicated ``lru_a`` and ``bonus`` leaves' gradients (summed over
  the ranks that split the batch) are compared on their own;
* every cache leaf is laid out by ``cache_placements`` and each rank
  holds only its blocks; the decode keeps every block at its address;
* one train step's collectives by kind, none named by a scan's region
  (``rglru_scan``, ``rwkv6_wkv``: the recurrences run on each rank's
  channels / heads with no collective);
* with no ranks, the scans on channel / head halves (as two model ranks
  hold them), forward and reverse through autograd, stitched back equal
  the whole call;
* at world size 1 (a gloo group in this process) the three steps equal
  the unsharded ones bit for bit.

The enc-dec and vlm families' sharded steps are held in
``tests/test_torch_sharded_encdec.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_mesh import auto_mesh, run_reference, save, spawn  # noqa: E402

CASES = {"hybrid": "recurrentgemma-2b", "ssm": "rwkv6-3b"}
TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL = 1e-4
# the ssm's bounds, those of its one-process parity tests (their notes
# say why): tests/test_torch_train_step.py and tests/test_torch_rwkv.py
SSM_LOSS_ATOL = 5e-4
SSM_UPDATE_RTOL = 0.02
SSM_GRAD_SHARE = 1e-3
SSM_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, STEPS, DECODE = 4, 32, 2, 4
MAX_LEN = S + 64                     # the reference's default cache
SCAN_REGIONS = ("rglru_scan", "rwkv6_wkv")


def _tokens(vocab: int):
    rng = np.random.default_rng(3)
    return rng.integers(0, vocab, (STEPS, B, S), dtype=np.int32)


def reference(out):
    import jax

    from repro.configs import get_smoke
    from repro.launch import strategy
    from repro.models import model
    from repro.models.config import ShapeConfig
    from repro.optim import AdamWConfig
    from repro.parallel import sharding as shlib
    from repro.parallel.ctx import parallel_ctx

    mesh = auto_mesh()
    res = {}
    for case, arch in CASES.items():
        cfg = get_smoke(arch)
        fn, _, ctx = strategy.jit_train_step(
            cfg, ShapeConfig("t", "train", S, B), mesh, AdamWConfig())
        state = strategy.init_train_state(cfg, jax.random.PRNGKey(0), mesh)
        res[case, "state0"] = jax.tree.map(np.asarray, state)
        # the train step donates its state: the params again, for the rest
        params = jax.device_put(res[case, "state0"]["params"],
                                shlib.param_shardings(cfg, mesh))
        toks = _tokens(cfg.vocab_size)
        tok_sh = strategy.named(mesh, shlib.batch_pspecs(
            cfg, {"tokens": toks[0]}, mesh))
        grad = jax.jit(jax.grad(lambda p, b: model.loss_fn(cfg)(p, b)[0]),
                       in_shardings=(shlib.param_shardings(cfg, mesh),
                                     tok_sh))
        with parallel_ctx(ctx):
            res[case, "grads"] = jax.tree.map(
                np.asarray, grad(params, {"tokens": toks[0]}))
            losses = []
            for t in toks:
                state, m = fn(state, {"tokens": t})
                losses.append(float(m["loss"]))
        res[case, "losses"] = losses
        res[case, "state"] = jax.tree.map(np.asarray, state)

        pfn, _, ctx = strategy.jit_prefill_step(
            cfg, ShapeConfig("p", "prefill", S, B), mesh)
        dfn, (_, tok_abs, cache_abs), _ = strategy.jit_decode_step(
            cfg, ShapeConfig("d", "decode", MAX_LEN, B), mesh)
        batch = jax.device_put({"tokens": toks[0]}, tok_sh)
        with parallel_ctx(ctx):
            logits, cache = pfn(params, batch)
            res[case, "logits"] = [np.asarray(logits)]
            res[case, "prefill_cache"] = jax.tree.map(np.asarray, cache)
            cache = jax.device_put(cache, strategy.named(
                mesh, shlib.cache_pspecs(cfg, cache_abs, mesh)))
            step_sh = strategy.named(mesh, shlib.batch_pspecs(cfg, tok_abs,
                                                              mesh))
            tokens = []
            for _ in range(DECODE):
                tok = np.asarray(logits).argmax(-1).astype(np.int32)
                tokens.append(tok)
                logits, cache = dfn(params, jax.device_put(tok, step_sh),
                                    cache)
                res[case, "logits"].append(np.asarray(logits))
        res[case, "tokens"] = tokens
        res[case, "cache"] = jax.tree.map(np.asarray, cache)
    save(res, out)


def _placements(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: tuple(t.placements), tree)


def port(rank, mesh, ref):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shlib
    from repro_torch.parallel.ctx import parallel_ctx
    from repro_torch.tree import flatten, tree_map

    res = {}
    for case, arch in CASES.items():
        cfg = get_smoke(arch)
        state0 = tree_map(lambda a: torch.from_numpy(np.array(a)),
                          ref[case, "state0"])
        toks = [torch.from_numpy(t) for t in _tokens(cfg.vocab_size)]
        st = strategy.ShardedTrainStep(cfg, AdamWConfig(), mesh, state0, B,
                                       S, step_impl="eager")
        r = {"losses": [float(st({"tokens": t})["loss"]) for t in toks],
             "state": tree_map(lambda t: t.full_tensor().numpy(), st.state),
             "local_bytes": shlib.local_bytes(st.state["params"]),
             "want_bytes": shlib.sharded_param_bytes(cfg, mesh),
             "kinds": st.collectives.stats().count_by_kind,
             "scan_records": [c for c in st.collectives.records
                              if c["name"] in SCAN_REGIONS]}
        # the gradients at the initial state and the first batch
        params = shlib.shard_params(state0["params"], cfg, mesh)
        batch = {"tokens": shlib.distribute(toks[0], shlib.placements(
            shlib.batch_placements({"tokens": toks[0]}, mesh)["tokens"],
            mesh), mesh)}
        with parallel_ctx(strategy.make_ctx(cfg, mesh)):
            _, _, grads = strategy.value_and_grad(cfg)(params, batch)
            grads = strategy.constrain_grads(cfg, grads, params)
        r["grads"] = tree_map(lambda t: t.full_tensor().numpy(), grads)

        pre = strategy.ShardedPrefillStep(cfg, mesh, state0["params"], B, S,
                                          MAX_LEN, "eager")
        r["logits"] = [pre({"tokens": toks[0]}).clone().numpy()]
        r["prefill_cache"] = tree_map(lambda t: t.full_tensor().numpy(),
                                      pre.cache)
        r["cache_plc"] = _placements(pre.cache)
        r["want_plc"] = tree_map(
            lambda pt: shlib.placements(pt, mesh),
            shlib.cache_placements(cfg, pre.cache, mesh))
        r["local_shapes"] = tree_map(lambda t: tuple(t.to_local().shape),
                                     pre.cache)
        dec = strategy.ShardedDecodeStep(cfg, mesh, state0["params"], B,
                                         MAX_LEN, "eager")
        dec.load_cache(pre.cache)
        ptrs = [t.to_local().data_ptr() for t in flatten(dec.cache)[0]]
        for tok in ref[case, "tokens"]:
            r["logits"].append(dec(torch.from_numpy(tok)).clone().numpy())
        r["same_addresses"] = ptrs == [t.to_local().data_ptr()
                                       for t in flatten(dec.cache)[0]]
        r["decode_plc"] = _placements(dec.cache)
        r["cache"] = tree_map(lambda t: t.full_tensor().numpy(), dec.cache)
        res[case] = r
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_recurrent")
    ref = run_reference("test_torch_sharded_recurrent", "reference",
                        tmp / "ref.pkl")
    return ref, spawn(port, tmp / "port", ref)


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_tree(got, want, **tol):
    want = dict(_items(want))
    got = dict(_items(got))
    assert got.keys() == want.keys()
    for name, v in got.items():
        np.testing.assert_allclose(v, want[name], err_msg=name, **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_reference(results, case):
    ref, ranks = results
    got = ranks[0][case]
    if case == "hybrid":
        np.testing.assert_allclose(got["losses"], ref[case, "losses"], **TOL)
        _assert_tree(got["state"], ref[case, "state"], atol=PARAM_ATOL,
                     rtol=0)
        return
    np.testing.assert_allclose(got["losses"], ref[case, "losses"], rtol=0,
                               atol=SSM_LOSS_ATOL)
    p0 = dict(_items(ref[case, "state0"]["params"]))
    want = dict(_items(ref[case, "state"]["params"]))
    for name, a in _items(got["state"]["params"]):
        da, db = a - p0[name], want[name] - p0[name]
        rel = np.linalg.norm(da - db) / np.linalg.norm(db)
        assert rel <= SSM_UPDATE_RTOL, (name, rel)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_reference(results, case):
    ref, ranks = results
    want = dict(_items(ref[case, "grads"]))
    got = dict(_items(ranks[0][case]["grads"]))
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        atol = (TOL["atol"] if case == "hybrid"
                else SSM_GRAD_SHARE * float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaf_gradients_are_summed_over_the_batch(results, case):
    """lru_a (the hybrid's recurrent layers) and bonus (the ssm's) are
    replicated and read inside a per-rank body: their gradients are the
    sums over the batch ranks, nonzero, each rank the same."""
    ref, ranks = results
    if case == "hybrid":
        names = [f"/layers/{i}/rec/lru_a" for i in (0, 1, 3, 4)]
    else:
        names = ["/blocks/tm/bonus"]
    want = dict(_items(ref[case, "grads"]))
    for r in ranks:
        got = dict(_items(r[case]["grads"]))
        for name in names:
            w = want[name]
            assert float(np.abs(w).min()) > 0, name
            atol = (TOL["atol"] if case == "hybrid"
                    else SSM_GRAD_SHARE * float(np.abs(w).max()))
            np.testing.assert_allclose(got[name], w, rtol=TOL["rtol"],
                                       atol=atol, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_serving_steps_match_reference(results, case):
    ref, ranks = results
    tol = TOL if case == "hybrid" else SSM_TOL
    for r in ranks:
        got = r[case]["logits"]
        assert len(got) == len(ref[case, "logits"]) == DECODE + 1
        for i, (a, b) in enumerate(zip(got, ref[case, "logits"])):
            np.testing.assert_allclose(a, b, err_msg=f"step {i}", **tol)
        for i in range(DECODE):
            np.testing.assert_array_equal(got[i].argmax(-1),
                                          ref[case, "tokens"][i])
        _assert_tree(r[case]["prefill_cache"], ref[case, "prefill_cache"],
                     **tol)
        _assert_tree(r[case]["cache"], ref[case, "cache"], **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_is_laid_out_by_cache_placements(results, case):
    from torch.distributed.tensor import Replicate, Shard

    _, ranks = results
    batch_only = (Shard(0), Replicate())
    for r in ranks:
        got = r[case]["cache_plc"]
        assert got == r[case]["want_plc"] == r[case]["decode_plc"]
        assert got["pos"] == batch_only
        if case == "hybrid":
            for i, layer in got["layers"].items():
                if "k" in layer:       # the window ring: slots over model
                    assert layer["k"] == layer["v"] == (Shard(0), Shard(1))
                else:
                    assert layer["conv"] == layer["h"] == batch_only
        else:
            stacked = (Shard(1), Replicate())
            assert got["blocks"]["tm"] == {"last": stacked, "s": stacked}
            assert got["blocks"]["cm"] == {"last": stacked}


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_blocks(results, case):
    from repro_torch.configs import get_smoke

    _, ranks = results
    cfg = get_smoke(CASES[case])
    rows = B // 2
    for r in ranks:
        assert r[case]["local_bytes"] == r[case]["want_bytes"]
        shapes = r[case]["local_shapes"]
        assert shapes["pos"] == (rows,)
        if case == "hybrid":
            w = cfg.attention_window // 2      # 16 slots, 8 a model rank
            assert shapes["layers"]["2"]["k"] == (rows, w, 1, cfg.head_dim)
            assert shapes["layers"]["0"]["conv"] == (
                rows, cfg.conv_width - 1, cfg.lru_width)
            assert shapes["layers"]["0"]["h"] == (rows, cfg.lru_width)
        else:
            h, n = cfg.rwkv_heads, cfg.rwkv_head_dim
            assert shapes["blocks"]["tm"]["s"] == (cfg.num_layers, rows, h,
                                                   n, n)
            assert shapes["blocks"]["cm"]["last"] == (cfg.num_layers, rows,
                                                      cfg.d_model)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_keeps_each_block_at_its_address(results, case):
    _, ranks = results
    assert all(r[case]["same_addresses"] for r in ranks)


@pytest.mark.parametrize("case", list(CASES))
def test_train_collectives_by_kind_none_inside_a_scan(results, case):
    _, ranks = results
    for r in ranks:
        kinds = r[case]["kinds"]
        assert kinds.get("all-gather", 0) > 0
        assert kinds.get("reduce-scatter", 0) + kinds.get("all-reduce", 0) > 0
        assert kinds.get("all-to-all", 0) == 0
        assert r[case]["scan_records"] == []


# ---------------------------------------------------------------------------
# the scans on split blocks, no ranks: halves as two model ranks hold them
# ---------------------------------------------------------------------------

def _halves(t, dim):
    return [c.contiguous() for c in t.chunk(2, dim=dim)]


def test_split_rglru_scan_forward_and_reverse_equal_the_whole():
    from repro_torch.kernels.rglru_scan.ops import rglru_scan

    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 37, 64, generator=g).requires_grad_()
    b = torch.randn(2, 37, 64, generator=g).requires_grad_()
    dh = torch.randn(2, 37, 64, generator=g)
    h = rglru_scan(a, b)
    da, db = torch.autograd.grad(h, (a, b), dh)
    parts = []
    for ah, bh, dhh in zip(_halves(a.detach(), 2), _halves(b.detach(), 2),
                           _halves(dh, 2)):
        ah.requires_grad_()
        bh.requires_grad_()
        hh = rglru_scan(ah, bh)
        parts.append((hh, *torch.autograd.grad(hh, (ah, bh), dhh)))
    for i, whole in enumerate((h, da, db)):
        assert torch.equal(torch.cat([p[i] for p in parts], dim=2), whole)


def test_split_wkv_forward_and_reverse_equal_the_whole():
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv

    g = torch.Generator().manual_seed(1)
    shape = (2, 24, 4, 8)
    r, k, v = (0.5 * torch.randn(shape, generator=g) for _ in range(3))
    logw = -torch.exp(0.5 * torch.randn(shape, generator=g))
    u = 0.5 * torch.randn(4, 8, generator=g)
    do = torch.randn(shape, generator=g)
    ins = [t.requires_grad_() for t in (r, k, v, logw, u)]
    o, s1 = rwkv6_wkv(*ins)
    whole = (o, s1, *torch.autograd.grad(o, ins, do))
    parts = []
    for j in range(2):
        hs = slice(2 * j, 2 * j + 2)
        half = [t.detach()[:, :, hs].contiguous().requires_grad_()
                for t in (r, k, v, logw)]
        half.append(u.detach()[hs].contiguous().requires_grad_())
        oh, sh = rwkv6_wkv(*half)
        parts.append((oh, sh, *torch.autograd.grad(oh, half, do[:, :, hs])))
    dims = (2, 1, 2, 2, 2, 2)          # o, state, dr, dk, dv, dlogw
    for i, d in enumerate(dims):
        assert torch.equal(torch.cat([p[i] for p in parts], dim=d),
                           whole[i]), i
    # du sums r k (do . v) over rows and tokens, which the plain reverse
    # adds in an order that depends on the head count: the same sum,
    # within its rounding bound gamma_n sum |terms|, n = b * s terms
    terms = (r * k * (do * v).sum(-1, keepdim=True)).detach()
    n = shape[0] * shape[1]
    bound = n * torch.finfo(torch.float32).eps * terms.abs().sum((0, 1))
    diff = (torch.cat([p[6] for p in parts]) - whole[6]).abs()
    assert bool((diff <= bound).all())


# ---------------------------------------------------------------------------
# world size 1: bit for bit against the unsharded steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_dev_mesh

    store = tmp_path_factory.mktemp("world1") / "store"
    init_distributed("cpu", f"file://{store}")
    try:
        yield make_dev_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    from repro_torch.tree import flatten

    return flatten(tree)[0]


@pytest.mark.parametrize("case", list(CASES))
def test_world_one_train_step_is_train_step_bit_for_bit(world_one, case):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_map

    cfg = get_smoke(CASES[case])
    s0 = strategy.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    ref = strategy.TrainStep(cfg, AdamWConfig(), s0, B, S, "eager")
    got = strategy.ShardedTrainStep(cfg, AdamWConfig(), world_one, s0, B,
                                    S, "eager")
    for t in _tokens(cfg.vocab_size):
        batch = {"tokens": torch.from_numpy(t)}
        a = {k: v.clone() for k, v in ref(batch).items()}
        b = got(batch)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(
        _leaves(ref.state), _leaves(tree_map(lambda t: t.to_local(),
                                             got.state))))
    assert got.collectives.stats().count_by_kind == {}


@pytest.mark.parametrize("case", list(CASES))
def test_world_one_serving_steps_are_unsharded_bit_for_bit(world_one, case):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.models import model

    cfg = get_smoke(CASES[case])
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size)[0])
    pre = strategy.ShardedPrefillStep(cfg, world_one, params, B, S, MAX_LEN,
                                      "eager")
    dec = strategy.ShardedDecodeStep(cfg, world_one, params, B, MAX_LEN,
                                     "eager")
    logits, cache = model.prefill_fn(cfg, MAX_LEN)(params, {"tokens": toks})
    assert torch.equal(pre({"tokens": toks}), logits)
    assert all(torch.equal(a, b.to_local()) for a, b in zip(
        _leaves(cache), _leaves(pre.cache)))
    dec.load_cache(pre.cache)
    step = model.decode_inplace_fn(cfg)
    for _ in range(2):
        tok = logits.argmax(-1).int()
        logits = step(params, tok, cache)
        assert torch.equal(dec(tok), logits)
    assert all(torch.equal(a, b.to_local()) for a, b in zip(
        _leaves(cache), _leaves(dec.cache)))
    assert dec.collectives.stats().count_by_kind == {}

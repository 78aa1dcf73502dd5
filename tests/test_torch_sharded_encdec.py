"""The port's sharded steps for the enc-dec and vlm families
(``launch.strategy.ShardedTrainStep``, ``ShardedPrefillStep``,
``ShardedDecodeStep``) on 4 gloo ranks, a (2, 2) ("data", "model")
mesh, against the reference's ``jit_train_step``, ``jit_prefill_step``
and ``jit_decode_step`` on a 4-device CPU mesh of Auto axes, their
inputs ``device_put`` to the jits' shardings: whisper-medium SMOKE (4 /
4 heads: the encoder's, the decoder's and the cross-attention's split
over model, the flash kernel on each rank's heads and rows) and
llava-next-mistral-7b SMOKE (GQA 4 / 2, 8 patches before the tokens),
(4, 32) tokens from ``np.random.default_rng(3)`` and frames or patches
from the same generator (rounded to bf16, as ``input_specs`` gives
them), 2 train steps from the reference's initial state, a prefill
into the reference's cache of prompt + 64 slots and 4 greedy decode
steps, fp32:

* losses within TOL, every parameter and AdamW moment within
  PARAM_ATOL but whisper's key biases, held to STEPS x lr
  (``tests/test_torch_train_encdec.py``'s rule: their gradient is zero
  but for rounding), the gradients at the first batch within TOL;
* prefill and decode logits within LOGIT_TOL (the one-process parity
  files' bound), greedy tokens equal, every cache leaf within TOL; the
  reference's scalar ``pos`` against each row of the port's, whisper's
  ``ring`` (which the reference does not keep) prompt + 64;
* every cache leaf laid out by ``cache_placements`` (the KV's batch
  over data and slots over model, whisper's encoder states, positions
  and rings on the batch), each rank holding only its blocks; the
  decode keeps every block at its address; one train step's collectives
  by kind, one decode step's split softmax three all-reduces a layer;
* whisper decoding across its ring: rows whose positions lie past the
  96-slot ring in a 160-slot buffer (the port's ring inside a longer
  buffer, ``whisper.decode_step``), 4 steps on 4 ranks against the
  one-process ``decode_step`` on the same cache;
* llava's prefill into fewer slots than its patches and tokens (the
  ring drops the oldest patches first, as the reference's servers size
  it) against the port's one-process prefill (the reference's jitted
  prefill takes no ``max_len``);
* at world size 1 (a gloo group in this process) the three steps equal
  the unsharded ones bit for bit, whisper's decode across its ring.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_mesh import auto_mesh, run_reference, save, spawn  # noqa: E402

CASES = {"encdec": "whisper-medium", "vlm": "llava-next-mistral-7b"}
STUB = {"encdec": "frames", "vlm": "patches"}
TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL = 1e-4
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LR = 3e-4                            # AdamWConfig's default
B, S, STEPS, DECODE = 4, 32, 2, 4
RING = S + 64                        # whisper's ring: the prompt + 64
# whisper's decode across its ring: each row's positions past the
# 96-slot ring of a 160-slot buffer (slots on both model ranks' halves,
# one row at the ring's last slot, one just wrapped)
RING_POS = (95, 96, 130, 200)
# llava's prefill into fewer slots than its 8 patches and 32 tokens
SHORT_MAX_LEN = 24


def _seq(cfg) -> int:
    """The stream positions of a prompt: the vlm's patches and tokens."""
    return S + (cfg.num_patches if cfg.family == "vlm" else 0)


def _inputs(cfg):
    """(tokens (STEPS, B, S) int32, frames or patches (STEPS, B, n, d)
    fp32) from one generator."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (STEPS, B, S), dtype=np.int32)
    n = cfg.encoder_positions if cfg.family == "encdec" else cfg.num_patches
    stub = rng.standard_normal((STEPS, B, n, cfg.d_model)).astype(np.float32)
    return toks, stub


def _port_batches(cfg, case):
    toks, stub = _inputs(cfg)
    return [{"tokens": torch.from_numpy(t),
             STUB[case]: torch.from_numpy(f).to(torch.bfloat16)}
            for t, f in zip(toks, stub)]


def _port_max_len(cfg) -> int:
    """The ``max_len`` whose cache is the reference's prompt + 64 slots:
    whisper's buffer is ``max_len`` + 64, the others' ``max_len``."""
    return S if cfg.family == "encdec" else _seq(cfg) + 64


def reference(out):
    import jax
    import jax.numpy as jnp

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
        seq = _seq(cfg)
        fn, (_, batch_abs), ctx = strategy.jit_train_step(
            cfg, ShapeConfig("t", "train", seq, B), mesh, AdamWConfig())
        state = strategy.init_train_state(cfg, jax.random.PRNGKey(0), mesh)
        res[case, "state0"] = jax.tree.map(np.asarray, state)
        # the train step donates its state: the params again, for the rest
        params = jax.device_put(res[case, "state0"]["params"],
                                shlib.param_shardings(cfg, mesh))
        batch_sh = strategy.named(mesh, shlib.batch_pspecs(cfg, batch_abs,
                                                            mesh))
        toks, stub = _inputs(cfg)
        batches = [jax.device_put(
            {"tokens": t, STUB[case]: jnp.asarray(f, jnp.bfloat16)},
            batch_sh) for t, f in zip(toks, stub)]
        grad = jax.jit(jax.grad(lambda p, b: model.loss_fn(cfg)(p, b)[0]),
                       in_shardings=(shlib.param_shardings(cfg, mesh),
                                     batch_sh))
        with parallel_ctx(ctx):
            res[case, "grads"] = jax.tree.map(np.asarray,
                                              grad(params, batches[0]))
            losses = []
            for b in batches:
                state, m = fn(state, b)
                losses.append(float(m["loss"]))
        res[case, "losses"] = losses
        res[case, "state"] = jax.tree.map(np.asarray, state)

        pfn, _, ctx = strategy.jit_prefill_step(
            cfg, ShapeConfig("p", "prefill", seq, B), mesh)
        dfn, (_, tok_abs, cache_abs), _ = strategy.jit_decode_step(
            cfg, ShapeConfig("d", "decode", seq + 64, B), mesh)
        with parallel_ctx(ctx):
            logits, cache = pfn(params, batches[0])
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


def _records(counter, name=None):
    return [(r["kind"], r["bytes"]) for r in counter.records
            if name is None or r["name"] == name]


def _full(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.full_tensor().numpy(), tree)


def _random_cache(cfg, max_len, seed):
    """A decode cache of ``model.init_cache(cfg, B, max_len)``'s tree,
    every floating leaf drawn from a normal."""
    from repro_torch.models import model
    from repro_torch.tree import tree_map

    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: torch.randn(t.shape, generator=g,
                                          dtype=t.dtype)
                    if t.dtype.is_floating_point else t,
                    model.init_cache(cfg, B, max_len))


def _ring_cache(cfg):
    """Whisper's cache across its ring: a 160-slot buffer, each row's
    96-slot ring, its position at ``RING_POS``."""
    cache = _random_cache(cfg, RING, 5)
    cache["pos"] = torch.tensor(RING_POS, dtype=torch.int32)
    cache["ring"] = torch.full((B,), RING, dtype=torch.int32)
    return cache


def port(rank, mesh, ref):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.models import model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shlib
    from repro_torch.parallel.ctx import parallel_ctx
    from repro_torch.tree import flatten, tree_map

    res = {}
    for case, arch in CASES.items():
        cfg = get_smoke(arch)
        seq, max_len = _seq(cfg), _port_max_len(cfg)
        state0 = tree_map(lambda a: torch.from_numpy(np.array(a)),
                          ref[case, "state0"])
        params = state0["params"]
        batches = _port_batches(cfg, case)
        st = strategy.ShardedTrainStep(cfg, AdamWConfig(), mesh, state0, B,
                                       seq, step_impl="eager")
        r = {"losses": [float(st(b)["loss"]) for b in batches],
             "state": _full(st.state),
             "local_bytes": shlib.local_bytes(st.state["params"]),
             "want_bytes": shlib.sharded_param_bytes(cfg, mesh),
             "kinds": st.collectives.stats().count_by_kind}
        # the gradients at the initial state and the first batch
        sharded = shlib.shard_params(params, cfg, mesh)
        batch = tree_map(lambda t, pt: shlib.distribute(
            t, shlib.placements(pt, mesh), mesh), batches[0],
            shlib.batch_placements(batches[0], mesh))
        with parallel_ctx(strategy.make_ctx(cfg, mesh)):
            _, _, grads = strategy.value_and_grad(cfg)(sharded, batch)
            grads = strategy.constrain_grads(cfg, grads, sharded)
        r["grads"] = _full(grads)

        pre = strategy.ShardedPrefillStep(cfg, mesh, params, B, seq,
                                          max_len, "eager")
        r["logits"] = [pre(batches[0]).clone().numpy()]
        r["prefill_cache"] = _full(pre.cache)
        r["cache_plc"] = _placements(pre.cache)
        r["want_plc"] = tree_map(
            lambda pt: shlib.placements(pt, mesh),
            shlib.cache_placements(cfg, pre.cache, mesh))
        r["local_shapes"] = tree_map(lambda t: tuple(t.to_local().shape),
                                     pre.cache)
        dec = strategy.ShardedDecodeStep(cfg, mesh, params, B, max_len,
                                         "eager")
        r["softmax_records"] = _records(dec.collectives, "decode_attention")
        dec.load_cache(pre.cache)
        ptrs = [t.to_local().data_ptr() for t in flatten(dec.cache)[0]]
        for tok in ref[case, "tokens"]:
            r["logits"].append(dec(torch.from_numpy(tok)).clone().numpy())
        r["same_addresses"] = ptrs == [t.to_local().data_ptr()
                                       for t in flatten(dec.cache)[0]]
        r["decode_plc"] = _placements(dec.cache)
        r["cache"] = _full(dec.cache)

        if case == "encdec":
            # across the ring: the sharded decode and the one-process
            # decode_step on the same cache and tokens
            ring = strategy.ShardedDecodeStep(cfg, mesh, params, B, RING,
                                              "eager")
            cache = _ring_cache(cfg)
            ring.load_cache(cache)
            step = model.decode_fn(cfg)
            r["ring"], r["ring_one"] = [], []
            for tok in ref[case, "tokens"]:
                tok = torch.from_numpy(tok)
                r["ring"].append(ring(tok).clone().numpy())
                logits, cache = step(params, tok, cache)
                r["ring_one"].append(logits.numpy())
            r["ring_cache"] = _full(ring.cache)
            r["ring_one_cache"] = tree_map(lambda t: t.numpy(), cache)
        else:
            # fewer slots than the patches and tokens: the ring keeps the
            # newest positions
            short = strategy.ShardedPrefillStep(cfg, mesh, params, B, seq,
                                                SHORT_MAX_LEN, "eager")
            r["short"] = short(batches[0]).clone().numpy()
            r["short_cache"] = _full(short.cache)
            logits, cache = model.prefill_fn(cfg, SHORT_MAX_LEN)(
                params, batches[0])
            r["short_one"] = logits.numpy()
            r["short_one_cache"] = tree_map(lambda t: t.numpy(), cache)
        res[case] = r
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_encdec")
    ref = run_reference("test_torch_sharded_encdec", "reference",
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


def _assert_cache(got, want):
    """A port cache against the reference's: ``pos`` row by row (the
    reference's whisper keeps a scalar), whisper's ``ring`` prompt + 64,
    every other leaf within TOL."""
    got = dict(_items(got))
    want = dict(_items(want))
    np.testing.assert_array_equal(
        got.pop("/pos"), np.broadcast_to(want.pop("/pos"), (B,)))
    if "/ring" in got:
        np.testing.assert_array_equal(got.pop("/ring"), np.full((B,), RING))
    _assert_tree(got, want, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_reference(results, case):
    ref, ranks = results
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"], ref[case, "losses"], **TOL)
    want = dict(_items(ref[case, "state"]))
    names = set()
    for name, v in _items(got["state"]):
        names.add(name)
        if name.startswith("/params/") and name.endswith("/bk"):
            # zero gradient but for rounding: AdamW moves each element up
            # to ~lr a step, in each side's rounding's direction
            assert np.abs(v - want[name]).max() <= STEPS * LR, name
            continue
        np.testing.assert_allclose(v, want[name], atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
    assert names == set(want)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_reference(results, case):
    ref, ranks = results
    _assert_tree(ranks[0][case]["grads"], ref[case, "grads"], **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_serving_steps_match_reference(results, case):
    ref, ranks = results
    for r in ranks:
        got = r[case]["logits"]
        assert len(got) == len(ref[case, "logits"]) == DECODE + 1
        for i, (a, b) in enumerate(zip(got, ref[case, "logits"])):
            np.testing.assert_allclose(a, b, err_msg=f"step {i}",
                                       **LOGIT_TOL)
        for i in range(DECODE):
            np.testing.assert_array_equal(got[i].argmax(-1),
                                          ref[case, "tokens"][i])
        _assert_cache(r[case]["prefill_cache"], ref[case, "prefill_cache"])
        _assert_cache(r[case]["cache"], ref[case, "cache"])


@pytest.mark.parametrize("case", list(CASES))
def test_cache_is_laid_out_by_cache_placements(results, case):
    from torch.distributed.tensor import Replicate, Shard

    _, ranks = results
    batch_only = (Shard(0), Replicate())
    kv = (Shard(1), Shard(2))           # (L, b, S, hkv, hd): b, S
    for r in ranks:
        got = r[case]["cache_plc"]
        assert got == r[case]["want_plc"] == r[case]["decode_plc"]
        assert got["blocks"] == {"k": kv, "v": kv}
        assert got["pos"] == batch_only
        if case == "encdec":
            assert got["ring"] == got["enc_out"] == batch_only


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_blocks(results, case):
    from repro_torch.configs import get_smoke

    _, ranks = results
    cfg = get_smoke(CASES[case])
    rows, slots = B // 2, (_seq(cfg) + 64) // 2
    for r in ranks:
        assert r[case]["local_bytes"] == r[case]["want_bytes"]
        shapes = r[case]["local_shapes"]
        assert shapes["pos"] == (rows,)
        assert shapes["blocks"]["k"] == (cfg.num_layers, rows, slots,
                                         cfg.num_kv_heads, cfg.head_dim)
        if case == "encdec":
            assert shapes["ring"] == (rows,)
            assert shapes["enc_out"] == (rows, cfg.encoder_positions,
                                         cfg.d_model)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_keeps_each_block_at_its_address(results, case):
    _, ranks = results
    assert all(r[case]["same_addresses"] for r in ranks)


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_by_kind(results, case):
    """A train step gathers and reduces; a decode step splits the self-
    attention's softmax over the two model ranks' slots: three
    all-reduces a layer (the row maxima, the sums, the fp32 outputs)."""
    from repro_torch.configs import get_smoke

    _, ranks = results
    cfg = get_smoke(CASES[case])
    m_bytes = B // 2 * cfg.num_heads * 4
    want = [("all-reduce", m_bytes), ("all-reduce", m_bytes),
            ("all-reduce", m_bytes * cfg.head_dim)] * cfg.num_layers
    for r in ranks:
        kinds = r[case]["kinds"]
        assert kinds.get("all-gather", 0) > 0
        assert kinds.get("reduce-scatter", 0) + kinds.get("all-reduce", 0) > 0
        assert r[case]["softmax_records"] == want


def test_whisper_decode_across_its_ring_matches_one_process(results):
    _, ranks = results
    for r in ranks:
        got = r["encdec"]
        assert len(got["ring"]) == DECODE
        for i, (a, b) in enumerate(zip(got["ring"], got["ring_one"])):
            np.testing.assert_allclose(a, b, err_msg=f"step {i}", **TOL)
        _assert_tree(got["ring_cache"], got["ring_one_cache"], **TOL)
        np.testing.assert_array_equal(got["ring_cache"]["pos"],
                                      np.array(RING_POS) + DECODE)


def test_vlm_prefill_into_a_short_ring_matches_one_process(results):
    from repro_torch.configs import get_smoke

    _, ranks = results
    cfg = get_smoke(CASES["vlm"])
    assert SHORT_MAX_LEN < _seq(cfg)
    for r in ranks:
        got = r["vlm"]
        np.testing.assert_allclose(got["short"], got["short_one"], **TOL)
        _assert_tree(got["short_cache"], got["short_one_cache"], **TOL)
        assert got["short_cache"]["blocks"]["k"].shape[2] == SHORT_MAX_LEN


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


def _local(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to_local(), tree)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_world_one_steps_are_unsharded_bit_for_bit(world_one, case, step):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.models import model
    from repro_torch.optim import AdamWConfig

    cfg = get_smoke(CASES[case])
    seq, batches = _seq(cfg), _port_batches(cfg, case)
    s0 = strategy.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    params = s0["params"]
    if step == "train":
        ref = strategy.TrainStep(cfg, AdamWConfig(), s0, B, seq, "eager")
        got = strategy.ShardedTrainStep(cfg, AdamWConfig(), world_one, s0,
                                        B, seq, "eager")
        for batch in batches:
            a = {k: v.clone() for k, v in ref(batch).items()}
            b = got(batch)
            assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.equal(x, y) for x, y in zip(
            _leaves(ref.state), _leaves(_local(got.state))))
        assert got.collectives.stats().count_by_kind == {}
        return
    if step == "prefill":
        max_len = _port_max_len(cfg)
        pre = strategy.ShardedPrefillStep(cfg, world_one, params, B, seq,
                                          max_len, "eager")
        logits, cache = model.prefill_fn(cfg, max_len)(params, batches[0])
        assert torch.equal(pre(batches[0]), logits)
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(cache), _leaves(_local(pre.cache))))
        return
    # decode: whisper's rows across their ring, llava's at mixed positions
    if case == "encdec":
        max_len, cache = RING, _ring_cache(cfg)
    else:
        max_len = _seq(cfg) + 64
        cache = _random_cache(cfg, max_len, 5)
        cache["pos"] = torch.tensor(RING_POS, dtype=torch.int32)
    dec = strategy.ShardedDecodeStep(cfg, world_one, params, B, max_len,
                                     "eager")
    dec.load_cache(cache)
    one = model.decode_inplace_fn(cfg)
    tok = batches[0]["tokens"][:, 0]
    for _ in range(2):
        logits = one(params, tok, cache)
        assert torch.equal(dec(tok), logits)
        tok = logits.argmax(-1).int()
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(cache), _leaves(_local(dec.cache))))
    assert dec.collectives.stats().count_by_kind == {}
    assert cache["blocks"]["k"].shape[2] == (RING + 64 if case == "encdec"
                                             else max_len)

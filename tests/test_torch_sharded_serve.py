"""The port's sharded serving steps (``launch.strategy.ShardedPrefillStep``
and ``ShardedDecodeStep``) on 4 gloo ranks, a (2, 2) ("data", "model")
mesh, against the reference's ``jit_prefill_step`` / ``jit_decode_step``
on a 4-device CPU mesh of Auto axes, their inputs ``device_put`` to the
jits' shardings: a (4, 32) prompt from ``np.random.default_rng(3)``,
the reference's default cache of prompt + 64 = 96 slots, 4 greedy
decode steps, fp32:

* smollm-135m SMOKE (3 / 1 heads: heads whole on model) and
  deepseek-moe-16b SMOKE with its default ``moe_impl`` (4 / 4 heads
  split over model; the experts on the tokens gathered whole): prefill
  and step logits within TOL, greedy tokens equal, every cache leaf
  within TOL after the last step, the cache laid out by
  ``cache_placements`` (the batch over data, the 96 slots over model, so
  the decode attention's softmax is split over the two model ranks);
* deepseek-moe-16b with ``moe_impl="ep"``: the prefill matches; its
  decode is refused on both sides (a sequence of 1 does not split over
  2 model ranks: the reference's ``shard_map`` raises, the port's
  ``moe_ep`` a ``ValueError``);
* each rank holds only its blocks; one decode step's collectives hold
  the split softmax's three all-reduces a layer over model, count and
  bytes from the shapes; the sharded decode equals the port's
  one-process ``decode_step``, also from a cache whose rows sit at
  different positions (slots on both model ranks, one past a ring
  wrap); the decode step keeps every rank's cache block at its address;
* with no ranks, :func:`decode_attention_pieces` (the split softmax,
  its reductions over a stacked dim of pieces) against the one-piece
  ``decode_attention``;
* at world size 1 (a gloo group in this process) both steps, sharing
  the caller's parameter tensors, equal the unsharded prefill and 2 decode
  steps bit for bit;
* mixtral-8x7b SMOKE: its decode cache is a 16-slot window ring, split
  8 slots a model rank;
* rank 0's counted collectives of the prefill and of one decode step,
  count and bytes by kind, equal the dry run's records of the same
  cells (``repro_torch.launch.dryrun`` on a "cpu"-typed fake 2 x 2 mesh,
  made in the reference's subprocess).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_mesh import auto_mesh, run_reference, save, spawn  # noqa: E402

CASES = {
    "smollm": ("smollm-135m", {}),
    "deepseek": ("deepseek-moe-16b", {}),
    "deepseek_ep": ("deepseek-moe-16b", {"moe_impl": "ep"}),
    # a 16-slot window ring in the sequence-sharded decode cache
    "mixtral": ("mixtral-8x7b", {}),
}
DECODE = ("smollm", "deepseek", "mixtral")     # the EP decode is refused
TOL = dict(atol=1e-5, rtol=1e-5)
B, S, STEPS = 4, 32, 4
MAX_LEN = S + 64                     # the reference's default cache
# the per-row positions of the mixed-cache step: slots on both model
# ranks' halves of the 96, one row valid in the first half only, one
# past a ring wrap
MIXED_POS = (10, 50, 95, 200)


def _cfg(get_smoke, case):
    arch, knobs = CASES[case]
    return dataclasses.replace(get_smoke(arch), **knobs)


def _tokens(vocab: int):
    return np.random.default_rng(3).integers(0, vocab, (B, S),
                                             dtype=np.int32)


def reference(out):
    import jax

    from repro.configs import get_smoke
    from repro.launch import strategy
    from repro.models import model
    from repro.models.config import ShapeConfig
    from repro.parallel import sharding as shlib
    from repro.parallel.ctx import parallel_ctx

    mesh = auto_mesh()
    res = {}
    for case in CASES:
        cfg = _cfg(get_smoke, case)
        params = jax.device_put(model.init_params(cfg, jax.random.PRNGKey(0)),
                                shlib.param_shardings(cfg, mesh))
        res[case, "params"] = jax.tree.map(np.asarray, params)
        pfn, _, ctx = strategy.jit_prefill_step(
            cfg, ShapeConfig("p", "prefill", S, B), mesh)
        batch = {"tokens": _tokens(cfg.vocab_size)}
        batch = jax.device_put(batch, strategy.named(
            mesh, shlib.batch_pspecs(cfg, batch, mesh)))
        dfn, (_, tok_abs, cache_abs), _ = strategy.jit_decode_step(
            cfg, ShapeConfig("d", "decode", MAX_LEN, B), mesh)
        with parallel_ctx(ctx):
            logits, cache = pfn(params, batch)
            res[case, "logits"] = [np.asarray(logits)]
            cache = jax.device_put(cache, strategy.named(
                mesh, shlib.cache_pspecs(cfg, cache_abs, mesh)))
            tok_sh = strategy.named(mesh, shlib.batch_pspecs(cfg, tok_abs,
                                                             mesh))
            toks = []
            for _ in range(STEPS):
                tok = np.asarray(logits).argmax(-1).astype(np.int32)
                toks.append(tok)
                try:
                    logits, cache = dfn(params, jax.device_put(tok, tok_sh),
                                        cache)
                except Exception as e:     # the EP decode: shard_map's own
                    res[case, "decode_error"] = f"{type(e).__name__}: {e}"
                    break
                res[case, "logits"].append(np.asarray(logits))
        res[case, "tokens"] = toks
        res[case, "cache"] = jax.tree.map(np.asarray, cache)
    res["dryrun"] = _dryrun_records()
    save(res, out)


def _dryrun_records():
    """The dry run's collectives (count and bytes by kind) of each case's
    prefill and decode cells on a "cpu"-typed fake 2 x 2 mesh: the plan
    the gloo ranks run."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    out = {}
    for case in CASES:
        cfg = _cfg(get_smoke, case)
        cells = [("prefill", S)] + ([("decode", MAX_LEN)]
                                    if case in DECODE else [])
        for kind, seq in cells:
            c = dryrun.run_cell(cfg.name, ShapeConfig(kind, kind, seq, B),
                                save=False, cfg_override=cfg,
                                mesh_shape=(2, 2),
                                mesh_device="cpu")["collectives"]
            out[case, kind] = (c["count_by_kind"], c["bytes_by_kind"])
    return out


def _kinds(counter):
    stats = counter.stats()
    return stats.count_by_kind, stats.bytes_by_kind


def _placements(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: tuple(t.placements), tree)


def _records(counter, name=None):
    return [(r["kind"], r["bytes"]) for r in counter.records
            if name is None or r["name"] == name]


def port(rank, mesh, ref):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding as shlib
    from repro_torch.tree import flatten, tree_map

    res = {}
    for case in CASES:
        cfg = _cfg(get_smoke, case)
        params = tree_map(lambda a: torch.from_numpy(np.array(a)),
                          ref[case, "params"])
        toks = torch.from_numpy(_tokens(cfg.vocab_size))
        pre = strategy.ShardedPrefillStep(cfg, mesh, params, B, S, MAX_LEN,
                                          "eager")
        r = {"logits": [pre({"tokens": toks}).clone().numpy()],
             "cache_plc": _placements(pre.cache),
             "want_plc": tree_map(lambda pt: shlib.placements(pt, mesh),
                                  shlib.cache_placements(cfg, pre.cache,
                                                         mesh)),
             "local_shapes": tree_map(lambda t: tuple(t.to_local().shape),
                                      pre.cache),
             "local_bytes": shlib.local_bytes(pre.params),
             "want_bytes": shlib.sharded_param_bytes(cfg, mesh),
             "kinds": {"prefill": _kinds(pre.collectives)}}
        res[case] = r
        if case not in DECODE:
            try:
                strategy.ShardedDecodeStep(cfg, mesh, params, B, MAX_LEN,
                                           "eager")
            except ValueError as e:
                r["decode_error"] = str(e)
            continue
        dec = strategy.ShardedDecodeStep(cfg, mesh, params, B, MAX_LEN,
                                         "eager")
        r["records"] = _records(dec.collectives)
        r["kinds"]["decode"] = _kinds(dec.collectives)
        r["softmax_records"] = _records(dec.collectives, "decode_attention")
        dec.load_cache(pre.cache)
        ptrs = [t.to_local().data_ptr() for t in flatten(dec.cache)[0]]
        for tok in ref[case, "tokens"]:
            r["logits"].append(dec(torch.from_numpy(tok)).clone().numpy())
        r["same_addresses"] = ptrs == [t.to_local().data_ptr()
                                       for t in flatten(dec.cache)[0]]
        r["cache"] = tree_map(lambda t: t.full_tensor().numpy(), dec.cache)
        if rank == 0:
            # the one-process prefill and decode_step on the same tokens
            logits, cache = transformer.prefill(params, {"tokens": toks},
                                                cfg, MAX_LEN)
            one = [logits.numpy()]
            for tok in ref[case, "tokens"]:
                logits, cache = transformer.decode_step(
                    params, torch.from_numpy(tok), cache, cfg)
                one.append(logits.numpy())
            r["one"] = one
        # one step from a cache whose rows sit at MIXED_POS, the same
        # full cache on every rank
        g = torch.Generator().manual_seed(5)
        mixed = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                               dtype=t.dtype)
                         if t.dtype.is_floating_point else t,
                         transformer.init_cache(cfg, B, MAX_LEN))
        mixed["pos"] = torch.tensor(MIXED_POS, dtype=torch.int32)
        tok = torch.from_numpy(ref[case, "tokens"][0])
        dec.load_cache(mixed)
        r["mixed"] = dec(tok).clone().numpy()
        r["mixed_cache"] = tree_map(lambda t: t.full_tensor().numpy(),
                                    dec.cache)
        logits, cache = transformer.decode_step(
            params, tok, tree_map(torch.clone, mixed), cfg)
        r["mixed_one"] = logits.numpy()
        r["mixed_one_cache"] = tree_map(lambda t: t.numpy(), cache)
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    ref = run_reference("test_torch_sharded_serve", "reference",
                        tmp / "ref.pkl")
    return ref, spawn(port, tmp / "port", ref)


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_tree(got, want):
    want = dict(_items(want))
    got = dict(_items(got))
    assert got.keys() == want.keys()
    for name, v in got.items():
        np.testing.assert_allclose(v, want[name], err_msg=name, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_matches_reference(results, case):
    ref, ranks = results
    for r in ranks:
        np.testing.assert_allclose(r[case]["logits"][0],
                                   ref[case, "logits"][0], **TOL)


@pytest.mark.parametrize("case", DECODE)
def test_decode_matches_reference(results, case):
    ref, ranks = results
    assert len(ref[case, "logits"]) == STEPS + 1
    for r in ranks:
        got = r[case]["logits"]
        for i in range(STEPS + 1):
            np.testing.assert_allclose(got[i], ref[case, "logits"][i],
                                       err_msg=f"step {i}", **TOL)
        # the greedy tokens: the port's argmax is the reference's
        for i in range(STEPS):
            np.testing.assert_array_equal(got[i].argmax(-1),
                                          ref[case, "tokens"][i])
        _assert_tree(r[case]["cache"], ref[case, "cache"])


def test_ep_decode_is_refused_on_both_sides(results):
    ref, ranks = results
    err = ref["deepseek_ep", "decode_error"]
    assert err.startswith("ValueError: shard_map") and \
        "not evenly divisible" in err
    for r in ranks:
        assert "do not split evenly" in r["deepseek_ep"]["decode_error"]


@pytest.mark.parametrize("case", list(CASES))
def test_cache_is_laid_out_by_cache_placements(results, case):
    from torch.distributed.tensor import Replicate, Shard

    _, ranks = results
    for r in ranks:
        got, want = r[case]["cache_plc"], r[case]["want_plc"]
        assert got == want
        # the batch over data, the 96 slots over model, pos on the batch
        assert got["blocks"]["k"] == (Shard(1), Shard(2))
        assert got["pos"] == (Shard(0), Replicate())
        for layer in got.get("dense_layers", {}).values():
            assert layer["k"] == (Shard(0), Shard(1))


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_blocks(results, case):
    from repro_torch.configs import get_smoke

    _, ranks = results
    cfg = _cfg(get_smoke, case)
    n = cfg.num_layers - cfg.first_k_dense
    # the 96 slots, or a window's ring of fewer (mixtral's 16)
    slots = min(cfg.attention_window or MAX_LEN, MAX_LEN)
    kv = (B // 2, slots // 2, cfg.num_kv_heads, cfg.head_dim)
    for r in ranks:
        shapes = r[case]["local_shapes"]
        assert shapes["blocks"]["k"] == (n, *kv)   # (3, 2, 48, 1, 16)
        assert shapes["pos"] == (B // 2,)
        for layer in shapes.get("dense_layers", {}).values():
            assert layer["v"] == kv
        assert r[case]["local_bytes"] == r[case]["want_bytes"]


@pytest.mark.parametrize("case", DECODE)
def test_decode_step_counts_the_split_softmax(results, case):
    from repro_torch.configs import get_smoke

    _, ranks = results
    cfg = _cfg(get_smoke, case)
    rows = B // 2                       # this rank's rows
    m_bytes = rows * cfg.num_heads * 4  # (1, rows, hkv, g, 1) fp32
    o_bytes = m_bytes * cfg.head_dim    # (1, rows, hkv, g, hd) fp32
    want = [("all-reduce", m_bytes), ("all-reduce", m_bytes),
            ("all-reduce", o_bytes)] * cfg.num_layers
    for r in ranks:
        assert r[case]["softmax_records"] == want
        assert len(r[case]["records"]) > len(want)


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_equal_the_dry_run_records(results, case):
    # the record is rank 0's: the second model rank's decode step
    # gathers smaller blocks where a dim does not split evenly over the
    # two (768 B less for smollm, 1024 B for deepseek and mixtral)
    ref, ranks = results
    kinds = ranks[0][case]["kinds"]
    assert set(kinds) == ({"prefill", "decode"} if case in DECODE
                          else {"prefill"})
    for kind, got in kinds.items():
        assert got == ref["dryrun"][case, kind], kind


@pytest.mark.parametrize("case", DECODE)
def test_sharded_decode_matches_one_process_decode(results, case):
    _, ranks = results
    got, one = ranks[0][case]["logits"], ranks[0][case]["one"]
    for i in range(STEPS + 1):
        np.testing.assert_allclose(got[i], one[i], err_msg=f"step {i}",
                                   **TOL)


@pytest.mark.parametrize("case", DECODE)
def test_mixed_positions_step_matches_one_process_step(results, case):
    _, ranks = results
    for r in ranks:
        np.testing.assert_allclose(r[case]["mixed"], r[case]["mixed_one"],
                                   **TOL)
        _assert_tree(r[case]["mixed_cache"], r[case]["mixed_one_cache"])


@pytest.mark.parametrize("case", DECODE)
def test_decode_keeps_each_block_at_its_address(results, case):
    _, ranks = results
    assert all(r[case]["same_addresses"] for r in ranks)


# ---------------------------------------------------------------------------
# the split softmax with no ranks: pieces stacked on a leading dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("n_valid", ["zero", "one_piece", "wrapped"])
def test_split_softmax_matches_one_piece(pieces, group, n_valid):
    from repro_torch.models.attention import (decode_attention,
                                              decode_attention_pieces)

    g = torch.Generator().manual_seed(pieces * 10 + group)
    b, hkv, hd, slots = 4, 2, 16, 96
    q = torch.randn(b, 1, hkv * group, hd, generator=g)
    k = torch.randn(b, slots, hkv, hd, generator=g)
    v = torch.randn(b, slots, hkv, hd, generator=g)
    s_p = slots // pieces
    nv = {"zero": torch.zeros(b, dtype=torch.int32),
          # every row's valid slots inside the first piece
          "one_piece": torch.tensor([1, 5, s_p - 1, s_p],
                                    dtype=torch.int32),
          # pos past a ring wrap: every slot valid, and rows short of it
          "wrapped": torch.tensor([slots, slots, slots - 1, 2 * s_p + 1],
                                  dtype=torch.int32)}[n_valid]

    def stack(t):                       # (b, S, ...) -> (P, b, S_p, ...)
        return t.reshape(b, pieces, s_p, hkv, hd).transpose(0, 1)

    got = decode_attention_pieces(
        q, stack(k), stack(v), nv, torch.arange(pieces) * s_p,
        lambda t: t.amax(0, keepdim=True).expand_as(t),
        lambda t: t.sum(0, keepdim=True).expand_as(t))
    want = decode_attention(q, k, v, nv)
    torch.testing.assert_close(got, want, **TOL)
    if n_valid == "zero":               # the uniform mean of the cache
        mean = v.mean(dim=1).repeat_interleave(group, dim=1)
        torch.testing.assert_close(got[:, 0], mean, **TOL)


# ---------------------------------------------------------------------------
# world size 1: bit for bit against the unsharded prefill and decode
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


@pytest.mark.parametrize("case", list(CASES))
def test_world_one_steps_are_unsharded_bit_for_bit(world_one, case):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.models import model
    from repro_torch.tree import flatten

    cfg = _cfg(get_smoke, case)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size))
    pre = strategy.ShardedPrefillStep(cfg, world_one, params, B, S, MAX_LEN,
                                      "eager")
    dec = strategy.ShardedDecodeStep(cfg, world_one, params, B, MAX_LEN,
                                     "eager")
    # the steps share the caller's memory: at world size 1 the tensors
    assert all(a.to_local().data_ptr() == b.data_ptr()
               == c.to_local().data_ptr() for a, b, c in zip(
                   flatten(pre.params)[0], flatten(params)[0],
                   flatten(dec.params)[0]))
    logits, cache = model.prefill_fn(cfg, MAX_LEN)(params, {"tokens": toks})
    assert torch.equal(pre({"tokens": toks}), logits)
    dec.load_cache(pre.cache)
    step = model.decode_inplace_fn(cfg)
    for _ in range(2):
        tok = logits.argmax(-1).int()
        logits = step(params, tok, cache)
        assert torch.equal(dec(tok), logits)
    assert all(torch.equal(a, b.to_local()) for a, b in zip(
        flatten(cache)[0], flatten(dec.cache)[0]))
    kinds = dec.collectives.stats().count_by_kind
    assert kinds == ({"all-to-all": 2 * (cfg.num_layers - cfg.first_k_dense)}
                     if cfg.moe_impl == "ep" else {})
